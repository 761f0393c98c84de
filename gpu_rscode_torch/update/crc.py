"""Seekable CRC32 arithmetic — incremental per-chunk checksum fix-up.

An in-place patch must refresh the chunk's ``# crc32`` metadata line
without re-reading the untouched prefix and suffix.  CRC32 (the zlib
polynomial) is affine over GF(2) in the message bits: for equal-length
messages, ``crc(x ⊕ y) = crc(x) ⊕ crc(y) ⊕ crc(0^n)`` (the init/xorout
constants cancel pairwise).  A patched chunk is
``new = old ⊕ pad(Δ)`` with ``pad(Δ)`` the edit delta zero-extended to
the chunk length, so

    crc(new) = crc(old) ⊕ crc(0^pre ‖ Δ ‖ 0^post) ⊕ crc(0^len)

and the last two terms together are the register part of Δ alone,
``crc(Δ) ⊕ crc(0^|Δ|)``, advanced through the ``post`` zero bytes: O(log
n) via the classic GF(2) matrix-power shift (zlib's ``crc32_combine``,
reimplemented here — Python's :mod:`zlib` does not expose it), each power
applied as four byte-table lookups.  Appended bytes are plain
streaming :func:`zlib.crc32` continuation.

Everything here is pure host math, checked against full re-hashes with
zlib in tests/test_torch_layout.py.
"""

from __future__ import annotations

import functools
import zlib

_POLY = 0xEDB88320  # CRC-32, reflected


def _gf2_matrix_times(mat: list[int], vec: int) -> int:
    out = 0
    i = 0
    while vec:
        if vec & 1:
            out ^= mat[i]
        vec >>= 1
        i += 1
    return out


def _gf2_matrix_square(mat) -> tuple[int, ...]:
    return tuple(_gf2_matrix_times(mat, mat[n]) for n in range(32))


@functools.lru_cache(maxsize=None)
def _operator(j: int) -> tuple[int, ...]:
    """Matrix for "advance the CRC register past 2^j zero bytes".

    Pure recursive construction over immutable tuples: lru_cache may
    race two first computations of the same ``j`` across threads (the
    serve daemon patches archives from a pool), but both produce the
    identical value and nothing shared is ever mutated.  j is bounded by
    the bit length of a chunk size (< 64)."""
    if j == 0:
        odd = [0] * 32
        odd[0] = _POLY          # one zero BIT
        row = 1
        for n in range(1, 32):
            odd[n] = row
            row <<= 1
        even = _gf2_matrix_square(odd)   # two zero bits
        op = _gf2_matrix_square(even)    # four bits
        return _gf2_matrix_square(op)    # one zero BYTE (2^0 bytes)
    return _gf2_matrix_square(_operator(j - 1))


@functools.lru_cache(maxsize=None)
def _tables(j: int) -> tuple[tuple[int, ...], ...]:
    """:func:`_operator` ``(j)`` as four 256-entry tables, one per byte of
    the register: the matrix-vector product becomes four lookups."""
    mat = _operator(j)
    return tuple(tuple(_gf2_matrix_times(mat, b << (8 * q)) for b in range(256)) for q in range(4))


def _advance(crc: int, n: int) -> int:
    """The CRC register advanced through ``n`` zero bytes (no conditioning),
    O(log n)."""
    j = 0
    while n:
        if n & 1:
            t = _tables(j)
            crc = t[0][crc & 0xFF] ^ t[1][(crc >> 8) & 0xFF] ^ t[2][(crc >> 16) & 0xFF] ^ t[3][crc >> 24]
        n >>= 1
        j += 1
    return crc


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC32 of ``A ‖ B`` given ``crc32(A)``, ``crc32(B)`` and
    ``len(B)`` — zlib's crc32_combine, O(log len2)."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    return (_advance(crc1 & 0xFFFFFFFF, len2) ^ crc2) & 0xFFFFFFFF


@functools.lru_cache(maxsize=4096)
def crc32_zeros(n: int) -> int:
    """``crc32`` of ``n`` zero bytes, O(log n) (doubling via combine)."""
    if n <= 0:
        return 0
    if n == 1:
        return zlib.crc32(b"\x00")
    half = crc32_zeros(n // 2)
    crc = crc32_combine(half, half, n // 2)
    if n & 1:
        crc = zlib.crc32(b"\x00", crc)
    return crc & 0xFFFFFFFF


def crc32_patch(
    crc_old: int, chunk_len: int, off: int, delta: bytes | bytearray
) -> int:
    """CRC32 of a ``chunk_len``-byte message after XOR-ing ``delta`` in
    at byte offset ``off``, given only the old CRC — the seekable fix-up
    (no prefix/suffix re-read; O(log chunk_len))."""
    if not delta:
        return crc_old & 0xFFFFFFFF
    post = chunk_len - off - len(delta)
    assert off >= 0 and post >= 0, (off, len(delta), chunk_len)
    # crc(0^off ‖ Δ ‖ 0^post) ⊕ crc(0^len) is the register part of Δ alone
    # (leading zeros leave a zero register), carried through the post zeros.
    lin = zlib.crc32(bytes(delta)) ^ crc32_zeros(len(delta))
    return (crc_old ^ _advance(lin, post)) & 0xFFFFFFFF


def crc32_append(crc_old: int, tail: bytes | bytearray) -> int:
    """CRC32 after appending ``tail`` to the message (plain streaming
    continuation — named for symmetry with :func:`crc32_patch`)."""
    return zlib.crc32(bytes(tail), crc_old) & 0xFFFFFFFF
