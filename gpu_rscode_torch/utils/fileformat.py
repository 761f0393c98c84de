"""On-disk formats: chunk files, .METADATA, conf files.

The port's own copy of the JAX package's ``utils/fileformat.py`` (row layout
only), byte-compatible with it and with the reference encoder:

* chunk file ``_<i>_<fileName>``, i in [0, n): i < k natives, i >= k parity;
  each holds ``chunk_size = ceil(total_size / k)`` bytes, rounded up to the
  symbol size, the tail zero-padded.
* ``<fileName>.METADATA`` text: line 1 ``totalSize``; line 2
  ``parityBlockNum nativeBlockNum``; then the (k+p) x k total matrix,
  identity block first, each entry "%d " and "\\n" per row.  Extension
  lines start with ``#``: ``# gfwidth 16``, ``# crc32 <i> <8-hex>``,
  ``# layout <name>``, ``# generation <g>`` (the update commit counter).
* conf file: k lines, each a surviving chunk file name; the row index is
  the integer right after the first character (the reference's
  ``atoi(name + 1)``).
"""

from __future__ import annotations

import os
import re
import zlib

import numpy as np


def chunk_file_name(file_name: str, index: int) -> str:
    """``_<i>_<basename>`` next to ``file_name``."""
    d, base = os.path.split(file_name)
    return os.path.join(d, f"_{index}_{base}")


def metadata_file_name(file_name: str) -> str:
    return file_name + ".METADATA"


def chunk_size_for(total_size: int, native_num: int, sym: int = 1) -> int:
    """Bytes per chunk: ceil(total/k), rounded up to the symbol size ``sym``
    (2 for GF(2^16) so every chunk holds whole symbols)."""
    chunk = -(-total_size // native_num)
    return -(-chunk // sym) * sym


def journal_path(file_name: str) -> str:
    """The undo journal a torn in-place update leaves next to an archive."""
    return file_name + ".rs_journal"


def write_metadata(path: str, total_size: int, parity_num: int, native_num: int, total_mat: np.ndarray, w: int = 8) -> None:
    rows = native_num + parity_num
    if total_mat.shape != (rows, native_num):
        raise ValueError(f"total matrix shape {total_mat.shape} != {(rows, native_num)}")
    with open(path, "w") as fp:
        fp.write(f"{total_size}\n")
        fp.write(f"{parity_num} {native_num}\n")
        for i in range(rows):
            fp.write("".join(f"{int(v)} " for v in total_mat[i]) + "\n")
        if w != 8:
            fp.write(f"# gfwidth {w}\n")


class ArchiveMeta:
    """One-read view of an archive's .METADATA with its extension lines.
    ``total_mat`` is None for the sizes-only metadata dialect (the caller
    regenerates the canonical [I; Vandermonde] matrix)."""

    __slots__ = ("path", "total_size", "parity_num", "native_num", "total_mat", "w", "crcs", "layout", "generation")

    def __init__(self, path, total_size, parity_num, native_num, total_mat, w, crcs, layout, generation=0):
        self.path = path
        self.total_size = total_size
        self.parity_num = parity_num
        self.native_num = native_num
        self.total_mat = total_mat
        self.w = w
        self.crcs = crcs
        self.layout = layout
        self.generation = generation

    @property
    def sym(self) -> int:
        return self.w // 8

    @property
    def chunk(self) -> int:
        return chunk_size_for(self.total_size, self.native_num, self.sym)


def _extension(text: str, name: str) -> list[list[str]]:
    """Token lists of every ``# <name> ...`` line."""
    out = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) >= 3 and parts[:2] == ["#", name]:
            out.append(parts[2:])
    return out


def _parse_field_width(text: str) -> int:
    for args in _extension(text, "gfwidth"):
        if len(args) == 1 and args[0].isdigit():
            return int(args[0])
    return 8


def _parse_layout(text: str) -> str:
    for args in _extension(text, "layout"):
        if len(args) == 1:
            return args[0]
    return "row"


def _parse_generation(text: str) -> int:
    for args in _extension(text, "generation"):
        if len(args) == 1 and args[0].isdigit():
            return int(args[0])
    return 0


def _parse_checksums(text: str) -> dict[int, int]:
    """``# crc32`` lines; a malformed line is skipped (its chunk then goes
    unverified) rather than fatal."""
    crcs: dict[int, int] = {}
    for args in _extension(text, "crc32"):
        if (
            len(args) == 2
            and args[0].isdigit()
            and len(args[1]) == 8
            and all(c in "0123456789abcdefABCDEF" for c in args[1])
        ):
            crcs[int(args[0])] = int(args[1], 16)
    return crcs


def _parse_metadata(text: str, path: str):
    tokens: list[str] = []
    for line in text.splitlines():
        if line.lstrip().startswith("#"):
            continue
        tokens += line.split()
    if len(tokens) < 3:
        raise ValueError(f"malformed metadata file {path!r}")
    total_size, parity_num, native_num = int(tokens[0]), int(tokens[1]), int(tokens[2])
    if total_size < 0 or parity_num <= 0 or native_num <= 0:
        raise ValueError(
            f"metadata fields out of range in {path!r}: size={total_size} "
            f"p={parity_num} k={native_num} (size >= 0, p/k > 0)"
        )
    if native_num + parity_num > 65536:
        raise ValueError(f"metadata declares n={native_num + parity_num} chunks in {path!r}; at most 65536")
    if len(tokens) == 3:
        return total_size, parity_num, native_num, None
    want = (native_num + parity_num) * native_num
    mat_tokens = tokens[3 : 3 + want]
    if len(mat_tokens) != want:
        raise ValueError(f"metadata matrix truncated: expected {want} entries, got {len(mat_tokens)}")
    vals = [int(t) for t in mat_tokens]
    if min(vals) < 0 or max(vals) > 65535:
        raise ValueError(f"metadata matrix entry out of range in {path!r}: [{min(vals)}, {max(vals)}]")
    dtype = np.uint16 if max(vals) > 255 else np.uint8
    mat = np.array(vals, dtype=dtype).reshape(native_num + parity_num, native_num)
    return total_size, parity_num, native_num, mat


def read_archive_meta(path: str) -> ArchiveMeta:
    """Parse .METADATA into an :class:`ArchiveMeta`."""
    with open(path) as fp:
        text = fp.read()
    total_size, parity_num, native_num, mat = _parse_metadata(text, path)
    w = _parse_field_width(text)
    if native_num + parity_num > (1 << w):
        raise ValueError(
            f"metadata declares n={native_num + parity_num} chunks in {path!r} "
            f"but GF(2^{w}) supports at most {1 << w}"
        )
    return ArchiveMeta(path, total_size, parity_num, native_num, mat, w, _parse_checksums(text), _parse_layout(text),
                       _parse_generation(text))


def append_checksums(path: str, crcs: dict[int, int]) -> None:
    """Append ``# crc32 <chunk_index> <8-hex>`` lines after the matrix block
    (invisible to the reference's fixed-token parser)."""
    with open(path, "a") as fp:
        for i in sorted(crcs):
            fp.write(f"# crc32 {i} {crcs[i] & 0xFFFFFFFF:08x}\n")


def rewrite_checksums(path: str, crcs: dict[int, int]) -> None:
    """Replace every ``# crc32`` line of a metadata file with ``crcs``
    (repair refreshes the rebuilt chunks' CRCs).  Every other line is kept
    byte for byte, and the ``# generation`` line moves to the end, as the
    JAX package's metadata rewrite leaves it.  Crash-safe: a temp file,
    fsync, an atomic rename and an fsync of the directory."""
    with open(path) as fp:
        lines = fp.readlines()
    generation = _parse_generation("".join(lines))
    kept = [ln for ln in lines if ln.split()[:2] not in (["#", "generation"], ["#", "crc32"])]
    tmp = path + ".tmp"
    with open(tmp, "w") as fp:
        fp.writelines(kept)
        for i in sorted(crcs):
            fp.write(f"# crc32 {i} {crcs[i] & 0xFFFFFFFF:08x}\n")
        if generation:
            fp.write(f"# generation {generation}\n")
        fp.flush()
        os.fsync(fp.fileno())
    os.replace(tmp, path)
    try:
        fd = os.open(os.path.dirname(os.path.abspath(path)), os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def crc32_of(buf, crc: int = 0) -> int:
    """Incremental CRC32 (zlib polynomial) over bytes-like or ndarray data."""
    if isinstance(buf, (bytes, bytearray, memoryview)):
        return zlib.crc32(buf, crc)
    return zlib.crc32(memoryview(np.ascontiguousarray(buf)).cast("B"), crc)


def chunk_crc32(mm, chunk: int, step: int) -> int:
    """CRC32 of ``mm[:chunk]`` (the whole chunk, padding included) in
    ``step``-byte slices."""
    crc = 0
    step = max(1, step)
    for s in range(0, chunk, step):
        crc = crc32_of(mm[s : min(s + step, chunk)], crc)
    return crc


def parse_chunk_index(name: str) -> int:
    """Row index from a chunk file name: the digits right after the first
    character of the base name."""
    base = os.path.basename(name)
    m = re.match(r"\d+", base[1:])
    if not m:
        raise ValueError(f"cannot parse chunk index from {name!r}")
    return int(m.group(0))


def write_conf(path: str, chunk_names: list[str]) -> None:
    with open(path, "w") as fp:
        for name in chunk_names:
            fp.write(name + "\n")


def read_conf(path: str) -> list[str]:
    with open(path) as fp:
        return [line.strip() for line in fp if line.strip()]
