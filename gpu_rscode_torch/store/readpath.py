"""Small-range archive reads — decode restricted to touched column windows.

The object façade's GET must reconstruct ONE object's byte range out of
a multi-MiB stripe archive without a whole-archive decode.  This module
rides the update engine's window mapping (update/layout.py): a file range
[at, at+len) touches only ~ceil(len/(k·sym)) columns on the interleaved
layout (a per-row span on the row layout), so

* the **fast path** preads exactly those column windows from the k
  native chunks and de-interleaves them back to file order — no GEMM,
  no parity read, no CRC pass over untouched data; the caller verifies
  the OBJECT's own CRC32 (stored in the object index) over the returned
  bytes, which is the integrity check full-chunk CRCs cannot give a
  range read;
* the **degraded path** (missing/truncated native chunk, or the
  caller's CRC verdict came back bad — silent bitrot) scans the archive
  for k healthy chunks (full CRC verification, the usual scrub
  machinery), inverts the survivor submatrix once, and dispatches the
  recovery GEMM over ONLY the touched column windows through the same
  plan-cached ``codec.decode`` the whole-archive path uses (K1 on the
  card) — a 4 KiB object read out of a degraded 64 MiB stripe decodes a
  few KiB per surviving chunk, not the archive.

Both paths return the exact [at, at+len) bytes; the bucket layer turns
"still wrong after the degraded pass" into a loud integrity error,
never silently wrong bytes.
"""

from __future__ import annotations

import os
import zlib

import numpy as np

from ..obs import metrics as _metrics
from ..ops.gemm import to_numpy
from ..update.layout import deinterleave, touched_windows
from ..utils.fileformat import (
    chunk_file_name,
    metadata_file_name,
    read_archive_meta,
)


class RangeReadError(ValueError):
    """The requested range cannot be read (out of bounds, archive
    unrecoverable for these columns) — actionable, never wrong bytes."""


def _read_counter():
    return _metrics.counter(
        "rs_store_range_reads_total",
        "windowed range reads against stripe archives, by path",
    )


def _pread_window(path: str, lo: int, hi: int) -> bytes | None:
    """Bytes [lo, hi) of one chunk file, or None when the file is
    absent/short — the fast path's per-chunk health probe."""
    try:
        with open(path, "rb") as fp:
            got = os.pread(fp.fileno(), hi - lo, lo)
    except OSError:
        return None
    return got if len(got) == hi - lo else None


def _slice_windows(meta, at: int, length: int):
    """The (window, file_lo) plan: each touched chunk-column window
    [b0, b1) with the file-space offset its de-interleaved bytes start
    at (interleaved), or the per-row read list (row layout)."""
    k, sym, chunk = meta.native_num, meta.sym, meta.chunk
    return touched_windows(meta.layout, at, length, k, sym, chunk)


def _assemble_interleaved(meta, windows, rows_of, at, length) -> bytes:
    """File bytes [at, at+length) from per-window (k, bw) native-row
    stacks (``rows_of(b0, b1) -> np.ndarray``)."""
    k, sym = meta.native_num, meta.sym
    out = bytearray()
    for b0, b1 in windows:
        stack = rows_of(b0, b1)
        file_bytes = deinterleave(stack, sym)
        file_lo = (b0 // sym) * k * sym
        lo = max(at, file_lo)
        hi = min(at + length, file_lo + file_bytes.shape[0])
        if lo < hi:
            out += file_bytes[lo - file_lo : hi - file_lo].tobytes()
    if len(out) != length:
        raise RangeReadError(
            f"window plan produced {len(out)} of {length} bytes "
            f"for range [{at}, {at + length})"
        )
    return bytes(out)


def _fast_interleaved(file_name, meta, at, length) -> bytes | None:
    k = meta.native_num
    windows = _slice_windows(meta, at, length)
    cache: dict[tuple, np.ndarray] = {}
    for b0, b1 in windows:
        rows = np.zeros((k, b1 - b0), dtype=np.uint8)
        for r in range(k):
            got = _pread_window(chunk_file_name(file_name, r), b0, b1)
            if got is None:
                return None
            rows[r] = np.frombuffer(got, dtype=np.uint8)
        cache[(b0, b1)] = rows
    return _assemble_interleaved(
        meta, windows, lambda b0, b1: cache[(b0, b1)], at, length
    )


def _fast_row(file_name, meta, at, length) -> bytes | None:
    chunk = meta.chunk
    out = bytearray()
    pos = at
    end = at + length
    while pos < end:
        r = pos // chunk
        lo = pos % chunk
        hi = min(chunk, lo + (end - pos))
        got = _pread_window(chunk_file_name(file_name, r), lo, hi)
        if got is None:
            return None
        out += got
        pos += hi - lo
    return bytes(out)


def _degraded(file_name, meta, at, length, *, strategy, segment_bytes, device):
    """Windowed reconstruction from any k healthy chunks: one survivor
    submatrix inversion, one recovery GEMM per touched window on
    ``device`` (K1 on CUDA), its result copied back to the host."""
    from .. import api
    from ..codec import RSCodec

    scan = api._scan_chunks(file_name, segment_bytes)
    try:
        chosen, inv = api._select_decodable_subset(scan)
    except ValueError as e:
        raise RangeReadError(
            f"range [{at}, {at + length}) unreadable: {e}"
        ) from e
    k, p, w, sym = meta.native_num, meta.parity_num, meta.w, meta.sym
    codec = RSCodec(k, p, w=w, strategy=strategy, device=device)
    chunk = meta.chunk

    # On the row layout the window list is already the per-row union
    # (layout.py), so one recovery GEMM per window rebuilds every
    # touched row's bytes there.
    windows = _slice_windows(meta, at, length)

    recovered: dict[tuple, np.ndarray] = {}
    for b0, b1 in windows:
        stack = np.zeros((k, b1 - b0), dtype=np.uint8)
        for j, idx in enumerate(chosen):
            got = _pread_window(chunk_file_name(file_name, idx), b0, b1)
            if got is None:
                raise RangeReadError(
                    f"survivor chunk {idx} shrank mid-read; re-scan "
                    "and repair the archive"
                )
            stack[j] = np.frombuffer(got, dtype=np.uint8)
        op_stack = stack.view(np.uint16) if sym > 1 else stack
        # An explicit device-to-host copy; at w=16 the little-endian
        # uint16 symbols view back to the chunk files' byte order.
        natives = to_numpy(codec.decode(inv, op_stack))
        if natives.dtype != np.uint8:
            natives = np.ascontiguousarray(natives).view(np.uint8)
        recovered[(b0, b1)] = natives

    if meta.layout == "interleaved":
        return _assemble_interleaved(
            meta, windows, lambda b0, b1: recovered[(b0, b1)], at, length
        )
    out = bytearray()
    pos = at
    end = at + length
    while pos < end:
        r = pos // chunk
        lo = pos % chunk
        hi = min(chunk, lo + (end - pos))
        for b0, b1 in windows:
            if b0 <= lo and hi <= b1:
                out += recovered[(b0, b1)][r, lo - b0 : hi - b0].tobytes()
                break
        else:
            raise RangeReadError(
                f"row {r} bytes [{lo}, {hi}) not covered by the window "
                f"plan {windows}"
            )
        pos += hi - lo
    return bytes(out)


def read_range(
    file_name: str,
    at: int,
    length: int,
    *,
    crc: int | None = None,
    strategy: str = "auto",
    segment_bytes: int = 64 * 1024 * 1024,
    info: dict | None = None,
    device=None,
) -> bytes:
    """Bytes [at, at+length) of the archived file, reading (and — when a
    native chunk is damaged — decoding) only the touched column windows.

    ``crc`` is the expected CRC32 of exactly these bytes (the object
    index stores one per object): a fast-path mismatch falls through to
    the degraded reconstruction, and a degraded mismatch raises
    :class:`RangeReadError` — a range read is never silently wrong.

    ``info`` (optional out-param) gains ``path``: which lane served the
    bytes (``fast``/``degraded``).

    ``device``: where the degraded path's recovery GEMM runs; None means
    CUDA and raises with no GPU present (the fast path needs no device).
    """
    meta = read_archive_meta(metadata_file_name(file_name))
    total = meta.total_size
    if length < 0 or at < 0 or at + length > total:
        raise RangeReadError(
            f"range [{at}, {at + length}) outside the archive's "
            f"{total} bytes"
        )
    if length == 0:
        if info is not None:
            info["path"] = "fast"
        return b""

    fast = (_fast_interleaved if meta.layout == "interleaved"
            else _fast_row)(file_name, meta, at, length)
    if fast is not None and (crc is None
                             or zlib.crc32(fast) == crc & 0xFFFFFFFF):
        _read_counter().labels(path="fast").inc()
        if info is not None:
            info["path"] = "fast"
        return fast

    got = _degraded(file_name, meta, at, length,
                    strategy=strategy, segment_bytes=segment_bytes,
                    device=device)
    if crc is not None and zlib.crc32(got) != crc & 0xFFFFFFFF:
        _read_counter().labels(path="failed").inc()
        raise RangeReadError(
            f"range [{at}, {at + length}) fails its CRC even after "
            "windowed reconstruction from k healthy chunks — the "
            "object is damaged beyond this archive's parity"
        )
    _read_counter().labels(path="degraded").inc()
    if info is not None:
        info["path"] = "degraded"
    return got
