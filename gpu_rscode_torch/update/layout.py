"""Chunk-layout geometry: file byte ranges ↔ (row, chunk offset).

Two layouts (the ``# layout`` metadata line):

* ``row`` — the reference's contiguous striping: chunk i holds file
  bytes [i*chunk, (i+1)*chunk).  Updates map an edit to per-row column
  ranges; appends are bounded by the tail-padding slack (growing the
  chunk size would re-stripe every byte).
* ``interleaved`` — file symbol s lives in row ``s % k``, column
  ``s // k``.  A contiguous edit of L bytes touches only
  ~``ceil(L/(k*sym))`` columns, and an append touches only the tail
  column block of every chunk — the append-mode layout.  The scan /
  repair / syndrome planes are layout-agnostic (column-wise linear
  algebra over whole chunk files); only the file↔chunk byte mapping
  here differs.

Pure NumPy reshapes/transposes; no I/O.
"""

from __future__ import annotations

import numpy as np


def interleave(file_bytes: np.ndarray, k: int, sym: int = 1) -> np.ndarray:
    """(k*cols*sym,) contiguous file bytes -> (k, cols*sym) chunk rows
    under the interleaved layout (symbol s -> row s % k, col s // k)."""
    n = file_bytes.shape[0]
    cols = n // (k * sym)
    assert n == cols * k * sym, (n, k, sym)
    return np.ascontiguousarray(
        file_bytes.reshape(cols, k, sym).transpose(1, 0, 2)
    ).reshape(k, cols * sym)


def deinterleave(rows: np.ndarray, sym: int = 1) -> np.ndarray:
    """(k, cols*sym) chunk rows -> (k*cols*sym,) contiguous file bytes —
    the inverse of :func:`interleave`."""
    k, width = rows.shape
    cols = width // sym
    assert width == cols * sym, (width, sym)
    return np.ascontiguousarray(
        rows.reshape(k, cols, sym).transpose(1, 0, 2)
    ).reshape(-1)


def _align_down(x: int, a: int) -> int:
    return (x // a) * a


def _align_up(x: int, a: int) -> int:
    return -(-x // a) * a


def touched_windows(
    layout: str, at: int, length: int, k: int, sym: int, chunk: int
) -> list[tuple[int, int]]:
    """Chunk-byte windows [lo, hi) (sym-aligned) an edit of file range
    [at, at+length) touches — the column footprint whose Δ must move.

    ``interleaved``: one window around the touched column range.  ``row``:
    the per-row union — exact for single-row and adjacent-disjoint edits,
    widening to the full chunk when three or more rows are crossed (every
    column is then touched by some row anyway)."""
    if length <= 0:
        return []
    if layout == "interleaved":
        lo = (at // (k * sym)) * sym
        hi = (-(-(at + length) // (k * sym))) * sym
        return [(lo, min(hi, chunk))]
    end = at + length - 1
    r0, r1 = at // chunk, end // chunk
    o0 = _align_down(at % chunk, sym)
    o1 = min(_align_up((end % chunk) + 1, sym), chunk)
    if r0 == r1:
        return [(o0, o1)]
    if r1 == r0 + 1 and o1 <= o0:
        # Two adjacent rows with disjoint column footprints: patch the
        # two real windows, not the dead columns between them.
        return [(0, o1), (o0, chunk)]
    return [(0, chunk)]


def touched_rows(
    layout: str, at: int, length: int, k: int, chunk: int
) -> list[int]:
    """Native chunk rows whose bytes an edit of [at, at+length) changes."""
    if length <= 0:
        return []
    if layout == "interleaved":
        return list(range(k))
    r0 = at // chunk
    r1 = (at + length - 1) // chunk
    return list(range(r0, min(r1, k - 1) + 1))


def row_file_range(
    layout: str, row: int, lo: int, hi: int, k: int, sym: int, chunk: int
) -> tuple[int, int] | None:
    """File byte range backing row ``row``'s chunk bytes [lo, hi) — or
    None when the mapping is not row-contiguous (interleaved)."""
    if layout == "interleaved":
        return None
    return row * chunk + lo, row * chunk + hi
