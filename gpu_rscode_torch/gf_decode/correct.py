"""Corrected decode — locate state per archive + in-place segment patch.

:class:`LocateContext` packages everything the file layer needs to run
error-locating decode over one archive: the (erasure-reduced) parity
check restricted to the surviving rows — the operand of the
syndrome GEMM (:meth:`..codec.RSCodec.syndrome`) — the error budget
``t``, the BM fast-path points when the generator is the reference's
Vandermonde, and the row maps between "position in the gathered survivor
stack" and chunk index.

:func:`correct_segment` applies a verified correction set to the host
segment IN PLACE (symbol-wise XOR of the located magnitudes) before the
caller hands the patched rows to the normal inverse-GEMM reconstruction.
"""

from __future__ import annotations

import numpy as np

from ..ops.gf import get_field
from .bw import locate_segment
from .syndrome import (
    erasure_reduced_check,
    parity_check_matrix,
    vandermonde_points,
)


class LocateContext:
    """Per-archive error-locating state.

    ``survivors`` are the chunk indices whose files are present and
    full-size, in the exact order the file layer stacks their rows into
    gathered segments; the complement (missing/truncated chunks) are
    erasures, projected out of the check by :func:`erasure_reduced_check`.

    Attributes:

    ``check``
        (r, n_surv) reduced parity check restricted to survivor rows —
        what the syndrome GEMM runs against gathered segments
        (r = p - nu).  ``None``-like empty (r == 0) means no headroom:
        erasures consumed the whole check and nothing can be verified.
    ``t``
        Per-column error budget floor(r / 2) — the classical
        2·errors + erasures <= n - k trade.
    ``points``
        BM fast-path evaluation points (Vandermonde generator, no
        erasures) or None.
    """

    def __init__(self, total_mat, k: int, p: int, w: int, survivors):
        self.gf = get_field(w)
        self.k, self.p, self.w = int(k), int(p), int(w)
        self.n = self.k + self.p
        self.survivors = [int(s) for s in survivors]
        if sorted(set(self.survivors)) != sorted(self.survivors):
            raise ValueError(f"duplicate survivor rows: {self.survivors}")
        self.erasures = sorted(
            set(range(self.n)) - set(self.survivors)
        )
        H = parity_check_matrix(total_mat, self.k, self.gf)
        reduced = erasure_reduced_check(H, self.erasures, self.gf)
        if reduced is None:
            raise ValueError(
                f"{len(self.erasures)} chunks missing exceeds parity "
                f"p={self.p}: archive is past erasure recovery, locate "
                "cannot help"
            )
        self.check = np.ascontiguousarray(
            reduced[:, self.survivors]
        ).astype(self.gf.dtype)
        self.r = self.check.shape[0]
        self.t = self.r // 2
        # BM fast path only on the full (unreduced) check, where native
        # columns keep their power structure; identical verdicts either
        # way — the general tiers cover everything.
        self.points = (
            vandermonde_points(total_mat, self.k, self.gf)
            if not self.erasures else None
        )

    def locate(self, S_np) -> dict[int, list[tuple[int, int]]]:
        """Map a segment's host syndromes to verified corrections keyed
        by column, each ``(survivor CHUNK index, magnitude)`` — raises
        :class:`.bw.UnlocatableError` past the t bound."""
        raw = locate_segment(
            S_np, self.check.astype(np.int64), self.gf, points=self.points
        )
        return {
            col: [(self.survivors[pos], mag) for pos, mag in fixes]
            for col, fixes in raw.items()
        }


def correct_segment(seg, corrections, row_of_chunk) -> int:
    """XOR the located magnitudes into the host segment, in place.

    ``seg`` is the gathered (n_surv, cols) SYMBOL view (uint8 for w=8,
    uint16 for w=16) whose rows follow ``LocateContext.survivors``;
    ``row_of_chunk`` maps chunk index -> row in ``seg``.  Returns the
    number of symbol errors patched.
    """
    patched = 0
    for col, fixes in corrections.items():
        for chunk_idx, mag in fixes:
            seg[row_of_chunk[chunk_idx], col] ^= seg.dtype.type(mag)
            patched += 1
    return patched
