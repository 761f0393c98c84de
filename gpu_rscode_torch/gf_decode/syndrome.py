"""Parity-check construction + erasure reduction for error-locating decode.

The code is the column space of the total matrix ``T = [I_k; G]``
(.METADATA's exact layout): a column of the stacked chunk array ``Y``
(n rows = k natives + p parity) is a valid codeword iff ``H @ Y == 0``
with

    H = [G | I_p]        (p, n)   since  H @ T = G ⊕ G = 0 over GF(2^w).

``S = H @ Y`` is the *syndrome*: zero columns are consistent, nonzero
columns carry exactly the error pattern's image ``H @ E`` — the input to
the key-equation solver (:mod:`.bw`).  The GEMM itself runs through
:meth:`..codec.RSCodec.syndrome` (K1 on a CUDA device).

Erasures (missing / known-bad chunks) contribute unknown terms to ``S``.
:func:`erasure_reduced_check` projects them out: a row transform ``R``
with ``R @ H[:, E] == 0`` yields the reduced check ``H' = R @ H`` whose
syndromes see only the *unknown* errors among surviving rows, with error
budget ``t' = floor((p - nu) / 2)`` — the classical errors-and-erasures
trade (2·errors + erasures <= n - k).
"""

from __future__ import annotations

import numpy as np

from ..ops.gf import GaloisField


def is_systematic(total_mat: np.ndarray, k: int) -> bool:
    """Whether the metadata matrix has the identity top block the locate
    path's parity-check construction assumes.  Foreign encoders may write
    any matrix; non-systematic archives stay erasure-only."""
    total_mat = np.asarray(total_mat)
    if total_mat.shape[0] <= k:
        return False
    return bool(
        np.array_equal(total_mat[:k], np.eye(k, dtype=total_mat.dtype))
    )


def parity_check_matrix(total_mat: np.ndarray, k: int,
                        gf: GaloisField) -> np.ndarray:
    """``H = [G | I_p]`` for a systematic total matrix ``[I; G]`` — the
    (p, n) parity check the syndrome GEMM dispatches."""
    total_mat = np.asarray(total_mat)
    if not is_systematic(total_mat, k):
        raise ValueError(
            "error-locating decode needs a systematic total matrix "
            "(identity top block); this archive's metadata is foreign — "
            "erasure-only decode still applies"
        )
    G = total_mat[k:].astype(gf.dtype)
    p = G.shape[0]
    return np.concatenate(
        [G, np.eye(p, dtype=gf.dtype)], axis=1
    )  # (p, k + p)


def vandermonde_points(total_mat: np.ndarray, k: int,
                       gf: GaloisField) -> np.ndarray | None:
    """The native-position evaluation points ``a_i = (i+1) mod 2^w`` IF
    the parity block is the reference's Vandermonde form (``G[j, i] =
    a_i^j``) — the structure the Berlekamp–Massey fast path keys on
    (power-sum syndromes).  Returns None for any other generator (Cauchy,
    foreign): those route through the general solver, same verdicts.
    Points must be distinct (k < 2^w) or the fast path is declined."""
    total_mat = np.asarray(total_mat)
    G = total_mat[k:]
    p = G.shape[0]
    if k >= gf.size:
        return None  # (i+1) mod 2^w wraps: points collide
    pts = (np.arange(k, dtype=np.int64) + 1) % gf.size
    want = gf.pow(
        pts[None, :], np.arange(p, dtype=np.int64)[:, None]
    ).astype(G.dtype)
    if not np.array_equal(G, want):
        return None
    return pts


def erasure_reduced_check(
    H: np.ndarray, erasure_cols: list[int], gf: GaloisField
) -> np.ndarray | None:
    """Row transform of ``H`` annihilating the erased columns.

    Returns ``H' = R @ H`` of shape (p - nu, n) with ``H'[:, e] == 0``
    for every erased position, or None when nu > p (more erasures than
    parity — nothing to check; the archive is already past erasure
    recovery too).  ``R`` is a null-space basis of ``H[:, E]^T``, found
    by GF Gauss elimination; for an MDS check (any p columns independent)
    the rank drop is exactly nu, so ``H'`` keeps p - nu independent rows.
    """
    from .bw import gf_eliminate

    H = np.asarray(H, dtype=np.int64)
    p = H.shape[0]
    E = sorted(set(int(e) for e in erasure_cols))
    if not E:
        return H.astype(gf.dtype)
    if len(E) > p:
        return None
    # Eliminate on [H_E | I_p] (the shared kernel — dependent erasure
    # columns, a non-MDS corner, just don't pivot): rows of the identity
    # half whose H_E half zeroed out form R, the left-null basis of H_E.
    aug = np.concatenate(
        [H[:, E], np.eye(p, dtype=np.int64)], axis=1
    )
    rank = gf_eliminate(aug, len(E), gf)
    R = aug[rank:, len(E):]  # (p - rank, p), R @ H_E == 0
    if R.shape[0] == 0:
        return np.zeros((0, H.shape[1]), dtype=gf.dtype)
    Hp = gf.matmul(R, H).astype(np.int64)
    # Exactness guard: the reduced check must really not see the erasures.
    if np.any(Hp[:, E]):
        raise AssertionError("erasure reduction left residual columns")
    return Hp.astype(gf.dtype)
