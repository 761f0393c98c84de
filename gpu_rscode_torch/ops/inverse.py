"""GF matrix inversion on the host: the port's own copy of ``invert_matrix``
and ``SingularMatrixError`` from the JAX package's ``ops/inverse.py``.

Gauss-Jordan with ROW pivoting (correct as-is for the inverse accumulator;
a zero diagonal pivot just swaps rows).  k is tiny, so the host inverts the
k x k survivor submatrix in microseconds, as the reference decoder does.
"""

from __future__ import annotations

import numpy as np

from .gf import GaloisField, get_field


class SingularMatrixError(ValueError):
    """The decode submatrix is not invertible."""


def invert_matrix(M: np.ndarray, gf: GaloisField | None = None) -> np.ndarray:
    """Inverse of a square GF matrix (host NumPy)."""
    gf = gf or get_field(8)
    M = np.array(M, dtype=np.int64)
    if M.ndim != 2 or M.shape[0] != M.shape[1]:
        raise ValueError(f"expected square matrix, got {M.shape}")
    k = M.shape[0]
    R = np.eye(k, dtype=np.int64)
    for i in range(k):
        nz = np.nonzero(M[i:, i])[0]
        if nz.size == 0:
            raise SingularMatrixError(f"matrix not invertible (column {i} has no pivot)")
        r = i + int(nz[0])
        if r != i:
            M[[i, r]] = M[[r, i]]
            R[[i, r]] = R[[r, i]]
        inv_p = int(gf.inv(M[i, i]))
        M[i] = gf.mul(M[i], inv_p)
        R[i] = gf.mul(R[i], inv_p)
        mask = M[:, i] != 0
        mask[i] = False
        if mask.any():
            factors = M[mask, i][:, None]
            M[mask] ^= gf.mul(factors, M[i][None, :]).astype(np.int64)
            R[mask] ^= gf.mul(factors, R[i][None, :]).astype(np.int64)
    return R.astype(gf.dtype)
