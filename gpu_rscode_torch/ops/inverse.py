"""GF matrix inversion: the port's own copy of the JAX package's
``ops/inverse.py``.

* :func:`invert_matrix` — host Gauss-Jordan with ROW pivoting (correct
  as-is for the inverse accumulator; a zero diagonal pivot just swaps
  rows).  k is tiny, so the host inverts the k x k survivor submatrix in
  microseconds, as the reference decoder does.
* :func:`invert_matrix_torch`, :func:`invert_matrix_torch_nopivot` and
  :func:`invert_matrix_torch_batch` — the same elimination as plain
  PyTorch ops on an explicit device, one pivot step at a time over the
  whole batch: the pivot row is found with ``argmax`` and gathered with
  ``index_select``, so no step waits for the host.  They return
  ``(inverse int32 (..., k, k), ok bool)`` where ``ok`` is False for a
  singular input (or, without pivoting, a zero diagonal pivot) and the
  inverse is then garbage.  ``repair_fleet`` inverts every survivor
  submatrix of a (k, w) group in one batched call and verifies each
  inverse on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .gf import GaloisField, get_field
from .gf_torch import tables


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


def _invert_batch(Ms, w: int, pivot: bool, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Jordan over the leading batch axis of (b, k, k) ``Ms`` on
    ``device``: the counterpart of the JAX package's vmapped
    ``_invert_jax`` / ``_invert_jax_nopivot``, step for step, so singular
    inputs give the same garbage and the same ``ok``."""
    gf = get_field(w)
    log, exp = tables(w, device)
    M = torch.as_tensor(np.asarray(Ms, dtype=np.int64), device=device)
    if M.dim() != 3 or M.shape[1] != M.shape[2]:
        raise ValueError(f"expected a (b, k, k) batch, got {tuple(M.shape)}")
    b, k, _ = M.shape
    eye = torch.eye(k, dtype=torch.int64, device=device).expand(b, k, k)
    A = torch.cat([M, eye], dim=2)  # (b, k, 2k)
    rows = torch.arange(k, device=device)
    batch = torch.arange(b, device=device)
    ok = torch.ones(b, dtype=torch.bool, device=device)
    mod = 2 * gf.sentinel + 1

    def gmul(x, y):
        return exp[log[x] + log[y]]

    for i in range(k):
        if pivot:
            cand = (A[:, :, i] != 0) & (rows >= i)
            ok &= cand.any(dim=1)
            r = cand.to(torch.int8).argmax(dim=1)  # first candidate row (0 when none)
            perm = rows.expand(b, k).clone()
            perm[:, i] = r
            perm[batch, r] = i
            A = torch.gather(A, 1, perm[:, :, None].expand(b, k, 2 * k))
        pivot_v = A[:, i, i]
        if not pivot:
            ok &= pivot_v != 0
        inv_p = exp[(gf.order - log[pivot_v]) % mod]  # zero maps to 0, as gf_inv
        row_i = gmul(A[:, i, :], inv_p[:, None])
        A[:, i, :] = row_i
        elim = gmul(A[:, :, i][:, :, None], row_i[:, None, :])
        elim[:, i, :] = 0
        A = A ^ elim
    return A[:, :, k:].to(torch.int32), ok


def invert_matrix_torch(M, w: int = 8, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Jordan inverse with row pivoting on ``device``: ``(inverse
    int32 (k, k), ok bool)``; ``ok`` is False for singular input."""
    inv, ok = _invert_batch(np.asarray(M)[None], w, True, device)
    return inv[0], ok[0]


def invert_matrix_torch_nopivot(M, w: int = 8, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Gauss-Jordan inverse WITHOUT row pivoting on ``device``; ``ok`` is
    also False when a diagonal pivot vanished (the caller retries with
    pivoting or the host inverter, and verifies the inverse either way)."""
    inv, ok = _invert_batch(np.asarray(M)[None], w, False, device)
    return inv[0], ok[0]


def invert_matrix_torch_batch(Ms, w: int = 8, *, pivot: bool = True, device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched inverse on ``device``: (b, k, k) -> ((b, k, k) int32, (b,)
    ok).  ``pivot=False`` runs the elimination without the pivot search;
    callers verify each inverse and re-solve the ones that fail."""
    return _invert_batch(Ms, w, pivot, device)


def mds_nopivot_order(rows, k: int) -> list:
    """Reorder a k-row survivor subset so pivot-free elimination succeeds
    for the systematic layout: surviving native r (the identity row e_r)
    goes to position r, and the parity rows fill the positions of the
    missing natives in order.  Every identity pivot is then 1; pivoting is
    only ever needed inside the small parity Schur complement, where the
    ``ok`` flag and the caller's verification catch a zero leading minor.
    The order of a survivor subset is free: the inverse is paired with
    chunks stacked in the same order."""
    rows = list(rows)
    out: list = [None] * len(rows)
    parities = []
    for r in rows:
        if r < k:
            out[r] = r
        else:
            parities.append(r)
    free = iter(i for i, v in enumerate(out) if v is None)
    for r in parities:
        out[next(free)] = r
    return out
