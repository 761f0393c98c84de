"""The port's on-device GF inverters (``ops/inverse.py``) against the JAX
package's: the same inverse and the same ``ok`` flag, bit for bit (garbage
included where ``ok`` is False), on the CPU."""

import numpy as np
import pytest
import torch

from gpu_rscode_torch.models.vandermonde import total_matrix as t_total_matrix
from gpu_rscode_torch.ops import inverse as t_inv
from gpu_rscode_torch.ops.gf import get_field
from gpu_rscode_tpu.ops import inverse as j_inv

CPU = torch.device("cpu")


def _random(rng, shape, w):
    return rng.integers(0, 1 << w, size=shape).astype(np.uint8 if w == 8 else np.uint16)


def _same(t_out, j_out):
    t_m, t_ok = t_out
    j_m, j_ok = j_out
    assert t_m.dtype == torch.int32 and t_m.device == CPU
    np.testing.assert_array_equal(t_m.numpy(), np.asarray(j_m))
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(j_ok))


def _cases(w):
    rng = np.random.default_rng(90 + w)
    zero_pivot = np.array([[0, 1, 2], [1, 2, 3], [4, 5, 6]])
    singular = np.array([[1, 2, 3], [2, 4, 6], [7, 7, 7]])  # row 1 = 2 * row 0
    cases = [zero_pivot, singular, np.zeros((4, 4), dtype=np.int64), np.eye(5, dtype=np.int64)]
    cases += [_random(rng, (k, k), w) for k in (1, 2, 6, 10, 16)]
    return cases


@pytest.mark.parametrize("w", [8, 16])
def test_single_inverse_and_nopivot_match_jax(w):
    for M in _cases(w):
        _same(t_inv.invert_matrix_torch(M, w, device=CPU), j_inv.invert_matrix_jax(M, w))
        _same(t_inv.invert_matrix_torch_nopivot(M, w, device=CPU), j_inv.invert_matrix_jax_nopivot(M, w))


def test_zero_pivot_but_invertible_is_inverted():
    M = np.array([[0, 1, 2], [1, 2, 3], [4, 5, 6]])
    gf = get_field(8)
    inv, ok = t_inv.invert_matrix_torch(M, 8, device=CPU)
    assert bool(ok)
    np.testing.assert_array_equal(gf.matmul(M, inv.numpy()), np.eye(3, dtype=np.uint8))
    np.testing.assert_array_equal(inv.numpy(), t_inv.invert_matrix(M, gf).astype(np.int32))
    _, ok = t_inv.invert_matrix_torch_nopivot(M, 8, device=CPU)
    assert not bool(ok)  # a zero diagonal pivot without the pivot search


@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("pivot", [True, False])
@pytest.mark.parametrize("b", [1, 64])
def test_batch_matches_jax(w, pivot, b):
    rng = np.random.default_rng(7 * b + w)
    k = 6
    Ms = _random(rng, (b, k, k), w)
    Ms[0] = 0  # a singular member
    if b > 1:
        Ms[1, 1] = Ms[1, 0]  # equal rows: singular
        Ms[2] = np.array([[0, 1, 2, 3, 4, 5]] + [list(r) for r in _random(rng, (k - 1, k), w)])  # zero pivot first
    _same(t_inv.invert_matrix_torch_batch(Ms, w, pivot=pivot, device=CPU),
          j_inv.invert_matrix_jax_batch(Ms, w, pivot=pivot))


@pytest.mark.parametrize("w", [8, 16])
def test_mds_nopivot_order_subsets_match_jax(w):
    """Survivor subsets of a (k=6, p=4) total matrix in mds_nopivot_order:
    the same order as JAX's, and the no-pivot batch inverts them like JAX's."""
    k, p = 6, 4
    gf = get_field(w)
    total = t_total_matrix(p, k, gf)
    rng = np.random.default_rng(w)
    subs, orders = [], []
    for _ in range(24):
        healthy = sorted(rng.choice(k + p, size=k, replace=False).tolist())
        order = t_inv.mds_nopivot_order(healthy, k)
        assert order == j_inv.mds_nopivot_order(healthy, k)
        assert sorted(order) == healthy
        orders.append(order)
        subs.append(total[order])
    Ms = np.stack(subs)
    t_out = t_inv.invert_matrix_torch_batch(Ms, w, pivot=False, device=CPU)
    _same(t_out, j_inv.invert_matrix_jax_batch(Ms, w, pivot=False))
    invs, oks = t_out
    for M, inv, ok in zip(Ms, invs.numpy(), oks.numpy()):
        if ok:
            np.testing.assert_array_equal(gf.matmul(M, inv), np.eye(k, dtype=gf.dtype))


def test_batch_rejects_non_square():
    with pytest.raises(ValueError, match="batch"):
        t_inv.invert_matrix_torch_batch(np.zeros((2, 3, 4)), 8, device=CPU)
