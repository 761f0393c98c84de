"""GF(2^w) core of the PyTorch port against the JAX package: tables,
product tables, elementwise ops, bit operators and coding matrices.
Tolerance everywhere: bit-exact (integer GF arithmetic)."""

import numpy as np
import pytest
import torch

from gpu_rscode_torch.models import vandermonde as t_vm
from gpu_rscode_torch.ops import gemm as t_gemm
from gpu_rscode_torch.ops import gf as t_gf
from gpu_rscode_torch.ops import gf_torch
from gpu_rscode_tpu.models import vandermonde as j_vm
from gpu_rscode_tpu.ops import gemm as j_gemm
from gpu_rscode_tpu.ops import gf as j_gf
from gpu_rscode_tpu.ops import gf_jax


@pytest.mark.parametrize("w", [4, 8, 16])
def test_field_tables_match_reference(w):
    mine, ref = t_gf.get_field(w), j_gf.get_field(w)
    np.testing.assert_array_equal(mine.log, ref.log)
    np.testing.assert_array_equal(mine.exp, ref.exp)
    assert mine.exp.dtype == ref.exp.dtype and mine.sentinel == ref.sentinel
    log, exp = gf_torch.tables(w)
    jlog, jexp = gf_jax.tables(w)
    np.testing.assert_array_equal(log.numpy(), np.asarray(jlog))
    np.testing.assert_array_equal(exp.numpy(), np.asarray(jexp))


@pytest.mark.parametrize("w", [4, 8, 16])
def test_tables_against_carryless_oracle(w):
    gf = t_gf.get_field(w)
    rng = np.random.default_rng(w)
    for a, b in rng.integers(0, 1 << w, size=(200, 2)):
        assert int(gf.mul(a, b)) == t_gf._carryless_mul_mod(int(a), int(b), w, gf.poly)


def test_mul_table_w8_full():
    got = gf_torch.mul_table(8).numpy()
    np.testing.assert_array_equal(got, np.asarray(gf_jax.mul_table(8)))
    np.testing.assert_array_equal(got, j_gf.get_field(8).mul_table)


@pytest.mark.parametrize("w", [8, 16])
def test_gf_mul_and_inv_on_samples(w):
    rng = np.random.default_rng(100 + w)
    a = rng.integers(0, 1 << w, size=4096)
    b = rng.integers(0, 1 << w, size=4096)
    a[:3] = 0  # zero operands ride the sentinel
    got = gf_torch.gf_mul(torch.as_tensor(a), torch.as_tensor(b), w).numpy()
    np.testing.assert_array_equal(got, np.asarray(gf_jax.gf_mul(a, b, w)))
    inv = gf_torch.gf_inv(torch.as_tensor(a), w).numpy()
    np.testing.assert_array_equal(inv, np.asarray(gf_jax.gf_inv(a, w)))
    nz = a != 0
    np.testing.assert_array_equal(t_gf.get_field(w).mul(a[nz], inv[nz]), 1)


def test_w16_mul_table_is_not_materialised():
    assert t_gf.get_field(16).mul_table is None
    with pytest.raises(ValueError, match="not materialised"):
        gf_torch.mul_table(16)


@pytest.mark.parametrize("w", [8, 16])
def test_bit_operators_match_reference(w):
    rng = np.random.default_rng(7 * w)
    A = rng.integers(0, 1 << w, size=(3, 5))
    np.testing.assert_array_equal(t_gf.get_field(w).expand_bitmatrix(A), j_gf.get_field(w).expand_bitmatrix(A))
    np.testing.assert_array_equal(
        t_gemm.expand_bitmatrix(A, w).numpy(), np.asarray(j_gemm.expand_bitmatrix_jnp(A, w))
    )
    dt = np.uint8 if w == 8 else np.uint16
    B = rng.integers(0, 1 << w, size=(5, 300)).astype(dt)
    planes = t_gemm.to_bitplanes(t_gemm.to_tensor(B), w)
    np.testing.assert_array_equal(planes.numpy(), np.asarray(j_gemm.to_bitplanes(B, w)))
    acc = rng.integers(0, 1000, size=(3 * w, 300)).astype(np.int32)
    got = t_gemm.to_numpy(t_gemm.from_bitplanes(torch.as_tensor(acc), w))
    want = np.asarray(j_gemm.from_bitplanes(acc, w, dtype=dt))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["vandermonde", "cauchy"])
@pytest.mark.parametrize("w,p,k", [(8, 4, 10), (8, 2, 250), (16, 4, 10), (16, 30, 100)])
def test_generator_matrices_match_reference(kind, w, p, k):
    mine = t_vm.generator_matrix(kind, p, k, t_gf.get_field(w))
    ref = j_vm.generator_matrix(kind, p, k, j_gf.get_field(w))
    assert mine.dtype == ref.dtype
    np.testing.assert_array_equal(mine, ref)
    np.testing.assert_array_equal(
        t_vm.total_matrix(p, k, t_gf.get_field(w)), j_vm.total_matrix(p, k, j_gf.get_field(w))
    )


def test_unknown_generator_and_width_raise():
    with pytest.raises(ValueError, match="unknown generator"):
        t_vm.generator_matrix("rainbow", 2, 4)
    with pytest.raises(ValueError, match="unsupported field width"):
        t_gf.GaloisField(12)
