"""K2 (the packed two-column GF(2^8) GEMM) of the PyTorch port against the
JAX package.

``gf_matmul_pack2_plain`` and ``gf_matmul_cuda(..., expand="pack2")`` on CPU
tensors are held bit-exact against the JAX ``gf_matmul_pallas(A, B,
expand="pack2")`` running interpreted on the CPU (as tests/test_pallas.py
runs it) and against the GF oracle.  The CUDA kernel runs only on the card
(chip_smoke.py); here the NumPy model of ``csrc/gf_pack2.cu`` in
tests/test_torch_k2_mma.py is checked against the oracle too."""

import numpy as np
import pytest
import torch

from gpu_rscode_torch.ops import cuda_gemm, cuda_pack2
from gpu_rscode_torch.ops.gemm import to_tensor
from gpu_rscode_tpu.ops.gf import get_field
from gpu_rscode_tpu.ops.pallas_gemm import gf_matmul_pallas
from test_torch_k2_mma import model as k2_model


def _operands(p, k, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(p, k), dtype=np.uint8),
            rng.integers(0, 256, size=(k, m), dtype=np.uint8))


def _port_results(A, B):
    Bt = to_tensor(B)
    return [cuda_pack2.gf_matmul_pack2_plain(A, Bt).numpy(),
            cuda_gemm.gf_matmul_cuda(A, Bt, 8, expand="pack2").numpy()]


@pytest.mark.parametrize("m", [511, 512, 4097])
def test_pack2_matches_pallas_interpreted(m):
    A, B = _operands(4, 10, m, 31 + m)
    want = np.asarray(gf_matmul_pallas(A, B, expand="pack2", tile=2048))
    np.testing.assert_array_equal(want, get_field(8).matmul(A, B))
    for got in _port_results(A, B):
        assert got.dtype == np.uint8 and got.shape == (4, m)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [31, 32, 63, 128])
def test_pack2_split_k(k):
    """Depth beyond 31 symbols runs as carry-free slices XORed together."""
    A, B = _operands(4, k, 512, 33 + k)
    want = np.asarray(gf_matmul_pallas(A, B, expand="pack2"))
    np.testing.assert_array_equal(want, get_field(8).matmul(A, B))
    for got in _port_results(A, B):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p,k,m", [(1, 1, 1), (10, 10, 301), (3, 5, 2)])
def test_pack2_small_and_wide_shapes(p, k, m):
    A, B = _operands(p, k, m, 7 * p + k + m)
    for got in _port_results(A, B):
        np.testing.assert_array_equal(got, get_field(8).matmul(A, B))


@pytest.mark.parametrize(
    "kwargs,match",
    [({"w": 16}, "byte-granular"), ({"fold_parity": False}, "pre-parity"), ({"refold": "sum"}, "refold do not apply")],
)
def test_pack2_refusals_match_jax(kwargs, match):
    """The JAX package's three refusals, in its words."""
    A, B = _operands(4, 10, 256, 5)
    if kwargs.get("w") == 16:
        A, B = A.astype(np.uint16), B.astype(np.uint16)
    with pytest.raises(ValueError, match=match):
        gf_matmul_pallas(A, B, expand="pack2", **kwargs)
    with pytest.raises(ValueError, match=match):
        cuda_gemm.gf_matmul_cuda(A, to_tensor(B), expand="pack2", **kwargs)
    with pytest.raises(ValueError, match=match):
        cuda_pack2.gf_matmul_pack2(A, to_tensor(B), **kwargs)


@pytest.mark.parametrize("p,k,m", [(4, 10, 101), (2, 31, 64), (3, 32, 65), (1, 63, 40)])
def test_kernel_model_matches_oracle(p, k, m):
    A, B = _operands(p, k, m, 100 + p + k + m)
    np.testing.assert_array_equal(k2_model(A, B), get_field(8).matmul(A, B))


def test_pack2_cpu_contract():
    """A CPU tensor takes the plain version and launches nothing; NumPy data
    and a non-positive tile are refused."""
    A, B = _operands(2, 4, 64, 1)
    before = cuda_pack2.LAUNCHES
    cuda_pack2.gf_matmul_pack2(A, to_tensor(B), tile=64)
    assert cuda_pack2.LAUNCHES == before
    with pytest.raises(TypeError, match="tensor"):
        cuda_pack2.gf_matmul_pack2(A, B)
    with pytest.raises(ValueError, match="tile"):
        cuda_pack2.gf_matmul_pack2(A, to_tensor(B), tile=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        cuda_pack2.gf_matmul_pack2(A[:, :3], to_tensor(B))
    assert torch.equal(cuda_pack2.gf_matmul_pack2_plain(A, to_tensor(B)[:, :0]), torch.empty((2, 0), dtype=torch.uint8))
