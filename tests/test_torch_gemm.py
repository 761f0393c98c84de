"""GF-GEMM of the PyTorch port against the JAX package.

The port's CUDA wrapper (``gf_matmul_cuda``) on CPU tensors takes its plain
version; it, ``gf_matmul_bitplane`` and ``gf_matmul_table`` are held
bit-exact against the JAX ``gf_matmul`` strategies and against the Pallas
kernel ``gf_matmul_pallas`` running interpreted on the CPU.  The CUDA
kernels run only on the card (chip_smoke.py); here the pre-parity popcount
kernel's operator layout is checked by emulating its word arithmetic in
NumPy (the folded bit-sliced kernel's model is test_torch_k1_bitslice.py)."""

import numpy as np
import pytest
import torch

from gpu_rscode_torch.ops import cuda_gemm
from gpu_rscode_torch.ops import gemm as t_gemm
from gpu_rscode_tpu.ops.gemm import from_bitplanes as j_from_bitplanes
from gpu_rscode_tpu.ops.gemm import gf_matmul as j_gf_matmul
from gpu_rscode_tpu.ops.gf import get_field
from gpu_rscode_tpu.ops.pallas_gemm import gf_matmul_pallas

# The Pallas test grid, its ragged widths, and p = k = 10 decode shapes.
SHAPES = [(2, 4, 256), (4, 10, 5000), (1, 1, 128), (8, 32, 1024), (3, 5, 100)]
SHAPES += [(2, 4, m) for m in (64, 2048, 2049, 4097)]
SHAPES += [(10, 10, 640), (10, 10, 3001)]


def _operands(p, k, m, w, seed):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if w == 8 else np.uint16
    A = rng.integers(0, 1 << w, size=(p, k)).astype(dt)
    B = rng.integers(0, 1 << w, size=(k, m)).astype(dt)
    return A, B


@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("p,k,m", SHAPES)
def test_plain_strategies_match_jax(p, k, m, w):
    A, B = _operands(p, k, m, w, p * 1000 + k * 10 + m + w)
    want = np.asarray(j_gf_matmul(A, B, w=w, strategy="bitplane"))
    Bt = t_gemm.to_tensor(B)
    for got in (
        cuda_gemm.gf_matmul_cuda(A, Bt, w),
        t_gemm.gf_matmul_bitplane(A, Bt, w),
        t_gemm.gf_matmul_table(A, Bt, w),
    ):
        got = t_gemm.to_numpy(got)
        assert got.dtype == want.dtype and got.shape == (p, m)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p,k,m", [(2, 4, 256), (4, 10, 777), (10, 10, 640), (3, 5, 100)])
@pytest.mark.parametrize("w", [8, 16])
def test_table_strategy_matches_jax_table(p, k, m, w):
    A, B = _operands(p, k, m, w, 55 + p + k + m + w)
    want = np.asarray(j_gf_matmul(A, B, w=w, strategy="table"))
    np.testing.assert_array_equal(t_gemm.to_numpy(t_gemm.gf_matmul(A, B, w, "table")), want)


@pytest.mark.parametrize(
    "p,k,m,w",
    [(p, k, m, 8) for p, k, m in SHAPES] + [(3, 5, 600, 16), (10, 10, 640, 16), (2, 4, 2049, 16)],
)
def test_cuda_wrapper_matches_pallas_interpreted(p, k, m, w):
    A, B = _operands(p, k, m, w, 7 + p + k + m + w)
    want = np.asarray(gf_matmul_pallas(A, B, w=w))
    got = t_gemm.to_numpy(cuda_gemm.gf_matmul_cuda(A, t_gemm.to_tensor(B), w))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, get_field(w).matmul(A, B))


@pytest.mark.parametrize("w,p,k,m", [(8, 4, 10, 640), (8, 10, 10, 300), (16, 3, 5, 600), (16, 10, 10, 256)])
def test_preparity_accumulators_match_pallas_shift(w, p, k, m):
    """fold_parity=False returns the masked-shift bit-plane accumulators
    exactly; folding them mod 2 gives the default mode's symbols."""
    A, B = _operands(p, k, m, w, 31 + p + k + m + w)
    acc = cuda_gemm.gf_matmul_cuda(A, t_gemm.to_tensor(B), w, fold_parity=False)
    assert acc.dtype == torch.int32 and tuple(acc.shape) == (p * w, m)
    ref = np.asarray(gf_matmul_pallas(A, B, w=w, fold_parity=False, expand="shift"))
    np.testing.assert_array_equal(acc.numpy(), ref)
    folded = t_gemm.to_numpy(t_gemm.from_bitplanes(acc, w))
    np.testing.assert_array_equal(folded, np.asarray(j_from_bitplanes(ref, w, dtype=folded.dtype)))
    np.testing.assert_array_equal(folded, t_gemm.to_numpy(cuda_gemm.gf_matmul_cuda(A, t_gemm.to_tensor(B), w)))


def _emulate_kernel(A, B, w, fold_parity=True):
    """NumPy model of gf_gemm.cu's popcount kernel: packed operator words
    AND the column's packed symbols, popcount per word, the sums per bit
    (or their parity, the folded symbols)."""
    k, m = B.shape
    words = -(-k * w // 32)
    op = cuda_gemm.pack_operator(A, w, words)
    assert op.dtype == np.uint32 and op.shape == (A.shape[0] * w, words)
    spw = 32 // w
    padded = np.zeros((words * spw, m), dtype=np.uint64)
    padded[:k] = B
    col = np.zeros((words, m), dtype=np.uint64)
    for j in range(words):
        for q in range(spw):
            col[j] |= padded[j * spw + q] << np.uint64(q * w)
    and_bits = op.astype(np.uint64)[:, :, None] & col[None, :, :]  # (p*w, words, m)
    as_bytes = and_bits.astype("<u8").view(np.uint8).reshape(*and_bits.shape, 8)
    acc = np.unpackbits(as_bytes, axis=-1).sum(axis=(1, 3)).astype(np.int32)
    if not fold_parity:
        return acc
    bits = (acc & 1).reshape(-1, w, m).astype(np.int64)
    return (bits << np.arange(w)[None, :, None]).sum(axis=1)


@pytest.mark.parametrize("w,p,k,m", [(8, 4, 10, 200), (8, 10, 10, 64), (8, 3, 33, 50), (16, 4, 10, 200), (16, 3, 7, 90)])
def test_kernel_operator_layout_emulated(w, p, k, m):
    """The bit order the CUDA kernel relies on: a column's k symbols,
    concatenated little-endian into 32-bit words, are its packed bit vector
    against the packed operator rows."""
    A, B = _operands(p, k, m, w, 300 + p + k + m + w)
    np.testing.assert_array_equal(_emulate_kernel(A, B, w), get_field(w).matmul(A, B))
    acc = cuda_gemm.gf_matmul_cuda(A, t_gemm.to_tensor(B), w, fold_parity=False)
    np.testing.assert_array_equal(_emulate_kernel(A, B, w, fold_parity=False), acc.numpy())


def test_pack_operator_padding_and_limits():
    A = np.array([[1, 2], [3, 4]])
    op = cuda_gemm.pack_operator(A, 8, 2)
    assert op.shape == (16, 2) and not op[:, 1].any()  # 16 columns fit in word 0
    with pytest.raises(ValueError, match="do not fit"):
        cuda_gemm.pack_operator(np.ones((1, 5), dtype=np.int64), 8, 1)


def test_cuda_wrapper_cpu_contract():
    """A CPU tensor takes the plain version and launches nothing; NumPy
    input and unknown strategies are rejected."""
    A, B = _operands(2, 4, 256, 8, 1)
    before = cuda_gemm.LAUNCHES
    cuda_gemm.gf_matmul_cuda(A, t_gemm.to_tensor(B), 8)
    assert cuda_gemm.LAUNCHES == before
    with pytest.raises(TypeError, match="tensor"):
        cuda_gemm.gf_matmul_cuda(A, B, 8)
    with pytest.raises(ValueError, match="unknown strategy"):
        t_gemm.gf_matmul(A, B, 8, "pallas")


def test_plain_version_blocks_columns(monkeypatch):
    """Column blocking of the plain version (bounded intermediate) is exact
    across ragged block edges."""
    monkeypatch.setattr(t_gemm, "PLAIN_BLOCK_COLS", 100)
    A, B = _operands(4, 10, 1001, 8, 3)
    got = t_gemm.to_numpy(t_gemm.gf_matmul_bitplane(A, t_gemm.to_tensor(B), 8))
    np.testing.assert_array_equal(got, get_field(8).matmul(A, B))
