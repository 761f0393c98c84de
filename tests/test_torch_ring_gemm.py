"""The port's ring strategy (``gpu_rscode_torch.ops.ring_gemm``) against the
JAX package's on the CPU: the embedding, the three stage programs and
every schedule field for Vandermonde and Cauchy blocks and inverses at w 8
and 16 with CSE on and off; the GEMM against ``gf_matmul_ring`` of the JAX
package and ``GaloisField.matmul`` at ``RS_XOR_OPT`` and ``RS_XOR_CSE`` 0
and 1; a packed operand made for xor feeding ring; the refusal of large
matrices; the clear hook.  Inputs from a NumPy seed; tolerance 0."""

import numpy as np
import pytest
import torch

from gpu_rscode_torch.models.vandermonde import generator_matrix
from gpu_rscode_torch.ops import ring_gemm as tr
from gpu_rscode_torch.ops import xor_gemm as tx
from gpu_rscode_torch.ops.gemm import to_numpy, to_tensor
from gpu_rscode_torch.ops.gf import get_field
from gpu_rscode_torch.ops.inverse import invert_matrix
from gpu_rscode_tpu.ops import ring_gemm as jr


@pytest.fixture(autouse=True)
def _no_store(monkeypatch):
    monkeypatch.delenv("RS_RUNLOG", raising=False)
    monkeypatch.delenv("RS_SCHEDULE_STORE", raising=False)
    for knob in ("RS_XOR_CSE", "RS_XOR_OPT", "RS_XOR_TILE", "RS_XOR_TILE_BUDGET", "RS_XOR_MAX_TERMS"):
        monkeypatch.delenv(knob, raising=False)


def coefficient_matrix(generator: str, k: int, p: int, w: int, inverse: bool) -> np.ndarray:
    gf = get_field(w)
    block = generator_matrix(generator, p, k, gf)
    if not inverse:
        return block
    total = np.concatenate([np.eye(k, dtype=gf.dtype), block])
    return invert_matrix(total[min(p, k):min(p, k) + k], gf)


@pytest.mark.parametrize("w", [8, 16])
def test_embedding_equals_jax(w):
    got, want = tr._ctx(w), jr._ctx(w)
    assert (got.p, got.g) == (want.p, want.g)
    np.testing.assert_array_equal(got.psi, want.psi)
    np.testing.assert_array_equal(got.m, want.m)
    assert tr.ring_params(w) == jr.ring_params(w)
    for a in (1, 2, 3, 29, 200, 255) + ((4097, 65535) if w == 16 else ()):
        np.testing.assert_array_equal(got.lift(a), want.lift(a))


MATRICES = [
    ("vandermonde", 1, 1, 8, False),
    ("vandermonde", 4, 2, 8, True),
    ("cauchy", 7, 3, 8, False),
    ("vandermonde", 10, 4, 8, False),
    ("cauchy", 12, 6, 8, True),
    ("vandermonde", 3, 2, 16, False),
    ("cauchy", 2, 3, 16, True),
]
FIELDS = ("digest", "w", "p", "rows_out", "k", "n_inputs", "s1_pairs", "s1_rows", "s2_pairs", "s2_rows", "s2_planes",
          "s3_pairs", "s3_rows", "terms_naive", "terms_cse", "cse", "xors")


@pytest.mark.parametrize("cse", [False, True])
@pytest.mark.parametrize("generator,k,p,w,inverse", MATRICES)
def test_ring_schedule_fields_equal_jax(generator, k, p, w, inverse, cse):
    A = coefficient_matrix(generator, k, p, w, inverse)
    got, want = tr.build_ring_schedule(A, w, cse=cse), jr.build_ring_schedule(A, w, cse=cse)
    for field in FIELDS:
        assert getattr(got, field) == getattr(want, field), field


@pytest.mark.parametrize("opt", ["0", "1"])
@pytest.mark.parametrize("cse", ["0", "1"])
def test_gemm_equals_jax_and_oracle(monkeypatch, opt, cse):
    monkeypatch.setenv("RS_XOR_OPT", opt)
    monkeypatch.setenv("RS_XOR_CSE", cse)
    gf = get_field(8)
    rng = np.random.default_rng(10 + int(opt) * 2 + int(cse))
    A = rng.integers(0, 256, size=(3, 5))
    B = rng.integers(0, 256, size=(5, 100)).astype(np.uint8)
    got = to_numpy(tr.gf_matmul_ring(A, to_tensor(B), 8))
    np.testing.assert_array_equal(got, np.asarray(jr.gf_matmul_ring(A, B, 8)))
    np.testing.assert_array_equal(got, gf.matmul(A.astype(gf.dtype), B))
    for w, shapes in ((8, ((1, 1, 32), (4, 10, 1000), (6, 12, 33))), (16, ((2, 3, 7), (4, 4, 300)))):
        gfw = get_field(w)
        for p, k, m in shapes:
            A = rng.integers(0, 1 << w, size=(p, k))
            B = rng.integers(0, 1 << w, size=(k, m)).astype(gfw.dtype)
            np.testing.assert_array_equal(to_numpy(tr.gf_matmul_ring(A, to_tensor(B), w)),
                                          gfw.matmul(A.astype(gfw.dtype), B))


def test_gemm_w16_equals_jax():
    rng = np.random.default_rng(16)
    A = rng.integers(0, 1 << 16, size=(2, 2))
    B = rng.integers(0, 1 << 16, size=(2, 40)).astype(np.uint16)
    got = to_numpy(tr.gf_matmul_ring(A, to_tensor(B), 16))
    np.testing.assert_array_equal(got, np.asarray(jr.gf_matmul_ring(A, B, 16)))


def test_all_zero_coefficients_give_zero_planes():
    """No active ring plane: stage 3 has no inputs at all."""
    B = np.random.default_rng(2).integers(0, 256, size=(3, 64)).astype(np.uint8)
    out = tr.gf_matmul_ring(np.zeros((2, 3), dtype=np.uint8), to_tensor(B), 8)
    assert tuple(out.shape) == (2, 64) and not out.any()


@pytest.mark.parametrize("w", [8, 16])
def test_packed_for_xor_feeds_ring(w):
    gf = get_field(w)
    rng = np.random.default_rng(w + 1)
    B = rng.integers(0, 1 << w, size=(5, 70)).astype(gf.dtype)
    packed = tx.pack_operand(tx.pad_operand(to_tensor(B), 96), w, cols_true=70)
    A = rng.integers(0, 1 << w, size=(2, 3))
    rows = [4, 0, 2]
    got = to_numpy(tr.gf_matmul_ring(A, packed.select(rows), w))
    np.testing.assert_array_equal(got, gf.matmul(A.astype(gf.dtype), B[rows]))
    np.testing.assert_array_equal(got, to_numpy(tx.gf_matmul_xor(A, packed.select(rows), w)))


def test_max_terms_refusal_like_jax(monkeypatch):
    monkeypatch.setenv("RS_XOR_MAX_TERMS", "50")
    A = np.array([[7, 9, 11]], dtype=np.uint8)
    with pytest.raises(ValueError) as got:
        tr.build_ring_schedule(A, 8)
    with pytest.raises(ValueError) as want:
        jr.build_ring_schedule(A, 8)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="w in"):
        tr.build_ring_schedule(A, 4)


def test_xor_clear_drops_ring_caches():
    A = np.array([[1, 2]], dtype=np.uint8)
    tr.gf_matmul_ring(A, torch.zeros((2, 32), dtype=torch.uint8), 8)
    (desc,) = [d for d in tr.ring_pipeline_stats() if d["digest"] == tx.matrix_digest(A, 8)]
    assert set(desc) == {"digest", "w", "p", "k", "rows_out", "cols", "cse", "ring_planes", "terms_naive", "terms_cse",
                         "xors", "calls", "compile_seconds", "opt"}
    assert tr.ring_schedule_stats()
    tx.clear_pipeline_cache()
    assert tr.ring_pipeline_stats() == [] and tr.ring_schedule_stats() == []
