"""The port's XOR strategy (``gpu_rscode_torch.ops.xor_gemm``) against the JAX
package's on the CPU: the host half (binary matrix, digest, Paar CSE, the
schedule fields) for Vandermonde and Cauchy blocks and their inverses at
k 1-12, p 1-6, w 8 and 16, with CSE on and off; the packed planes against
the JAX package's pack stage (all-0xFF / all-0xFFFF rows included); the
GEMM against ``gf_matmul_xor`` of the JAX package and ``GaloisField.matmul``
at ``RS_XOR_OPT`` and ``RS_XOR_CSE`` 0 and 1; the packed operand and its
``select``; the ``RS_XOR_MAX_TERMS`` refusal; and the codec's routing.
Inputs are made from a NumPy seed; tolerance 0 (byte identity)."""

import numpy as np
import pytest
import torch

from gpu_rscode_torch.codec import RSCodec
from gpu_rscode_torch.models.vandermonde import generator_matrix
from gpu_rscode_torch.ops import xor_gemm as tx
from gpu_rscode_torch.ops.gemm import to_numpy, to_tensor
from gpu_rscode_torch.ops.gf import get_field
from gpu_rscode_torch.ops.inverse import invert_matrix
from gpu_rscode_tpu.ops import xor_gemm as jx


@pytest.fixture(autouse=True)
def _no_store(monkeypatch):
    """No schedule store: the store has its own test file."""
    monkeypatch.delenv("RS_RUNLOG", raising=False)
    monkeypatch.delenv("RS_SCHEDULE_STORE", raising=False)
    for knob in ("RS_XOR_CSE", "RS_XOR_OPT", "RS_XOR_TILE", "RS_XOR_TILE_BUDGET", "RS_XOR_MAX_TERMS"):
        monkeypatch.delenv(knob, raising=False)


def coefficient_matrix(generator: str, k: int, p: int, w: int, inverse: bool) -> np.ndarray:
    """A (p, k) parity block, or the k x k inverse used when the first
    min(p, k) chunks are lost."""
    gf = get_field(w)
    block = generator_matrix(generator, p, k, gf)
    if not inverse:
        return block
    total = np.concatenate([np.eye(k, dtype=gf.dtype), block])
    return invert_matrix(total[min(p, k):min(p, k) + k], gf)


MATRICES = [
    ("vandermonde", 1, 1, 8, False),
    ("vandermonde", 4, 2, 8, True),
    ("cauchy", 7, 3, 8, True),
    ("vandermonde", 10, 4, 8, False),
    ("vandermonde", 10, 4, 8, True),
    ("cauchy", 12, 6, 8, False),
    ("cauchy", 3, 5, 8, True),
    ("vandermonde", 5, 6, 16, False),
    ("cauchy", 6, 3, 16, True),
    ("vandermonde", 2, 1, 16, True),
]


@pytest.mark.parametrize("cse", [False, True])
@pytest.mark.parametrize("generator,k,p,w,inverse", MATRICES)
def test_schedule_fields_equal_jax(generator, k, p, w, inverse, cse):
    A = coefficient_matrix(generator, k, p, w, inverse)
    np.testing.assert_array_equal(tx.binary_matrix(A, w), jx.binary_matrix(A, w))
    assert tx.matrix_digest(A, w) == jx.matrix_digest(A, w)
    got, want = tx.build_schedule(A, w, cse=cse), jx.build_schedule(A, w, cse=cse)
    for field in ("digest", "w", "rows_out", "k", "n_inputs", "pair_ops", "rows", "terms_naive", "terms_cse",
                  "cse", "xors"):
        assert getattr(got, field) == getattr(want, field), field


def test_paar_cse_equal_jax_on_random_rows():
    rng = np.random.default_rng(11)
    for _ in range(5):
        n = int(rng.integers(4, 40))
        rows = [set(np.flatnonzero(rng.random(n) < 0.4)) for _ in range(int(rng.integers(1, 30)))]
        got = tx.paar_cse([set(r) for r in rows], n)
        want = jx.paar_cse([set(r) for r in rows], n)
        assert got[0] == want[0] and got[1] == want[1]


def _jax_planes(B: np.ndarray, w: int) -> np.ndarray:
    import jax.numpy as jnp

    return np.stack([np.asarray(x) for x in jx._pack_stage(jnp.asarray(B), w)]).view(np.int32)


@pytest.mark.parametrize("w", [8, 16])
def test_pack_equals_jax_and_unpack_inverts(w):
    """All-ones rows set the sign bit of every word: the arithmetic right
    shifts of the int32 words must not leak it."""
    gf = get_field(w)
    rng = np.random.default_rng(w)
    B = rng.integers(0, 1 << w, size=(4, 160)).astype(gf.dtype)
    B[1] = (1 << w) - 1
    B[2, ::3] = (1 << w) - 1
    planes = tx._pack(to_tensor(B), w)
    np.testing.assert_array_equal(planes.numpy(), _jax_planes(B, w))
    np.testing.assert_array_equal(to_numpy(tx._unpack(planes, w, 4)), B)


@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("m", [1, 31, 33, 100, 1000])
def test_ragged_identity_round_trip(w, m):
    """unpack(pack(B)) through the whole GEMM with A = I: ragged widths pad
    to 32 columns and trim back, all-ones rows included."""
    gf = get_field(w)
    B = np.random.default_rng(m).integers(0, 1 << w, size=(3, m)).astype(gf.dtype)
    B[0] = (1 << w) - 1
    got = tx.gf_matmul_xor(np.eye(3, dtype=gf.dtype), to_tensor(B), w)
    assert got.is_contiguous()
    np.testing.assert_array_equal(to_numpy(got), B)


def test_bit_j_packs_into_plane_j():
    B = np.zeros((1, 64), dtype=np.uint8)
    for j in range(8):
        B[0, :] = 1 << j
        planes = tx._pack(to_tensor(B), 8).numpy()
        assert (planes[j] == -1).all() and not np.delete(planes, j, axis=0).any()


@pytest.mark.parametrize("opt", ["0", "1"])
@pytest.mark.parametrize("cse", ["0", "1"])
def test_gemm_equals_jax_and_oracle(monkeypatch, opt, cse):
    monkeypatch.setenv("RS_XOR_OPT", opt)
    monkeypatch.setenv("RS_XOR_CSE", cse)
    gf = get_field(8)
    rng = np.random.default_rng(int(opt) * 2 + int(cse))
    A = rng.integers(0, 256, size=(3, 5))
    B = rng.integers(0, 256, size=(5, 100)).astype(np.uint8)
    got = to_numpy(tx.gf_matmul_xor(A, to_tensor(B), 8))
    np.testing.assert_array_equal(got, np.asarray(jx.gf_matmul_xor(A, B, 8)))
    np.testing.assert_array_equal(got, gf.matmul(A.astype(gf.dtype), B))
    # A wider grid against the oracle alone.
    for w in (8, 16):
        gfw = get_field(w)
        for p, k, m in ((1, 1, 32), (4, 10, 1000), (6, 12, 257), (2, 3, 7)):
            A = rng.integers(0, 1 << w, size=(p, k))
            B = rng.integers(0, 1 << w, size=(k, m)).astype(gfw.dtype)
            np.testing.assert_array_equal(to_numpy(tx.gf_matmul_xor(A, to_tensor(B), w)),
                                          gfw.matmul(A.astype(gfw.dtype), B))


def test_gemm_w16_equals_jax():
    gf = get_field(16)
    rng = np.random.default_rng(16)
    A = rng.integers(0, 1 << 16, size=(2, 3))
    B = rng.integers(0, 1 << 16, size=(3, 70)).astype(np.uint16)
    got = to_numpy(tx.gf_matmul_xor(A, to_tensor(B), 16))
    np.testing.assert_array_equal(got, np.asarray(jx.gf_matmul_xor(A, B, 16)))
    np.testing.assert_array_equal(got, gf.matmul(A.astype(gf.dtype), B))


def test_zero_row_and_empty_width():
    A = np.array([[0, 0], [3, 1]], dtype=np.uint8)
    B = np.random.default_rng(1).integers(0, 256, size=(2, 64)).astype(np.uint8)
    out = to_numpy(tx.gf_matmul_xor(A, to_tensor(B), 8))
    assert not out[0].any()
    np.testing.assert_array_equal(out, get_field(8).matmul(A, B))
    assert tuple(tx.gf_matmul_xor(A, torch.zeros((2, 0), dtype=torch.uint8), 8).shape) == (2, 0)


def test_max_terms_refusal_like_jax(monkeypatch):
    monkeypatch.setenv("RS_XOR_MAX_TERMS", "20")
    A = np.array([[7, 9, 11]], dtype=np.uint8)
    with pytest.raises(ValueError) as got:
        tx.build_schedule(A, 8)
    with pytest.raises(ValueError) as want:
        jx.build_schedule(A, 8)
    assert str(got.value) == str(want.value)
    assert "RS_XOR_MAX_TERMS=20" in str(got.value)


def test_unsupported_width_refused():
    with pytest.raises(ValueError, match="w in"):
        tx.build_schedule(np.ones((1, 1), dtype=np.uint8), 4)
    for strategy in ("xor", "ring"):
        with pytest.raises(ValueError, match="GF\\(2\\^8\\) and GF\\(2\\^16\\) only"):
            RSCodec(2, 1, w=4, strategy=strategy, device="cpu")


@pytest.mark.parametrize("w", [8, 16])
def test_packed_operand_select_feeds_a_decode(w):
    """One pack of the whole survivor stack serves the syndrome-like GEMM
    and, through ``select``, the recovery decode."""
    k, p = 4, 3
    codec = RSCodec(k, p, w=w, strategy="xor", device="cpu")
    gf = codec.gf
    data = np.random.default_rng(5).integers(0, 1 << w, size=(k, 90)).astype(gf.dtype)
    stack = np.concatenate([data, to_numpy(codec.encode(data))])
    packed = codec.pack_operand(stack)
    assert (packed.rows, packed.cols, packed.cols_true) == (k + p, 96, 90)
    chosen = [1, 4, 5, 6]
    inv = codec.decode_matrix(chosen)
    np.testing.assert_array_equal(to_numpy(codec.decode(inv, packed.select(chosen))), data)
    # The whole stack through a parity-check-like GEMM, from the same planes.
    check = np.random.default_rng(6).integers(0, 1 << w, size=(2, k + p))
    np.testing.assert_array_equal(to_numpy(codec.syndrome(check, packed)), gf.matmul(check.astype(gf.dtype), stack))
    with pytest.raises(ValueError, match="out of range"):
        packed.select([k + p])
    with pytest.raises(ValueError, match="does not match pipeline"):
        codec.decode(inv, packed.select([0, 1, 2]))


def test_packed_operand_refused_by_other_strategies(monkeypatch):
    codec = RSCodec(2, 1, strategy="xor", device="cpu")
    packed = codec.pack_operand(np.zeros((2, 32), dtype=np.uint8))
    for strategy in ("bitplane", "table"):
        with pytest.raises(ValueError, match="packed operands require strategy='xor' or 'ring'"):
            RSCodec(2, 1, strategy=strategy, device="cpu").decode(np.eye(2, dtype=np.uint8), packed)
        assert RSCodec(2, 1, strategy=strategy, device="cpu").pack_operand(np.zeros((2, 32), np.uint8)) is None
    monkeypatch.setenv("RS_XOR_PACK_REUSE", "0")
    assert codec.pack_operand(np.zeros((2, 32), dtype=np.uint8)) is None


def test_pack_reuse_counts():
    codec = RSCodec(3, 2, strategy="xor", device="cpu")
    before = dict(tx.PACK_REUSE)
    packed = codec.pack_operand(np.zeros((5, 64), dtype=np.uint8))
    codec.syndrome(np.ones((2, 5), dtype=np.uint8), packed)
    codec.decode(np.eye(3, dtype=np.uint8), packed.select([0, 1, 2]))
    codec.encode(np.zeros((3, 64), dtype=np.uint8))
    assert {k: tx.PACK_REUSE[k] - before[k] for k in before} == {"packed": 2, "reused": 2}


def test_pipeline_cache_stats_and_clear():
    A = np.array([[1, 2], [3, 4]], dtype=np.uint8)
    tx.clear_pipeline_cache()
    tx.gf_matmul_xor(A, torch.zeros((2, 64), dtype=torch.uint8), 8)
    tx.gf_matmul_xor(A, torch.zeros((2, 64), dtype=torch.uint8), 8)
    (desc,) = tx.pipeline_stats()
    assert set(desc) == {"digest", "w", "k", "rows_out", "cols", "cse", "terms_naive", "terms_cse", "xors", "calls",
                         "compile_seconds", "opt"}
    assert desc["calls"] == 2 and desc["cols"] == 64
    (sched,) = tx.schedule_stats()
    assert sched["digest"] == tx.matrix_digest(A, 8)
    assert tx.padded_cols(0) == 32 and tx.padded_cols(33) == 64
    tx.clear_pipeline_cache()
    assert tx.pipeline_stats() == [] and tx.schedule_stats() == []
