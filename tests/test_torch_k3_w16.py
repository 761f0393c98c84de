"""K3 at w=16 on the sum and dot kernels (``ops/csrc/gf_planes.cu``,
``gf_planes_sum_kernel<16, ...>`` and ``gf_planes_dot_kernel<16, ...>``),
modelled in NumPy and held against the JAX package.

A 16-bit symbol is two byte-symbols, its low byte (bits 0-7) and its high
byte (8-15), and the (16p, 16k) GF(2) operator is the same matrix read as
the (2p*8, 2k*8) operator over them: the host scales its rows by 2^(s mod
8) (``cuda_planes.sum_operator(A, 16)``), so the w=8 plane words serve
unchanged.  The register models of ``test_torch_k3_sum.py`` and
``test_torch_k3_dot.py`` run it: 128-byte step rows, the LDS.128 of rows
2c and 2c + 1 and the 8 PRMT that split each column's low and high bytes,
the w=8 refolds, and the stores that interleave the two bytes of a symbol
(4 PRMT in the sum kernel, 12 in the dot kernel) into one 16-byte word a
lane.  Past the staged route's shared memory the kernels read their rows
from device memory (zero past k and past m), which the models run too.
Their symbols must equal the JAX package's exactly (tolerance 0):
``GaloisField.matmul`` and ``gf_matmul_pallas(w=16, expand=..., refold=...,
interpret=True)``.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_rscode_torch.ops import cuda_planes
from gpu_rscode_tpu.ops.gemm import expand_bitmatrix_jnp
from gpu_rscode_tpu.ops.gf import get_field
from gpu_rscode_tpu.ops.pallas_gemm import gf_matmul_pallas
from test_torch_k3_dot import model as dot_model
from test_torch_k3_sum import (G, INT32, SOURCE, STEP, WARPS, byte_perm, step_buffers, step_words,
                               unpack_a_tiles)
from test_torch_k3_sum import model as sum_model

MODELS = {"sum": sum_model, "dot": dot_model}
EXPANDS = cuda_planes.WIDE_EXPANDS
SMEM_LIMIT = 227 * 1024


def _operands(p, k, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 16, size=(p, k)).astype(np.uint16),
            rng.integers(0, 1 << 16, size=(k, m)).astype(np.uint16))


def _dense16() -> int:
    """The GF(2^16) element whose bit matrix has the most ones in one row."""
    return int(get_field(16).bitmats.sum(axis=2).max(axis=1).argmax())


def route(k: int, p: int) -> str:
    """The source's mma_route for the w=16 sum and dot kernels: "smem"
    while the operator (m-tile pairs x chunks of 512 bytes) and one
    128-byte-row step buffer a warp fit, else "direct"."""
    mtn = 2 * -(-(2 * p) // 4)
    kc = -(-k // 2)
    need = mtn * kc * 512 + WARPS * 2 * kc * 2 * STEP
    return "smem" if need <= SMEM_LIMIT else "direct"


def parent_edge(p: int, refold: str) -> int:
    """The largest k the w=16 instances of gf_planes_kernel took at p (its
    planes_smem: the operator, p m-tiles; for dot F' and the parity bits)."""
    def need(k):
        kf = -(-p // 2)
        extra = (-(-p // 8) * kf * 512 + 8 * 32 * kf * 32) if refold == "dot" else 0
        return p * -(-k // 2) * 512 + extra

    k = 0
    while need(k + 1) <= SMEM_LIMIT:
        k += 1
    return k


def test_source_constants():
    """The w=16 sum, dot and none instances run the three kernels through
    the X-macro (kStaged and kDirect routes), none of them a generic
    kernel; the folded launches count as "w16", the pre-parity ones as
    "preparity_w4_w16"; the step row is two bytes a column."""
    assert f"constexpr int kMaxSmem = {SMEM_LIMIT // 1024} * 1024;" in SOURCE
    assert "#define RS_WIDE_EXPANDS(X) X(kShift) X(kShiftRaw) X(kSign)" in SOURCE
    assert "RS_WIDE_EXPANDS(RS_CALL_W16)" in SOURCE
    assert ("#define RS_CALL_W16(E) RS_CALL_MMA(16, E, kSum) RS_CALL_MMA(16, E, kDot) RS_CALL_MMA(16, E, kNone)"
            in SOURCE)
    assert "static constexpr int kRowBytes = kSumStepCols * kSym;" in SOURCE
    assert "__host__ __device__ constexpr int sym_bytes(int w) { return w == 16 ? 2 : 1; }" in SOURCE
    assert not re.search(r"RS_PLANES_INSTANCES|gf_planes_kernel\b", SOURCE)
    for e in EXPANDS:
        for refold in ("sum", "dot"):
            assert cuda_planes.kind(16, e, refold) == "w16"
            assert (cuda_planes.is_sum_pair(e, refold, 16), cuda_planes.is_dot_pair(e, refold, 16)) == (
                refold == "sum", refold == "dot")
        assert cuda_planes.kind(16, e, "none") == "preparity_w4_w16"


@pytest.mark.parametrize("p,k", [(1, 1), (4, 10), (3, 7), (9, 4)])
def test_operator_is_the_byte_symbol_operator(p, k):
    """The host-packed A fragments, read back in the mma layout, are the JAX
    package's (16p, 16k) expand_bitmatrix, row r times 2^(r mod 8) (bits
    8-15 of a symbol by 2^(s-8)), depth 32c + 16h + 4t + q holding bit
    4h + t of byte-symbol 4c + q (symbol (4c + q) // 2's low or high
    byte), zero-padded to pairs of m-tiles; every sum term stays u8; the
    dot kernel's B fragments hold the same rows."""
    A, _ = _operands(p, k, 1, 5 * p + k)
    op = cuda_planes.sum_operator(A, 16)
    mtn, kc = 2 * -(-(2 * p) // 4), -(-(2 * k) // 4)
    assert op.shape == (16 * mtn, 32 * kc) and op.max() <= 128
    full = unpack_a_tiles(cuda_planes.pack_fragments(op, *op.shape)).transpose(0, 2, 1, 3).reshape(op.shape)
    bits = np.asarray(expand_bitmatrix_jnp(jnp.asarray(A.astype(np.int32)), 16)).astype(np.int64)
    want = np.zeros_like(full)
    for i in range(2 * k):  # byte-symbol i: bits 8 (i % 2) .. + 7 of symbol i // 2
        for s in range(8):
            col = 32 * (i // 4) + 16 * (s // 4) + 4 * (s % 4) + i % 4
            want[:16 * p, col] = bits[:, 16 * (i // 2) + 8 * (i % 2) + s] << (np.arange(16 * p) % 8)
    np.testing.assert_array_equal(full, want)
    b = cuda_planes.pack_b_fragments(op)
    assert (b[..., [0, 2, 1, 3]] == cuda_planes.pack_fragments(op, *op.shape)).all()
    np.testing.assert_array_equal(cuda_planes.sum_operator(A, 16, scaled=False) << (np.arange(op.shape[0]) % 8)[:, None],
                                  op)


def test_step_words_split_the_bytes():
    """One step of 128-byte rows: the words of chunk c hold, for column
    8g + j of group j, lo(2c), hi(2c), lo(2c + 1), hi(2c + 1) in bytes
    0-3, for the ring (rows past k whatever shared memory held) and the
    direct route (zero past k and m)."""
    k, m = 5, 50
    B = _operands(1, k, m, 3)[1]
    for direct in (False, True):
        words, out = step_buffers(B, [(0, 0)], 1, direct)
        assert words.shape == (1, 6, 8, 4) and out.dtype == np.uint16
        for c in range(3):
            r = step_words(words, c, 16)[:, 0]  # (GROUPS, 32 lanes)
            for j in range(8):
                col = 8 * G + j
                for q in range(4):
                    row = 2 * c + q // 2
                    got = (r[j] >> np.uint32(8 * q)) & 0xFF
                    ok = (row < k) & (col < m)
                    want = np.where(ok, (B[min(row, k - 1), np.minimum(col, m - 1)] >> (8 * (q % 2))) & 0xFF, 0)
                    if direct:
                        np.testing.assert_array_equal(got, want)
                    else:
                        np.testing.assert_array_equal(got[ok], want[ok])


@pytest.mark.parametrize("refold", ["sum", "dot"])
@pytest.mark.parametrize("expand", EXPANDS)
def test_model_matches_jax(expand, refold):
    """The model equals gf_matmul_pallas(w=16) interpreted and the GF(2^16)
    oracle: p = 1, 3, 4 (odd p: a padded m-tile, the dot kernel's 4-symbol
    tile half full), k = 1, 3, 10 (a chunk's second symbol past k), m
    ragged over two blocks of 128 columns and below one warp step.  JAX
    computes the stacked coefficient blocks in one call (its rows are
    independent)."""
    gf = get_field(16)
    for k in (1, 3, 10):
        for m in (203, 37):
            A, B = _operands(8, k, m, 100 * k + m)
            want = gf.matmul(A, B)
            if k == 10 and m == 203:
                jax_kw = {"acc_dtype": jnp.int8} if expand == "shift_raw" else {}
                np.testing.assert_array_equal(
                    np.asarray(gf_matmul_pallas(A, B, w=16, expand=expand, refold=refold, interpret=True, **jax_kw)),
                    want)
            for lo, hi in ((0, 1), (1, 4), (4, 8)):
                np.testing.assert_array_equal(MODELS[refold](A[lo:hi], B, expand, tile=128), want[lo:hi],
                                              err_msg=f"p={hi - lo} k={k} m={m}")


@pytest.mark.parametrize("refold", ["sum", "dot"])
def test_model_pinned_and_direct(refold):
    """Pinned blocks of 64 and 192 columns (the last ragged) repeat block
    0's output; the direct route (rows from device memory, zero past k and
    m) gives the same symbols as the staged one, ragged and misaligned m."""
    A, B = _operands(5, 7, 301, 41)
    want = get_field(16).matmul(A, B)
    for tile in (64, 192):
        np.testing.assert_array_equal(MODELS[refold](A, B, "shift_raw", tile=tile, pinned=True),
                                      want[:, np.arange(301) % tile])
    for expand in EXPANDS:
        np.testing.assert_array_equal(MODELS[refold](A, B, expand, tile=128, direct=True), want)


@pytest.mark.parametrize("k", [4, 33])
def test_largest_sums_are_exact(k):
    """Every symbol 0xFFFF (each plane word 0xFF bytes, -1 under sign) and
    every coefficient the densest element: the largest first-product sum
    is below 2^31 and, for shift, what the scaled operator predicts; the
    symbols are right in both kernels."""
    dense = _dense16()
    A = np.full((4, k), dense, dtype=np.uint16)
    B = np.full((k, 100), 0xFFFF, dtype=np.uint16)
    want = get_field(16).matmul(A, B)
    for expand in EXPANDS:
        for refold, mdl in MODELS.items():
            trace = []
            np.testing.assert_array_equal(mdl(A, B, expand, trace=trace), want, err_msg=f"{expand}+{refold}")
            top = max(int(np.abs(acc).max()) for acc in trace)
            assert top < INT32
            if expand == "shift":
                op = cuda_planes.sum_operator(A, 16).astype(np.int64)
                assert top == op.sum(axis=1).max()


@pytest.mark.parametrize("refold", ["sum", "dot"])
def test_model_at_the_shared_memory_edge(refold):
    """p = 16: the largest k the staged route takes (50) and the first past
    it, which reads the rows and the operator through L1 (51); the largest
    k gf_planes_kernel took (56 for sum, 38 for dot) and one past it (both
    now direct or staged); p = 1 at gf_planes_kernel's edge (908 sum, 874
    dot), far past the staged route's 226: every (k, p) taken before still
    runs, and the route changes nothing in the symbols."""
    assert [route(k, 16) for k in (50, 51)] == ["smem", "direct"]
    assert [route(k, 1) for k in (226, 227)] == ["smem", "direct"]
    assert (parent_edge(16, "sum"), parent_edge(16, "dot"), parent_edge(1, "sum"), parent_edge(1, "dot")) == (
        56, 38, 908, 874)
    gf = get_field(16)
    edge = parent_edge(1, refold)
    for p, k, m in ((16, 50, 70), (16, 51, 70), (16, parent_edge(16, refold) + 1, 9), (1, edge, 9)):
        A, B = _operands(p, k, m, k + p)
        got = MODELS[refold](A, B, "shift", tile=64, direct=route(k, p) == "direct")
        np.testing.assert_array_equal(got, gf.matmul(A, B), err_msg=f"p={p} k={k}")


def test_stores_interleave_the_bytes():
    """The sum kernel's store: after the refold byte b of group word w[j] is
    byte-symbol 2mt + b // 2 (the low byte, then the high) at column
    16t + 8(b & 1) + j, and lane g < 2 makes word i of its 8 columns
    16t + 8g.. with PRMT 0x6420 + 0x1111 g of w[2i], w[2i + 1]: the
    uint16 symbols of columns 2i and 2i + 1, low byte first."""
    rng = np.random.default_rng(7)
    lo, hi = rng.integers(0, 256, size=(2, 16)), rng.integers(0, 256, size=(2, 16))  # (half h, 8h + j)
    w = [np.uint32(lo[0, j] | lo[1, j] << 8 | hi[0, j] << 16 | hi[1, j] << 24) for j in range(8)]
    for g in range(2):
        words = [byte_perm(w[2 * i], w[2 * i + 1], 0x6420 + 0x1111 * g) for i in range(4)]
        got = np.array(words, dtype=np.uint32).view(np.uint16)
        np.testing.assert_array_equal(got, (lo[g, :8] | hi[g, :8] << 8).astype(np.uint16))
    assert "const uint32_t pick16 = 0x6420u + 0x1111u * (uint32_t)(g & 1);" in SOURCE


def test_wrapper_plain_version_matches_the_models():
    """The wrapper on a CPU tensor (the plain version) gives the models'
    symbols for both refolds, pinned too."""
    A, B = _operands(3, 6, 150, 13)
    Bt = torch.from_numpy(B.view(np.int16)).view(torch.uint16)
    for refold, mdl in MODELS.items():
        got = cuda_planes.gf_matmul_planes(A, Bt, "sign", refold, 64, w=16)
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16), mdl(A, B, "sign", tile=64))
        got = cuda_planes.gf_matmul_planes(A, Bt, "sign", refold, 64, pinned=True, w=16)
        np.testing.assert_array_equal(got.view(torch.int16).numpy().view(np.uint16),
                                      mdl(A, B, "sign", tile=64, pinned=True))
