"""K3 at W=4 on the sum, dot and none kernels (``ops/csrc/gf_planes.cu``,
``gf_planes_sum_kernel<4, ...>``, ``gf_planes_dot_kernel<4, ...>`` and
``gf_planes_none_kernel<4, ...>``), modelled in NumPy and held against the
JAX package.

A GF(2^4) symbol is one uint8 whose bits 4-7 are ignored, so a symbol has
four planes and a 32-deep chunk covers 8 symbols: depth 16h + 4t + q of
chunk c is plane t of symbol 8c + 4h + q (``cuda_planes.sum_operator(A,
4)``), and lane (g, t)'s b0 is plane t of the transposed word of rows
8c..8c+3, its b1 of rows 8c + 4..8c + 7.  The register models of
``test_torch_k3_sum.py``, ``test_torch_k3_dot.py`` and
``test_torch_k3_preparity.py`` run it with ``w=4``: the ring of 64-column
steps (8 rows a chunk), the PRMT transposes (twice a chunk, the second
skipped past k), the plane words (shift and shift_raw's folded shortcut;
the none kernel's exact words), the sum refold's two xor-shuffles and the
byte every lane stores, the dot kernel's lane-local move and its F of one
pass a tile, the none kernel's staged 4p rows, and the sum and none
kernels' lone last m-tile where p*4 rows leave one unpaired.  Their outputs must
equal the JAX package's exactly (tolerance 0): ``GaloisField(4).matmul``
and ``gf_matmul_pallas(w=4, ..., interpret=True)`` (its int8 sums for
``fold_parity=False, acc_dtype=jnp.int8``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_rscode_torch.ops import cuda_planes
from gpu_rscode_tpu.ops import pallas_gemm
from gpu_rscode_tpu.ops.gemm import expand_bitmatrix_jnp
from gpu_rscode_tpu.ops.gf import get_field
from test_torch_k3_dot import a_tile, second_operand
from test_torch_k3_dot import b_tile as dot_b_tile
from test_torch_k3_dot import model as dot_model
from test_torch_k3_preparity import model as none_model
from test_torch_k3_sum import (G, IDX, INT32, SOURCE, STEP, T, W4_SINGLE, WARPS, b_tile, chunk_planes, pass_pair,
                               step_buffers, sum_refold, unpack_a_tiles)
from test_torch_k3_sum import model as sum_model

GF4 = get_field(4)
EXPANDS = cuda_planes.NARROW_EXPANDS
MODELS = {"sum": sum_model, "dot": dot_model, "none": none_model}
SMEM_LIMIT = 227 * 1024
STAGING = WARPS * 32 * 72 * 4  # the none kernel's staging rows (kNoneRows x kNoneStride int32 a warp)


def _operands(p, k, m, seed):
    """(p, k) coefficients < 16 and (k, m) bytes, the high nibble random."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 16, size=(p, k)).astype(np.uint8), rng.integers(0, 256, size=(k, m)).astype(np.uint8)


def _want(A, B, expand, refold):
    """The plain version: GF(2^4) symbols, or the int32 pre-parity sums."""
    return cuda_planes.gf_matmul_planes_plain(A, torch.from_numpy(B), expand, refold, w=4).numpy()


def _dense4() -> int:
    return int(GF4.bitmats.sum(axis=2).max(axis=1).argmax())


def route(k: int, p: int, refold: str) -> str:
    """The source's mma_route at W=4: "smem" while the operator (m-tile
    pairs x 8-symbol chunks of 512 bytes), one step buffer a warp (8 rows a
    chunk, 64 bytes a row) and the none kernel's staging fit, else
    "direct"."""
    mtn, kc = 2 * -(-p // 8), -(-k // 8)
    need = mtn * kc * 512 + WARPS * 8 * kc * STEP + (STAGING if refold == "none" else 0)
    return "smem" if need <= SMEM_LIMIT else "direct"


def parent_edge(p: int, refold: str) -> int:
    """The largest k the generic kernel the three replace took at W=4: its
    operator (p*4 rows in 16-row m-tiles, k*4 deep), and for dot F's
    16-symbol tiles and a warp's parity bits, in shared memory."""
    mt = -(-p // 4)
    kf = -(-mt * 16 // 32)
    extra = (-(-p // 16) * kf * 512 + 8 * 32 * kf * 32) if refold == "dot" else 0
    k = 0
    while mt * -(-(k + 1) // 8) * 512 + extra <= SMEM_LIMIT:
        k += 1
    return k


def test_source_constants():
    """shift and shift_raw at W=4 run the three kernels through the
    X-macro, with W=4's lone last m-tile on; their launches count as "w4"
    (folded) and "preparity_w4_w16"; the folded forms read through L1
    past their edge, as w=16's do; W=4 keeps bit g & 3 and shuffles twice;
    the dot kernel's F is one pass a tile."""
    assert "#define RS_NARROW_EXPANDS(X) X(kShift) X(kShiftRaw)" in SOURCE
    assert "#define RS_CALL_W4(E) RS_CALL_MMA(4, E, kSum) RS_CALL_MMA(4, E, kDot) RS_CALL_MMA(4, E, kNone)" in SOURCE
    assert "RS_NARROW_EXPANDS(RS_CALL_W4)" in SOURCE and W4_SINGLE
    assert "if (w != 8 || refold == kNone) return {kDirect, 0};" in SOURCE
    assert "const uint32_t keep = 0x01010101u << (W == 4 ? (g & 3) : g);" in SOURCE
    assert "constexpr int kTilePasses = W == 4 ? 1 : 2;" in SOURCE
    assert "return w == 4 ? (k + 7) / 8 : sum_chunks(byte_syms(k, w), expand);" in SOURCE
    for e in EXPANDS:
        assert [cuda_planes.kind(4, e, r) for r in ("sum", "dot", "none")] == ["w4", "w4", "preparity_w4_w16"]
        assert cuda_planes.is_sum_pair(e, "sum", 4) and cuda_planes.is_dot_pair(e, "dot", 4)
        assert cuda_planes.is_none_pair(e, "none", 4)
    assert not cuda_planes.runs_mma("sign", "sum", 4) and not cuda_planes.runs_mma("nibble", "none", 4)
    assert cuda_planes.block_cols(None, 10**6) == cuda_planes.MMA_TILE


@pytest.mark.parametrize("p,k", [(1, 1), (4, 10), (3, 9), (9, 17)])
def test_operator_depth_order(p, k):
    """The host-packed A fragments, read back in the mma layout, are the
    JAX package's (4p, 4k) expand_bitmatrix with row r times 2^(r mod 4),
    depth 32c + 16h + 4t + q holding plane t of symbol 8c + 4h + q,
    zero-padded to pairs of m-tiles (8 symbols) and whole chunks; the
    none kernel's is the same unscaled, and the dot kernel's B fragments
    hold the same rows."""
    A, _ = _operands(p, k, 1, 3 * p + k)
    op = cuda_planes.sum_operator(A, 4)
    mtn, kc = 2 * -(-p // 8), -(-k // 8)
    assert op.shape == (16 * mtn, 32 * kc) and op.max() <= 8
    full = unpack_a_tiles(cuda_planes.pack_fragments(op, *op.shape)).transpose(0, 2, 1, 3).reshape(op.shape)
    bits = np.asarray(expand_bitmatrix_jnp(jnp.asarray(A.astype(np.int32)), 4)).astype(np.int64)
    want = np.zeros_like(full)
    for i in range(k):
        for s in range(4):
            want[:4 * p, 32 * (i // 8) + 16 * (i % 8 // 4) + 4 * s + i % 4] = bits[:, 4 * i + s] << (np.arange(4 * p) % 4)
    np.testing.assert_array_equal(full, want)
    np.testing.assert_array_equal(cuda_planes.sum_operator(A, 4, scaled=False).astype(np.int64)
                                  << (np.arange(op.shape[0]) % 4)[:, None], op)
    b = cuda_planes.pack_b_fragments(op)
    assert (b[..., [0, 2, 1, 3]] == cuda_planes.pack_fragments(op, *op.shape)).all()


@pytest.mark.parametrize("exact", [False, True])
@pytest.mark.parametrize("expand", EXPANDS)
def test_plane_words_are_the_jax_planes(expand, exact):
    """One warp step of every byte value over k = 9 rows (a chunk whose
    second half starts past k): the plane registers of every chunk, read
    back as B tiles at their depths, are JAX's _expand_* planes at w=4:
    value for value for the none kernel's exact words (shift_raw's
    int8(b >> s) of the whole byte), and for the folded words bit for bit
    (shift_raw's shortcut carries bits 4-7 and the next byte's only at 2^1
    and up); past k the b1 words are zero."""
    k = 9
    B = np.random.default_rng(4).integers(0, 256, size=(k, STEP), dtype=np.uint8)
    B[0] = np.arange(STEP)
    B[1] = np.arange(STEP) + 192
    words, _ = step_buffers(B, [(0, 0)], 1, direct=True, w=4)
    chunks = list(chunk_planes(words, k, expand, 4, exact))
    assert [c for c, _, _ in chunks] == [0, 1] and not chunks[1][2].any()
    planes = np.zeros((64, STEP), dtype=np.int64)
    for c, b0, b1 in chunks:
        for j in range(8):
            planes[32 * c:32 * c + 32, j::8] = b_tile(b0[j], b1[j], exact and expand == "shift_raw")[0]
    fn = getattr(pallas_gemm, f"_expand_{expand}")
    jax_planes = np.asarray(fn(jnp.asarray(B), 4, k, STEP).astype(jnp.int8)).astype(np.int64)
    d = np.arange(64)
    sym, s = 8 * (d // 32) + 4 * (d % 32 // 16) + d % 4, d % 16 // 4
    got, want = planes[sym < k], jax_planes[(4 * sym + s)[sym < k]]
    if exact or expand == "shift":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(got & 1, want & 1)
        assert (got >= 0).all()  # u8 operands


def test_sum_refold_two_shuffles():
    """The W=4 refold of random accumulators: after the mask of bit g & 3
    and the shuffles over g ^ 1 and g ^ 2, byte b of group word w[j] in
    lane (g, t) is the 4 parity bits of symbol g / 4 + 2(b / 2) of the
    m-tile at column 16t + 8(b & 1) + j, and the lane storing byte g & 3
    writes symbol g / 4 + 2((g / 2) & 1): every (symbol, column) of the
    tile once."""
    acc = np.random.default_rng(8).integers(-(1 << 31), 1 << 31, size=(8, 1, 16, 8))
    words = sum_refold(acc, 4)
    stored = {}
    for j in range(8):
        for lane in IDX:
            g, t = lane >> 2, lane & 3
            for b in range(4):
                sym, col = g // 4 + 2 * (b // 2), 2 * t + (b & 1)  # col: the n-index of group j
                rows = 4 * (g // 4) + 8 * (b // 2) + np.arange(4)
                want = sum(int(acc[j, 0, r, col] >> (r % 4) & 1) << (r % 4) for r in rows)
                assert int(words[j][0, lane]) >> (8 * b) & 0xFF == want
            b = g & 3
            key = (g // 4 + 2 * ((g >> 1) & 1), 16 * t + 8 * (g & 1) + j)
            assert key not in stored
            stored[key] = int(words[j][0, lane]) >> (8 * b) & 0xFF
    assert len(stored) == 4 * 64
    assert (G & 3).max() == 3 and (T >> 1).max() == 1


def test_dot_fold_and_move():
    """The dot kernel's W=4 F, read back as a 32 x 8 tile, takes each depth
    16h + 4t + e to symbol 4h + 2(e / 2) + t / 2 (4 depths, its 4 bits, a
    symbol); the lane-local move with the mask 0x02010201 << 2(t & 1)
    puts bit 2(t & 1) + (e & 1) of n-tile 2h + e / 2 there, so the second
    product of any accumulators is each symbol's 4 parity bits."""
    F = cuda_planes.dot_fold_operator(4)
    assert F.shape == (1, 32, 2) and F.dtype == np.uint32
    tile = dot_b_tile(F[0, :, 0], F[0, :, 1])
    assert (tile.sum(axis=1) == 1).all() and (tile.sum(axis=0) == 4).all()
    acc = np.random.default_rng(9).integers(-(1 << 31), 1 << 31, size=(4, 1, 16, 8))
    keep = np.uint32(0x02010201) << (2 * (T & 1)).astype(np.uint32)
    out = a_tile(*second_operand(acc, keep), signed=False)[0] @ tile
    for sym in range(8):
        nt, half = sym // 2, sym % 2  # n-tile rows 4 half .. 4 half + 3: the symbol's bits
        want = sum((acc[nt, 0, :, 4 * half + s] >> s & 1) << s for s in range(4))
        np.testing.assert_array_equal(out[:, sym], want)


@pytest.mark.parametrize("refold", ["sum", "dot", "none"])
@pytest.mark.parametrize("expand", EXPANDS)
def test_models_match_jax(expand, refold):
    """Each kernel's model equals gf_matmul_pallas(w=4) interpreted and the
    GF(2^4) oracle (the sums' parity for none): p = 1, 3, 4, 5 (a lone last
    m-tile, or a pass half padding) and 17 (past one 8-symbol tile), k = 1, 9 (a chunk
    past k) and 10, m ragged over two blocks of 128 columns (k = 9) and
    below one warp step, bytes with the high nibble set.  JAX computes the
    stacked coefficient rows in one call."""
    for k, m in ((1, 37), (9, 203), (10, 37)):
        A, B = _operands(30, k, m, 10 * k + m)
        folded = GF4.matmul(A, B & 0xF)
        want = _want(A, B, expand, refold)
        if k == 9 and m == 203:
            kw = dict(fold_parity=False, acc_dtype=jnp.int8) if refold == "none" else dict(refold=refold)
            np.testing.assert_array_equal(
                np.asarray(pallas_gemm.gf_matmul_pallas(A, B, w=4, expand=expand, interpret=True, **kw)), want)
        rows = 4 if refold == "none" else 1
        for lo, hi in ((0, 1), (1, 4), (4, 8), (8, 13), (13, 30)):
            got = MODELS[refold](A[lo:hi], B, expand, tile=128, w=4)
            np.testing.assert_array_equal(got, want[rows * lo:rows * hi], err_msg=f"p={hi - lo} k={k} m={m}")
            if refold == "none":
                np.testing.assert_array_equal(np.bitwise_or.reduce(
                    (got & 1).reshape(hi - lo, 4, m) << np.arange(4)[None, :, None], axis=1), folded[lo:hi])


@pytest.mark.parametrize("refold", ["sum", "dot", "none"])
def test_models_pinned_and_direct(refold):
    """Pinned blocks of 64 and 192 columns repeat block 0's output; the
    direct route (rows from device memory, zero past k and m) gives the
    staged route's output at a ragged, misaligned m."""
    A, B = _operands(5, 9, 301, 47)
    for expand in EXPANDS:
        want = _want(A, B, expand, refold)
        for tile in (64, 192):
            np.testing.assert_array_equal(MODELS[refold](A, B, expand, tile=tile, pinned=True, w=4),
                                          want[:, np.arange(301) % tile])
        np.testing.assert_array_equal(MODELS[refold](A, B, expand, tile=128, direct=True, w=4), want)


@pytest.mark.parametrize("k", [4, 33])
def test_largest_sums_are_exact(k):
    """Every byte 0xFF (shift_raw's planes int8(0xFF >> s): -1, 127, 63,
    31) and every coefficient the densest element: the largest first-product
    sum is below 2^31 and, for shift, what the scaled operator predicts;
    every kernel's output equals the plain version."""
    A = np.full((5, k), _dense4(), dtype=np.uint8)
    B = np.full((k, 100), 0xFF, dtype=np.uint8)
    for expand in EXPANDS:
        for refold, mdl in MODELS.items():
            trace = []
            np.testing.assert_array_equal(mdl(A, B, expand, trace=trace, w=4), _want(A, B, expand, refold),
                                          err_msg=f"{expand}+{refold}")
            top = max(int(np.abs(acc).max()) for acc in trace)
            assert top < INT32
            if expand == "shift" and refold != "none":
                assert top == cuda_planes.sum_operator(A, 4).astype(np.int64).sum(axis=1).max()


@pytest.mark.parametrize("refold", ["sum", "dot", "none"])
def test_models_at_the_shared_memory_edge(refold):
    """p = 16: the largest k the staged route takes (448; none 376) and the
    first past it, read from device memory, and the first k past the
    generic kernel's edge (p = 16: 904, dot 840; p = 1: 3632, dot 3496,
    which chip_smoke.py runs on the card): every (k, p) taken before still
    runs, and the route changes nothing in the output."""
    edge = 376 if refold == "none" else 448
    assert [route(k, 16, refold) for k in (edge, edge + 1)] == ["smem", "direct"]
    assert (parent_edge(16, refold), parent_edge(1, refold)) == ((840, 3496) if refold == "dot" else (904, 3632))
    cases = [(16, edge, 70), (16, edge + 1, 9), (16, parent_edge(16, refold) + 1, 9)]
    for p, k, m in cases:
        A, B = _operands(p, k, m, k + p)
        got = MODELS[refold](A, B, "shift", tile=64, direct=route(k, p, refold) == "direct", w=4)
        np.testing.assert_array_equal(got, _want(A, B, "shift", refold), err_msg=f"p={p} k={k}")


def test_lone_last_m_tile():
    """p*4 rows in 16-row m-tiles: p = 4 and 12 leave the last one unpaired
    (the sum and none kernels run it alone), p = 8 and 16 do not; the dot
    kernel always runs its 4 n-tiles a pass."""
    assert [pass_pair(mg, p, 4) for p, mg in ((4, 0), (12, 2), (8, 0), (16, 2), (5, 0))] == [
        False, False, True, True, True]
    assert all(pass_pair(0, p, w) for p in (1, 3) for w in (8, 16))
    assert "dot_pass4<EXPAND, SRC>(acc, rows, smem, opB, pass, kc, k, lane);" in SOURCE


def test_wrapper_plain_version_matches_the_models():
    """The wrapper on a CPU tensor (the plain version) gives the models'
    output for every refold, pinned too, at the default tile."""
    A, B = _operands(3, 6, 150, 13)
    Bt = torch.from_numpy(B)
    for refold, mdl in MODELS.items():
        got = cuda_planes.gf_matmul_planes(A, Bt, "shift_raw", refold, 64, w=4)
        np.testing.assert_array_equal(got.numpy(), mdl(A, B, "shift_raw", tile=64, w=4))
        got = cuda_planes.gf_matmul_planes(A, Bt, "shift", refold, pinned=True, w=4)
        np.testing.assert_array_equal(got.numpy(), mdl(A, B, "shift", tile=cuda_planes.MMA_TILE, pinned=True, w=4))
