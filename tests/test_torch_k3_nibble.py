"""K3's nibble expansion on the sum and dot kernels (``ops/csrc/gf_planes.cu``,
``gf_planes_sum_kernel<kNibble>`` and ``gf_planes_dot_kernel<kNibble>``),
modelled in NumPy and held against the JAX package.

The kernels run only on the card (``chip_smoke.py`` holds them bit-exact
against their plain version there).  Here the register models of
``test_torch_k3_sum.py`` and ``test_torch_k3_dot.py`` run the nibble's
chunk loop (``chunk_planes``): per four-symbol block of rows the PRMT
transposes, then up to 4 chunks whose plane registers are PTX ``prmt.b32``
lookups of the transposed words in each lane's two tables, the sign rule
included (a table byte 0x80 gives 0xFF for a selector nibble with bit 3
set, 0x80 without: odd and even under the operator scaled by 2^s).  The
host packs the scaled one-hot-nibble operator in that depth order
(``cuda_planes.nibble_operator``), k rounded up to pairs.  The models'
bytes must equal the JAX package's exactly (tolerance 0):
``GaloisField.matmul``, ``gf_matmul_pallas(expand="nibble", refold=...,
interpret=True)`` and ``kernel_sweep``'s ``_body_nibble`` interpreted,
normal and pinned.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_rscode_torch.ops import cuda_gemm, cuda_planes
from gpu_rscode_tpu.ops.gemm import expand_nibblematrix_jnp
from gpu_rscode_tpu.ops.gf import get_field
from gpu_rscode_tpu.ops.pallas_gemm import _expand_nibble, gf_matmul_pallas
from gpu_rscode_tpu.tools import kernel_sweep as j_sweep
from test_torch_k3_dot import model as dot_model
from test_torch_k3_sum import (E1, E8, GROUPS, INT32, SOURCE, STEP, T, WARPS, _densest_element, _operands,
                               b_tile, byte_perm, chunk_planes, prmt, step_buffers, unpack_a_tiles, warp_steps)
from test_torch_k3_sum import model as sum_model
from test_torch_planes import _jax_body

MODELS = {"sum": sum_model, "dot": dot_model}
SMEM_LIMIT = 227 * 1024


def _depth_map(k: int) -> np.ndarray:
    """For each depth of the packed operator (nc * 32), the column of the
    (p*8, k*32) one-hot-nibble operator it holds, -1 for padding: chunk
    c = 2j + e, depth 16h + 4t + q is plane v = 8e + 4h + t of symbol
    2j + q // 2's low (q even: column 16 + v) or high (q odd: column v)
    nibble."""
    nc = 2 * -(-k // 2)
    out = np.full(32 * nc, -1)
    for c, h, t, q in np.ndindex(nc, 2, 4, 4):
        sym, v = c - c % 2 + q // 2, 8 * (c % 2) + 4 * h + t
        if sym < k:
            out[32 * c + 16 * h + 4 * t + q] = 32 * sym + (v if q % 2 else 16 + v)
    return out


def _edge(op_in_smem: bool, p: int = 16) -> int:
    """The largest k the nibble's sum and dot instances take: one step
    buffer a warp beside the operator in shared memory, or alone (the
    operator read through L1), as the source's sum_smem counts them."""
    mtn = 2 * -(-p // 4)

    def need(k):
        op = mtn * 2 * -(-k // 2) * 32 * 16 if op_in_smem else 0
        return op + WARPS * 4 * -(-k // 4) * STEP

    k = 0
    while need(k + 1) <= SMEM_LIMIT:
        k += 1
    return k


def test_source_constants():
    """The kernels build the tables with PTX prmt.b32 (its sign rule; the
    documented __byte_perm reads 3-bit selectors), run nibble through the
    sum, dot and none kernels' X-macro (no generic kernel left), count one
    chunk a symbol, k rounded to pairs, stage
    the operator in shared memory or read it through L1 (the kOpL1 route,
    folded forms only), and walk the chunks for every kernel in one loop
    (the sum and none kernels share sum_pass)."""
    assert 'asm("prmt.b32 %0, %1, %2, %3;\\n"' in SOURCE
    assert "const uint32_t e1 = 1u << (8 * t), e8 = 0x80u << (8 * t);" in SOURCE
    assert "return expand == kNibble ? (k + 1) / 2 * 2 : (k + 3) / 4;" in SOURCE
    assert "return OP_SMEM ? op_s[i] : __ldg(op_g + i);" in SOURCE
    assert "if (expand == kNibble && refold != kNone) {" in SOURCE
    assert SOURCE.count("nibble_chunks(rows, k, e1, e8, [&](int c, const NibbleChunk& chunk) {") == 2
    assert "#define RS_SUM_EXPANDS(X) X(kShift) X(kShiftRaw) X(kCmp) X(kSign) X(kNibble)" in SOURCE
    assert "RS_PLANES_INSTANCES" not in SOURCE and "RS_SUM_EXPANDS(RS_CALL_W8)" in SOURCE
    assert f"constexpr int kMaxSmem = {SMEM_LIMIT // 1024} * 1024;" in SOURCE
    for refold in ("sum", "dot"):
        assert cuda_planes.is_sum_pair("nibble", refold) == (refold == "sum")
        assert cuda_planes.is_dot_pair("nibble", refold) == (refold == "dot")
        assert cuda_planes.kind(8, "nibble", refold) == refold
    assert cuda_planes.kind(8, "nibble", "none") == "preparity" and "planes" not in cuda_planes.KINDS
    # Every JAX nibble name the RS_PALLAS_* knobs take reaches the new kernels.
    for name in ("nibble", "nibble_const", "nibble32"):
        assert cuda_gemm.EXPANSIONS[name] == "nibble" and name in cuda_gemm.JAX_NAMES


def test_prmt_tables():
    """Selectors of 4 nibbles (bits 16-31 not read) against lane t's tables: plane
    v = 8e + 4h + t (table e1 or e8 in x for h = 0, in y for h = 1) is 1
    at nibble v for v < 8, and 0xFF at nibble v, 0x80 at nibble v - 8 for
    v >= 8, 0 elsewhere: its parity is the one-hot.  The 3-bit selectors of
    the documented __byte_perm would light nibble v + 8 too."""
    # Each nibble value in each position, and random selectors (bits 16-31 set too).
    sel = np.concatenate([np.arange(16, dtype=np.uint32) * 0x1111,
                          np.random.default_rng(5).integers(0, 1 << 32, 4096, dtype=np.uint64).astype(np.uint32)])
    sel = sel[:, None]
    for e, h in np.ndindex(2, 2):
        tab = E8 if e else E1
        got = prmt(tab, 0, sel) if h == 0 else prmt(0, tab, sel)  # (selectors, lanes)
        three_bit = byte_perm(tab, 0, sel) if h == 0 else byte_perm(0, tab, sel)
        assert (got == (prmt(tab, 0, sel & 0xFFFF) if h == 0 else prmt(0, tab, sel & 0xFFFF))).all()
        for n in range(4):
            nib = ((sel >> np.uint32(4 * n)) & 0xF).astype(np.int64)
            byte = ((got >> np.uint32(8 * n)) & 0xFF).astype(np.int64)
            v = 8 * e + 4 * h + T[None, :]
            want = np.where(nib == v, 0xFF if e else 1, np.where(nib == v - 8, 0x80, 0))
            np.testing.assert_array_equal(byte, want, err_msg=f"e={e} h={h} n={n}")
            np.testing.assert_array_equal(byte & 1, (nib == v).astype(np.int64))
            if not e:
                assert (((three_bit >> np.uint32(8 * n)) & 1)[nib == v + 8] == 1).all()


@pytest.mark.parametrize("p,k", [(1, 1), (4, 10), (3, 33), (10, 5)])
def test_operator_order_and_scaling(p, k):
    """The host-packed A fragments, read back in the mma layout, are the
    JAX package's one-hot-nibble operator with row i*8 + s times 2^s, its
    columns in the PRMT tables' order, zero-padded to whole pairs of
    m-tiles and to k rounded up to pairs; the dot kernel's B fragments
    hold the same rows."""
    A, _ = _operands(p, k, 1, 3 * p + k)
    op = cuda_planes.nibble_operator(A)
    mtn, nc = 2 * -(-p // 4), 2 * -(-k // 2)
    assert op.shape == (16 * mtn, 32 * nc) and op.max() <= 128
    tiles = unpack_a_tiles(cuda_planes.pack_fragments(op, *op.shape))
    full = tiles.transpose(0, 2, 1, 3).reshape(op.shape)
    nib = np.asarray(expand_nibblematrix_jnp(jnp.asarray(A))).astype(np.int64) << (np.arange(p * 8) % 8)[:, None]
    cols = _depth_map(k)
    want = np.zeros_like(full)
    want[:p * 8, cols >= 0] = nib[:, cols[cols >= 0]]
    np.testing.assert_array_equal(full, want)
    assert sorted(cols[cols >= 0]) == list(range(32 * k))  # every operator column once
    b = cuda_planes.pack_b_fragments(op)
    assert b.shape == (mtn, nc, 32, 4) and (b[..., [0, 2, 1, 3]] == cuda_planes.pack_fragments(op, *op.shape)).all()


@pytest.mark.parametrize("k", [1, 2, 3, 5])
def test_plane_registers_are_the_jax_planes(k):
    """One warp step through the chunk loop: the plane registers of every
    chunk, read back as B tiles (column 8g + j of group j), hold at each
    depth, in their parity, the row of JAX's _expand_nibble that the
    operator put there; the chunks are 0..nc-1 once each (a last block of 1
    or 2 symbols runs 2 chunks)."""
    B = np.random.default_rng(k).integers(0, 256, size=(k, STEP), dtype=np.uint8)
    words, _ = step_buffers(B, [(0, 0)], 1)
    chunks = list(chunk_planes(words, k, "nibble"))
    assert [c for c, _, _ in chunks] == list(range(2 * -(-k // 2)))
    planes = np.zeros((32 * len(chunks), STEP), dtype=np.int64)
    for c, b0, b1 in chunks:
        for j in range(GROUPS):
            planes[32 * c:32 * c + 32, j::GROUPS] = b_tile(b0[j], b1[j], False)[0]
    jax_planes = np.asarray(_expand_nibble(jnp.asarray(B), 8, k, STEP)).astype(np.int64)
    cols = _depth_map(k)
    np.testing.assert_array_equal(planes[cols >= 0] & 1, jax_planes[cols[cols >= 0]])


@pytest.mark.parametrize("k", [1, 3, 4, 5, 10, 33])
@pytest.mark.parametrize("refold", ["sum", "dot"])
def test_model_matches_jax(refold, k):
    """The model equals the GF oracle and gf_matmul_pallas(expand="nibble")
    interpreted, at p = 1, 4, 10: ragged m over two blocks of 128 columns
    (a ragged last step), and m below one warp step.  JAX computes the
    three coefficient blocks in one call, stacked (its rows are
    independent), to keep the interpreted calls few."""
    gf = get_field(8)
    for m in (203, 37):
        A, B = _operands(15, k, m, 100 * k + m)
        want = gf.matmul(A, B)
        if m == 203:
            np.testing.assert_array_equal(
                np.asarray(gf_matmul_pallas(A, B, expand="nibble", refold=refold, interpret=True)), want)
        for lo, hi in ((0, 1), (1, 5), (5, 15)):  # p = 1, 4, 10
            np.testing.assert_array_equal(MODELS[refold](A[lo:hi], B, "nibble", tile=128), want[lo:hi],
                                          err_msg=f"p={hi - lo} m={m}")


@pytest.mark.parametrize("pinned", [False, True])
def test_model_matches_sweep_body(pinned):
    """The sum model equals kernel_sweep's _body_nibble interpreted with
    make_fn's BlockSpecs, normal and pinned (every block reads block 0),
    over a ragged last block; so does the wrapper's plain version; the dot
    model equals both refolds of the oracle there."""
    A, B = _operands(j_sweep.P, j_sweep.K, 600, 29)
    want = _jax_body("nibble", A, B, 256, pinned)
    np.testing.assert_array_equal(sum_model(A, B, "nibble", tile=256, pinned=pinned), want)
    np.testing.assert_array_equal(dot_model(A, B, "nibble", tile=256, pinned=pinned), want)
    got = cuda_planes.gf_matmul_planes(A, torch.from_numpy(B), "nibble", "sum", 256, pinned=pinned)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("refold", ["sum", "dot"])
@pytest.mark.parametrize("k", [4, 33])
def test_largest_sums_are_exact(refold, k):
    """Every data byte 0xFF (every nibble 15: plane 15 is 0xFF, odd) and
    every coefficient the densest element, p = 10: the largest first-product
    sum is below 2^31 and is what the scaled operator predicts (2^s * 255
    over the row's ones among plane 15's columns), and the bytes are
    right."""
    elem, _ = _densest_element()
    A = np.full((10, k), elem, dtype=np.uint8)
    B = np.full((k, 200), 0xFF, dtype=np.uint8)
    trace = []
    np.testing.assert_array_equal(MODELS[refold](A, B, "nibble", trace=trace), get_field(8).matmul(A, B))
    top = max(int(np.abs(acc).max()) for acc in trace)
    nib = np.asarray(expand_nibblematrix_jnp(jnp.asarray(A))).astype(np.int64).reshape(80, k, 32)
    rows = (nib[:, :, 15] + nib[:, :, 31]).sum(axis=1) * 255 << (np.arange(80) % 8)
    assert top == rows.max() < INT32


@pytest.mark.parametrize("refold", ["sum", "dot"])
def test_model_at_the_shared_memory_edge(refold):
    """p = 16 (four passes, two of the dot kernel's 8-symbol tiles): the
    largest k whose operator stays in shared memory beside one step buffer
    a warp (52), the first past it, which reads the operator through L1
    (53), and the largest k the ring alone fits (908, the refusal's edge at
    any p)."""
    assert (_edge(True), _edge(False), _edge(False, p=1)) == (52, 908, 908)
    gf = get_field(8)
    for k, m in ((52, 70), (53, 70), (908, 9)):
        A, B = _operands(16, k, m, k)
        np.testing.assert_array_equal(MODELS[refold](A, B, "nibble", tile=64), gf.matmul(A, B), err_msg=f"k={k}")


def test_deep_and_pinned():
    """p = 9, k = 33 (three passes, a last block of one symbol): pinned with
    tiles of 64 and 192 columns (the last block ragged) repeats block 0's
    output in both models; the steps of every block are visited once."""
    A, B = _operands(9, 33, 500, 31)
    want = get_field(8).matmul(A, B)
    for tile in (64, 192):
        assert [w for w, _ in warp_steps(500, tile, True)] == list(range(0, 500, STEP))
        for model in MODELS.values():
            np.testing.assert_array_equal(model(A, B, "nibble", tile=tile, pinned=True), want[:, np.arange(500) % tile])
