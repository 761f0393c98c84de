"""K3's dot refold for the four byte expansions (``ops/csrc/gf_planes.cu``,
``gf_planes_dot_kernel``), modelled in NumPy and held against the JAX
package.

The kernel runs only on the card (``chip_smoke.py`` holds it bit-exact
against its plain version there).  Here a NumPy model follows it register
by register: the per-warp shared-memory ring of 64-column steps (rows past
k and columns past m hold random bytes, which must not change a stored
byte), each lane's 8-byte reads, the PRMT transposes and plane words it
shares with ``gf_planes_sum_kernel`` (``test_torch_k3_sum.py``), the first
product with the planes as the A operand of ``mma.m16n8k32`` and the
host-packed operator (scaled by 2^s, ``cuda_planes.sum_operator``) as B
fragments, the move of the masked accumulator bytes into the second
product's A registers (PRMT and a mask, inside the lane), the second
product against the 0/1 F (``cuda_planes.dot_fold_operator``) and the
8-byte stores, the only place a lane writes.  The model's bytes must equal
the JAX package's exactly (tolerance 0): ``GaloisField.matmul``,
``gf_matmul_pallas(refold="dot", interpret=True)`` and ``kernel_sweep``'s
``_body_signf`` and ``_body_raw_dot`` interpreted.
"""


import numpy as np
import pytest
import torch

from gpu_rscode_torch.ops import cuda_planes
from gpu_rscode_tpu.ops.gf import get_field
from gpu_rscode_tpu.ops.pallas_gemm import gf_matmul_pallas
from gpu_rscode_tpu.tools import kernel_sweep as j_sweep
from test_torch_k3_sum import (G, INT32, LANES, SOURCE, STEP, T, _densest_element, _jax_sweep_body, _operands,
                               byte_perm, chunk_planes, operator, step_buffers, warp_steps)

EXPANDS = ("shift", "shift_raw", "cmp", "sign")
# (JAX sweep body, expansion) pairs whose refold is "dot".
SWEEP_BODIES = {"signf": "sign", "raw_dot": "shift_raw"}


def low_bytes(a, b, c, d):
    """The kernel's ``low_bytes``: 3 PRMT."""
    return byte_perm(byte_perm(a, b, 0x0040), byte_perm(c, d, 0x4000), 0x7610)


def _bytes(regs: np.ndarray, signed: bool) -> np.ndarray:
    """(..., 32 lanes) uint32 -> (..., 32, 4) int64 bytes, low byte first."""
    by = np.ascontiguousarray(regs.astype(np.uint32)).view(np.uint8).reshape(*regs.shape, 4).astype(np.int64)
    return np.where(by >= 128, by - 256, by) if signed else by


def a_tile(a0, a1, a2, a3, signed: bool) -> np.ndarray:
    """Per-lane A registers (S, 32) each -> (S, 16, 32) tiles: lane (g, t)
    holds rows g (regs 0, 2) and g + 8 (regs 1, 3) at depths 4t.. (regs 0,
    1) and 16 + 4t.. (regs 2, 3)."""
    S = a0.shape[0]
    tile = np.zeros((S, 16, 32), dtype=np.int64)
    for reg, (row, dep) in zip((a0, a1, a2, a3), ((0, 0), (8, 0), (0, 16), (8, 16))):
        by = _bytes(reg, signed).reshape(S, 8, 4, 4)  # (S, g, t, byte)
        tile[:, row:row + 8, dep:dep + 16] = by.reshape(S, 8, 16)
    return tile


def b_tile(b0, b1) -> np.ndarray:
    """Per-lane B registers (..., 32) -> (..., 32, 8) tiles: depth 4t + q of
    column g is byte q of b0 in lane (g, t), depth 16 + 4t + q byte q of b1."""
    lead = np.shape(b0)[:-1]
    tile = np.zeros((*lead, 32, 8), dtype=np.int64)
    for reg, dep in ((b0, 0), (b1, 16)):
        by = _bytes(np.asarray(reg), False).reshape(*lead, 8, 4, 4)  # (g, t, q)
        tile[..., dep:dep + 16, :] = np.moveaxis(by.reshape(*lead, 8, 16), -2, -1)
    return tile


def c_regs(acc: np.ndarray) -> list:
    """(S, 16, 8) int64 sums -> the C fragment's 4 registers (S, 32) as the
    lane holds them (two's complement): rows g, g, g + 8, g + 8 at columns
    2t, 2t + 1, 2t, 2t + 1."""
    u = acc.astype(np.uint32)
    return [u[:, G, 2 * T], u[:, G, 2 * T + 1], u[:, G + 8, 2 * T], u[:, G + 8, 2 * T + 1]]


def second_operand(acc: np.ndarray, keep) -> list:
    """One m-block's accumulators (4 n-tiles, S, 16, 8) -> the second
    product's A registers: each lane's own C registers, low bytes gathered
    by 3 PRMT and masked to their output bit."""
    regs = [c_regs(acc[nt]) for nt in range(4)]
    return [low_bytes(regs[nt][h], regs[nt][h + 1], regs[nt + 1][h], regs[nt + 1][h + 1]) & keep
            for nt, h in ((0, 0), (0, 2), (2, 0), (2, 2))]


def model(A: np.ndarray, B: np.ndarray, expand: str, tile: int | None = None, pinned: bool = False,
          trace: list | None = None, direct: bool = False, w: int | None = None) -> np.ndarray:
    """NumPy model of gf_planes_dot_kernel<W, expand>: (p, k) coefficients,
    (k, m) uint8 (W=4, 8) or uint16 (W=16) -> (p, m) of B's type.  ``w``:
    16 for uint16, else 8 unless given (4).  ``tile`` as the wrapper rounds
    it; ``direct``: the rows read from device memory (the w=4 and 16
    kernels past their shared-memory edge).  ``trace`` collects every
    first-product accumulator after each depth chunk."""
    p, k = A.shape
    m = B.shape[1]
    w16 = B.dtype == np.uint16
    wd = 16 if w16 else w or 8
    assert not direct or wd != 8  # w=8's dot kernel always stages its rows
    tile = cuda_planes.tile_cols(tile, m)
    assert tile % STEP == 0
    opB = cuda_planes.pack_b_fragments(operator(A, expand, wd))  # (2 * npass, kc, 32, 4)
    npass, kc = opB.shape[0] // 2, opB.shape[1]
    assert opB.shape[0] % 2 == 0
    opF = cuda_planes.dot_fold_operator(wd)  # (passes a tile, 32, 2): 2, or 1 at w=4
    tile_passes = opF.shape[0]
    f_tiles = [b_tile(opF[q, :, 0], opF[q, :, 1]) for q in range(tile_passes)]
    steps = warp_steps(m, tile, pinned)
    assert [w for w, _ in steps] == list(range(0, m, STEP))  # every step once, blocks ragged or not
    S = len(steps)
    words, out = step_buffers(B, steps, p, direct, wd)
    writes = np.zeros((p, m), dtype=np.int64)
    # Byte e of a second-product register: output bit 2t + (e & 1), at w=4
    # bit 2(t & 1) + (e & 1) of symbol t / 2 of its n-tile.
    keep = np.uint32(0x02010201) << (2 * (T & 1 if wd == 4 else T)).astype(np.uint32)
    col0 = np.array([w for w, _ in steps])
    signed = expand == "sign"
    kb = k if wd == 4 else k * wd // 8
    chunks = list(chunk_planes(words, kb, expand, wd))  # the same registers in every pass
    assert sorted(c for c, _, _ in chunks) == list(range(kc))  # every operator chunk once
    for f in range(-(-npass // tile_passes)):
        o = np.zeros((4, S, 16, 8), dtype=np.int64)
        for q in range(tile_passes):
            ps = tile_passes * f + q
            if ps >= npass:
                break
            acc = np.zeros((4, 4, S, 16, 8), dtype=np.int64)  # (m-block, n-tile, S, column, row)
            for c, pw0, pw1 in chunks:
                b01, b23 = opB[2 * ps, c], opB[2 * ps + 1, c]  # two LDS.128 per 16 mma
                ops = [b_tile(b01[:, 0], b01[:, 1]), b_tile(b01[:, 2], b01[:, 3]),
                       b_tile(b23[:, 0], b23[:, 1]), b_tile(b23[:, 2], b23[:, 3])]
                # m-block mb: rows g and g + 8 are columns 8g + mb and 8g + 4 + mb.
                regs = (pw0[:4], pw0[4:], pw1[:4], pw1[4:])
                a = a_tile(*(x.reshape(-1, LANES) for x in regs), signed).reshape(4, S, 16, 32)
                for nt in range(4):
                    acc[:, nt] += np.matmul(a, ops[nt])
                if trace is not None:
                    trace.append(acc.copy())
            assert np.abs(acc).max(initial=0) < INT32
            for mb in range(4):
                o[mb] += np.matmul(a_tile(*second_operand(acc[mb], keep), signed=False), f_tiles[q])
        assert o.min() >= 0 and o.max() < 256
        regs = [c_regs(o[mb]) for mb in range(4)]
        if w16:  # byte-symbols 8f + 2t, 8f + 2t + 1: the low and high bytes of symbol 4f + t
            words16 = [low_bytes(regs[mb][h], regs[mb][h + 1], regs[mb + 1][h], regs[mb + 1][h + 1])
                       for h in (0, 2) for mb in (0, 2)]  # columns 8g + 2i, 8g + 2i + 1 in word i
            for lane in range(LANES):
                g, t = lane >> 2, lane & 3
                sym = 4 * f + t
                if sym >= p:
                    continue
                for b in range(8):
                    cols = col0 + 8 * g + b
                    ok = cols < m
                    out[sym, cols[ok]] = (words16[b // 2][ok, lane] >> np.uint32(16 * (b & 1))) & 0xFFFF
                    writes[sym, cols[ok]] += 1
            continue
        for h in range(2):
            lo = low_bytes(*(regs[mb][h] for mb in range(4)))
            hi = low_bytes(*(regs[mb][2 + h] for mb in range(4)))
            for lane in range(LANES):
                g, t = lane >> 2, lane & 3
                sym = 8 * f + 2 * t + h
                if sym >= p:
                    continue
                for b in range(8):
                    cols = col0 + 8 * g + b
                    ok = cols < m
                    word = lo[:, lane] if b < 4 else hi[:, lane]
                    out[sym, cols[ok]] = (word[ok] >> np.uint32(8 * (b & 3))) & 0xFF
                    writes[sym, cols[ok]] += 1
    assert (writes == 1).all()  # every output symbol written once, by the stores only
    return out


def test_source_constants():
    """The layout the model reads from the source, the routing of every
    expansion's dot refold at w=8 (and the lane-width ones at w=16, shift
    and shift_raw at w=4) to the dot kernel, and no generic kernel left
    in the source."""
    assert "RS_CALL_MMA(8, E, kDot)" in SOURCE and "RS_CALL_MMA(16, E, kDot)" in SOURCE
    assert "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32" in SOURCE
    assert "const uint32_t keep = 0x02010201u << (2 * (W == 4 ? t & 1 : t));" in SOURCE
    assert "RS_CALL_MMA(4, E, kDot)" in SOURCE and "RS_PLANES_INSTANCES" not in SOURCE
    assert all(cuda_planes.is_dot_pair(e, "dot") and cuda_planes.kind(8, e, "dot") == "dot"
               for e in EXPANDS + ("nibble",))
    assert not cuda_planes.is_dot_pair("nibble", "none") and cuda_planes.is_dot_pair("shift", "dot", 16)
    assert cuda_planes.kind(16, "shift", "dot") == "w16" and not cuda_planes.is_dot_pair("cmp", "dot", 16)
    assert cuda_planes.is_dot_pair("shift", "dot", 4) and cuda_planes.kind(4, "shift", "dot") == "w4"


def test_fold_operator():
    """F's two fragments, read back as 32 x 8 tiles, take each depth of a
    pass to its symbol: one 1 a depth, 8 depths (the 8 bits) a symbol, and
    pass q to symbols 4q..4q+3."""
    F = cuda_planes.dot_fold_operator()
    assert F.shape == (2, 32, 2) and F.dtype == np.uint32
    for q in range(2):
        t = b_tile(F[q, :, 0], F[q, :, 1])
        assert (t.sum(axis=1) == 1).all()
        np.testing.assert_array_equal(t.sum(axis=0), np.where(np.arange(8) // 4 == q, 8, 0))


@pytest.mark.parametrize("p,k", [(1, 1), (4, 10), (3, 33), (10, 32)])
def test_operator_fragments(p, k):
    """The B fragments, read back as 32 x 8 tiles, are the sum kernel's
    scaled operator rows (n-tile nt: rows 8nt..8nt+7), chunk by chunk."""
    op = cuda_planes.sum_operator(_operands(p, k, 1, p * k)[0]).astype(np.int64)
    frags = cuda_planes.pack_b_fragments(op)
    for r16, c in np.ndindex(frags.shape[:2]):
        for h in range(2):
            got = b_tile(frags[r16, c, :, 2 * h], frags[r16, c, :, 2 * h + 1])
            np.testing.assert_array_equal(got, op[16 * r16 + 8 * h:16 * r16 + 8 * h + 8, 32 * c:32 * c + 32].T)


def test_move_is_lane_local():
    """The C fragment of the first product and the A fragment of the second
    put the same rows (columns of the data) in the same lane, so the second
    operand is built from each lane's own accumulators, 3 PRMT and one AND a
    register (16 instructions a m-block, no shuffle, movmatrix or shared
    memory): byte e of register 16h + 4t is output bit 2t + (e & 1) of
    n-tile 2h + e // 2, masked, for accumulators of any sign."""
    acc = np.random.default_rng(9).integers(-(1 << 31), 1 << 31, size=(4, 1, 16, 8))
    keep = np.uint32(0x02010201) << (2 * T).astype(np.uint32)
    got = a_tile(*second_operand(acc, keep), signed=False)[0]
    want = np.zeros((16, 32), dtype=np.int64)
    for h, t, e in np.ndindex(2, 4, 4):
        bit = 2 * t + (e & 1)
        want[:, 16 * h + 4 * t + e] = acc[2 * h + e // 2, 0, :, bit] & (1 << bit)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("k", [1, 3, 4, 5, 10, 33])
@pytest.mark.parametrize("expand", EXPANDS)
def test_model_matches_jax(expand, k):
    """The model equals the GF oracle and, for the JAX package's expansion
    names, gf_matmul_pallas(refold="dot") interpreted, at p = 1, 3, 4, 9
    (odd p and a second 8-symbol tile): ragged m over two blocks of 128
    columns, and m below one warp step."""
    gf = get_field(8)
    for p in (1, 3, 4, 9):
        for m in (203, 37):
            A, B = _operands(p, k, m, 100 * k + 10 * p + m)
            want = gf.matmul(A, B)
            if expand != "cmp" and m == 203:  # "cmp" is the sweep's name only
                np.testing.assert_array_equal(
                    np.asarray(gf_matmul_pallas(A, B, expand=expand, refold="dot", interpret=True)), want)
            np.testing.assert_array_equal(model(A, B, expand, tile=128), want, err_msg=f"p={p} m={m}")


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("name", sorted(SWEEP_BODIES))
def test_model_matches_sweep_body(name, pinned):
    """The model equals kernel_sweep's dot-refold body of the same
    formulation interpreted with make_fn's BlockSpecs, normal and pinned
    (every block reads block 0), over a ragged last block; so does the
    wrapper's plain version."""
    A, B = _operands(j_sweep.P, j_sweep.K, 600, 17 + len(name))
    want = _jax_sweep_body(name, A, B, 256, pinned)
    np.testing.assert_array_equal(model(A, B, SWEEP_BODIES[name], tile=256, pinned=pinned), want)
    got = cuda_planes.gf_matmul_planes(A, torch.from_numpy(B), SWEEP_BODIES[name], "dot", 256, pinned=pinned)
    np.testing.assert_array_equal(got.numpy(), want)


def _smem_edge(p: int) -> int:
    """The largest k whose operator and one step buffer a warp fit in a
    block's shared memory (the source's sum_smem with one stage)."""
    mtn = cuda_planes.sum_operator(np.zeros((p, 1), dtype=np.uint8)).shape[0] // 16

    def need(k):
        kc = -(-k // 4)
        return mtn * kc * 32 * 16 + 4 * 4 * kc * STEP

    k = 1
    while need(k + 1) <= 227 * 1024:
        k += 1
    return k


@pytest.mark.parametrize("expand", EXPANDS)
def test_model_at_the_shared_memory_edge(expand):
    """p = 16 (two 8-symbol tiles, four passes) at the largest k whose
    operator fits in shared memory, and p = 15 at k = 64."""
    k = _smem_edge(16)
    assert "constexpr int kMaxSmem = 227 * 1024;" in SOURCE
    for p, depth, m in ((16, k, 70), (15, 64, 100)):
        A, B = _operands(p, depth, m, depth + p)
        np.testing.assert_array_equal(model(A, B, expand, tile=64), get_field(8).matmul(A, B),
                                      err_msg=f"p={p} k={depth}")


@pytest.mark.parametrize("expand", EXPANDS)
def test_model_deep_and_pinned(expand):
    """p = 10, k = 32: three passes (the last one half padding) over two
    8-symbol tiles, eight depth chunks; pinned with tiles of 64 and 192
    columns (the last block ragged) repeats block 0's output."""
    A, B = _operands(10, 32, 500, 11)
    want = get_field(8).matmul(A, B)
    np.testing.assert_array_equal(model(A, B, expand, tile=128), want)
    for tile in (64, 192):
        np.testing.assert_array_equal(model(A, B, expand, tile=tile, pinned=True), want[:, np.arange(500) % tile])


@pytest.mark.parametrize("expand", EXPANDS)
@pytest.mark.parametrize("k", [4, 33])
def test_largest_sums_are_exact(expand, k):
    """Every data byte 0xFF and every coefficient the densest element: the
    largest first-product sum is below 2^31 and, for 0/1 (0/-1) planes,
    what the scaled operator predicts; the second product's sums stay below
    256 (asserted in the model) and the bytes are right."""
    elem, ones = _densest_element()
    A = np.full((4, k), elem, dtype=np.uint8)
    B = np.full((k, 200), 0xFF, dtype=np.uint8)
    trace = []
    np.testing.assert_array_equal(model(A, B, expand, trace=trace), get_field(8).matmul(A, B))
    top = max(int(np.abs(acc).max()) for acc in trace)
    assert top < INT32
    if expand != "shift_raw":
        assert top <= 128 * ones * k
