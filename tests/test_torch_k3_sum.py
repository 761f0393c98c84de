"""K3's sum refold for the four byte expansions (``ops/csrc/gf_planes.cu``,
``gf_planes_sum_kernel``), modelled in NumPy and held against the JAX
package.

The kernel runs only on the card (``chip_smoke.py`` holds it bit-exact
against its plain version there).  Here a NumPy model follows it register
by register: the host-packed A fragments of ``mma.m16n8k32`` (the operator
scaled by 2^s in four-symbol plane-word order, ``cuda_planes.sum_operator``),
each step's rows in the warp's shared-memory buffer (rows past k and
columns past m hold random bytes there, which must not change a stored
byte), each lane's 8-byte reads, the PRMT transposes, the plane words of
each expansion, the int32 mma sums, the refold's gather, mask and
xor-shuffles (as lane permutations) and the 8-byte stores, the only place a
lane writes.  The model's bytes must equal the JAX package's exactly
(tolerance 0): ``GaloisField.matmul``, ``gf_matmul_pallas(expand=...,
refold="sum", interpret=True)`` and ``kernel_sweep``'s bodies interpreted.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gpu_rscode_torch.ops import cuda_planes
from gpu_rscode_tpu.ops.gemm import expand_bitmatrix_jnp
from gpu_rscode_tpu.ops.gf import get_field
from gpu_rscode_tpu.ops.pallas_gemm import gf_matmul_pallas
from gpu_rscode_tpu.tools import kernel_sweep as j_sweep

LANES = 32
# The model reads the kernel's layout from its source, so the two cannot drift.
SOURCE = cuda_planes.SOURCES[0].read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


def _flag(name: str) -> bool:
    return re.search(rf"constexpr bool {name} = (true|false);", SOURCE).group(1) == "true"


WARPS = _const("kSumWarps")
GROUPS = _const("kSumGroups")
STAGES = _const("kSumStages")
W4_SINGLE = _flag("kW4Single")  # W=4: the sum and none kernels run a lone last m-tile alone
STEP = 8 * GROUPS  # columns a warp step (kSumStepCols)
IDX = np.arange(LANES)
G, T = IDX >> 2, IDX & 3
INT32 = 1 << 31
# (JAX sweep body, expansion) pairs whose refold is "sum".
SWEEP_BODIES = {"base": "shift", "cmp": "cmp", "sign": "sign", "signc": "sign"}


def byte_perm(x, y, sel):
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays; ``sel`` may be
    an array (one selector per lane)."""
    both = (np.asarray(y, dtype=np.uint64) << np.uint64(32)) | np.asarray(x, dtype=np.uint64)
    sel = np.asarray(sel, dtype=np.uint64)
    out = np.zeros(np.broadcast(both, sel).shape, dtype=np.uint64)
    for i in range(4):
        src = (sel >> np.uint64(4 * i)) & np.uint64(7)
        out |= ((both >> (np.uint64(8) * src)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def vcmpne4(x, y):
    """CUDA's ``__vcmpne4``: 0xFF in each byte where x and y differ."""
    x, y = np.asarray(x, dtype=np.uint32), np.asarray(y, dtype=np.uint32)
    out = np.zeros(np.broadcast(x, y).shape, dtype=np.uint32)
    for q in range(4):
        sh = np.uint32(8 * q)
        out |= np.where(((x >> sh) & 0xFF) != ((y >> sh) & 0xFF), np.uint32(0xFF) << sh, np.uint32(0))
    return out


def transpose4(x0, x1, x2, x3):
    """The kernel's ``transpose4``: 8 PRMT."""
    a, b = byte_perm(x0, x1, 0x5140), byte_perm(x2, x3, 0x5140)
    c, d = byte_perm(x0, x1, 0x7362), byte_perm(x2, x3, 0x7362)
    return [byte_perm(a, b, 0x5410), byte_perm(a, b, 0x7632), byte_perm(c, d, 0x5410), byte_perm(c, d, 0x7632)]


def plane_word(r, s, expand, exact=False, w=8):
    """The kernel's ``plane_word<EXPAND, EXACT, W>``: plane s (per lane) of
    the 4 symbols in word r; ``exact`` (the none kernel): JAX's values,
    shift_raw without the next byte's bits, but at w=16 (r: lo(2c),
    hi(2c), lo(2c + 1), hi(2c + 1)) a low byte keeps its high byte's bits
    (JAX's plane is the low byte of the 16-bit b >> s)."""
    s = np.asarray(s, dtype=np.uint32)
    bit = np.uint32(0x01010101) << s
    if expand == "shift_raw":
        if exact and w == 16:
            return (r >> s) & (np.uint32(0x00FF00FF) | ((np.uint32(0xFF) >> s) * np.uint32(0x01000100)))
        return (r >> s) & ((np.uint32(0xFF) >> s) * np.uint32(0x01010101)) if exact else r >> s
    if expand == "cmp":
        return vcmpne4(r & bit, 0) & np.uint32(0x01010101)
    if expand == "sign":
        return vcmpne4(r & bit, 0)
    return (r >> s) & np.uint32(0x01010101)


def prmt(x, y, sel):
    """PTX ``prmt.b32`` in its default mode on uint32 arrays: byte n is
    byte ``sel[4n+2:4n]`` of {y, x}, or, where ``sel`` bit 4n+3 is set, bit
    7 of that byte replicated (the nibble tables' sign rule); ``sel[31:16]``
    is not read."""
    both = (np.asarray(y, dtype=np.uint64) << np.uint64(32)) | np.asarray(x, dtype=np.uint64)
    sel = np.asarray(sel, dtype=np.uint64)
    out = np.zeros(np.broadcast(both, sel).shape, dtype=np.uint64)
    for n in range(4):
        nib = (sel >> np.uint64(4 * n)) & np.uint64(0xF)
        byte = (both >> (np.uint64(8) * (nib & np.uint64(7)))) & np.uint64(0xFF)
        byte = np.where(nib & np.uint64(8), np.where(byte & np.uint64(0x80), np.uint64(0xFF), np.uint64(0)), byte)
        out |= byte << np.uint64(8 * n)
    return out.astype(np.uint32)


# nibble: lane t's two PRMT tables (the kernel's e1, e8).
E1, E8 = np.uint32(1) << (8 * T).astype(np.uint32), np.uint32(0x80) << (8 * T).astype(np.uint32)


def step_words(words: np.ndarray, c: int, w: int = 8) -> np.ndarray:
    """The kernel's ``step_words<W>`` for word chunk c of every step:
    (GROUPS, S, 32) words, r[j] of lane (g, t) column 8g + j, byte q
    byte-symbol 4c + q.  w=4 and 8: the LDS.64 of rows 4c..4c+3 and two
    PRMT transposes; w=16: the LDS.128 of rows 2c and 2c + 1 and 8 PRMT
    splitting each column's low and high bytes."""
    if w == 16:
        x, y = words[:, 2 * c][:, G], words[:, 2 * c + 1][:, G]  # (S, 32, 4)
        return np.stack([byte_perm(x[..., u], y[..., u], sel) for u in range(4) for sel in (0x5410, 0x7632)])
    x = [words[:, 4 * c + q][:, G] for q in range(4)]  # LDS.64 of row 4c + q: (S, 32, half)
    return np.stack(transpose4(*(xq[..., 0] for xq in x)) + transpose4(*(xq[..., 1] for xq in x)))


def chunk_planes(words: np.ndarray, k: int, expand: str, w: int = 8, exact: bool = False):
    """The kernels' depth-chunk loop over one step's words (S, rows, g,
    words): yields (chunk c, pw0, pw1), pw0 and pw1 the plane registers
    (GROUPS, S, 32) at depths 4t.. and 16 + 4t.. of each column group.
    Byte expansions: chunk c is byte-symbols 4c..4c+3 (k of them), planes
    t and 4 + t.  w=4 (k symbols): chunk c is plane t of the words of rows
    8c..8c+3 (pw0) and 8c + 4..8c + 7 (pw1, zero if row 8c + 4 is past k).
    nibble: rows 4b..4b+3 are chunks 4b + 2h' + e (h' = 1 only if row
    4b + 2 < k), planes 8e + t and 8e + 4 + t of the low (h' = 0) or high
    16 bits of each transposed word, made by PRMT from lane t's tables;
    ``exact`` ANDs e = 1's planes to 0/1."""
    if w == 4:
        for c in range(-(-k // 8)):
            pw0 = plane_word(step_words(words, 2 * c, 4), T, expand, exact)
            pw1 = (plane_word(step_words(words, 2 * c + 1, 4), T, expand, exact) if 8 * c + 4 < k
                   else np.zeros_like(pw0))
            yield c, pw0, pw1
        return
    for b in range(-(-k // 4)):
        r = step_words(words, b, w)
        if expand != "nibble":
            yield b, plane_word(r, T, expand, exact, w), plane_word(r, T + 4, expand, exact, w)
            continue
        for h2 in range(2):
            if h2 and 4 * b + 2 >= k:
                break
            sel = r >> np.uint32(16) if h2 else r
            for e in range(2):
                tab = E8 if e else E1
                keep = np.uint32(0x01010101 if exact and e else 0xFFFFFFFF)
                yield 4 * b + 2 * h2 + e, prmt(tab, 0, sel) & keep, prmt(0, tab, sel) & keep


def operator(A: np.ndarray, expand: str, w: int = 8, scaled: bool = True) -> np.ndarray:
    """The sum, dot and none kernels' host-packed operator for ``expand``."""
    if expand == "nibble":
        return cuda_planes.nibble_operator(A, scaled=scaled)
    return cuda_planes.sum_operator(A, w, scaled=scaled)


def step_buffers(B: np.ndarray, steps: list, p: int, direct: bool = False, w: int = 8):
    """Each warp step's rows as the lanes read them, as words (S, rows, g,
    words a lane: 2 at w=4 and 8, 4 at w=16 where B is uint16): from the
    ring (whole chunks of rows: 8 at w=4, 4 at w=8, 2 at w=16), rows < k
    at the read columns below m and the rest whatever the shared memory
    held; under the direct route zero past k and past m.  And the output
    as torch.empty leaves it."""
    k, m = B.shape
    nb = B.dtype.itemsize
    rng = np.random.default_rng(k * 7919 + m)
    rows = 2 * -(-k // 2) if nb == 2 else 8 * -(-k // 8) if w == 4 else 4 * -(-k // 4)
    buf = rng.integers(0, 256, size=(len(steps), rows, STEP * nb), dtype=np.uint8)
    if direct:
        buf[:] = 0
    for i, (_, rcol) in enumerate(steps):
        n = max(0, min(STEP, m - rcol))
        buf[i, :k, :n * nb] = np.ascontiguousarray(B[:, rcol:rcol + n]).view(np.uint8).reshape(k, n * nb)
    words = buf.reshape(len(steps), rows, 8, 2 * nb, 4).copy().view("<u4")[..., 0]
    out = rng.integers(0, 1 << (8 * nb), size=(p, m)).astype(B.dtype)
    return words, out


def unpack_a_tiles(frags: np.ndarray) -> np.ndarray:
    """(mt, kc, 32, 4) uint32 A fragments -> (mt, kc, 16, 32) int64 tiles, in
    the m16n8k32 8-bit A layout: lane g*4 + t holds rows g (regs 0, 2) and
    g + 8 (regs 1, 3) at depth t*4.. (regs 0, 1) and 16 + t*4.. (regs 2, 3)."""
    mt, kc = frags.shape[:2]
    b = np.ascontiguousarray(frags).view(np.uint8).reshape(mt, kc, 8, 4, 2, 2, 4)  # g t kh h q
    return b.transpose(0, 1, 5, 2, 4, 3, 6).reshape(mt, kc, 16, 32).astype(np.int64)


def b_tile(b0: np.ndarray, b1: np.ndarray, signed: bool) -> np.ndarray:
    """Per-lane B registers (S, 32) of one group -> (S, 32, 8) tiles: depth
    t*4 + q of column g is byte q of b0 in lane (g, t), depth 16 + t*4 + q
    byte q of b1."""
    S = b0.shape[0]
    regs = np.stack([b0, b1], axis=1).astype(np.uint32)  # (S, kh, 32)
    by = np.ascontiguousarray(regs).view(np.uint8).reshape(S, 2, 8, 4, 4)  # S kh g t q
    tile = by.transpose(0, 1, 3, 4, 2).reshape(S, 32, 8).astype(np.int64)
    return np.where(tile >= 128, tile - 256, tile) if signed else tile


def warp_steps(m: int, tile: int, pinned: bool):
    """(write column, read column) of every warp step, in the kernel's block
    and warp loops."""
    steps = []
    for blk0 in range(0, m, tile):
        span = min(m, blk0 + tile) - blk0
        rd0 = 0 if pinned else blk0
        for warp in range(WARPS):
            for col in range(warp * STEP, span, WARPS * STEP):
                steps.append((blk0 + col, rd0 + col))
    return sorted(steps)


def pass_pair(mg: int, p: int, w: int) -> bool:
    """The kernels' ``pass_pair<W>``: whether the pass over m-tiles mg and
    mg + 1 covers both (at w=4 the last of an odd count of m-tiles of the
    p*4 rows runs alone)."""
    return w != 4 or not W4_SINGLE or mg + 1 < -(-p * w // 16)


def first_product(A: np.ndarray, B: np.ndarray, expand: str, tile, pinned: bool, w: int = 8,
                  direct: bool = False, exact: bool = False, trace: list | None = None):
    """The sum and none kernels' first product: yields per pass (mg, acc,
    col0, out), acc (NT, GROUPS, S, 16, 8) the int32 sums of m-tiles mg and
    mg + 1 (NT = 2) or mg alone (NT = 1, :func:`pass_pair`) for every warp
    step (column col0 of the step), and the output array as torch.empty
    leaves it (shared by every pass).  The operator is unscaled for
    ``exact`` (the none kernel, JAX's plane values)."""
    p, k = A.shape
    m = B.shape[1]
    tile = cuda_planes.tile_cols(tile, m)
    assert tile % STEP == 0
    op = operator(A, expand, w, scaled=not exact)
    mtn, kc = op.shape[0] // 16, op.shape[1] // 32
    assert mtn % 2 == 0  # m-tiles in pairs: a pass has no branch
    a = unpack_a_tiles(cuda_planes.pack_fragments(op, 16 * mtn, 32 * kc))
    steps = warp_steps(m, tile, pinned)
    assert [c for c, _ in steps] == list(range(0, m, STEP))  # every step once, blocks ragged or not
    words, out = step_buffers(B, steps, p, direct, w)
    col0 = np.array([c for c, _ in steps])
    kb = k if w == 4 else k * w // 8  # rows of the step: symbols (w=4) or byte-symbols
    chunks = list(chunk_planes(words, kb, expand, w, exact))  # the same registers in every pass
    assert sorted(c for c, _, _ in chunks) == list(range(kc))  # every operator chunk once
    signed = expand == "sign" or (exact and expand == "shift_raw")
    for mg in range(0, mtn, 2):
        nt = 2 if pass_pair(mg, p, w) else 1
        acc = np.zeros((nt, GROUPS, len(steps), 16, 8), dtype=np.int64)
        for c, b0, b1 in chunks:
            bt = b_tile(b0.reshape(-1, LANES), b1.reshape(-1, LANES), signed).reshape(GROUPS, len(steps), 32, 8)
            for u in range(nt):
                acc[u] += np.matmul(a[mg + u, c], bt)
                if trace is not None:
                    trace.append(acc[u].copy())
        assert np.abs(acc).max(initial=0) < INT32
        yield mg, acc, col0, out


def sum_refold(acc: np.ndarray, w: int = 8) -> list:
    """The refold's gather, mask and xor-shuffles of one m-tile's sums
    (GROUPS, S, 16, 8): the 8 group words w[j] (S, 32), byte b of w[j] bit
    g's OR over g of byte-symbol 2mt + b / 2 at column 16t + 8(b & 1) + j.
    w=4: bit g & 3's OR over g ^ 1 and g ^ 2 (two shuffles) of symbol
    4mt + g / 4 + 2(b / 2)."""
    keep = np.uint32(0x01010101) << (G & 3 if w == 4 else G).astype(np.uint32)
    acc32 = acc.astype(np.uint32)  # two's complement, as the registers hold it
    words = []
    for j in range(GROUPS):
        c0, c1 = acc32[j][:, G, 2 * T], acc32[j][:, G, 2 * T + 1]
        c2, c3 = acc32[j][:, G + 8, 2 * T], acc32[j][:, G + 8, 2 * T + 1]
        v = byte_perm(byte_perm(c0, c1, 0x0040), byte_perm(c2, c3, 0x4000), 0x7610) & keep
        v |= v[:, IDX ^ 4]
        v |= v[:, IDX ^ 8]
        if w != 4:
            v |= v[:, IDX ^ 16]
        words.append(v)
    return words


def model(A: np.ndarray, B: np.ndarray, expand: str, tile: int | None = None, pinned: bool = False,
          trace: list | None = None, direct: bool = False, w: int | None = None) -> np.ndarray:
    """NumPy model of gf_planes_sum_kernel<W, expand>: (p, k) coefficients,
    (k, m) uint8 (W=4, 8) or uint16 (W=16) -> (p, m) of B's type.  ``w``:
    16 for uint16, else 8 unless given (4).  ``tile`` as the wrapper rounds
    it; ``direct``: the rows read from device memory (the w=4 and 16
    kernels past their shared-memory edge).  ``trace`` collects every int32
    accumulator after each depth chunk."""
    p = A.shape[0]
    m = B.shape[1]
    w16 = B.dtype == np.uint16
    wd = 16 if w16 else w or 8
    assert not direct or wd != 8  # w=8's sum kernel always stages its rows
    out = None
    writes = np.zeros((p, m), dtype=np.int64)
    pick = (G & 3) | (((G & 3) + 4) << 4)
    pick16 = 0x6420 + 0x1111 * (G & 1)
    for mg, acc, col0, out in first_product(A, B, expand, tile, pinned, wd, direct, trace=trace):
        for u in range(len(acc)):
            w = sum_refold(acc[u], wd)
            if w16:  # m-tile mg + u is one symbol: lanes g < 2 store 8 columns
                words = [byte_perm(w[2 * i], w[2 * i + 1], pick16) for i in range(4)]
                for lane in range(LANES):
                    g, t = lane >> 2, lane & 3
                    sym = mg + u
                    if g >= 2 or sym >= p:
                        continue
                    for e in range(8):
                        cols = col0 + 16 * t + 8 * g + e
                        ok = cols < m
                        out[sym, cols[ok]] = (words[e // 2][ok, lane] >> np.uint32(16 * (e & 1))) & 0xFFFF
                        writes[sym, cols[ok]] += 1
                continue
            lo = byte_perm(byte_perm(w[0], w[1], pick), byte_perm(w[2], w[3], pick), 0x5410)
            hi = byte_perm(byte_perm(w[4], w[5], pick), byte_perm(w[6], w[7], pick), 0x5410)
            for lane in range(LANES):
                g, t = lane >> 2, lane & 3
                if wd == 4:  # every lane: byte g & 3 is symbol 4mt + g / 4 + 2((g / 2) & 1)
                    sym = 4 * (mg + u) + (g >> 2) + 2 * ((g >> 1) & 1)
                else:
                    sym = 2 * (mg + u) + (g >> 1)
                if (wd != 4 and g >= 4) or sym >= p:
                    continue
                for e in range(8):
                    cols = col0 + 16 * t + 8 * (g & 1) + e
                    ok = cols < m
                    word = lo[:, lane] if e < 4 else hi[:, lane]
                    out[sym, cols[ok]] = (word[ok] >> np.uint32(8 * (e & 3))) & 0xFF
                    writes[sym, cols[ok]] += 1
    assert (writes == 1).all()  # every output symbol written once, by the stores only
    return out


def _operands(p, k, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(p, k), dtype=np.uint8),
            rng.integers(0, 256, size=(k, m), dtype=np.uint8))


def _jax_sweep_body(name, A, B, tile, pinned=False):
    """``kernel_sweep.make_fn``'s pallas_call (k=10, p=4), interpreted."""
    p, k, w = j_sweep.P, j_sweep.K, j_sweep.W
    m = B.shape[1]
    op = expand_bitmatrix_jnp(jnp.asarray(A), w).astype(jnp.int8)
    b_map = (lambda i: (0, 0)) if pinned else (lambda i: (0, i))
    return np.asarray(pl.pallas_call(
        functools.partial(j_sweep.BODIES[name], w=w, k=k, p=p),
        out_shape=jax.ShapeDtypeStruct((p, m), jnp.uint8),
        grid=(pl.cdiv(m, tile),),
        in_specs=[pl.BlockSpec((p * w, k * w), lambda i: (0, 0)), pl.BlockSpec((k, tile), b_map)],
        out_specs=pl.BlockSpec((p, tile), lambda i: (0, i)),
        interpret=True,
    )(op, jnp.asarray(B)))


def _densest_element() -> tuple[int, int]:
    """The GF(2^8) element whose 8x8 bit matrix has the most ones in one row,
    and that count."""
    rows = get_field(8).bitmats.sum(axis=2).max(axis=1)
    return int(rows.argmax()), int(rows.max())


def test_source_constants():
    """The layout the model reads from the source, the wrapper's tile
    granularity, the mma of each expansion, and the pairs the kernel runs:
    every expansion's sum refold at w=8 (and the lane-width ones at w=16,
    test_torch_k3_w16.py, and shift and shift_raw at w=4,
    test_torch_k3_w4.py); no generic kernel is left in the source."""
    assert (WARPS, GROUPS, STAGES) == (4, 8, 3)
    assert "constexpr int kSumStepCols = 8 * kSumGroups;" in SOURCE
    assert cuda_planes.TILE_STEP == STEP
    assert "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32" in SOURCE
    assert "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32" in SOURCE
    assert "#define RS_SUM_EXPANDS(X) X(kShift) X(kShiftRaw) X(kCmp) X(kSign) X(kNibble)" in SOURCE
    assert "gf_planes_kernel" not in SOURCE and "RS_PLANES_INSTANCES" not in SOURCE
    assert "RS_CALL_MMA(8, E, kSum)" in SOURCE and "RS_SUM_EXPANDS(RS_CALL_W8)" in SOURCE
    assert set(cuda_planes.SUM_EXPANDS) == set(cuda_planes.EXPANDS)
    assert all(cuda_planes.is_sum_pair(e, "sum") for e in cuda_planes.SUM_EXPANDS)
    assert not cuda_planes.is_sum_pair("nibble", "none") and not cuda_planes.is_sum_pair("shift", "dot")


@pytest.mark.parametrize("p,k", [(1, 1), (4, 10), (3, 33), (10, 32)])
def test_operator_is_scaled_and_permuted(p, k):
    """The host-packed A fragments, read back in the mma layout, are the JAX
    package's expand_bitmatrix with row i*8 + s times 2^s, its columns in
    four-symbol plane-word order, zero-padded to whole pairs of m-tiles and
    whole chunks."""
    A, _ = _operands(p, k, 1, p * k)
    mtn, kc = 2 * -(-p // 4), -(-k // 4)
    tiles = unpack_a_tiles(cuda_planes.pack_fragments(cuda_planes.sum_operator(A), 16 * mtn, 32 * kc))
    full = tiles.transpose(0, 2, 1, 3).reshape(16 * mtn, 32 * kc)
    bits = np.asarray(expand_bitmatrix_jnp(A.astype(np.int32), 8)).astype(np.int64)
    want = np.zeros_like(full)
    for i in range(k):
        for s in range(8):
            want[:p * 8, 32 * (i // 4) + 16 * (s // 4) + 4 * (s % 4) + i % 4] = bits[:, i * 8 + s] << (np.arange(p * 8) % 8)
    np.testing.assert_array_equal(full, want)
    assert full.max() <= 128


@pytest.mark.parametrize("expand", ["shift", "shift_raw", "cmp", "sign"])
def test_plane_words(expand):
    """Every byte value in every position of a word and every plane: the
    plane word's byte q is, seen as the mma's u8 (s8 for sign), bit s of
    byte q plus even multiples (shift_raw's higher bits), or its negation
    (sign)."""
    v = np.arange(256, dtype=np.uint32)
    r = v | ((v ^ 0x5A) << 8) | ((v ^ 0xC3) << 16) | ((255 - v) << 24)
    for s in range(8):
        pw = plane_word(r, np.uint32(s), expand)
        for q, byte in enumerate((v, v ^ 0x5A, v ^ 0xC3, 255 - v)):
            got = ((pw >> np.uint32(8 * q)) & 0xFF).astype(np.int64)
            bit = (byte >> s) & 1
            if expand == "sign":
                np.testing.assert_array_equal(np.where(got >= 128, got - 256, got), -bit.astype(np.int64))
            elif expand == "shift_raw":
                np.testing.assert_array_equal(got & 1, bit)
            else:
                np.testing.assert_array_equal(got, bit)


def test_transpose4():
    """The 8-PRMT transpose: byte q of output word j is byte j of input
    word q."""
    x = np.random.default_rng(3).integers(0, 1 << 32, size=(4, 64), dtype=np.uint64).astype(np.uint32)
    r = transpose4(*x)
    for j in range(4):
        for q in range(4):
            np.testing.assert_array_equal((r[j] >> np.uint32(8 * q)) & 0xFF, (x[q] >> np.uint32(8 * j)) & 0xFF)


@pytest.mark.parametrize("k", [1, 3, 4, 5, 10, 32, 33])
@pytest.mark.parametrize("expand", ["shift", "shift_raw", "cmp", "sign"])
def test_model_matches_jax(expand, k):
    """The model equals the GF oracle and, for the JAX package's expansion
    names, gf_matmul_pallas(refold="sum") interpreted, at p = 1, 2, 4, 10:
    ragged m (not a multiple of 4, 8 or 64) over two blocks of 128 columns,
    and m below one warp step."""
    gf = get_field(8)
    for p in (1, 2, 4, 10):
        for m in (203, 37):
            A, B = _operands(p, k, m, 100 * k + 10 * p + m)
            want = gf.matmul(A, B)
            if expand != "cmp":  # "cmp" is the sweep's name only
                np.testing.assert_array_equal(
                    np.asarray(gf_matmul_pallas(A, B, expand=expand, refold="sum", interpret=True)), want)
            np.testing.assert_array_equal(model(A, B, expand, tile=128), want, err_msg=f"p={p} m={m}")


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("name", sorted(SWEEP_BODIES))
def test_model_matches_sweep_body(name, pinned):
    """The model equals kernel_sweep's body of the same formulation
    interpreted with make_fn's BlockSpecs, normal and pinned (every block
    reads block 0), over a ragged last block."""
    A, B = _operands(j_sweep.P, j_sweep.K, 600, 7 + len(name))
    want = _jax_sweep_body(name, A, B, 256, pinned)
    np.testing.assert_array_equal(model(A, B, SWEEP_BODIES[name], tile=256, pinned=pinned), want)
    got = cuda_planes.gf_matmul_planes(A, torch.from_numpy(B), SWEEP_BODIES[name], "sum", 256, pinned=pinned)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("expand", ["shift", "shift_raw", "cmp", "sign"])
def test_model_deep_and_pinned(expand):
    """p = 10, k = 32: three passes over pairs of m-tiles (the last one
    half padding), eight depth chunks; pinned with tiles of 64 and 192 columns
    (the last block ragged) repeats block 0's output."""
    A, B = _operands(10, 32, 500, 11)
    want = get_field(8).matmul(A, B)
    np.testing.assert_array_equal(model(A, B, expand, tile=128), want)
    for tile in (64, 192):
        np.testing.assert_array_equal(model(A, B, expand, tile=tile, pinned=True), want[:, np.arange(500) % tile])


@pytest.mark.parametrize("expand", ["shift", "shift_raw", "cmp", "sign"])
@pytest.mark.parametrize("k", [4, 33])
def test_largest_sums_are_exact(expand, k):
    """Every data byte 0xFF and every coefficient the densest element: the
    densest rows sum 2^s * plane over every selected depth.  The largest
    accumulator is what the sum predicts and below 2^31, and the bytes are
    right."""
    elem, ones = _densest_element()
    A = np.full((4, k), elem, dtype=np.uint8)
    B = np.full((k, 200), 0xFF, dtype=np.uint8)
    trace = []
    np.testing.assert_array_equal(model(A, B, expand, trace=trace), get_field(8).matmul(A, B))
    top = max(int(np.abs(acc).max()) for acc in trace)
    assert top < INT32
    if expand != "shift_raw":  # planes are 0/1 (or 0/-1): sum = 2^s * ones * k at most
        bits = np.asarray(expand_bitmatrix_jnp(A.astype(np.int32), 8)).astype(np.int64)
        assert top == max(int(bits[r].sum()) << (r % 8) for r in range(bits.shape[0]))
        assert top <= 128 * ones * k


def test_plain_version_pinned_uses_the_wrapper_tile():
    """The wrapper's tile rounds to the 64-column step; the plain version's
    pinned output repeats block 0 at that width, as the model does."""
    A, B = _operands(4, 10, 300, 12)
    want = model(A, B, "shift", tile=100, pinned=True)
    np.testing.assert_array_equal(want, get_field(8).matmul(A, B)[:, np.arange(300) % 128])
    got = cuda_planes.gf_matmul_planes(A, torch.from_numpy(B), "shift", "sum", 100, pinned=True)
    np.testing.assert_array_equal(got.numpy(), want)
