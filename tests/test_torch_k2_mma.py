"""K2, the packed two-column GF(2^8) GEMM on the fp16 tensor cores
(``ops/csrc/gf_pack2.cu``, ``gf_pack2_kernel``), modelled in NumPy and held
against the JAX package.

The kernel runs only on the card (``chip_smoke.py`` holds it bit-exact
against its plain version there).  Here a NumPy model follows it register by
register: the A fragments of ``mma.m16n8k16`` from the host-packed operator
(``cuda_pack2.pack_fragments``), each lane's 16-byte read of 8 uint16 lanes
(past row k and past the last lane the kernel copies nothing, so the model
reads random bits there, which must not change a stored byte),
the B fragments built with the ``0x6400`` fp16 encoding by the kernel's
shifts, masks and byte permutes, f32 accumulation over each 30-symbol depth
slice, the refold (``acc + 2^23``, the parity bits shifted to bit g, the
three xor-shuffles), the XOR of the slices and the permuted 16-byte stores.
The model's bytes must equal the JAX package's GEMM (``GaloisField.matmul``,
and ``gf_matmul_pallas(expand="pack2")`` interpreted) exactly: tolerance 0.
"""

import re

import numpy as np
import pytest

from gpu_rscode_torch.ops import cuda_pack2
from gpu_rscode_tpu.ops.gemm import expand_bitmatrix_jnp
from gpu_rscode_tpu.ops.gf import get_field as j_get_field
from gpu_rscode_tpu.ops.pallas_gemm import gf_matmul_pallas

LANES = 32
# The model reads the kernel's layout from its source, so the two cannot drift.
SOURCE = cuda_pack2.SOURCES[0].read_text()


def _const(name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


WARPS = _const("kWarps")
GROUPS = _const("kGroups")
SLICE = _const("kSlice")
WARP_LANES = 8 * GROUPS  # uint16 lanes a warp step (kWarpLanes)
SLICE_STEPS = SLICE // 2
F32_EXACT = 1 << 23
IDX = np.arange(LANES)
G, T = IDX >> 2, IDX & 3


def byte_perm(x, y, sel: int):
    """CUDA's ``__byte_perm(x, y, sel)`` on uint32 arrays."""
    both = (np.asarray(y, dtype=np.uint64) << np.uint64(32)) | np.asarray(x, dtype=np.uint64)
    out = np.zeros(np.broadcast(x, y).shape, dtype=np.uint64)
    for i in range(4):
        src = (sel >> (4 * i)) & 7
        out |= ((both >> np.uint64(8 * src)) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def unpack_a_tiles(frags: np.ndarray) -> np.ndarray:
    """(mt, ks, 32, 4) uint32 A fragments -> (mt, ks, 16, 16) float32 tiles,
    reading each lane's registers as the m16n8k16 A layout defines them."""
    mt, ks = frags.shape[:2]
    h16 = np.ascontiguousarray(frags).view(np.uint16).reshape(mt, ks, 8, 4, 2, 2, 2)  # g t kh h q
    tiles = h16.transpose(0, 1, 5, 2, 4, 3, 6).reshape(mt, ks, 16, 16)  # row h*8+g, depth kh*8+t*2+q
    return tiles.view(np.float16).astype(np.float32)


def load_words(lanes16: np.ndarray, row: int, steps: int) -> np.ndarray:
    """Each lane's read of data row ``row``: (steps, 32, GROUPS / 2)
    uint32, lane g holding uint16 lanes GROUPS*g .. GROUPS*g + GROUPS - 1
    of its warp step."""
    v = lanes16[row].reshape(steps, 8, GROUPS)[:, G]  # (steps, 32, 4)
    return (v[..., 0::2] | (v[..., 1::2] << 16)).astype(np.uint32)  # (steps, 32, GROUPS / 2)


def planes2(W: np.ndarray, s: np.ndarray):
    """The kernel's ``planes2``: planes s, s + 1 of W's two lanes as fp16."""
    x = ((W >> s) & 0x01010101) | 0x64006400
    y = ((W >> (s + 1)) & 0x01010101) | 0x64006400
    return byte_perm(x, y, 0x5410), byte_perm(x, y, 0x7632)


def b_registers(words: np.ndarray) -> np.ndarray:
    """(steps, 32, GROUPS / 2) loaded words -> (steps, 32, GROUPS) B
    registers."""
    s = (2 * T)[None, :]
    regs = []
    for w in range(GROUPS // 2):
        lo, hi = planes2(words[..., w].astype(np.uint32), s.astype(np.uint32))
        regs += [lo, hi]
    return np.stack(regs, axis=-1)


def b_tiles(b0: np.ndarray, b1: np.ndarray) -> np.ndarray:
    """B registers of both symbols -> (steps, GROUPS, 16, 8) float32: depth
    row kh*8 + t*2 + q of column n is half q of b_kh in lane (g = n, t)."""
    steps = b0.shape[0]
    regs = np.stack([b0, b1]).astype(np.uint32)  # (kh, steps, 32, G)
    halves = np.ascontiguousarray(regs).view(np.uint16).reshape(2, steps, 8, 4, GROUPS, 2)  # kh s g t j q
    tiles = halves.transpose(1, 4, 0, 3, 5, 2).reshape(steps, GROUPS, 16, 8)
    return tiles.view(np.float16).astype(np.float32)


def int_bits(acc: np.ndarray) -> np.ndarray:
    return (acc.astype(np.float32) + np.float32(F32_EXACT)).view(np.uint32)


def refold(acc: np.ndarray) -> np.ndarray:
    """(steps, GROUPS, 16, 8) f32 accumulators -> (steps, 32, GROUPS) words:
    lanes g < 4 hold symbol 2mt's lanes n = 2t, 2t + 1, lanes g >= 4 the
    same of symbol 2mt + 1."""
    bits = int_bits(acc)
    c = [bits[:, :, G + 8 * h, 2 * T + q] for h in (0, 1) for q in (0, 1)]  # (steps, G, 32)
    w0 = (byte_perm(c[0], c[1], 0x5410) & 0x01010101) << G.astype(np.uint32)
    w1 = (byte_perm(c[2], c[3], 0x5410) & 0x01010101) << G.astype(np.uint32)
    upper = G >= 4
    v = np.where(upper, w1, w0) | np.where(upper, w0, w1)[..., IDX ^ 16]
    v |= v[..., IDX ^ 4]
    v |= v[..., IDX ^ 8]
    return v.transpose(0, 2, 1)


def warp_steps(m2: int, tile: int) -> list[int]:
    """The first uint16 lane of every warp step, in the kernel's block and
    warp loops."""
    per_block = tile // 2
    bases = []
    for blk0 in range(0, m2, per_block):
        blk1 = min(m2, blk0 + per_block)
        for warp in range(WARPS):
            bases += range(blk0 + warp * WARP_LANES, blk1, WARPS * WARP_LANES)
    return sorted(bases)


def model(A: np.ndarray, B: np.ndarray, tile: int | None = None, trace: list | None = None) -> np.ndarray:
    """NumPy model of gf_pack2_kernel: (p, k) coefficients, (k, m) uint8 ->
    (p, m) uint8.  ``trace`` collects every f32 accumulator after each
    k-step."""
    p, k = A.shape
    m = B.shape[1]
    if m % 2:
        B = np.pad(B, ((0, 0), (0, 1)))
    m2 = B.shape[1] // 2
    bases = warp_steps(m2, cuda_pack2.tile_cols(tile, m))
    assert bases == list(range(0, m2, WARP_LANES))  # every step once, blocks ragged or not
    steps = len(bases)
    # Shared memory past the last lane, and the row past an odd k, hold
    # whatever was there: random bits here.
    ks = -(-k // 2)
    lanes16 = np.random.default_rng(k * 7919 + m).integers(0, 1 << 16, size=(2 * ks, steps * WARP_LANES),
                                                          dtype=np.uint32)
    lanes16[:k, :m2] = B[:, 0::2].astype(np.uint32) | (B[:, 1::2].astype(np.uint32) << 8)
    a = unpack_a_tiles(cuda_pack2.pack_fragments(A))
    mt, ks = a.shape[:2]
    out16 = np.zeros((p, steps * WARP_LANES), dtype=np.uint32)
    for t_m in range(mt):
        res = np.zeros((steps, LANES, GROUPS), dtype=np.uint32)
        for c0 in range(0, ks, SLICE_STEPS):
            acc = np.zeros((steps, GROUPS, 16, 8), dtype=np.float32)
            for c in range(c0, min(ks, c0 + SLICE_STEPS)):
                b0 = b_registers(load_words(lanes16, 2 * c, steps))
                b1 = b_registers(load_words(lanes16, 2 * c + 1, steps))
                acc = acc + np.matmul(a[t_m, c], b_tiles(b0, b1), dtype=np.float32)
                if trace is not None:
                    trace.append(acc.copy())
            res ^= refold(acc)
        for h in (0, 1):
            sym = 2 * t_m + h
            if sym >= p:
                continue
            for t in range(4):
                word = res[:, 16 * h + t]  # lane (g = 4h, t): (steps, GROUPS)
                o = [byte_perm(word[:, 2 * q], word[:, 2 * q + 1], sel)
                     for sel in (0x5410, 0x7632) for q in range(GROUPS // 2)]
                for q in range(2 * GROUPS):
                    out16[sym, np.arange(steps) * WARP_LANES + 2 * GROUPS * t + q] = (o[q // 2] >> (16 * (q & 1))) & 0xFFFF
    out = np.empty((p, 2 * m2), dtype=np.uint8)
    out[:, 0::2], out[:, 1::2] = out16[:, :m2] & 0xFF, out16[:, :m2] >> 8
    return out[:, :m]


def _operands(p, k, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(p, k), dtype=np.uint8),
            rng.integers(0, 256, size=(k, m), dtype=np.uint8))


def test_source_constants():
    """The layout the model reads from the source, and the wrapper's column
    granularity: one warp step of 128 columns."""
    assert (WARPS, GROUPS, SLICE) == (4, 8, 30)
    assert SLICE % 2 == 0 and SLICE * 8 < 256
    assert cuda_pack2.TILE_STEP == 2 * WARP_LANES
    assert "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32" in SOURCE


@pytest.mark.parametrize("m", [1639, 1640])
@pytest.mark.parametrize("k", [1, 10, 29, 30, 31, 32, 60, 61, 62, 63, 128])
def test_model_matches_jax(k, m):
    """The model equals the GF oracle and the JAX pack2 kernel interpreted,
    at slice edges (29-32, 60-63), k = 128, odd and even m, with a ragged
    last block (820 uint16 lanes end inside a 2048-column block and inside
    a 64-lane warp step)."""
    p = 4 if k < 60 else 3
    A, B = _operands(p, k, m, 1000 + k + m)
    want = j_get_field(8).matmul(A, B)
    np.testing.assert_array_equal(np.asarray(gf_matmul_pallas(A, B, expand="pack2", interpret=True)), want)
    np.testing.assert_array_equal(model(A, B), want)


@pytest.mark.parametrize("tile", [64, 100, 1000, 4097])
def test_model_ragged_blocks(tile):
    """Tiles that are not a multiple of the 128-column step round up, and the
    last block is ragged: every warp step is taken once."""
    A, B = _operands(10, 10, 4097, tile)
    assert cuda_pack2.tile_cols(tile, 4097) % cuda_pack2.TILE_STEP == 0
    np.testing.assert_array_equal(model(A, B, tile=tile), j_get_field(8).matmul(A, B))


@pytest.mark.parametrize("p,k", [(1, 1), (4, 10), (3, 31), (10, 62)])
def test_fragments_match_jax_operator(p, k):
    """The host-packed A fragments, read back in the mma layout, are the JAX
    package's expand_bitmatrix, zero-padded to whole m-tiles and k-steps."""
    A, _ = _operands(p, k, 1, p * k)
    tiles = unpack_a_tiles(cuda_pack2.pack_fragments(A))
    mt, ks = tiles.shape[:2]
    assert (mt, ks) == (-(-p // 2), -(-k // 2))
    full = tiles.transpose(0, 2, 1, 3).reshape(16 * mt, 16 * ks)
    want = np.zeros_like(full)
    want[:p * 8, :k * 8] = np.asarray(expand_bitmatrix_jnp(A.astype(np.int32), 8))
    np.testing.assert_array_equal(full, want)


def test_b_fragment_encoding():
    """Every uint16 lane value and every plane: the B registers hold fp16
    1024 + ((v >> s) & 0x0101), exactly, at the depth rows of the layout."""
    v = np.arange(1 << 16, dtype=np.uint32)
    W = v | ((v ^ 0xA5C3) << 16)  # low lane v, high lane another value
    for s in range(0, 8, 2):
        lo, hi = planes2(W, np.uint32(s))
        for reg, lane in ((lo, v), (hi, v ^ 0xA5C3)):
            h = reg.view(np.uint16).reshape(-1, 2).view(np.float16).astype(np.float64)
            for q in (0, 1):
                np.testing.assert_array_equal(h[:, q], 1024 + ((lane >> (s + q)) & 0x0101))


def _densest_element() -> tuple[int, int]:
    """The GF(2^8) element whose 8x8 bit matrix has the most ones in one row,
    and that count."""
    rows = j_get_field(8).bitmats.sum(axis=2).max(axis=1)
    return int(rows.argmax()), int(rows.max())


@pytest.mark.parametrize("k", [30, 31, 62])
def test_largest_sum_is_exact(k):
    """Every data byte 0xFF and every coefficient the densest element: each
    selected plane is 257, so the accumulator of the densest row reaches
    ones * 30 * (1024 + 257), the largest a slice can hold.  It stays below
    2^23, every partial sum is an exact integer, and the bytes are right."""
    elem, ones = _densest_element()
    A = np.full((3, k), elem, dtype=np.uint8)
    B = np.full((k, 1024), 0xFF, dtype=np.uint8)
    trace = []
    np.testing.assert_array_equal(model(A, B, trace=trace), j_get_field(8).matmul(A, B))
    top = max(float(acc.max()) for acc in trace)
    assert top == ones * min(k, SLICE) * (1024 + 257)
    assert top < F32_EXACT
    for acc in trace:
        assert np.array_equal(acc, np.floor(acc))


def test_partial_sums_match_integer_sums():
    """On random data every f32 partial sum equals the int64 sum of the same
    products: the f32 path is exact, not merely right after the refold."""
    A, B = _operands(4, 31, 256, 5)
    trace = []
    model(A, B, trace=trace)
    a = unpack_a_tiles(cuda_pack2.pack_fragments(A)).astype(np.int64)
    lanes16 = np.zeros((32, 128), dtype=np.uint32)
    lanes16[:31] = B[:, 0::2].astype(np.uint32) | (B[:, 1::2].astype(np.uint32) << 8)
    steps = lanes16.shape[1] // WARP_LANES
    # m-tile 0's slice 0 is the first SLICE_STEPS traces.
    acc = np.zeros((steps, GROUPS, 16, 8), dtype=np.int64)
    for c in range(SLICE_STEPS):
        b = b_tiles(b_registers(load_words(lanes16, 2 * c, steps)),
                    b_registers(load_words(lanes16, 2 * c + 1, steps))).astype(np.int64)
        acc = acc + np.matmul(a[0, c], b)
        np.testing.assert_array_equal(trace[c].astype(np.int64), acc)
    assert max(float(t.max()) for t in trace) < F32_EXACT
