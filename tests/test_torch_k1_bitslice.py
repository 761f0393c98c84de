"""K1's folded form, the bit-sliced XOR kernel (``ops/csrc/gf_gemm.cu``,
``gf_bitslice_kernel``), modelled in NumPy and held against the JAX package.

The kernel runs only on the card (``chip_smoke.py`` holds it bit-exact
against its plain version there).  Here a NumPy model follows its layout
step by step: the host masks (``cuda_gemm.pack_masks``) and tile plan
(``cuda_gemm.bitslice_plan``), each lane's 16-byte chunks at byte
``512*u + 16*lane`` of its warp's span with the kernel's three access widths
(16-byte, 4 x 4-byte, bytes) chosen by alignment and the row's end, the
masked-swap transpose into bit planes, the streamed accumulation over depth
chunks of staged masks, the output-row tiles, the inverse transpose and the
bounded stores.  The model's bytes must equal the JAX package's GEMM
(``GaloisField.matmul``, and ``gf_matmul_pallas`` interpreted) exactly:
tolerance 0.
"""

import re

import numpy as np
import pytest

from gpu_rscode_torch.ops import cuda_gemm
from gpu_rscode_tpu.ops.gf import get_field as j_get_field
from gpu_rscode_tpu.ops.pallas_gemm import gf_matmul_pallas

LANES = 32
# The model reads the kernel's layout from its source, so the two cannot drift.
SOURCE = cuda_gemm.SOURCES[0].read_text()
WARPS_PER_BLOCK = int(re.search(r"constexpr int kThreads = (\d+);", SOURCE).group(1)) // LANES
COLS_PER_BLOCK = WARPS_PER_BLOCK * LANES * 32
KEEP = [0x55555555, 0x33333333, 0x0F0F0F0F, 0x00FF00FF]


def transpose_planes(x: np.ndarray) -> np.ndarray:
    """The kernel's ``transpose_planes`` on (..., W) uint32 words: stage a
    swaps bit a of the word index with bit a of the bit position."""
    x = x.astype(np.uint32, copy=True)
    W = x.shape[-1]
    a = 0
    while (1 << a) < W:
        sh = np.uint32(1 << a)
        for i in range(W):
            if i & (1 << a):
                continue
            j = i | (1 << a)
            t = ((x[..., i] >> sh) ^ x[..., j]) & np.uint32(KEEP[a])
            x[..., j] ^= t
            x[..., i] ^= t << sh
        a += 1
    return x


def _path(addr: int, off: int, length: int) -> str:
    if off + 16 <= length:
        if addr % 16 == 0:
            return "vec16"
        if addr % 4 == 0:
            return "u32x4"
    return "bytes"


def load16(buf: np.ndarray, base: int, off: int, length: int, paths: dict) -> np.ndarray:
    """The kernel's ``load16``: 16 bytes of the row at ``base`` (its byte
    address; allocations are 16-byte aligned), zero past ``length``."""
    path = _path(base + off, off, length)
    paths[path] = paths.get(path, 0) + 1
    if path != "bytes":
        return buf[base + off : base + off + 16].copy()
    out = np.zeros(16, dtype=np.uint8)
    for b in range(16):
        if off + b < length:
            out[b] = buf[base + off + b]
    return out


def store16(buf: np.ndarray, base: int, off: int, length: int, v: np.ndarray, paths: dict) -> None:
    path = _path(base + off, off, length)
    paths[path] = paths.get(path, 0) + 1
    if path != "bytes":
        buf[base + off : base + off + 16] = v
        return
    for b in range(16):
        if off + b < length:
            buf[base + off + b] = v[b]


def emulate_bitslice(A, B, w, row_offset=0):
    """NumPy model of ``rs_gf_bitslice``; returns (C, info).  ``row_offset``
    shifts B's first byte off 16-byte alignment, as a view would."""
    k, m = B.shape
    p = A.shape[0]
    rt, tiles, depth = cuda_gemm.bitslice_plan(p, k, w)
    masks = cuda_gemm.pack_masks(A, w, rt, tiles)
    assert masks.shape == (tiles, k, w, rt * w) and masks.dtype == np.uint32
    length = m * (w // 8)
    span = 512 * (w // 4)
    blocks = -(-m // COLS_PER_BLOCK)
    src = np.concatenate([np.zeros(row_offset, np.uint8), np.ascontiguousarray(B).view(np.uint8).ravel()])
    guard = 64
    dst = np.full(p * length + guard, 0xAB, dtype=np.uint8)
    loads, stores = {}, {}
    # Thread t = (block, warp, lane): its byte offset in every row.
    offs = [(blk * WARPS_PER_BLOCK + warp) * span + 16 * lane
            for blk in range(blocks) for warp in range(WARPS_PER_BLOCK) for lane in range(LANES)]

    def row_words(i):
        words = np.zeros((len(offs), w), dtype=np.uint32)
        for t, off in enumerate(offs):
            for u in range(w // 4):
                chunk = load16(src, row_offset + i * length, off + 512 * u, length, loads)
                words[t, 4 * u : 4 * u + 4] = chunk.view("<u4")
        return words

    rows_loaded = {}
    for g in range(tiles):  # one block per (column block, tile); tiles are independent
        out = np.zeros((len(offs), rt * w), dtype=np.uint32)
        for i0 in range(0, k, depth):
            staged = masks[g, i0 : i0 + depth]  # the chunk in shared memory
            assert staged.nbytes <= cuda_gemm.MASK_SMEM_BYTES
            for r in range(staged.shape[0]):
                i = i0 + r
                if i not in rows_loaded:
                    rows_loaded[i] = row_words(i)
                planes = transpose_planes(rows_loaded[i])
                for s in range(w):
                    out ^= planes[:, s, None] & staged[r, s][None, :]
        for r in range(rt):
            row = g * rt + r
            if row >= p:
                break
            y = transpose_planes(out[:, r * w : (r + 1) * w])
            for t, off in enumerate(offs):
                for u in range(w // 4):
                    v = y[t, 4 * u : 4 * u + 4].astype("<u4").view(np.uint8)
                    store16(dst, row * length, off + 512 * u, length, v, stores)
    assert (dst[p * length :] == 0xAB).all(), "a store went past the last row's end"
    C = dst[: p * length].view(B.dtype).reshape(p, m)
    return C, dict(rt=rt, tiles=tiles, depth=depth, loads=loads, stores=stores)


def _operands(p, k, m, w, seed):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if w == 8 else np.uint16
    return rng.integers(0, 1 << w, size=(p, k)).astype(dt), rng.integers(0, 1 << w, size=(k, m)).astype(dt)


@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("m", [1, 31, 33, 1639, 4097])
@pytest.mark.parametrize("p,k", [(4, 10), (10, 10), (4, 33)])
def test_model_matches_jax_gf_matmul(p, k, m, w):
    """The main path's (p=4, k=10), the whole decode inverse p=k=10 and a
    depth of 33, at ragged and misaligned widths (1,639 is the last segment
    of a 1 GiB encode)."""
    A, B = _operands(p, k, m, w, 1000 * p + 10 * k + m + w)
    got, _ = emulate_bitslice(A, B, w)
    np.testing.assert_array_equal(got, j_get_field(w).matmul(A, B))


@pytest.mark.parametrize("w,m", [(8, 1639), (8, 4097), (16, 1639), (16, 4097)])
def test_model_matches_pallas_interpreted(w, m):
    A, B = _operands(4, 10, m, w, 77 + m + w)
    got, _ = emulate_bitslice(A, B, w)
    np.testing.assert_array_equal(got, np.asarray(gf_matmul_pallas(A, B, w=w)))


@pytest.mark.parametrize(
    "w,p,k,m,rt,tiles,depth",
    [
        (8, 16, 50, 1100, 8, 2, 48),  # two y-tiles and two depth chunks
        (16, 4, 33, 700, 4, 1, 24),  # depth chunks at w=16
        (16, 5, 7, 300, 3, 2, 7),  # a ragged last tile
        (8, 10, 10, 2049, 5, 2, 10),  # the decode inverse
        (8, 8, 100, 513, 8, 1, 48),  # three depth chunks, the last one short
        (16, 12, 60, 130, 4, 3, 24),  # three tiles, three chunks each
    ],
)
def test_model_tiles_and_depth_chunks(w, p, k, m, rt, tiles, depth):
    A, B = _operands(p, k, m, w, 5 + p + k + m)
    got, info = emulate_bitslice(A, B, w)
    assert (info["rt"], info["tiles"], info["depth"]) == (rt, tiles, depth)
    np.testing.assert_array_equal(got, j_get_field(w).matmul(A, B))


@pytest.mark.parametrize("w,m,row_offset", [(8, 1639, 0), (8, 4100, 0), (8, 4096, 3), (16, 1639, 0), (16, 2048, 2)])
def test_model_misaligned_rows_take_narrow_accesses(w, m, row_offset):
    """Rows whose start is not 16-byte aligned take the 4-byte or byte
    accesses, and the bytes stay exact."""
    A, B = _operands(4, 10, m, w, 9 + m + row_offset)
    got, info = emulate_bitslice(A, B, w, row_offset=row_offset)
    np.testing.assert_array_equal(got, j_get_field(w).matmul(A, B))
    length = m * (w // 8)
    assert info["loads"].get("bytes", 0) > 0
    if length % 16:
        assert info["stores"].get("bytes", 0) > 0
    if length % 16 and length % 4 == 0 and row_offset % 4 == 0:
        assert info["loads"].get("u32x4", 0) > 0 and info["stores"].get("u32x4", 0) > 0


def test_model_aligned_rows_take_wide_accesses():
    """A width whose rows are all 16-byte aligned and a whole number of warp
    spans (the main path's segments are) loads and stores with 16-byte
    accesses alone."""
    A, B = _operands(4, 10, 4096, 8, 11)
    got, info = emulate_bitslice(A, B, 8)
    np.testing.assert_array_equal(got, j_get_field(8).matmul(A, B))
    assert set(info["loads"]) == {"vec16"} and set(info["stores"]) == {"vec16"}


@pytest.mark.parametrize("w", [8, 16])
def test_transpose_makes_bit_planes_and_is_an_involution(w):
    """Bit s of the symbol in any of a thread's 32 columns lands in plane s,
    at a position that differs from column to column; transposing twice
    gives the words back."""
    positions = {}
    for j in range(w):  # word j holds 32 // w symbols, symbol q at bit q*w
        for q in range(32 // w):
            for s in range(w):
                words = np.zeros((1, w), dtype=np.uint32)
                words[0, j] = np.uint32(1) << np.uint32(q * w + s)
                planes = transpose_planes(words)[0]
                nonzero = np.flatnonzero(planes)
                assert list(nonzero) == [s]
                pos = int(planes[s]).bit_length() - 1
                assert planes[s] == np.uint32(1) << np.uint32(pos)
                positions.setdefault((j, q), set()).add(pos)
    assert all(len(v) == 1 for v in positions.values())
    assert len({next(iter(v)) for v in positions.values()}) == 32
    x = np.random.default_rng(w).integers(0, 2**32, size=(50, w), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(transpose_planes(transpose_planes(x)), x)


@pytest.mark.parametrize("w,p,k", [(8, 4, 10), (8, 10, 10), (8, 16, 50), (16, 4, 10), (16, 5, 7)])
def test_pack_masks_matches_expand_bitmatrix(w, p, k):
    """Entry [g, i, s, r*w + t] is all ones exactly where the JAX package's
    expand_bitmatrix has a one at (output bit (g*rt + r)*w + t, input bit
    i*w + s); the padding rows of the last tile are zero."""
    A, _ = _operands(p, k, 1, w, 3 + p + k + w)
    rt, tiles, _ = cuda_gemm.bitslice_plan(p, k, w)
    masks = cuda_gemm.pack_masks(A, w, rt, tiles)
    bits = j_get_field(w).expand_bitmatrix(A)
    assert masks.shape == (tiles, k, w, rt * w) and masks.dtype == np.uint32
    assert set(np.unique(masks)) <= {0, 0xFFFFFFFF}
    for g in range(tiles):
        for r in range(rt):
            row = g * rt + r
            for t in range(w):
                got = masks[g, :, :, r * w + t].reshape(k * w)
                want = bits[row * w + t] if row < p else np.zeros(k * w)
                np.testing.assert_array_equal(got == 0xFFFFFFFF, want.astype(bool))


@pytest.mark.parametrize(
    "p,k,w,plan",
    [(4, 10, 8, (4, 1, 10)), (10, 10, 8, (5, 2, 10)), (4, 10, 16, (4, 1, 10)), (1, 1, 8, (1, 1, 1)),
     (128, 128, 8, (8, 16, 48)), (64, 200, 8, (8, 8, 48)), (128, 128, 16, (4, 32, 24)), (64, 64, 16, (4, 16, 24))],
)
def test_bitslice_plan_at_the_card_shapes(p, k, w, plan):
    """Every tile stays within 64 planes and the masks of one depth chunk
    within the shared-memory budget, at chip_smoke's shapes."""
    rt, tiles, depth = cuda_gemm.bitslice_plan(p, k, w)
    assert (rt, tiles, depth) == plan
    assert rt * w <= cuda_gemm.TILE_PLANES and rt * tiles >= p > rt * (tiles - 1)
    assert depth * w * rt * w * 4 <= cuda_gemm.MASK_SMEM_BYTES


@pytest.mark.parametrize("w", [8, 16])
def test_every_tile_height_the_plan_gives_has_a_kernel_instance(w):
    """``bitslice_plan`` picks rt with rt * w <= TILE_PLANES; gf_gemm.cu must
    instantiate exactly those rt, or a shape would be refused on the card."""
    instances = {int(rt) for rt in re.findall(rf"X\({w}, (\d+)\)", SOURCE)}
    plans = {cuda_gemm.bitslice_plan(p, 10, w)[0] for p in range(1, 256)}
    assert instances == set(range(1, cuda_gemm.TILE_PLANES // w + 1)) == plans
