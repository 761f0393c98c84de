"""K3's pre-parity form (``ops/csrc/gf_planes.cu``,
``gf_planes_none_kernel<W, ...>``) at w=8 and w=16, modelled in NumPy and
held against the JAX package (w=4: ``test_torch_k3_w4.py``).

The kernel is the sum kernel's first product (``test_torch_k3_sum.py``'s
register model: the ring or the direct route, the PRMT transposes, the
four-symbol plane words, m-tile pairs) on the unscaled 0/1 operator with
JAX's plane values exactly (shift and cmp 0/1, sign {0, -1}, shift_raw
int8(b >> s) with the next byte's bits masked off, nibble 0/1 from the
PRMT tables and one AND), and an epilogue through shared memory: each
lane's C fragments go to its warp's staging rows with 4 STS.128 a row
(16-byte chunks swizzled by c ^ (c >> 3), rows 288 bytes apart), and each
LDS.128 / STG.128 pair moves two whole 256-byte row segments.  The model
follows every store to its staging word and every staging word to the
output, and checks that no quarter-warp's 16-byte accesses share a bank.
At w=16 a symbol is two byte-symbols (128-byte step rows, the low and
high bytes split by PRMT) over the unscaled ``sum_operator(A, 16)``,
whose rows i*16 + 8h + s' are JAX's rows i*16 + s, so the 16p rows are
staged as w=8's 2p byte-symbols' are; shift_raw's exact word keeps a low
byte's bits from its high byte (JAX's plane is the low byte of the whole
16-bit b >> s).  Its int32 sums must equal the JAX package's exactly
(tolerance 0): ``gf_matmul_pallas(fold_parity=False, acc_dtype=jnp.int8,
interpret=True)``, whose parity folds to ``GaloisField.matmul``.
"""


import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_rscode_torch.ops import cuda_planes
from gpu_rscode_torch.ops.gemm import from_bitplanes
from gpu_rscode_tpu.ops import pallas_gemm
from gpu_rscode_tpu.ops.gf import get_field
from test_torch_k3_nibble import _depth_map
from test_torch_k3_sum import (G, GROUPS, IDX, INT32, LANES, SOURCE, STEP, T, WARPS, _const, _densest_element,
                               _operands, b_tile, chunk_planes, first_product, step_buffers)

ROWS, STRIDE = _const("kNoneRows"), _const("kNoneStride")
SMEM_LIMIT = 227 * 1024
EXPANDS = cuda_planes.SUM_EXPANDS
# The JAX expansion of each kernel expansion ("cmp" is the sweep's name only).
JAX_EXPAND = {"shift": "shift", "shift_raw": "shift_raw", "sign": "sign", "nibble": "nibble"}


def sts_offsets(u: int, h: int, v: int) -> np.ndarray:
    """Int32 offset in the warp's staging of each lane's STS.128 number v
    of row 16u + 8h + g: chunk 4t + v of the row, swizzled."""
    return (16 * u + 8 * h + G) * STRIDE + 4 * ((4 * T + v) ^ (T >> 1))


def lds_offsets(i: int) -> np.ndarray:
    """Int32 offset of each lane's LDS.128 number i: chunk L % 16 of row
    2i + L / 16, swizzled."""
    c = IDX & 15
    return (2 * i + (IDX >> 4)) * STRIDE + 4 * (c ^ (c >> 3))


def conflict_free(offsets: np.ndarray) -> bool:
    """Whether each quarter-warp's 16-byte accesses fall in 8 distinct bank
    groups (a 128-byte shared-memory wavefront)."""
    units = (offsets * 4 // 16) % 8
    return all(len(set(units[q:q + 8])) == 8 for q in range(0, LANES, 8))


def model(A: np.ndarray, B: np.ndarray, expand: str, tile: int | None = None, pinned: bool = False,
          direct: bool = False, trace: list | None = None, w: int | None = None) -> np.ndarray:
    """NumPy model of gf_planes_none_kernel<W, expand>: (p, k) coefficients,
    (k, m) uint8 (W=4, 8) or uint16 (W=16) -> (p*W, m) int32 sums.  ``w``:
    16 for uint16, else 8 unless given (4)."""
    p = A.shape[0]
    m = B.shape[1]
    wd = 16 if B.dtype == np.uint16 else w or 8
    C = np.random.default_rng(m).integers(-(1 << 31), 1 << 31, size=(p * wd, m))  # as torch.empty leaves it
    writes = np.zeros((p * wd, m), dtype=np.int64)
    for mg, acc, col0, _ in first_product(A, B, expand, tile, pinned, wd, direct, exact=True, trace=trace):
        S = len(col0)
        stage = np.full((S, ROWS * STRIDE), np.iinfo(np.int64).min)  # unwritten
        for u in range(len(acc)):  # a lone m-tile (w=4) stages rows 0-15 alone
            for h in range(2):
                for v in range(4):
                    groups = range(4 * (v & 1), 4 * (v & 1) + 4)
                    off = sts_offsets(u, h, v)
                    for e, j in enumerate(groups):  # reg 2h (v < 2: column 16t + j) or 2h + 1 (16t + 8 + j)
                        assert (stage[:, off + e] == np.iinfo(np.int64).min).all()
                        stage[:, off + e] = acc[u][j][:, G + 8 * h, 2 * T + (v >> 1)]
        nrows = min(ROWS, wd * p - 16 * mg)
        for i in range(-(-nrows // 2)):
            row = 2 * i + (IDX >> 4)
            off = lds_offsets(i)
            for lane in range(LANES):
                if row[lane] >= nrows:
                    continue
                for e in range(4):
                    cols = col0 + 4 * (lane & 15) + e
                    ok = cols < m
                    val = stage[:, off[lane] + e]
                    assert (val[ok] != np.iinfo(np.int64).min).all()  # only staged words leave
                    C[16 * mg + row[lane], cols[ok]] = val[ok]
                    writes[16 * mg + row[lane], cols[ok]] += 1
    assert (writes == 1).all()  # every sum written once, by the stores only
    return C


def route(k: int, p: int, expand: str) -> str:
    """The source's mma_route for the none kernel: "smem" while the
    operator (m-tile pairs x chunks of 512 bytes), the staging rows and one
    step buffer a warp fit, else "direct"."""
    mtn = 2 * -(-p // 4)
    kc = 2 * -(-k // 2) if expand == "nibble" else -(-k // 4)
    need = mtn * kc * 512 + WARPS * ROWS * STRIDE * 4 + WARPS * 4 * -(-k // 4) * STEP
    return "smem" if need <= SMEM_LIMIT else "direct"


def parent_edge(p: int, expand: str) -> int:
    """The largest k gf_planes_kernel<8, expand, none> took at p: its
    operator (p*8 rows in 16-row m-tiles; k*8 deep, k*32 for nibble) in
    shared memory."""
    mt = -(-p // 2)

    def need(k):
        return mt * (k if expand == "nibble" else -(-k // 4)) * 512

    k = 0
    while need(k + 1) <= SMEM_LIMIT:
        k += 1
    return k


def test_source_constants():
    """Every w=8 expansion's pre-parity form runs the none kernel through
    the X-macro (routes kStaged and kDirect), as w=4's and w=16's do, no
    generic kernel is left, the w=8 launches count as "preparity"; the
    staging rows and their swizzle are the model's."""
    assert (ROWS, STRIDE) == (32, 72)
    assert "#define RS_CALL_W8(E) RS_CALL_MMA(8, E, kSum) RS_CALL_MMA(8, E, kDot) RS_CALL_MMA(8, E, kNone)" in SOURCE
    assert "sum_pass<W, EXPAND, SRC, true>(acc, rows, smem, opA, mg, kc, k, lane);" in SOURCE
    assert "const int* st_r = stage + (lane >> 4) * kNoneStride + 4 * (c_rd ^ (c_rd >> 3));" in SOURCE
    assert "__stcs(reinterpret_cast<int4*>(dst), v);" in SOURCE
    assert "RS_PLANES_INSTANCES" not in SOURCE and "RS_CALL_MMA(16, E, kNone)" in SOURCE
    for e in EXPANDS:
        assert cuda_planes.is_none_pair(e, "none") and cuda_planes.kind(8, e, "none") == "preparity"
        assert cuda_planes.is_none_pair(e, "none", 16) == (e in cuda_planes.WIDE_EXPANDS)
    assert cuda_planes.kind(4, "shift", "none") == "preparity_w4_w16"


def test_staging_is_complete_and_conflict_free():
    """The 16 STS.128 of a pass fill each of the 32 x 64 staged words once,
    the 16 LDS.128 read each once, at the row and column the fragment
    held; no quarter-warp's access shares a bank group."""
    filled = np.full(ROWS * STRIDE, -1)
    for u, h, v in np.ndindex(2, 2, 4):
        off = sts_offsets(u, h, v)
        assert conflict_free(off)
        for e in range(4):
            col = 16 * T + 8 * (v >> 1) + 4 * (v & 1) + e  # reg 2h + (v >> 1), group 4(v & 1) + e
            assert (filled[off + e] == -1).all()
            filled[off + e] = (16 * u + 8 * h + G) * 64 + col
    for i in range(16):
        off = lds_offsets(i)
        assert conflict_free(off)
        for e in range(4):
            want = (2 * i + (IDX >> 4)) * 64 + 4 * (IDX & 15) + e
            np.testing.assert_array_equal(filled[off + e], want)
    assert (filled >= 0).sum() == ROWS * 64


@pytest.mark.parametrize("expand", EXPANDS)
def test_exact_planes_are_the_jax_planes(expand):
    """One warp step of every byte value: the plane registers of every
    chunk, read back as B tiles at their depths, are JAX's planes (its
    _expand_* cast to int8, the acc_dtype=int8 contract) value for value:
    shift_raw's int8(b >> s) without the next byte's bits, sign's -1,
    nibble's one-hot 0/1."""
    k = 5
    B = np.random.default_rng(3).integers(0, 256, size=(k, STEP), dtype=np.uint8)
    B[0] = np.arange(STEP)
    B[1] = np.arange(STEP) + 192
    words, _ = step_buffers(B, [(0, 0)], 1)
    signed = expand in ("sign", "shift_raw")
    chunks = list(chunk_planes(words, k, expand, exact=True))
    planes = np.zeros((32 * len(chunks), STEP), dtype=np.int64)
    for c, b0, b1 in chunks:
        for j in range(GROUPS):
            planes[32 * c:32 * c + 32, j::GROUPS] = b_tile(b0[j], b1[j], signed)[0]
    fn = pallas_gemm._expand_nibble if expand == "nibble" else getattr(pallas_gemm, f"_expand_{expand}", None)
    if fn is None:  # cmp: the sweep's name only, the plain expansion's values
        jax_planes = cuda_planes.expand_planes(torch.from_numpy(B), expand).numpy()
    else:
        jax_planes = np.asarray(fn(jnp.asarray(B), 8, k, STEP).astype(jnp.int8)).astype(np.int64)
    if expand == "nibble":
        cols = _depth_map(k)
    else:
        d = np.arange(32 * len(chunks))
        sym, s = 4 * (d // 32) + d % 4, 4 * (d % 32 // 16) + d % 16 // 4
        cols = np.where(sym < k, 8 * sym + s, -1)
    np.testing.assert_array_equal(planes[cols >= 0], jax_planes[cols[cols >= 0]])


@pytest.mark.parametrize("p,k", [(1, 1), (4, 10), (3, 33)])
def test_operators_are_unscaled(p, k):
    """The none kernel's operators are the sum kernel's without the 2^s:
    0/1, in the same depth order."""
    A, _ = _operands(p, k, 1, p + 7 * k)
    for fn in (cuda_planes.sum_operator, cuda_planes.nibble_operator):
        op = fn(A, scaled=False)
        assert op.max() <= 1
        np.testing.assert_array_equal(op.astype(np.int64) << (np.arange(op.shape[0]) % 8)[:, None], fn(A))


@pytest.mark.parametrize("expand", EXPANDS)
def test_model_matches_jax(expand):
    """The model equals gf_matmul_pallas(fold_parity=False,
    acc_dtype=int8) interpreted value for value (cmp: the plain version,
    held against JAX in test_torch_planes_wide.py), and its parity folds to
    the GF oracle: p = 1, 3, 4 (odd p: padded rows not stored), k = 1, 5,
    10, m ragged over two blocks of 128 columns and below one warp step."""
    for k in (1, 5, 10):
        for m in (203, 37):
            A, B = _operands(8, k, m, 10 * k + m)
            if k == 10 and m == 203 and expand in JAX_EXPAND:
                want = np.asarray(pallas_gemm.gf_matmul_pallas(A, B, expand=JAX_EXPAND[expand], fold_parity=False,
                                                               acc_dtype=jnp.int8, interpret=True))
            else:
                want = cuda_planes.gf_matmul_planes_plain(A, torch.from_numpy(B), expand, "none").numpy()
            folded = get_field(8).matmul(A, B)
            for lo, hi in ((0, 1), (1, 4), (4, 8)):
                got = model(A[lo:hi], B, expand, tile=128)
                np.testing.assert_array_equal(got, want[8 * lo:8 * hi], err_msg=f"p={hi - lo} k={k} m={m}")
                np.testing.assert_array_equal(from_bitplanes(torch.from_numpy(got & 1).int(), 8).numpy(), folded[lo:hi])


@pytest.mark.parametrize("expand", ["shift_raw", "nibble"])
def test_model_pinned_and_direct(expand):
    """Pinned blocks of 64 and 192 columns repeat block 0's sums; the direct
    route (rows from device memory, zero past k and m) gives the staged
    route's sums."""
    A, B = _operands(5, 7, 301, 43)
    want = cuda_planes.gf_matmul_planes_plain(A, torch.from_numpy(B), expand, "none").numpy()
    for tile in (64, 192):
        np.testing.assert_array_equal(model(A, B, expand, tile=tile, pinned=True), want[:, np.arange(301) % tile])
    np.testing.assert_array_equal(model(A, B, expand, tile=128, direct=True), want)


@pytest.mark.parametrize("k", [4, 33])
def test_largest_sums_are_exact(k):
    """Every data byte 0xFF and every coefficient the densest element:
    every expansion's sums equal the plain version's (JAX's contract) and
    the largest is what the 0/1 operator predicts: the row's ones times the
    plane (1, -1 for sign, int8(0xFF >> s) for shift_raw)."""
    elem, ones = _densest_element()
    A = np.full((4, k), elem, dtype=np.uint8)
    B = np.full((k, 100), 0xFF, dtype=np.uint8)
    for expand in EXPANDS:
        trace = []
        got = model(A, B, expand, trace=trace)
        np.testing.assert_array_equal(got, cuda_planes.gf_matmul_planes_plain(A, torch.from_numpy(B), expand,
                                                                               "none").numpy())
        top = max(int(np.abs(acc).max()) for acc in trace)
        assert top < INT32
        if expand in ("shift", "cmp", "sign"):
            assert top == ones * k
        if expand == "shift_raw":  # plane 0 is int8(0xFF) = -1, plane 1 0x7F
            assert top <= 127 * ones * k


@pytest.mark.parametrize("expand", ["shift", "nibble"])
def test_model_at_the_shared_memory_edge(expand):
    """p = 16: the largest k the staged route takes (152; nibble 44) and the
    first past it, read from device memory; gf_planes_kernel's edge at
    p = 16 (224; nibble 56) and at p = 1 (1816; nibble 454), far past the
    staged route: every (k, p) taken before still runs, the route changes
    no sum."""
    edge = {"shift": 152, "nibble": 44}[expand]
    assert [route(k, 16, expand) for k in (edge, edge + 1)] == ["smem", "direct"]
    assert (parent_edge(16, expand), parent_edge(1, expand)) == {"shift": (224, 1816), "nibble": (56, 454)}[expand]
    cases = [(16, edge, 70), (16, edge + 1, 70), (16, parent_edge(16, expand), 9), (1, parent_edge(1, expand), 9)]
    for p, k, m in cases:
        A, B = _operands(p, k, m, k + p)
        got = model(A, B, expand, tile=64, direct=route(k, p, expand) == "direct")
        want = cuda_planes.gf_matmul_planes_plain(A, torch.from_numpy(B), expand, "none").numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"p={p} k={k}")


# --- w=16 ---------------------------------------------------------------

def _operands16(p, k, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 16, size=(p, k)).astype(np.uint16),
            rng.integers(0, 1 << 16, size=(k, m)).astype(np.uint16))


def route16(k: int, p: int) -> str:
    """The source's mma_route for the none kernel at w=16: "smem" while the
    operator (16p rows in m-tile pairs x chunks of two symbols), the staging
    rows and one 128-byte-row step buffer a warp fit, else "direct"."""
    mtn, kc = 2 * -(-(2 * p) // 4), -(-k // 2)
    need = mtn * kc * 512 + WARPS * ROWS * STRIDE * 4 + WARPS * 2 * kc * 2 * STEP
    return "smem" if need <= SMEM_LIMIT else "direct"


@pytest.mark.parametrize("expand", cuda_planes.WIDE_EXPANDS)
def test_exact_planes_w16_are_the_jax_planes(expand):
    """One warp step of 16-bit symbols (every byte value in both halves,
    k = 3: a chunk's second symbol past k): the exact plane registers, read
    back as B tiles at their depths, are JAX's w=16 planes cast to int8
    value for value.  shift_raw's low byte-symbol keeps the high byte's
    bits that b >> s brings down (one AND with 0x00FF00FF | (0xFF >> s) *
    0x01000100); its high byte-symbol's plane is w=8's."""
    k = 3
    B = np.random.default_rng(5).integers(0, 1 << 16, size=(k, STEP)).astype(np.uint16)
    B[0] = np.arange(STEP) * 0x0101 + 0x80
    B[1] = (np.arange(STEP) << 8) | (255 - np.arange(STEP))
    words, _ = step_buffers(B, [(0, 0)], 1, direct=True)
    signed = expand in ("sign", "shift_raw")
    chunks = list(chunk_planes(words, 2 * k, expand, 16, exact=True))
    planes = np.zeros((32 * len(chunks), STEP), dtype=np.int64)
    for c, b0, b1 in chunks:
        for j in range(GROUPS):
            planes[32 * c:32 * c + 32, j::GROUPS] = b_tile(b0[j], b1[j], signed)[0]
    fn = getattr(pallas_gemm, f"_expand_{expand}")
    jax_planes = np.asarray(fn(jnp.asarray(B), 16, k, STEP).astype(jnp.int8)).astype(np.int64)
    d = np.arange(32 * len(chunks))
    byte_sym, s = 4 * (d // 32) + d % 4, 4 * (d % 32 // 16) + d % 16 // 4
    sym, bit = byte_sym // 2, 8 * (byte_sym % 2) + s
    rows = np.where(sym < k, 16 * sym + bit, -1)
    np.testing.assert_array_equal(planes[rows >= 0], jax_planes[rows[rows >= 0]])
    assert "if (EXACT && W == 16) return (r >> s) & (0x00FF00FFu | ((0xFFu >> s) * 0x01000100u));" in SOURCE


@pytest.mark.parametrize("expand", cuda_planes.WIDE_EXPANDS)
def test_model_w16_matches_jax(expand):
    """The w=16 model equals gf_matmul_pallas(w=16, fold_parity=False,
    acc_dtype=int8) interpreted value for value, and its parity folds to
    the GF(2^16) oracle: p = 1 (one m-tile beside a padded one), 3 (48 rows:
    a pass that stages 16), 4, k = 1 and 5 (a chunk's second symbol past
    k), m ragged over two blocks of 128 columns (k = 5) and below one warp
    step."""
    for k, m in ((1, 37), (5, 203)):
        A, B = _operands16(8, k, m, 30 * k + m)
        want = cuda_planes.gf_matmul_planes_plain(
            A, torch.from_numpy(B.view(np.int16)).view(torch.uint16), expand, "none", w=16).numpy()
        if k == 5:
            np.testing.assert_array_equal(np.asarray(pallas_gemm.gf_matmul_pallas(
                A, B, w=16, expand=expand, fold_parity=False, acc_dtype=jnp.int8, interpret=True)), want)
        folded = get_field(16).matmul(A, B)
        for lo, hi in ((0, 1), (1, 4), (4, 8)):
            got = model(A[lo:hi], B, expand, tile=128)
            np.testing.assert_array_equal(got, want[16 * lo:16 * hi], err_msg=f"p={hi - lo} k={k} m={m}")
            np.testing.assert_array_equal(
                from_bitplanes(torch.from_numpy(got & 1).int(), 16).numpy().view(np.uint16), folded[lo:hi])


def test_model_w16_pinned_direct_and_largest_sums():
    """Pinned blocks repeat block 0's sums and the direct route gives the
    staged one's; every symbol 0xFFFF with the densest element keeps every
    expansion's sums exact (shift_raw's low-byte planes int8(0xFF): -1)."""
    A, B = _operands16(3, 7, 301, 49)
    Bt = torch.from_numpy(B.view(np.int16)).view(torch.uint16)
    want = cuda_planes.gf_matmul_planes_plain(A, Bt, "shift_raw", "none", w=16).numpy()
    np.testing.assert_array_equal(model(A, B, "shift_raw", tile=192, pinned=True), want[:, np.arange(301) % 192])
    np.testing.assert_array_equal(model(A, B, "shift_raw", tile=128, direct=True), want)
    dense = int(get_field(16).bitmats.sum(axis=2).max(axis=1).argmax())
    A = np.full((2, 4), dense, dtype=np.uint16)
    B = np.full((4, 40), 0xFFFF, dtype=np.uint16)
    Bt = torch.from_numpy(B.view(np.int16)).view(torch.uint16)
    for expand in cuda_planes.WIDE_EXPANDS:
        trace = []
        got = model(A, B, expand, trace=trace)
        np.testing.assert_array_equal(got, cuda_planes.gf_matmul_planes_plain(A, Bt, expand, "none", w=16).numpy())
        assert max(int(np.abs(acc).max()) for acc in trace) < INT32


def test_model_w16_at_the_shared_memory_edge():
    """p = 16: the largest k the staged route takes at w=16 (42) and the
    first past it, read from device memory, and one past the generic
    kernel's edge there (56; its p = 1 edge, 908, runs on the card in
    chip_smoke.py): every (k, p) taken before still runs, the route
    changes no sum."""
    assert [route16(k, 16) for k in (42, 43)] == ["smem", "direct"]
    for p, k, m in ((16, 42, 70), (16, 43, 9), (16, 57, 9)):
        A, B = _operands16(p, k, m, k + p)
        got = model(A, B, "shift_raw", tile=64, direct=route16(k, p) == "direct")
        want = cuda_planes.gf_matmul_planes_plain(A, torch.from_numpy(B.view(np.int16)).view(torch.uint16),
                                                  "shift_raw", "none", w=16).numpy()
        np.testing.assert_array_equal(got, want, err_msg=f"p={p} k={k}")
