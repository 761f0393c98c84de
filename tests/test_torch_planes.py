"""K3 (the bit-plane GEMMs and the copy floor) of the PyTorch port against
the JAX package.

Each plain body is held bit-exact against the JAX body of the same name
from ``tools/kernel_sweep.BODIES``, run through ``pl.pallas_call(...,
interpret=True)`` with ``make_fn``'s BlockSpecs, for the normal and the
pinned index map and for ``dma``; every body runs in interpret mode on the
CPU.  The nibble operator, the field's nibble matrices and the dispatch of
every JAX expansion name through ``gf_matmul_cuda`` are held against the
JAX package.  The CUDA kernel runs only on the card (chip_smoke.py); here
its fragment layout, in-register expansion and both refolds are checked by
a NumPy model of ``csrc/gf_planes.cu`` at the level of mma fragments."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from gpu_rscode_torch.ops import cuda_gemm, cuda_planes
from gpu_rscode_torch.ops import gemm as t_gemm
from gpu_rscode_torch.ops import gf as t_gf
from gpu_rscode_torch.tools import kernel_sweep as t_sweep
from gpu_rscode_tpu.ops.gemm import expand_bitmatrix_jnp, expand_nibblematrix_jnp
from gpu_rscode_tpu.ops.gf import get_field
from gpu_rscode_tpu.ops.pallas_gemm import gf_matmul_pallas
from gpu_rscode_tpu.tools import kernel_sweep as j_sweep

K, P = j_sweep.K, j_sweep.P
TILE = 128


def _operands(p, k, m, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(p, k), dtype=np.uint8),
            rng.integers(0, 256, size=(k, m), dtype=np.uint8))


def _jax_body(name, A, B, tile, pinned):
    """``kernel_sweep.make_fn``'s pallas_call, interpreted."""
    p, k, w = j_sweep.P, j_sweep.K, j_sweep.W
    m = B.shape[1]
    nib = name in j_sweep.NIBBLE_BODIES
    op = (expand_nibblematrix_jnp if nib else expand_bitmatrix_jnp)(jnp.asarray(A), w).astype(jnp.int8)
    b_map = (lambda i: (0, 0)) if pinned else (lambda i: (0, i))
    return np.asarray(pl.pallas_call(
        functools.partial(j_sweep.BODIES[name], w=w, k=k, p=p),
        out_shape=jax.ShapeDtypeStruct((p, m), jnp.uint8),
        grid=(pl.cdiv(m, tile),),
        in_specs=[pl.BlockSpec((p * w, k * 32 if nib else k * w), lambda i: (0, 0)),
                  pl.BlockSpec((k, tile), b_map)],
        out_specs=pl.BlockSpec((p, tile), lambda i: (0, i)),
        interpret=True,
    )(op, jnp.asarray(B)))


def test_sweep_bodies_are_the_jax_bodies():
    assert set(t_sweep.BODIES) == set(j_sweep.BODIES)
    assert (t_sweep.K, t_sweep.P, t_sweep.W) == (j_sweep.K, j_sweep.P, j_sweep.W)


@pytest.mark.parametrize("pinned", [False, True])
@pytest.mark.parametrize("m", [512, 600])
@pytest.mark.parametrize("name", sorted(j_sweep.BODIES))
def test_plain_body_matches_jax_body(name, m, pinned):
    A, B = _operands(P, K, m, 40 + m)
    want = _jax_body(name, A, B, TILE, pinned)
    Bt = torch.from_numpy(B)
    if name == "dma":
        assert not pinned or np.array_equal(want, B[:P, np.arange(m) % TILE])
        got = cuda_planes.copy_floor(Bt, P, TILE) if not pinned else None
    else:
        expand, refold = t_sweep.BODIES[name]
        got = cuda_planes.gf_matmul_planes(A, Bt, expand, refold, TILE, pinned=pinned)
    if got is not None:
        np.testing.assert_array_equal(got.numpy(), want)
    oracle = B[:P] if name == "dma" else get_field(8).matmul(A, B)
    np.testing.assert_array_equal(want, oracle[:, np.arange(m) % TILE] if pinned else oracle)


@pytest.mark.parametrize("p,k,m", [(1, 4, 100), (4, 10, 777), (10, 32, 300), (3, 5, 32)])
@pytest.mark.parametrize("expand,refold", cuda_planes.PAIRS)
def test_plain_pairs_match_oracle(expand, refold, p, k, m):
    A, B = _operands(p, k, m, 50 + p + k + m)
    got = cuda_planes.gf_matmul_planes_plain(A, torch.from_numpy(B), expand, refold)
    np.testing.assert_array_equal(got.numpy(), get_field(8).matmul(A, B))


@pytest.mark.parametrize("p,k", [(4, 10), (1, 1), (10, 32)])
def test_operators_match_jax(p, k):
    A, _ = _operands(p, k, 1, p * k)
    np.testing.assert_array_equal(t_gemm.expand_nibblematrix(A).numpy(), np.asarray(expand_nibblematrix_jnp(jnp.asarray(A))))
    np.testing.assert_array_equal(t_gemm.expand_bitmatrix(A).numpy(), np.asarray(expand_bitmatrix_jnp(jnp.asarray(A))))


def test_nibble_mats_match_jax():
    np.testing.assert_array_equal(t_gf.get_field(8).nibble_mats, get_field(8).nibble_mats)
    with pytest.raises(ValueError, match="w=8 only"):
        t_gf.GaloisField(16).nibble_mats


JAX_NAMES = ["shift", "shift_raw", "packed32", "sign16", "shift_u8", "nibble_const", "nibble32", "sign", "nibble"]


@pytest.mark.parametrize("refold", ["sum", "dot"])
@pytest.mark.parametrize("expand", JAX_NAMES)
def test_dispatch_of_jax_names_matches_pallas(expand, refold):
    A, B = _operands(4, 10, 640, 61)
    want = np.asarray(gf_matmul_pallas(A, B, expand=expand, refold=refold))
    got = cuda_gemm.gf_matmul_cuda(A, torch.from_numpy(B), 8, expand=expand, refold=refold)
    np.testing.assert_array_equal(got.numpy(), want)


def test_dispatch_names_and_refusals():
    assert set(cuda_gemm.EXPANSIONS) == set(JAX_NAMES) | {"pack2", "cmp", "signc"}
    assert set(cuda_gemm.EXPANSIONS.values()) == set(cuda_planes.EXPANDS) | {"pack2"}
    A, B = _operands(4, 10, 64, 62)
    Bt = torch.from_numpy(B)
    for name in ("cmp", "signc"):  # the sweep's names, not gf_matmul_pallas's
        got = cuda_gemm.gf_matmul_cuda(A, Bt, expand=name)
        np.testing.assert_array_equal(got.numpy(), get_field(8).matmul(A, B))
    with pytest.raises(ValueError, match="unknown expand"):
        cuda_gemm.gf_matmul_cuda(A, Bt, expand="bogus")
    with pytest.raises(ValueError, match="unknown refold"):
        cuda_gemm.gf_matmul_cuda(A, Bt, expand="shift", refold="autotune")
    with pytest.raises(ValueError, match="byte-granular"):
        cuda_gemm.gf_matmul_cuda(A, Bt.to(torch.int32).to(torch.uint16), 16, expand="nibble")
    with pytest.raises(ValueError, match="w=8 only"):
        cuda_gemm.gf_matmul_cuda(A, Bt.to(torch.int32).to(torch.uint16), 16, expand="shift_raw")
    with pytest.raises(ValueError, match="pre-parity"):
        cuda_gemm.gf_matmul_cuda(A, Bt, expand="shift", fold_parity=False)
    with pytest.raises(ValueError, match="expand=None runs K1"):
        cuda_gemm.gf_matmul_cuda(A, Bt, refold="dot")


def test_wrappers_cpu_contract():
    A, B = _operands(4, 10, 100, 63)
    Bt = torch.from_numpy(B)
    before = (cuda_planes.LAUNCHES, cuda_planes.COPY_LAUNCHES)
    cuda_planes.gf_matmul_planes(A, Bt, "shift", "sum")
    cuda_planes.copy_floor(Bt, 4)
    assert (cuda_planes.LAUNCHES, cuda_planes.COPY_LAUNCHES) == before
    with pytest.raises(TypeError, match="tensor"):
        cuda_planes.gf_matmul_planes(A, B, "shift", "sum")
    with pytest.raises(ValueError, match="0 < p <= k"):
        cuda_planes.copy_floor(Bt, 11)
    with pytest.raises(ValueError, match="tile must be positive"):
        cuda_planes.copy_floor(Bt, 4, tile=0)
    assert cuda_planes.tile_cols(None, 10**6) == cuda_planes.DEFAULT_TILE
    assert cuda_planes.tile_cols(100, 10**6) == 128 and cuda_planes.tile_cols(8192, 100) == 128


# --- NumPy model of gf_planes.cu at the level of mma fragments ---------------

def _bytes4(x):
    return [(int(x) >> (8 * q)) & 0xFF for q in range(4)]


def _a_matrix(frag):
    """(32, 4) uint32 A fragment -> the 16 x 32 tile it holds (PTX layout
    of mma.m16n8k32 with 8-bit A)."""
    M = np.zeros((16, 32), dtype=np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, (row, col) in enumerate(((g, t * 4), (g + 8, t * 4), (g, 16 + t * 4), (g + 8, 16 + t * 4))):
            M[row, col:col + 4] = _bytes4(frag[lane, reg])
    return M


def _b_matrix(regs, signed):
    """Per lane (b0, b1) -> the 32 x 8 B tile (column g holds depth t*4..
    in b0 and 16 + t*4.. in b1)."""
    M = np.zeros((32, 8), dtype=np.int64)
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for reg, row in ((0, t * 4), (1, 16 + t * 4)):
            M[row:row + 4, g] = _bytes4(regs[lane][reg])
    return np.where(M >= 128, M - 256, M) if signed else M


def _expand4(b, s0, expand):
    """The device function expand4, in Python integers."""
    if expand == "shift_raw":
        return sum(((b >> (s0 + q)) & 0xFF) << (8 * q) for q in range(4))
    if expand == "cmp":
        x = (b * 0x01010101) & (0x08040201 << s0) & 0xFFFFFFFF
        return sum((0x01 if (x >> (8 * q)) & 0xFF else 0) << (8 * q) for q in range(4))
    bits = (((b >> s0) & 0xF) * 0x00204081) & 0x01010101
    return (bits * 0xFF) & 0xFFFFFFFF if expand == "sign" else bits


def _emulate_kernel(A, B, expand, refold, tile, pinned=False):
    k, m = B.shape
    p = A.shape[0]
    mt, kc, mf, kf = cuda_planes._dims(k, p, expand)
    opA = cuda_planes.pack_fragments(cuda_planes._operator_bits(A, expand).numpy(), 16 * mt, 32 * kc)
    opF = cuda_planes.pack_fragments(cuda_planes.fold_operator(p), 16 * mf, 32 * kf)
    Am = [[_a_matrix(opA[i, c]) for c in range(kc)] for i in range(mt)]
    Fm = [[_a_matrix(opF[i, c]) for c in range(kf)] for i in range(mf)]
    C = np.full((p, m), -1, dtype=np.int64)

    def load4(row, col0):
        return sum(int(B[row, col0 + j]) << (8 * j) for j in range(4) if row < k and col0 + j < m)

    def store8(sym, col0, lo, hi):
        for j in range(8):
            if col0 + j < m:
                C[sym, col0 + j] = ((lo if j < 4 else hi) >> (8 * (j & 3))) & 0xFF

    for blk0 in range(0, m, tile):
        for base in range(blk0, min(m, blk0 + tile), 32):
            rbase = base - (blk0 if pinned else 0)
            bits = np.zeros((32, 32 * kf), dtype=np.int64)  # [column 4n + j, row]
            for i in range(mt):
                acc = {j: np.zeros((16, 8), dtype=np.int64) for j in range(4)}
                for c in range(kc):
                    regs = {j: [] for j in range(4)}
                    for lane in range(32):
                        g, t = lane >> 2, lane & 3
                        if expand == "nibble":
                            wd = load4(c, rbase + 4 * g)
                        else:
                            w0 = load4(c * 4 + (t >> 1), rbase + 4 * g)
                            w1 = load4(c * 4 + 2 + (t >> 1), rbase + 4 * g)
                        for j in range(4):
                            if expand == "nibble":
                                b = (wd >> (8 * j)) & 0xFF
                                hi, lo = b >> 4, b & 0xF
                                regs[j].append(((1 << (8 * (hi & 3))) if hi >> 2 == t else 0,
                                                (1 << (8 * (lo & 3))) if lo >> 2 == t else 0))
                            else:
                                s0 = (t & 1) * 4
                                regs[j].append((_expand4((w0 >> (8 * j)) & 0xFF, s0, expand),
                                                _expand4((w1 >> (8 * j)) & 0xFF, s0, expand)))
                    for j in range(4):
                        acc[j] += Am[i][c] @ _b_matrix(regs[j], signed=True)
                for j in range(4):
                    if refold == "sum":
                        for t in range(4):
                            v = 0
                            for g in range(8):  # the three xor-shuffles OR over g
                                d = acc[j][:, 2 * t:2 * t + 2]
                                v |= ((d[g, 0] & 1) | (d[g, 1] & 1) << 8 | (d[g + 8, 0] & 1) << 16
                                      | (d[g + 8, 1] & 1) << 24) << g
                            for g, sel in ((0, 0), (1, 16)):
                                if 2 * i + g < p:
                                    col = base + 8 * t + j
                                    for off, shift in ((0, sel), (4, sel + 8)):
                                        if col + off < m:
                                            C[2 * i + g, col + off] = (v >> shift) & 0xFF
                    else:
                        for n in range(8):
                            bits[4 * n + j, 16 * i:16 * i + 16] = acc[j][:, n] & 1
            if refold == "dot":
                for f in range(mf):
                    for j in range(4):
                        out = sum(Fm[f][c] @ bits[[4 * g + j for g in range(8)], 32 * c:32 * c + 32].T
                                  for c in range(kf))
                        for t in range(4):
                            for g in range(16):
                                sym = 16 * f + g
                                for n, off in ((2 * t, 0), (2 * t + 1, 4)):
                                    if sym < p and base + 8 * t + off + j < m:
                                        C[sym, base + 8 * t + off + j] = out[g, n] & 0xFF
    return C


@pytest.mark.parametrize("expand,refold", cuda_planes.PAIRS)
def test_kernel_model_matches_oracle(expand, refold):
    """Fragment packing, per-lane expansion, the column permutation 4n + j,
    the shuffle refold and the dot refold through shared memory, modelled
    lane by lane: a ragged edge and p past one m-tile of F rows."""
    A, B = _operands(3, 5, 70, 70)
    np.testing.assert_array_equal(_emulate_kernel(A, B, expand, refold, 64), get_field(8).matmul(A, B))


@pytest.mark.parametrize("refold", ["sum", "dot"])
def test_kernel_model_pinned_and_deep(refold):
    A, B = _operands(17, 9, 40, 71)
    want = get_field(8).matmul(A, B)
    np.testing.assert_array_equal(_emulate_kernel(A, B, "shift_raw", refold, 32, pinned=True),
                                  want[:, np.arange(40) % 32])


def test_fragment_packing_round_trips():
    rng = np.random.default_rng(72)
    op = rng.integers(0, 256, size=(40, 70))
    frags = cuda_planes.pack_fragments(op, 48, 96)
    assert frags.shape == (3, 3, 32, 4) and frags.dtype == np.uint32
    full = np.block([[_a_matrix(frags[i, c]) for c in range(3)] for i in range(3)])
    np.testing.assert_array_equal(full[:40, :70], op)
    assert not full[40:].any() and not full[:, 70:].any()
