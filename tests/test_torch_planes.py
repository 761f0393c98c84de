"""K3 (the bit-plane GEMMs and the copy floor) of the PyTorch port against
the JAX package.

Each plain body is held bit-exact against the JAX body of the same name
from ``tools/kernel_sweep.BODIES``, run through ``pl.pallas_call(...,
interpret=True)`` with ``make_fn``'s BlockSpecs, for the normal and the
pinned index map and for ``dma``; every body runs in interpret mode on the
CPU.  The nibble operator, the field's nibble matrices and the dispatch of
every JAX expansion name through ``gf_matmul_cuda`` are held against the
JAX package.  The CUDA kernel runs only on the card (chip_smoke.py); here
its fragment packing is checked here, and every folded pair at w=8, which
runs ``gf_planes_sum_kernel`` or ``gf_planes_dot_kernel``, by the register
models of ``test_torch_k3_sum.py`` and ``test_torch_k3_dot.py`` (nibble's
PRMT tables: ``test_torch_k3_nibble.py``)."""

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
from test_torch_k3_dot import model as dot_kernel_model
from test_torch_k3_sum import model as sum_kernel_model

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


def test_dispatch_names_and_refusals(monkeypatch):
    monkeypatch.setattr(cuda_gemm, "_AUTOTUNE_CACHE", {})  # the autotune case's decision stays here
    assert set(cuda_gemm.EXPANSIONS) == set(JAX_NAMES) | {"pack2", "cmp", "signc"}
    assert set(cuda_gemm.EXPANSIONS.values()) == set(cuda_planes.EXPANDS) | {"pack2"}
    A, B = _operands(4, 10, 64, 62)
    Bt = torch.from_numpy(B)
    for name in ("cmp", "signc"):  # the sweep's names, not gf_matmul_pallas's
        got = cuda_gemm.gf_matmul_cuda(A, Bt, expand=name)
        np.testing.assert_array_equal(got.numpy(), get_field(8).matmul(A, B))
    for bad in ({"expand": "bogus"}, {"expand": "shift", "refold": "bogus"}, {"expand": "nibble", "w": 16},
                {"expand": "pack2", "fold_parity": False}):
        # Refused by both packages, with the JAX package's words.
        kw = dict(bad)
        w = kw.pop("w", 8)
        Aw, Bw = (A, B) if w == 8 else (A.astype(np.uint16), B.astype(np.uint16))
        with pytest.raises(ValueError) as j_err:
            gf_matmul_pallas(Aw, Bw, w=w, **kw)
        with pytest.raises(ValueError) as t_err:
            cuda_gemm.gf_matmul_cuda(Aw, t_gemm.to_tensor(Bw), w, **kw)
        assert str(t_err.value) == str(j_err.value)
    # What the port refused before and the JAX package runs: refold
    # "autotune", shift_raw at w=16, the pre-parity form of a named
    # expansion, and a refold with expand=None (the default expansion).
    A16, B16 = A.astype(np.uint16) * 257, B.astype(np.uint16) * 251
    cases = (({"expand": "shift", "refold": "autotune"}, {}, 8, A, B),
             ({"expand": "shift_raw"}, {"acc_dtype": jnp.int8}, 16, A16, B16),
             ({"expand": "shift", "fold_parity": False}, {"acc_dtype": jnp.int8}, 8, A, B),
             ({"refold": "dot"}, {}, 8, A, B))
    for kw, jax_kw, w, Aw, Bw in cases:
        want = np.asarray(gf_matmul_pallas(Aw, Bw, w=w, **kw, **jax_kw))
        got = cuda_gemm.gf_matmul_cuda(Aw, t_gemm.to_tensor(Bw), w, **kw)
        np.testing.assert_array_equal(t_gemm.to_numpy(got), want, err_msg=str(kw))


def test_wrappers_cpu_contract():
    A, B = _operands(4, 10, 100, 63)
    Bt = torch.from_numpy(B)
    before = {name: dict(counts) for name, counts in (("eager", cuda_planes.LAUNCHES),
                                                      ("captured", cuda_planes.CAPTURED))}
    cuda_planes.gf_matmul_planes(A, Bt, "shift", "sum")
    cuda_planes.gf_matmul_planes(A, Bt, "shift", "dot")
    cuda_planes.gf_matmul_planes(A, Bt, "shift", "none")
    cuda_planes.copy_floor(Bt, 4)
    assert {"eager": cuda_planes.LAUNCHES, "captured": cuda_planes.CAPTURED} == before
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


def _emulate_kernel(A, B, expand, refold, tile, pinned=False):
    """Every folded pair at w=8 runs the sum or the dot kernel: their
    register models."""
    if cuda_planes.is_sum_pair(expand, refold):
        return sum_kernel_model(A, B, expand, tile, pinned)
    assert cuda_planes.is_dot_pair(expand, refold)
    return dot_kernel_model(A, B, expand, tile, pinned)


@pytest.mark.parametrize("expand,refold", cuda_planes.PAIRS)
def test_kernel_model_matches_oracle(expand, refold):
    """Every folded pair at w=8 through its kernel's register model (the
    sum or the dot kernel), lane by lane: a ragged edge, p off the m-tile
    pairs."""
    A, B = _operands(3, 5, 70, 70)
    np.testing.assert_array_equal(_emulate_kernel(A, B, expand, refold, 64), get_field(8).matmul(A, B))


@pytest.mark.parametrize("refold", ["sum", "dot"])
def test_kernel_model_pinned_and_deep(refold):
    A, B = _operands(17, 9, 100, 71)
    want = get_field(8).matmul(A, B)
    np.testing.assert_array_equal(_emulate_kernel(A, B, "shift_raw", refold, 64, pinned=True),
                                  want[:, np.arange(100) % 64])


def test_fragment_packing_round_trips():
    rng = np.random.default_rng(72)
    op = rng.integers(0, 256, size=(40, 70))
    frags = cuda_planes.pack_fragments(op, 48, 96)
    assert frags.shape == (3, 3, 32, 4) and frags.dtype == np.uint32
    full = np.block([[_a_matrix(frags[i, c]) for c in range(3)] for i in range(3)])
    np.testing.assert_array_equal(full[:40, :70], op)
    assert not full[40:].any() and not full[:, 70:].any()
