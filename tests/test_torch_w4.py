"""GF(2^4) through the port's CUDA entry points, against the JAX package.

JAX's ``RSCodec(k, p, w=4)`` runs K1 (``gf_matmul_pallas(A, B, 4)``), and
``gf_matmul_pallas`` takes ``expand="shift" | "shift_raw"`` with the sum,
dot and autotune refolds and ``fold_parity=False`` at w=4.  The port runs
the same through K1 (``csrc/gf_gemm.cu``: the bit-sliced kernel and the
popcount kernel at W=4) and K3 (``csrc/gf_planes.cu``: the sum, dot and
none kernels at W=4).  A symbol is one uint8 with bits 4-7 ignored, as JAX ignores them.
Each output is held with tolerance 0 against ``gf_matmul_pallas(...,
interpret=True)`` and ``GaloisField(4).matmul`` on seeded inputs whose
bytes have the high nibble set: symbols exactly, pre-parity sums value for
value against JAX's with ``acc_dtype=int8`` (the card's int8 tensor cores)
and mod 2 against its default accumulator.  The kernels run only on the card
(chip_smoke.py phases 3 and 7); here NumPy models of K1's W=4 masks and
popcount operator and of K3's W=4 fragments, loads and refolds follow them.
"""

import re
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_rscode_torch.codec import RSCodec
from gpu_rscode_torch.ops import cuda_gemm, cuda_planes
from gpu_rscode_torch.ops.gemm import to_numpy, to_tensor
from gpu_rscode_tpu.codec import RSCodec as JaxCodec
from gpu_rscode_tpu.ops.gf import get_field
from gpu_rscode_tpu.ops.pallas_gemm import gf_matmul_pallas
from test_torch_gemm import _emulate_kernel as emulate_popcount
from test_torch_k1_bitslice import COLS_PER_BLOCK, LANES, WARPS_PER_BLOCK, load16, store16, transpose_planes
from test_torch_k3_dot import model as dot_model
from test_torch_k3_preparity import model as none_model
from test_torch_k3_sum import model as sum_model
from test_torch_sharded import _both

GF4 = get_field(4)
EXPANDS = ("shift", "shift_raw")


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for var in cuda_gemm.KNOBS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(cuda_gemm, "_AUTOTUNE_CACHE", {})


def _operands(p, k, m, seed):
    """(p, k) coefficients < 16 and (k, m) bytes, the high nibble random."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 16, size=(p, k)).astype(np.uint8), rng.integers(0, 256, size=(k, m)).astype(np.uint8)


def _oracle(A, B):
    return GF4.matmul(A, B & 0xF)


@pytest.mark.parametrize("fold", [True, False])
@pytest.mark.parametrize("refold", ["sum", "dot", "autotune"])
@pytest.mark.parametrize("expand", EXPANDS)
def test_named_expansions_match_jax(expand, refold, fold):
    """Every (expand, refold, fold_parity) JAX takes at w=4, odd p and a
    ragged width: the symbols equal JAX's and the oracle's; the pre-parity
    sums equal JAX's int8 sums and, mod 2, its default accumulator's."""
    A, B = _operands(3, 5, 203, 40 + len(expand) + len(refold))
    got = cuda_gemm.gf_matmul_cuda(A, to_tensor(B), 4, fold_parity=fold, expand=expand, refold=refold)
    ref = np.asarray(gf_matmul_pallas(A, B, w=4, expand=expand, refold=refold, fold_parity=fold, interpret=True))
    if fold:
        assert got.dtype == torch.uint8 and got.shape == (3, 203)
        np.testing.assert_array_equal(to_numpy(got), ref)
        np.testing.assert_array_equal(ref, _oracle(A, B))
    else:
        assert got.dtype == torch.int32 and got.shape == (12, 203) and ref.shape == (12, 203)
        int8 = np.asarray(gf_matmul_pallas(A, B, w=4, expand=expand, fold_parity=False, acc_dtype=jnp.int8,
                                           interpret=True))
        np.testing.assert_array_equal(got.numpy(), int8)
        np.testing.assert_array_equal(got.numpy() & 1, ref & 1)


@pytest.mark.parametrize("fold", [True, False])
def test_k1_matches_jax(fold):
    """No knob and no formulation named: K1, folded and pre-parity (the
    popcount kernel's masked sums equal JAX's shift expansion's)."""
    A, B = _operands(4, 10, 1000, 4)
    got = cuda_gemm.gf_matmul_cuda(A, to_tensor(B), 4, fold_parity=fold)
    ref = np.asarray(gf_matmul_pallas(A, B, w=4, expand="shift", fold_parity=fold, interpret=True))
    np.testing.assert_array_equal(to_numpy(got), ref)
    if fold:
        np.testing.assert_array_equal(ref, _oracle(A, B))
        np.testing.assert_array_equal(np.asarray(gf_matmul_pallas(A, B, w=4, interpret=True)), ref)


@pytest.mark.parametrize("name", ["sign", "nibble", "pack2", "packed32", "shift_u8"])
def test_refusals_match_jax(name):
    """What JAX refuses at w=4 the port refuses with the same class and
    message."""
    A, B = _operands(2, 3, 64, 7)
    with pytest.raises(ValueError) as jax_err:
        gf_matmul_pallas(A, B, w=4, expand=name, interpret=True)
    with pytest.raises(ValueError) as port_err:
        cuda_gemm.gf_matmul_cuda(A, to_tensor(B), 4, expand=name)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize("value", ["sign", "nibble", "pack2"])
def test_knobs_that_do_not_apply_warn_as_jax(monkeypatch, value):
    """RS_PALLAS_EXPAND naming a formulation that does not apply at w=4
    warns with JAX's text and falls back to shift_raw."""
    A, B = _operands(2, 3, 64, 8)
    monkeypatch.setenv("RS_PALLAS_EXPAND", value)
    texts = []
    for run in (lambda: np.asarray(gf_matmul_pallas(A, B, w=4, interpret=True)),
                lambda: to_numpy(cuda_gemm.gf_matmul_cuda(A, to_tensor(B), 4))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = run()
        np.testing.assert_array_equal(out, _oracle(A, B))
        texts.append([str(w.message) for w in caught if "RS_PALLAS" in str(w.message)])
    assert texts[0] == texts[1] == [f"RS_PALLAS_EXPAND={value!r} is unknown or does not apply at w=4; using "
                                    "'shift_raw'"]


def test_knobs_resolve_as_jax(monkeypatch):
    """Under RS_PALLAS_EXPAND=shift_raw the default refold at w=4 is sum
    (JAX's _default_refold(4)); RS_PALLAS_REFOLD=dot and =autotune run K3 at
    W=4; the static resolution the mesh uses is sum."""
    A, B = _operands(4, 10, 300, 9)
    monkeypatch.setenv("RS_PALLAS_EXPAND", "shift_raw")
    assert cuda_gemm._default_refold(4) == "sum" == cuda_gemm.static_refold(4)
    cuda_planes.reset_counts()
    for refold in (None, "dot", "autotune"):
        if refold:
            monkeypatch.setenv("RS_PALLAS_REFOLD", refold)
        np.testing.assert_array_equal(to_numpy(cuda_gemm.gf_matmul_cuda(A, to_tensor(B), 4)), _oracle(A, B))
        np.testing.assert_array_equal(np.asarray(gf_matmul_pallas(A, B, w=4, interpret=True)), _oracle(A, B))
    assert cuda_gemm.static_refold(4) == "sum" and cuda_gemm.plan_refold_resolution(4) == "autotune"
    assert set(cuda_gemm.autotune_decisions().values()) <= {"sum", "dot"}
    assert sum(cuda_planes.LAUNCHES.values()) == 0  # CPU tensors: the plain versions


@pytest.mark.parametrize("knob", [None, "shift_raw"])
def test_codec_round_trip_matches_jax(monkeypatch, knob):
    """RSCodec(10, 4, w=4) on the CPU under every strategy that takes w=4
    (auto, cuda's plain version, bitplane, table) and under
    RS_PALLAS_EXPAND=shift_raw: parity equal to JAX's codec, and a decode
    with the first 4 natives lost gives the data back."""
    if knob:
        monkeypatch.setenv("RS_PALLAS_EXPAND", knob)
    data = np.random.default_rng(44).integers(0, 16, size=(10, 1000)).astype(np.uint8)
    ref = JaxCodec(10, 4, w=4, strategy="bitplane")
    want = np.asarray(ref.encode(data))
    rows = list(range(4, 14))
    for strategy in ("auto", "cuda", "bitplane", "table"):
        codec = RSCodec(10, 4, w=4, strategy=strategy, device="cpu")
        np.testing.assert_array_equal(codec.total_matrix, ref.total_matrix)
        parity = to_numpy(codec.encode(data))
        np.testing.assert_array_equal(parity, want)
        chunks = np.concatenate([data, parity])
        dec = codec.decode_matrix(rows)
        np.testing.assert_array_equal(dec, ref.decode_matrix(rows))
        np.testing.assert_array_equal(to_numpy(codec.decode(dec, chunks[rows])), data)


def test_codec_auto_never_picks_a_strategy_that_refuses_w4():
    """strategy="auto" resolves on the card to cuda (K1 at w=4) and its
    candidates leave out xor, ring and cpu, which refuse w=4."""
    from gpu_rscode_torch import tune

    assert tune.static_choice(4, "cuda") == "cuda"
    for device in ("cuda", "cpu"):
        assert not {"xor", "ring", "cpu"} & set(tune.candidate_strategies(4, device))


@pytest.mark.parametrize("stripe,k", [(1, 10), (2, 8), (4, 32)])
def test_mesh_takes_w4_as_jax(stripe, k):
    """The JAX package's mesh runs w=4 (cols: the folded kernel; stripe:
    the pre-parity form psummed); so does the port's, on K1's two forms'
    plain versions here."""
    rng = np.random.default_rng(k)
    A = rng.integers(0, 16, size=(3, k)).astype(np.uint8)
    B = rng.integers(0, 16, size=(k, (8 // stripe) * 64)).astype(np.uint8)
    got, ref = _both(A, B, 4, stripe, "cuda", "pallas")
    np.testing.assert_array_equal(got, GF4.matmul(A, B))
    np.testing.assert_array_equal(got, ref)


# --- K1 at W=4: the bit-sliced kernel's masks and loads, the popcount operator

def emulate_bitslice4(A, B):
    """NumPy model of ``gf_bitslice_kernel<4, rt>``: bytes loaded and
    transposed as at w=8 (8 words of 32 symbols), planes 0-3 folded with
    the (tiles, k, 4, rt*4) masks, output planes 4-7 zero, the inverse
    transpose and the bounded stores."""
    k, m = B.shape
    p = A.shape[0]
    rt, tiles, depth = cuda_gemm.bitslice_plan(p, k, 4)
    masks = cuda_gemm.pack_masks(A, 4, rt, tiles)
    assert masks.shape == (tiles, k, 4, rt * 4)
    offs = [(blk * WARPS_PER_BLOCK + warp) * 1024 + 16 * lane
            for blk in range(-(-m // COLS_PER_BLOCK)) for warp in range(WARPS_PER_BLOCK) for lane in range(LANES)]
    src = np.ascontiguousarray(B).ravel()
    dst = np.full(p * m + 64, 0xAB, dtype=np.uint8)
    paths = {}
    for g in range(tiles):
        out = np.zeros((len(offs), rt * 4), dtype=np.uint32)
        for i0 in range(0, k, depth):
            for r, staged in enumerate(masks[g, i0:i0 + depth]):
                words = np.stack([np.concatenate([load16(src, (i0 + r) * m, off + 512 * u, m, paths).view("<u4")
                                                  for u in range(2)]) for off in offs])
                planes = transpose_planes(words)
                for s in range(4):
                    out ^= planes[:, s, None] & staged[s][None, :]
        for r in range(rt):
            row = g * rt + r
            if row >= p:
                break
            y = transpose_planes(np.concatenate([out[:, 4 * r:4 * r + 4], np.zeros((len(offs), 4), np.uint32)], 1))
            for t, off in enumerate(offs):
                for u in range(2):
                    store16(dst, row * m, off + 512 * u, m, y[t, 4 * u:4 * u + 4].astype("<u4").view(np.uint8),
                            paths)
    assert (dst[p * m:] == 0xAB).all()
    return dst[:p * m].reshape(p, m)


@pytest.mark.parametrize("p,k,m", [(4, 10, 1000), (3, 5, 33), (16, 12, 4097), (17, 3, 100), (10, 40, 1639)])
def test_bitslice_w4_model_matches_jax(p, k, m):
    """Ragged widths, one tile of 16 rows and two tiles (p = 17), depth
    chunks: the model's bytes are JAX's, high nibble of the input ignored and
    of the output zero."""
    A, B = _operands(p, k, m, p * k + m)
    got = emulate_bitslice4(A, B)
    np.testing.assert_array_equal(got, np.asarray(gf_matmul_pallas(A, B, w=4, interpret=True)))
    assert not (got >> 4).any()


def test_bitslice_w4_plan_and_instances():
    """The plan's tile heights at w=4 are exactly the source's instances
    (rt * 4 <= 64), and the kernel stores bytes (SW = 8)."""
    source = cuda_gemm.SOURCES[0].read_text()
    instances = {int(rt) for rt in re.findall(r"X\(4, (\d+)\)", source)}
    plans = {cuda_gemm.bitslice_plan(p, 10, 4)[0] for p in range(1, 256)}
    assert instances == set(range(1, 17)) == plans
    assert "constexpr int SW = W < 8 ? 8 : W;" in source


@pytest.mark.parametrize("fold", [True, False])
def test_popcount_w4_model_matches_jax(fold):
    """The popcount kernel at W=4: eight symbols a word, each masked to its
    nibble before it is packed, against the packed operator rows."""
    source = cuda_gemm.SOURCES[0].read_text()
    assert "& ((1u << W) - 1u)) << (q * W)" in source
    A, B = _operands(4, 33, 300, 12)
    got = emulate_popcount(A, B & 0xF, 4, fold_parity=fold)
    ref = np.asarray(gf_matmul_pallas(A, B, w=4, expand="shift", fold_parity=fold, interpret=True))
    np.testing.assert_array_equal(got, ref)


# --- K3 at W=4: the sum, dot and none kernels (shift | shift_raw) -----------

def emulate_planes4(A, B, expand, refold, tile, pinned=False):
    """The kernel that runs (4, expand, refold), lane by lane: the register
    models of gf_planes_sum_kernel, gf_planes_dot_kernel and
    gf_planes_none_kernel at W=4 (test_torch_k3_sum.py, test_torch_k3_dot.py,
    test_torch_k3_preparity.py; their W=4 checks in test_torch_k3_w4.py):
    8-symbol chunks of four-symbol plane words, the sum refold's two
    xor-shuffles and the byte a storing lane picks, the dot refold's F of
    one pass a tile, and refold none's staged int32 rows."""
    models = {"sum": sum_model, "dot": dot_model, "none": none_model}
    return models[refold](A, B, expand, tile, pinned, w=4).astype(np.int64)


@pytest.mark.parametrize("refold", ["sum", "dot", "none"])
@pytest.mark.parametrize("expand", EXPANDS)
def test_planes_w4_model_matches_jax(expand, refold):
    """Odd p (a half m-tile of padding rows), k = 9 (a chunk whose last
    symbols are past k), a ragged edge over two blocks, p = 17 past one F
    tile: the model equals the plain version, which equals JAX's int8 sums
    and folded symbols."""
    for p, k, m in ((3, 9, 70), (17, 2, 40)):
        A, B = _operands(p, k, m, 5 * p + k)
        want = cuda_planes.gf_matmul_planes_plain(A, to_tensor(B), expand, refold, w=4)
        np.testing.assert_array_equal(emulate_planes4(A, B, expand, refold, 64), to_numpy(want).astype(np.int64))
        kw = dict(fold_parity=False, acc_dtype=jnp.int8) if refold == "none" else dict(refold=refold)
        ref = np.asarray(gf_matmul_pallas(A, B, w=4, expand=expand, interpret=True, **kw))
        np.testing.assert_array_equal(to_numpy(want), ref)


def test_planes_w4_pinned_and_largest_sums():
    """Pinned blocks repeat block 0's output; every byte 0xFF (shift_raw's
    planes int8(0xFF >> s)) with the densest element keeps the sums exact."""
    A, B = _operands(4, 10, 150, 13)
    want = _oracle(A, B)
    np.testing.assert_array_equal(emulate_planes4(A, B, "shift_raw", "dot", 64, pinned=True),
                                  want[:, np.arange(150) % 64])
    dense = int(GF4.bitmats.sum(axis=2).max(axis=1).argmax())
    A = np.full((5, 7), dense, dtype=np.uint8)
    B = np.full((7, 40), 0xFF, dtype=np.uint8)
    for refold in ("none", "sum"):
        got = emulate_planes4(A, B, "shift_raw", refold, 64)
        want = cuda_planes.gf_matmul_planes_plain(A, to_tensor(B), "shift_raw", refold, w=4)
        np.testing.assert_array_equal(got, to_numpy(want).astype(np.int64))


def test_planes_w4_dims_and_refusals():
    """W=4's m-tiles are 4 symbols (in pairs) and its depth chunks 8; the
    dot kernel's F is one pass a tile; the plain version's F holds 2^s up
    to 8; sign and the byte-granular expansions are refused at w=4, and the
    data must be uint8."""
    assert cuda_planes.sum_operator(np.ones((5, 10), dtype=np.uint8), 4).shape == (32, 64)
    assert cuda_planes.dot_fold_operator(4).shape == (1, 32, 2)
    assert cuda_planes.fold_operator(3, 4).max() == 8
    A, B = _operands(2, 3, 64, 14)
    with pytest.raises(ValueError, match="lane-width"):
        cuda_planes.gf_matmul_planes(A, to_tensor(B), "sign", "sum", w=4)
    for expand in ("cmp", "nibble"):
        with pytest.raises(ValueError, match="byte-granular"):
            cuda_planes.gf_matmul_planes(A, to_tensor(B), expand, "sum", w=4)
    with pytest.raises(ValueError, match="uint8"):
        cuda_planes.gf_matmul_planes(A, to_tensor(B.astype(np.uint16)), "shift", "sum", w=4)
