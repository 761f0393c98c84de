"""K3's GEMM at w=16 and its pre-parity form, against the JAX package.

The port runs ``shift``, ``shift_raw`` and ``sign`` at w=16 with the sum,
dot and autotune refolds, and the pre-parity form (``fold_parity=False``,
K3's refold "none") of every expansion name but pack2.  Each is held with
tolerance 0 against ``gf_matmul_pallas(..., interpret=True)`` on seeded
inputs: the folded symbols exactly and against ``GaloisField.matmul``; the
pre-parity sums value for value against JAX's with ``acc_dtype=int8`` (the
TPU's production contract, which the card's int8 tensor cores reproduce)
and against its default accumulator mod 2 (``shift_raw``'s sums depend on
the accumulator; their parity does not).  The CUDA kernels run only on the
card (chip_smoke.py phase 7); here NumPy models of ``csrc/gf_planes.cu``
at the level of mma fragments check each instance's kernel: the sum and
dot kernels at w=16 (``test_torch_k3_w16.py``) and the none kernel at w=8
and 16 (``test_torch_k3_preparity.py``: at w=16 two byte-symbols a
symbol, shift_raw's exact words keeping a low byte's high bits)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_rscode_torch.ops import cuda_gemm, cuda_planes
from gpu_rscode_torch.ops.gemm import from_bitplanes, to_numpy, to_tensor
from gpu_rscode_tpu.ops.gf import get_field
from gpu_rscode_tpu.ops.pallas_gemm import gf_matmul_pallas
from test_torch_k3_dot import model as dot_model
from test_torch_k3_preparity import model as none_model
from test_torch_k3_sum import model as sum_model

JAX_NAMES = ["shift", "shift_raw", "packed32", "sign16", "shift_u8", "nibble_const", "nibble32", "sign", "nibble"]


def _operands(p, k, m, w, seed):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if w == 8 else np.uint16
    return (rng.integers(0, 1 << w, size=(p, k)).astype(dt), rng.integers(0, 1 << w, size=(k, m)).astype(dt))


@pytest.fixture(autouse=True)
def _no_knobs(monkeypatch):
    for var in cuda_gemm.KNOBS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(cuda_gemm, "_AUTOTUNE_CACHE", {})  # the autotune cases' decisions stay here


@pytest.mark.parametrize("refold", ["sum", "dot", "autotune"])
@pytest.mark.parametrize("expand", cuda_planes.WIDE_EXPANDS)
def test_w16_matches_jax_and_oracle(expand, refold):
    A, B = _operands(4, 10, 640, 16, 81)
    jax_kw = {"acc_dtype": jnp.int8} if expand == "shift_raw" else {}
    want = np.asarray(gf_matmul_pallas(A, B, w=16, expand=expand, refold=refold, interpret=True, **jax_kw))
    got = to_numpy(cuda_gemm.gf_matmul_cuda(A, to_tensor(B), 16, expand=expand, refold=refold))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, get_field(16).matmul(A, B))


@pytest.mark.parametrize("name,w", [(n, 8) for n in JAX_NAMES] + [(n, 16) for n in cuda_planes.WIDE_EXPANDS])
def test_preparity_matches_jax_int8(name, w):
    A, B = _operands(4, 10, 384, w, 82 + w)
    want = np.asarray(gf_matmul_pallas(A, B, w=w, expand=name, fold_parity=False, acc_dtype=jnp.int8,
                                       interpret=True))
    got = cuda_gemm.gf_matmul_cuda(A, to_tensor(B), w, expand=name, fold_parity=False)
    assert got.dtype == torch.int32 and got.shape == (4 * w, 384)
    np.testing.assert_array_equal(got.numpy(), want)
    default = np.asarray(gf_matmul_pallas(A, B, w=w, expand=name, fold_parity=False, interpret=True))
    np.testing.assert_array_equal(got.numpy() & 1, default & 1)
    np.testing.assert_array_equal(to_numpy(from_bitplanes(got, w)), get_field(w).matmul(A, B))


def test_preparity_ignores_refold_and_pack2_refuses(monkeypatch):
    """With fold_parity=False the refold is ignored (autotune times
    nothing), as in the JAX package; pack2's pre-parity refusal keeps its
    words."""
    A, B = _operands(3, 6, 200, 8, 83)
    Bt = torch.from_numpy(B)
    monkeypatch.setattr(cuda_gemm, "_time_refold", lambda run: pytest.fail("timed a pre-parity dispatch"))
    outs = [cuda_gemm.gf_matmul_cuda(A, Bt, expand="sign", fold_parity=False, refold=r).numpy()
            for r in (None, "sum", "dot", "autotune")]
    for out in outs[1:]:
        np.testing.assert_array_equal(out, outs[0])
    with pytest.raises(ValueError, match="pack2 cannot emit pre-parity accumulators"):
        cuda_gemm.gf_matmul_cuda(A, Bt, expand="pack2", fold_parity=False)


@pytest.mark.parametrize("p,k,m", [(1, 1, 33), (3, 5, 300), (10, 9, 100)])
def test_w16_plain_instances_match_oracle(p, k, m):
    A, B = _operands(p, k, m, 16, 84 + p)
    want = get_field(16).matmul(A, B)
    Bt = to_tensor(B)
    for expand in cuda_planes.WIDE_EXPANDS:
        for refold in ("sum", "dot"):
            got = cuda_planes.gf_matmul_planes(A, Bt, expand, refold, w=16)
            np.testing.assert_array_equal(to_numpy(got), want, err_msg=f"{expand}+{refold}")
        acc = cuda_planes.gf_matmul_planes(A, Bt, expand, "none", w=16)
        np.testing.assert_array_equal(to_numpy(from_bitplanes(acc, 16)), want)
        pinned = cuda_planes.gf_matmul_planes(A, Bt, expand, "dot", tile=64, pinned=True, w=16)
        np.testing.assert_array_equal(to_numpy(pinned), want[:, np.arange(m) % 64])


def test_instances_and_refusals():
    assert set(cuda_planes.INSTANCES) == {(8, e, r) for e in cuda_planes.EXPANDS for r in cuda_planes.REFOLDS} | {
        (16, e, r) for e in ("shift", "shift_raw", "sign") for r in ("sum", "dot", "none")} | {
        (4, e, r) for e in ("shift", "shift_raw") for r in ("sum", "dot", "none")}
    assert [cuda_planes.kind(*i) for i in ((8, "shift", "sum"), (8, "nibble", "sum"), (16, "shift", "sum"),
                                           (16, "sign", "none"), (8, "cmp", "none"), (8, "shift_raw", "dot"),
                                           (8, "nibble", "dot"), (4, "shift", "dot"), (4, "shift_raw", "none"),
                                           (16, "sign", "dot"))] == [
        "sum", "sum", "w16", "preparity_w4_w16", "preparity", "dot", "dot", "w4", "preparity_w4_w16", "w16"]
    A, B = _operands(2, 3, 64, 16, 85)
    for expand in ("cmp", "nibble"):
        with pytest.raises(ValueError, match="byte-granular"):
            cuda_planes.gf_matmul_planes(A, to_tensor(B), expand, "sum", w=16)
    with pytest.raises(ValueError, match="uint16"):
        cuda_planes.gf_matmul_planes(A, torch.zeros((3, 64), dtype=torch.uint8), "shift", "sum", w=16)
    with pytest.raises(ValueError, match="w=4, 8 and 16"):
        cuda_planes.gf_matmul_planes(A % 16, torch.zeros((3, 64), dtype=torch.uint8), "shift", "sum", w=2)


def test_w16_dot_folds_bytes_with_the_w8_f():
    """The w=16 dot kernel's F is w=8's over 2p byte-symbols: byte-symbol
    2i weighs bits 0-7 of symbol i by 2^s and 2i + 1 bits 8-15 by 2^(s-8),
    each a sum below 256, and lo | hi << 8 is fold_operator(p, 16)'s
    2^s weighting; the kernel's F fragments are w=8's (two passes an
    8-byte-symbol tile)."""
    for p in (1, 8, 9, 17):
        F8 = cuda_planes.fold_operator(2 * p, 8)
        assert F8.max() <= 128 and F8.sum(axis=1).max() < 256
        np.testing.assert_array_equal(F8[0::2] + (F8[1::2] << 8), cuda_planes.fold_operator(p, 16))
    np.testing.assert_array_equal(cuda_planes.dot_fold_operator(16), cuda_planes.dot_fold_operator(8))


@pytest.mark.parametrize("w", [4, 8, 16])
def test_operators_are_each_kernels_packing(w):
    """The wrapper's device operators for every instance are the packing
    its kernel's model reads: every instance runs the sum, dot or none
    kernel, on the operator scaled by 2^s but for none (B fragments and F,
    one pass a tile at w=4, for dot)."""
    p, k = 5, 7
    A = np.random.default_rng(88 + w).integers(0, 1 << w, size=(p, k))
    for iw, expand, refold in cuda_planes.INSTANCES:
        if iw != w:
            continue
        opA, opF = cuda_planes._operators(A, expand, refold, w, torch.device("cpu"))
        assert cuda_planes.runs_mma(expand, refold, w)
        op = (cuda_planes.nibble_operator(A, scaled=refold != "none") if expand == "nibble"
              else cuda_planes.sum_operator(A, w, scaled=refold != "none"))
        want = cuda_planes.pack_b_fragments(op) if refold == "dot" else cuda_planes.pack_fragments(op, *op.shape)
        want_f = cuda_planes.dot_fold_operator(w) if refold == "dot" else None
        np.testing.assert_array_equal(opA.numpy().view(np.uint32).reshape(want.shape), want.view(np.uint32),
                                      err_msg=f"w={w} {expand}+{refold}")
        if want_f is None:
            assert opF is None
        else:
            np.testing.assert_array_equal(opF.numpy().view(np.uint32).reshape(want_f.shape), want_f.view(np.uint32))
    assert cuda_planes.runs_mma("shift", "none", 8) and cuda_planes.runs_mma("shift", "none", 16)
    assert not cuda_planes.runs_mma("cmp", "none", 16) and not cuda_planes.runs_mma("sign", "sum", 4)


def _kernel_model(A, B, expand, refold, w, tile, pinned=False):
    """The model of the kernel that runs (w, expand, refold): the sum, dot
    or none kernel's (w=16 from B's uint16)."""
    if refold == "none":
        return none_model(A, B, expand, tile, pinned)
    return (sum_model if refold == "sum" else dot_model)(A, B, expand, tile, pinned).astype(np.int64)


@pytest.mark.parametrize("expand,refold,w", [(e, r, 16) for e in cuda_planes.WIDE_EXPANDS
                                             for r in ("sum", "dot", "none")]
                         + [(e, "none", 8) for e in cuda_planes.EXPANDS])
def test_kernel_model_matches_plain(expand, refold, w):
    """Odd p (a padded m-tile, not stored), odd k (a w=16 chunk whose second
    symbol is past k), a ragged edge, and p past one 4-symbol dot tile at
    w=16, through the model of the kernel that runs each instance."""
    p, k, m = (9, 3, 70) if w == 16 and refold == "dot" else (3, 5, 70)
    A, B = _operands(p, k, m, w, 86)
    want = cuda_planes.gf_matmul_planes_plain(A, to_tensor(B), expand, refold, w=w)
    np.testing.assert_array_equal(_kernel_model(A, B, expand, refold, w, 64), _widen64(want))


def test_kernel_model_w16_pinned_and_largest_sums():
    """Pinned blocks at w=16, and the largest shift_raw planes: every
    symbol 0xFFFF (each plane byte 0xFF, -1 as int8) and every coefficient
    the densest element of the w=16 field."""
    A, B = _operands(2, 4, 100, 16, 87)
    want = get_field(16).matmul(A, B)
    np.testing.assert_array_equal(_kernel_model(A, B, "shift_raw", "sum", 16, 64, pinned=True),
                                  want[:, np.arange(100) % 64])
    dense = int(get_field(16).bitmats.sum(axis=2).max(axis=1).argmax())
    A = np.full((2, 3), dense, dtype=np.uint16)
    B = np.full((3, 40), 0xFFFF, dtype=np.uint16)
    for refold in ("none", "dot"):
        got = _kernel_model(A, B, "shift_raw", refold, 16, 64)
        want = cuda_planes.gf_matmul_planes_plain(A, to_tensor(B), "shift_raw", refold, w=16)
        np.testing.assert_array_equal(got, _widen64(want))


def _widen64(t: torch.Tensor) -> np.ndarray:
    return to_numpy(t).astype(np.int64)
