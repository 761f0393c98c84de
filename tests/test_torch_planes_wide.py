"""K3's GEMM at w=16 and its pre-parity form, against the JAX package.

The port runs ``shift``, ``shift_raw`` and ``sign`` at w=16 with the sum,
dot and autotune refolds, and the pre-parity form (``fold_parity=False``,
K3's refold "none") of every expansion name but pack2.  Each is held with
tolerance 0 against ``gf_matmul_pallas(..., interpret=True)`` on seeded
inputs: the folded symbols exactly and against ``GaloisField.matmul``; the
pre-parity sums value for value against JAX's with ``acc_dtype=int8`` (the
TPU's production contract, which the card's int8 tensor cores reproduce)
and against its default accumulator mod 2 (``shift_raw``'s sums depend on
the accumulator; their parity does not).  The CUDA kernel runs only on the
card (chip_smoke.py phase 7); here a NumPy model of ``csrc/gf_planes.cu``
at the level of mma fragments checks its w=16 loads, expansions and
refolds (F' for dot) and the pre-parity stores."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_rscode_torch.ops import cuda_gemm, cuda_planes
from gpu_rscode_torch.ops.gemm import from_bitplanes, to_numpy, to_tensor
from gpu_rscode_tpu.ops.gf import get_field
from gpu_rscode_tpu.ops.pallas_gemm import gf_matmul_pallas
from test_torch_planes import _a_matrix, _b_matrix, _expand4

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
                                           (8, "nibble", "dot"), (4, "shift", "dot"), (4, "shift_raw", "none"))] == [
        "sum", "sum", "w16", "preparity", "preparity", "dot", "dot", "w4", "preparity"]
    A, B = _operands(2, 3, 64, 16, 85)
    for expand in ("cmp", "nibble"):
        with pytest.raises(ValueError, match="byte-granular"):
            cuda_planes.gf_matmul_planes(A, to_tensor(B), expand, "sum", w=16)
    with pytest.raises(ValueError, match="uint16"):
        cuda_planes.gf_matmul_planes(A, torch.zeros((3, 64), dtype=torch.uint8), "shift", "sum", w=16)
    with pytest.raises(ValueError, match="w=4, 8 and 16"):
        cuda_planes.gf_matmul_planes(A % 16, torch.zeros((3, 64), dtype=torch.uint8), "shift", "sum", w=2)


def test_fold_operator_split():
    """F' at w=16: per symbol a low-byte row (2^s, s < 8) and a high-byte
    row (2^(s-8), s >= 8), in tiles of 8 symbols; lo | hi << 8 is F's
    2^s weighting."""
    for p in (1, 8, 9, 17):
        Fs = cuda_planes.fold_operator_split(p)
        assert Fs.shape == (16 * -(-p // 8), 16 * p) and Fs.max() <= 128
        rows = np.array([16 * (i // 8) + i % 8 for i in range(p)])
        np.testing.assert_array_equal(Fs[rows] + (Fs[rows + 8] << 8), cuda_planes.fold_operator(p, 16))
        assert cuda_planes._dims(10, p, "shift", 16) == (p, 5, -(-p // 8), -(-p * 16 // 32))


# --- NumPy model of gf_planes_kernel at w=16 and with refold none -----------

def _emulate(A, B, expand, refold, tile, w, pinned=False):
    """gf_planes_kernel<W, EXPAND, REFOLD> lane by lane: the w=16 two-symbol
    chunks (rows 2c, 2c + 1 at bits 4t..4t+3), the w=8 four-symbol ones, the
    sum refold's xor-shuffles and w=16 stores, the dot refold's parity bits
    through shared memory and F' (w=16), and refold none's int32 stores."""
    k, m = B.shape
    p = A.shape[0]
    mt, kc, mf, kf = cuda_planes._dims(k, p, expand, w)
    opA = cuda_planes.pack_fragments(cuda_planes._operator_bits(A, expand, w).numpy(), 16 * mt, 32 * kc)
    F = cuda_planes.fold_operator(p) if w == 8 else cuda_planes.fold_operator_split(p)
    opF = cuda_planes.pack_fragments(F, 16 * mf, 32 * kf)
    Am = [[_a_matrix(opA[i, c]) for c in range(kc)] for i in range(mt)]
    Fm = [[_a_matrix(opF[i, c]) for c in range(kf)] for i in range(mf)]
    C = np.full((p * w if refold == "none" else p, m), -(1 << 40), dtype=np.int64)

    def sym(row, col):
        return int(B[row, col]) if row < k and col < m else 0

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
                        for j in range(4):
                            col = rbase + 4 * g + j
                            if w == 16:
                                pair = (sym(2 * c, col), sym(2 * c + 1, col))
                                regs[j].append(tuple(_expand4(b, 4 * t, expand) for b in pair))
                            elif expand == "nibble":
                                b = sym(c, col)
                                hi, lo = b >> 4, b & 0xF
                                regs[j].append(((1 << (8 * (hi & 3))) if hi >> 2 == t else 0,
                                                (1 << (8 * (lo & 3))) if lo >> 2 == t else 0))
                            else:
                                s0 = (t & 1) * 4
                                regs[j].append((_expand4(sym(c * 4 + (t >> 1), col), s0, expand),
                                                _expand4(sym(c * 4 + 2 + (t >> 1), col), s0, expand)))
                    for j in range(4):
                        acc[j] += Am[i][c] @ _b_matrix(regs[j], signed=True)
                for j in range(4):
                    for n in range(8):
                        col = base + 4 * n + j
                        if refold == "none":
                            for r in range(16):
                                if 16 * i + r < p * w and col < m:
                                    C[16 * i + r, col] = acc[j][r, n]
                        elif refold == "dot":
                            bits[4 * n + j, 16 * i:16 * i + 16] = acc[j][:, n] & 1
                    if refold == "sum":  # w=16 only here: m-tile i is symbol i
                        for t in range(4):
                            v = 0
                            for g in range(8):
                                d = acc[j][:, 2 * t:2 * t + 2]
                                v |= ((d[g, 0] & 1) | (d[g, 1] & 1) << 8 | (d[g + 8, 0] & 1) << 16
                                      | (d[g + 8, 1] & 1) << 24) << g
                            for off, val in ((0, (v & 0xFF) | ((v >> 8) & 0xFF00)),
                                             (4, ((v >> 8) & 0xFF) | ((v >> 16) & 0xFF00))):
                                if base + 8 * t + off + j < m:
                                    C[i, base + 8 * t + off + j] = val
            if refold == "dot":
                for f in range(mf):
                    for j in range(4):
                        out = sum(Fm[f][c] @ bits[[4 * g + j for g in range(8)], 32 * c:32 * c + 32].T
                                  for c in range(kf))
                        for t in range(4):
                            for n, off in ((2 * t, 0), (2 * t + 1, 4)):
                                col = base + 8 * t + off + j
                                for g in range(8 if w == 16 else 16):
                                    s = (8 if w == 16 else 16) * f + g
                                    if s < p and col < m:
                                        C[s, col] = ((out[g, n] & 0xFF) | (out[g + 8, n] & 0xFF) << 8 if w == 16
                                                     else out[g, n] & 0xFF)
    return C


@pytest.mark.parametrize("expand,refold,w", [(e, r, 16) for e in cuda_planes.WIDE_EXPANDS
                                             for r in ("sum", "dot", "none")]
                         + [(e, "none", 8) for e in cuda_planes.EXPANDS])
def test_kernel_model_matches_plain(expand, refold, w):
    """Odd p (w=8's half m-tile of padding rows is not stored), odd k (a
    w=16 chunk whose second symbol is past k), a ragged edge, and p past
    one F' tile at w=16."""
    p, k, m = (9, 3, 70) if w == 16 and refold == "dot" else (3, 5, 70)
    A, B = _operands(p, k, m, w, 86)
    want = cuda_planes.gf_matmul_planes_plain(A, to_tensor(B), expand, refold, w=w)
    np.testing.assert_array_equal(_emulate(A, B, expand, refold, 64, w), _widen64(want))


def test_kernel_model_w16_pinned_and_largest_sums():
    """Pinned blocks at w=16, and the largest shift_raw planes: every
    symbol 0xFFFF (each plane byte 0xFF, -1 as int8) and every coefficient
    the densest element of the w=16 field."""
    A, B = _operands(2, 4, 100, 16, 87)
    want = get_field(16).matmul(A, B)
    np.testing.assert_array_equal(_emulate(A, B, "shift_raw", "sum", 64, 16, pinned=True),
                                  want[:, np.arange(100) % 64])
    dense = int(get_field(16).bitmats.sum(axis=2).max(axis=1).argmax())
    A = np.full((2, 3), dense, dtype=np.uint16)
    B = np.full((3, 40), 0xFFFF, dtype=np.uint16)
    for refold in ("none", "dot"):
        got = _emulate(A, B, "shift_raw", refold, 64, 16)
        want = cuda_planes.gf_matmul_planes_plain(A, to_tensor(B), "shift_raw", refold, w=16)
        np.testing.assert_array_equal(got, _widen64(want))


def _widen64(t: torch.Tensor) -> np.ndarray:
    return to_numpy(t).astype(np.int64)
