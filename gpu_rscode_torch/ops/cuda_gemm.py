"""The fused GF(2^w) GEMM as a hand-written CUDA kernel: the counterpart of
the JAX package's ``ops/pallas_gemm.py`` (``gf_matmul_pallas``).

``gf_matmul_cuda`` computes ``C = A . B`` over GF(2^w) with the kernel in
``csrc/gf_gemm.cu``.  Its plain version is
:func:`.gemm.gf_matmul_bitplane`, which it takes only for a tensor on the
CPU.  For a CUDA tensor it launches the kernel or raises: nothing catches a
build or launch error.

The operator is packed on the host from ``A`` (one row per output bit, its
``k*w`` coefficients as bits of 32-bit words, zero-padded to the kernel's
word bucket) and kept on the device per coefficient matrix.

``expand`` names one of the JAX package's expansion formulations; it sends
the product to the kernel that computes it on the card (:data:`EXPANSIONS`):
``"pack2"`` to K2 (:mod:`.cuda_pack2`), every other name to K3's GEMM
(:mod:`.cuda_planes`).  The lane-width variants were ways around the TPU
compiler's refusals; on the card one 32-bit register already holds four
bytes, so their algebra is the base expansion's.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .gemm import coefficients, gf_matmul_bitplane
from .gf import get_field

# Kernel launches since the count was last reset.  Only the launch below
# adds to it.
LAUNCHES = 0

SOURCES = [_build.CSRC / "gf_gemm.cu"]


def _lib() -> ctypes.CDLL:
    lib = _build.load("gf_gemm", SOURCES)
    if not hasattr(lib, "_rs_bound"):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rs_gf_gemm.argtypes = [vp, vp, vp, i32, i32, i32, ctypes.c_longlong, i32, i32, vp]
        lib.rs_gf_gemm.restype = i32
        lib.rs_gf_gemm_words.argtypes = [i32, i32]
        lib.rs_gf_gemm_words.restype = i32
        lib._rs_bound = True
    return lib


def pack_operator(A: np.ndarray, w: int, words: int) -> np.ndarray:
    """(p, k) GF matrix -> (p*w, words) uint32 operator rows: bit ``i*w + s``
    of row ``r`` is entry ``(r, i*w + s)`` of ``expand_bitmatrix(A)``, the
    coefficient of output bit ``r`` on bit s of symbol i."""
    bits = get_field(w).expand_bitmatrix(A)  # (p*w, k*w) 0/1
    pw, kw = bits.shape
    if kw > 32 * words:
        raise ValueError(f"{kw} operator columns do not fit in {words} words")
    padded = np.zeros((pw, 32 * words), dtype=np.uint32)
    padded[:, :kw] = bits
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (padded.reshape(pw, words, 32) * weights).sum(axis=2, dtype=np.uint32)


def _operator(A: np.ndarray, w: int, words: int, device: torch.device) -> torch.Tensor:
    return _build.cached_operator(
        ("gf_gemm", A.shape, A.tobytes(), w, words, str(device)),
        lambda: torch.from_numpy(pack_operator(A, w, words).view(np.int32)).to(device),
    )


# JAX expansion name -> the card's kernel: "pack2" is K2, the rest K3's
# GEMM with the named expansion.
EXPANSIONS = {
    "shift": "shift", "packed32": "shift", "shift_u8": "shift",
    "shift_raw": "shift_raw",
    "sign": "sign", "sign16": "sign", "signc": "sign",
    "nibble": "nibble", "nibble_const": "nibble", "nibble32": "nibble",
    "cmp": "cmp",
    "pack2": "pack2",
}
# Byte-granular formulations: GF(2^8) only.
BYTE_ONLY = frozenset(EXPANSIONS) - {"shift", "shift_raw", "sign"}


def _default_refold(w: int) -> str:
    """"dot" at w=8, "sum" elsewhere, as the JAX package defaults."""
    return "dot" if w == 8 else "sum"


def gf_matmul_cuda(A, B: torch.Tensor, w: int = 8, fold_parity: bool = True, expand: str | None = None,
                   refold: str | None = None, tile: int | None = None) -> torch.Tensor:
    """``C = A . B`` over GF(2^w) through the CUDA kernels.

    ``A``: (p, k) coefficient matrix (NumPy or tensor, entries < 2^w).
    ``B``: (k, m) contiguous tensor of uint8 (w=8) or uint16 (w=16).
    Returns (p, m) symbols of B's dtype or, with ``fold_parity=False``, the
    (p*w, m) int32 bit-plane accumulators (pre-parity form).

    ``expand=None`` runs K1, which takes no ``refold`` or ``tile``.  A named
    expansion (a key of :data:`EXPANSIONS`) runs K2 or K3 at w=8 with
    folded output; ``refold`` ("sum" or "dot") defaults to "dot" at w=8,
    ``tile`` is the columns a CUDA block covers.
    """
    if expand is not None:
        return _gf_matmul_expand(A, B, w, fold_parity, expand, refold, tile)
    if refold is not None or tile is not None:
        raise ValueError("refold and tile apply to an explicit expand; expand=None runs K1, which takes neither")
    return _gf_matmul_k1(A, B, w, fold_parity)


def _gf_matmul_expand(A, B, w, fold_parity, expand, refold, tile) -> torch.Tensor:
    from . import cuda_pack2, cuda_planes

    if expand not in EXPANSIONS:
        raise ValueError(f"unknown expand {expand!r}")
    if expand == "sign" and w not in (8, 16):
        raise ValueError(
            f"expand='sign' needs a lane-width field (w=8 or 16), got w={w}; use expand='shift' for other widths"
        )
    if expand in BYTE_ONLY and w != 8:
        raise ValueError(f"expand={expand!r} is a GF(2^8) (byte-granular) strategy, got w={w}")
    if expand == "pack2":
        return cuda_pack2.gf_matmul_pack2(A, B, w, fold_parity, refold, tile)
    if w != 8:
        raise ValueError(f"expand={expand!r} at w={w}: the K3 planes formulations are ported at w=8 only")
    if not fold_parity:
        raise ValueError("the K3 formulations emit folded symbols; pre-parity accumulators come from expand=None (K1)")
    refold = _default_refold(w) if refold is None else refold
    return cuda_planes.gf_matmul_planes(A, B, EXPANSIONS[expand], refold, tile)


def _gf_matmul_k1(A, B: torch.Tensor, w: int, fold_parity: bool) -> torch.Tensor:
    global LAUNCHES
    if not isinstance(B, torch.Tensor):
        raise TypeError(f"B must be a tensor, got {type(B).__name__}")
    if B.device.type == "cpu":
        return gf_matmul_bitplane(A, B, w, fold_parity)
    if B.device.type != "cuda":
        raise ValueError(f"gf_matmul_cuda runs on cuda or cpu tensors, got {B.device}")
    if w not in (8, 16):
        raise ValueError(f"the CUDA kernel supports w=8 and w=16, got w={w}")
    want = torch.uint8 if w == 8 else torch.uint16
    if B.dtype != want:
        raise TypeError(f"B must be {want} at w={w}, got {B.dtype}")
    if B.dim() != 2 or not B.is_contiguous():
        raise ValueError(f"B must be a contiguous 2-D tensor, got shape {tuple(B.shape)}")
    k, m = B.shape
    A = coefficients(A, k, w)
    p = A.shape[0]
    rows = p if fold_parity else p * w
    C = torch.empty((rows, m), dtype=B.dtype if fold_parity else torch.int32, device=B.device)
    if p == 0 or m == 0:
        return C
    lib = _lib()
    words = lib.rs_gf_gemm_words(k, w)
    if words < 0:
        raise ValueError(f"depth k={k} at w={w} exceeds the kernel's operator width")
    op = _operator(A, w, words, B.device)
    with torch.cuda.device(B.device):
        err = lib.rs_gf_gemm(
            op.data_ptr(), B.data_ptr(), C.data_ptr(), k, p, w, m, words,
            int(fold_parity), torch.cuda.current_stream(B.device).cuda_stream,
        )
    _build.check(lib, err, "gf_gemm")
    LAUNCHES += 1
    return C
