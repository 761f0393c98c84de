"""The fused GF(2^w) GEMM as hand-written CUDA kernels: the counterpart of
the JAX package's ``ops/pallas_gemm.py`` (``gf_matmul_pallas``).

``gf_matmul_cuda`` computes ``C = A . B`` over GF(2^w) with the kernels in
``csrc/gf_gemm.cu``: the folded form (``fold_parity=True``, every encode and
decode) with the bit-sliced XOR kernel, the pre-parity form with the
popcount kernel.  Its plain version is :func:`.gemm.gf_matmul_bitplane`,
which it takes only for a tensor on the CPU.  For a CUDA tensor it launches
one of the two kernels or raises: nothing catches a build or launch error.

The bit-sliced kernel reads the operator as masks (:func:`pack_masks`: each
operator bit spread to an all-ones or all-zeros 32-bit word, in the order
the kernel streams them), tiled and staged as :func:`bitslice_plan` says.
The popcount kernel reads it as packed words (:func:`pack_operator`).  Both
are built on the host from ``A`` and kept on the device per coefficient
matrix.

``expand`` names one of the JAX package's expansion formulations; it sends
the product to the kernel that computes it on the card (:data:`EXPANSIONS`):
``"pack2"`` to K2 (:mod:`.cuda_pack2`), every other name to K3's GEMM
(:mod:`.cuda_planes`).  The lane-width variants were ways around the TPU
compiler's refusals; on the card one 32-bit register already holds four
bytes, so their algebra is the base expansion's.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _build
from .gemm import coefficients, gf_matmul_bitplane
from .gf import get_field

# Kernel launches (either form) since the counts were last reset.  Only the
# launch below adds to LAUNCHES (an eager launch, which runs at once) or
# CAPTURED (a launch recorded into a CUDA graph, which runs nothing then);
# the plan layer adds to REPLAYED the K1 kernels each graph replay runs.
# Every addition holds COUNT_LOCK: the serving daemon dispatches from
# several threads at once, and += on a module global is not atomic.
LAUNCHES = 0
CAPTURED = 0
REPLAYED = 0
COUNT_LOCK = threading.Lock()

SOURCES = [_build.CSRC / "gf_gemm.cu"]

# The bit-sliced kernel's plan, chosen here (bitslice_plan); rs_gf_bitslice
# refuses an rt it has no instance for or a chunk over a block's shared memory.
TILE_PLANES = 64  # output planes a thread keeps in registers: rt * w <= 64
MASK_SMEM_BYTES = 96 * 1024  # shared memory for one depth chunk of masks


def _lib() -> ctypes.CDLL:
    lib = _build.load("gf_gemm", SOURCES)
    if not hasattr(lib, "_rs_bound"):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rs_gf_bitslice.argtypes = [vp, vp, vp, i32, i32, i32, i64, i32, i32, i32, vp]
        lib.rs_gf_bitslice.restype = i32
        lib.rs_gf_popcount.argtypes = [vp, vp, vp, i32, i32, i32, i64, i32, vp]
        lib.rs_gf_popcount.restype = i32
        lib.rs_gf_popcount_words.argtypes = [i32, i32]
        lib.rs_gf_popcount_words.restype = i32
        lib._rs_bound = True
    return lib


def bitslice_plan(p: int, k: int, w: int) -> tuple[int, int, int]:
    """``(rt, tiles, depth)`` of the bit-sliced kernel for a (p, k) matrix:
    ``tiles`` output tiles of ``rt`` symbol rows (``rt * w <= 64`` planes,
    the rows spread evenly), and ``depth`` input rows of masks staged in
    shared memory at once."""
    tiles = -(-p * w // TILE_PLANES)
    rt = -(-p // tiles)
    depth = min(k, MASK_SMEM_BYTES // (w * rt * w * 4))
    return rt, tiles, depth


def pack_masks(A: np.ndarray, w: int, rt: int, tiles: int) -> np.ndarray:
    """(p, k) GF matrix -> (tiles, k, w, rt*w) uint32 masks: entry
    ``[g, i, s, r*w + t]`` is all ones when output bit t of symbol row
    ``g*rt + r`` takes bit s of input symbol i (entry ``((g*rt + r)*w + t,
    i*w + s)`` of ``expand_bitmatrix(A)``), else zero; rows past p are zero."""
    bits = get_field(w).expand_bitmatrix(A)  # (p*w, k*w) 0/1
    pw, kw = bits.shape
    padded = np.zeros((tiles * rt * w, kw), dtype=np.uint32)
    padded[:pw] = bits
    tiled = padded.reshape(tiles, rt * w, kw // w, w).transpose(0, 2, 3, 1)
    return np.ascontiguousarray(tiled * np.uint32(0xFFFFFFFF))


def pack_operator(A: np.ndarray, w: int, words: int) -> np.ndarray:
    """(p, k) GF matrix -> (p*w, words) uint32 operator rows of the popcount
    kernel: bit ``i*w + s`` of row ``r`` is entry ``(r, i*w + s)`` of
    ``expand_bitmatrix(A)``, the coefficient of output bit ``r`` on bit s of
    symbol i."""
    bits = get_field(w).expand_bitmatrix(A)  # (p*w, k*w) 0/1
    pw, kw = bits.shape
    if kw > 32 * words:
        raise ValueError(f"{kw} operator columns do not fit in {words} words")
    padded = np.zeros((pw, 32 * words), dtype=np.uint32)
    padded[:, :kw] = bits
    weights = np.uint32(1) << np.arange(32, dtype=np.uint32)
    return (padded.reshape(pw, words, 32) * weights).sum(axis=2, dtype=np.uint32)


def _device_operator(kind: str, A: np.ndarray, w: int, layout: tuple, pack, device: torch.device) -> torch.Tensor:
    return _build.cached_operator(
        (kind, A.shape, A.tobytes(), w, layout, str(device)),
        lambda: torch.from_numpy(pack().view(np.int32)).to(device),
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

    ``expand=None`` runs K1 (the bit-sliced kernel, or with
    ``fold_parity=False`` the popcount kernel), which takes no ``refold`` or
    ``tile``.  A named
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
    global LAUNCHES, CAPTURED
    if not isinstance(B, torch.Tensor):
        raise TypeError(f"B must be a tensor, got {type(B).__name__}")
    if B.device.type == "cpu":
        return gf_matmul_bitplane(A, B, w, fold_parity)
    if B.device.type != "cuda":
        raise ValueError(f"gf_matmul_cuda runs on cuda or cpu tensors, got {B.device}")
    if w not in (8, 16):
        raise ValueError(f"the CUDA kernels support w=8 and w=16, got w={w}")
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
    stream = torch.cuda.current_stream(B.device).cuda_stream
    if fold_parity:
        rt, tiles, depth = bitslice_plan(p, k, w)
        masks = _device_operator("gf_bitslice", A, w, (rt, tiles), lambda: pack_masks(A, w, rt, tiles), B.device)
        with torch.cuda.device(B.device):
            err = lib.rs_gf_bitslice(masks.data_ptr(), B.data_ptr(), C.data_ptr(), k, p, w, m, rt, tiles, depth, stream)
        _build.check(lib, err, "gf_gemm (bit-sliced)")
    else:
        words = lib.rs_gf_popcount_words(k, w)
        if words < 0:
            raise ValueError(f"depth k={k} at w={w} exceeds the popcount kernel's operator width (k*w <= 2048 bits)")
        op = _device_operator("gf_popcount", A, w, (words,), lambda: pack_operator(A, w, words), B.device)
        with torch.cuda.device(B.device):
            err = lib.rs_gf_popcount(op.data_ptr(), B.data_ptr(), C.data_ptr(), k, p, w, m, words, stream)
        _build.check(lib, err, "gf_gemm (popcount)")
    capturing = torch.cuda.is_current_stream_capturing()
    with COUNT_LOCK:
        if capturing:
            CAPTURED += 1
        else:
            LAUNCHES += 1
    return C
