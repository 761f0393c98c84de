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
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .gemm import gf_matmul_bitplane
from .gf import get_field

# Kernel launches since the count was last reset.  Only the launch below
# adds to it.
LAUNCHES = 0

_SOURCES = [_build.CSRC / "gf_gemm.cu"]
_OPERATORS: dict = {}
_MAX_OPERATORS = 64


def _lib() -> ctypes.CDLL:
    lib = _build.load("gf_gemm", _SOURCES)
    if not hasattr(lib, "_rs_bound"):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rs_gf_gemm.argtypes = [vp, vp, vp, i32, i32, i32, ctypes.c_longlong, i32, i32, vp]
        lib.rs_gf_gemm.restype = i32
        lib.rs_gf_gemm_words.argtypes = [i32, i32]
        lib.rs_gf_gemm_words.restype = i32
        lib.rs_cuda_error_string.argtypes = [i32]
        lib.rs_cuda_error_string.restype = ctypes.c_char_p
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
    key = (A.shape, A.tobytes(), w, words, str(device))
    op = _OPERATORS.get(key)
    if op is None:
        if len(_OPERATORS) >= _MAX_OPERATORS:
            _OPERATORS.clear()
        packed = pack_operator(A, w, words)
        op = torch.from_numpy(packed.view(np.int32)).to(device)
        _OPERATORS[key] = op
    return op


def gf_matmul_cuda(A, B: torch.Tensor, w: int = 8, fold_parity: bool = True) -> torch.Tensor:
    """``C = A . B`` over GF(2^w) through the CUDA kernel.

    ``A``: (p, k) coefficient matrix (NumPy or tensor, entries < 2^w).
    ``B``: (k, m) contiguous tensor of uint8 (w=8) or uint16 (w=16).
    Returns (p, m) symbols of B's dtype or, with ``fold_parity=False``, the
    (p*w, m) int32 bit-plane accumulators (pre-parity form).
    """
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
    A = np.asarray(A.cpu() if isinstance(A, torch.Tensor) else A).astype(np.int64)
    k, m = B.shape
    if A.ndim != 2 or A.shape[1] != k:
        raise ValueError(f"shape mismatch {A.shape} @ {tuple(B.shape)}")
    if A.size and (A.min() < 0 or A.max() >= 1 << w):
        raise ValueError(f"coefficient out of range for GF(2^{w})")
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
    if err != 0:
        raise RuntimeError(
            f"gf_gemm kernel launch failed: {lib.rs_cuda_error_string(err).decode()} "
            f"(cudaError {err})"
        )
    LAUNCHES += 1
    return C
