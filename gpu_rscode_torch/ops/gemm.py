"""GF(2^w) GEMM, plain PyTorch versions: the counterpart of the JAX
package's ``ops/gemm.py``.

``C = A . B`` over GF(2^w): ``A`` is the tiny (p, k) coefficient matrix
(host NumPy), ``B`` the (k, m) stripe of uint8 (w=8) or uint16 (w=16)
symbols, and accumulation is XOR.

* **bitplane:** ``bits(C) = expand_bitmatrix(A) @ bits(B) mod 2``, one
  integer-valued matmul over GF(2) bit planes.  On the CPU it is an int32
  matmul; on CUDA ``torch.matmul`` has no integer path, so it runs in
  float32 with TF32 switched off (the depth k*w <= 2048 keeps every sum
  exact, far below 2^24).  This is also the plain version the CUDA kernel
  (:mod:`.cuda_gemm`) is held against.
* **table:** branchless log/exp gathers XOR-folded over k.

Torch's uint16 support for shifts and bitwise ops is thin, so symbols are
widened to int32 before any arithmetic and narrowed back at the end.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch

from .gf import get_field
from .gf_torch import tables

# Columns per plain-version block: bounds the (k*w, cols) bit-plane
# intermediate (4 bytes per entry after the matmul cast) on either device.
PLAIN_BLOCK_COLS = 1 << 18


def to_tensor(arr, device=None) -> torch.Tensor:
    """NumPy uint8/uint16 symbols (or a tensor) -> tensor on ``device``."""
    if isinstance(arr, torch.Tensor):
        return arr if device is None else arr.to(device)
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.uint16)
    else:
        t = torch.from_numpy(arr)
    return t if device is None else t.to(device)


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """Tensor of symbols or accumulators -> host NumPy array."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.uint16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _widen(B: torch.Tensor) -> torch.Tensor:
    """uint8/uint16 symbols -> int32 values (uint16 through int16 & 0xFFFF)."""
    if B.dtype == torch.uint16:
        return B.view(torch.int16).to(torch.int32) & 0xFFFF
    return B.to(torch.int32)


def _narrow(x: torch.Tensor, w: int) -> torch.Tensor:
    """int32 values in [0, 2^w) -> uint8 (w <= 8) or uint16 symbols."""
    if w <= 8:
        return x.to(torch.uint8)
    return torch.where(x >= 1 << 15, x - (1 << 16), x).to(torch.int16).view(torch.uint16)


def _coeff(A, device) -> torch.Tensor:
    """Coefficient matrix (NumPy or tensor) -> int64 tensor on ``device``."""
    if isinstance(A, torch.Tensor):
        return A.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(A, dtype=np.int64), device=device)


def coefficients(A, k: int, w: int) -> np.ndarray:
    """A kernel wrapper's (p, k) coefficient matrix as host int64, checked
    against the data's depth ``k`` and the field GF(2^w)."""
    A = np.asarray(A.cpu() if isinstance(A, torch.Tensor) else A).astype(np.int64)
    if A.ndim != 2 or A.shape[1] != k:
        raise ValueError(f"shape mismatch {A.shape} @ ({k}, m)")
    if A.size and (A.min() < 0 or A.max() >= 1 << w):
        raise ValueError(f"coefficient out of range for GF(2^{w})")
    return A


@functools.lru_cache(maxsize=None)
def _np_bitmats(w: int) -> np.ndarray:
    return get_field(w).bitmats  # (2^w, w, w) uint8


def expand_bitmatrix(A, w: int = 8, device=None) -> torch.Tensor:
    """(p, k) GF matrix -> (p*w, k*w) 0/1 uint8 operator (one gather from
    the per-element bitmatrix table)."""
    A = _coeff(A, device)
    bitmats = torch.as_tensor(_np_bitmats(w), device=A.device)
    p, k = A.shape
    blocks = bitmats[A]  # (p, k, w, w)
    return blocks.permute(0, 2, 1, 3).reshape(p * w, k * w)


@functools.lru_cache(maxsize=None)
def _np_nibble_mats(w: int) -> np.ndarray:
    return get_field(w).nibble_mats  # (256, 8, 32) uint8


def expand_nibblematrix(A, w: int = 8, device=None) -> torch.Tensor:
    """(p, k) GF(2^8) matrix -> (p*w, k*32) 0/1 uint8 one-hot-nibble
    operator: block (i, j) maps ``[one_hot(hi); one_hot(lo)]`` of data byte
    j to the bit planes of ``A[i, j] * byte``."""
    A = _coeff(A, device)
    mats = torch.as_tensor(_np_nibble_mats(w), device=A.device)
    p, k = A.shape
    blocks = mats[A]  # (p, k, w, 32)
    return blocks.permute(0, 2, 1, 3).reshape(p * w, k * 32)


def to_bitplanes(B: torch.Tensor, w: int = 8) -> torch.Tensor:
    """(k, m) symbols -> (k*w, m) 0/1 uint8 planes, bit 0 (LSB) first:
    row ``i*w + s`` holds bit s of symbol row i."""
    k, m = B.shape
    shifts = torch.arange(w, dtype=torch.int32, device=B.device)
    planes = (_widen(B)[:, None, :] >> shifts[None, :, None]) & 1
    return planes.reshape(k * w, m).to(torch.uint8)


def from_bitplanes(Cbits: torch.Tensor, w: int = 8) -> torch.Tensor:
    """(p*w, m) integer accumulators -> (p, m) symbols: parity of each
    accumulator (XOR == sum mod 2), refolded into w-bit symbols."""
    pw, m = Cbits.shape
    shifts = torch.arange(w, dtype=torch.int32, device=Cbits.device)
    planes = (Cbits.to(torch.int32) & 1).reshape(pw // w, w, m)
    return _narrow((planes << shifts[None, :, None]).sum(dim=1, dtype=torch.int32), w)


@contextlib.contextmanager
def _exact_float32_matmul():
    """Full float32 products on CUDA: TF32 keeps ~10 mantissa bits, which
    would round the integer sums the parity is read from."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _dot_bits(a_bits: torch.Tensor, b_bits: torch.Tensor) -> torch.Tensor:
    """Integer matmul with exact accumulation -> int32 (sums below 2^24 on
    CUDA, where it runs in float32)."""
    if a_bits.device.type == "cpu":
        return a_bits.to(torch.int32) @ b_bits.to(torch.int32)
    with _exact_float32_matmul():
        acc = a_bits.to(torch.float32) @ b_bits.to(torch.float32)
    return acc.to(torch.int32)


def gf_matmul_bitplane(A, B: torch.Tensor, w: int = 8, fold_parity: bool = True) -> torch.Tensor:
    """``C = A . B`` over GF(2^w) as one GF(2) bit-plane matmul.

    ``fold_parity=False`` returns the raw (p*w, m) int32 accumulators of
    the masked planes instead of the folded (p, m) symbols.
    """
    a_bits = expand_bitmatrix(A, w, B.device)
    p, m = a_bits.shape[0] // w, B.shape[1]
    if fold_parity:
        out = torch.empty((p, m), dtype=B.dtype, device=B.device)
    else:
        out = torch.empty((p * w, m), dtype=torch.int32, device=B.device)
    for lo in range(0, m, PLAIN_BLOCK_COLS):
        hi = min(m, lo + PLAIN_BLOCK_COLS)
        acc = _dot_bits(a_bits, to_bitplanes(B[:, lo:hi], w))
        out[:, lo:hi] = from_bitplanes(acc, w) if fold_parity else acc
    return out


def gf_matmul_table(A, B: torch.Tensor, w: int = 8) -> torch.Tensor:
    """``C = A . B`` via branchless log/exp gathers, XOR-folded over k."""
    log, exp = tables(w, B.device)
    logA = log[_coeff(A, B.device)]  # (p, k)
    logB = log[_widen(B).long()]  # (k, m)
    acc = torch.zeros((logA.shape[0], B.shape[1]), dtype=torch.int64, device=B.device)
    for t in range(logA.shape[1]):
        acc ^= exp[logA[:, t, None] + logB[t][None, :]]
    return _narrow(acc.to(torch.int32), w)


STRATEGIES = ("cuda", "bitplane", "table")


def gf_matmul(A, B, w: int = 8, strategy: str = "bitplane") -> torch.Tensor:
    """Dispatch over the GEMM strategies; ``B`` may be NumPy or a tensor."""
    B = to_tensor(B)
    if strategy == "bitplane":
        return gf_matmul_bitplane(A, B, w)
    if strategy == "table":
        return gf_matmul_table(A, B, w)
    if strategy == "cuda":
        from .cuda_gemm import gf_matmul_cuda

        return gf_matmul_cuda(A, B, w)
    raise ValueError(f"unknown strategy {strategy!r}; choose from {', '.join(STRATEGIES)}")
