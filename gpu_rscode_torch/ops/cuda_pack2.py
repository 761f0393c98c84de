"""K2, the packed two-column GF(2^8) GEMM, as a hand-written CUDA kernel:
the counterpart of the JAX package's ``ops/pallas_gemm.py``
``_pallas_matmul_pack2`` (``gf_matmul_pallas(expand="pack2")``).

Two adjacent data bytes share one integer lane; bit plane s of both is
``(v >> s) & 0x0101``; the (p*8, k*8) bit operator selects the planes
summed into each output bit's accumulator; ``acc & 0x0101`` refolded over
the 8 output bits gives both output bytes of the lane.  Each 8-bit field
stays carry-free while the depth is at most 248, so deeper products run as
slices of at most 31 data symbols, XORed together.

``gf_matmul_pack2`` launches ``csrc/gf_pack2.cu`` for a CUDA tensor and
takes :func:`gf_matmul_pack2_plain` only for a CPU tensor.  Nothing catches
a build or launch error.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .gemm import PLAIN_BLOCK_COLS, _dot_bits, coefficients, expand_bitmatrix
from .gf import get_field

# Kernel launches since the count was last reset.  Only the launch below
# adds to it.
LAUNCHES = 0

K_SLICE = 31  # data symbols per carry-free depth slice: 31 * 8 = 248 < 256
DEFAULT_TILE = 512  # columns per block: one lane per thread
SOURCES = [_build.CSRC / "gf_pack2.cu"]


def _lib() -> ctypes.CDLL:
    lib = _build.load("gf_pack2", SOURCES)
    if not hasattr(lib, "_rs_bound"):
        vp, i32 = ctypes.c_void_p, ctypes.c_int
        lib.rs_gf_pack2.argtypes = [vp, vp, vp, i32, i32, ctypes.c_longlong, i32, vp]
        lib.rs_gf_pack2.restype = i32
        lib._rs_bound = True
    return lib


def tile_cols(tile: int | None, m: int) -> int:
    """The columns a block covers: ``tile`` rounded up to even, at most the
    padded width."""
    tile = DEFAULT_TILE if tile is None else int(tile)
    if tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    return min(tile + tile % 2, max(2, m + m % 2))


def check_call(w: int, fold_parity: bool, refold) -> None:
    """The refusals of the JAX package's pack2 path, in its order and words."""
    if w != 8:
        raise ValueError(f"expand='pack2' is a GF(2^8) (byte-granular) strategy, got w={w}")
    if not fold_parity:
        raise ValueError("pack2 cannot emit pre-parity accumulators")
    if refold is not None:
        raise ValueError("pack2 has a fixed f32/packed-refold pipeline; acc_dtype and refold do not apply")


def pack_operator(A: np.ndarray) -> np.ndarray:
    """(p, k) GF(2^8) matrix -> (p, k) uint64 words: bit ``t*8 + s`` of word
    (o, i) is entry (o*8 + t, i*8 + s) of ``expand_bitmatrix(A)``, the
    coefficient of output bit t on data bit s."""
    blocks = get_field(8).bitmats[A]  # (p, k, 8 t, 8 s)
    weights = np.uint64(1) << np.arange(64, dtype=np.uint64)
    return (blocks.reshape(*A.shape, 64).astype(np.uint64) * weights).sum(axis=2, dtype=np.uint64)


def _operator(A: np.ndarray, device: torch.device) -> torch.Tensor:
    return _build.cached_operator(
        ("gf_pack2", A.shape, A.tobytes(), str(device)),
        lambda: torch.from_numpy(pack_operator(A).view(np.int64)).to(device),
    )


def _pack2_slice(a_op: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """One carry-free slice, as ``_pallas_matmul_pack2`` computes it:
    (k, m) uint8 with m even -> (p, m) uint8."""
    k, m = B.shape
    p = a_op.shape[0] // 8
    shifts = torch.arange(8, dtype=torch.int32, device=B.device)
    out = torch.empty((p, m), dtype=torch.uint8, device=B.device)
    for lo in range(0, m, PLAIN_BLOCK_COLS):
        hi = min(m, lo + PLAIN_BLOCK_COLS)
        blk = B[:, lo:hi].to(torch.int32)
        # The little-endian uint16 view of byte pairs, written out so it
        # holds on any host: column 2j is the low byte, 2j + 1 the high.
        v = blk[:, 0::2] | (blk[:, 1::2] << 8)  # (k, m2)
        planes = ((v[:, None, :] >> shifts[None, :, None]) & 0x0101).reshape(k * 8, -1)
        acc = _dot_bits(a_op, planes)  # packed fields < 2^17: exact
        bits = (acc & 0x0101).reshape(p, 8, -1)
        out16 = (bits << shifts[None, :, None]).sum(dim=1, dtype=torch.int32)
        out[:, lo:hi:2] = (out16 & 0xFF).to(torch.uint8)
        out[:, lo + 1:hi:2] = (out16 >> 8).to(torch.uint8)
    return out


def gf_matmul_pack2_plain(A, B: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K2: odd m padded to even, depth split into
    slices of at most 31 data symbols, slices XORed.  int32 matmul on the
    CPU, float32 with TF32 off on CUDA (sums stay below 2^17)."""
    k, m = B.shape
    A = coefficients(A, k, 8)
    if m % 2:
        B = torch.nn.functional.pad(B, (0, 1))
    out = None
    for c0 in range(0, k, K_SLICE):
        a_op = expand_bitmatrix(A[:, c0:c0 + K_SLICE], 8, B.device)
        part = _pack2_slice(a_op, B[c0:c0 + K_SLICE])
        out = part if out is None else out ^ part
    if out is None:
        out = torch.zeros((A.shape[0], B.shape[1]), dtype=torch.uint8, device=B.device)
    return out[:, :m]


def gf_matmul_pack2(A, B: torch.Tensor, w: int = 8, fold_parity: bool = True, refold=None,
                    tile: int | None = None) -> torch.Tensor:
    """``C = A . B`` over GF(2^8) through K2.

    ``A``: (p, k) coefficients; ``B``: (k, m) contiguous uint8 tensor.
    ``tile``: columns per CUDA block (rounded up to even, at most the
    padded width; default 512).
    Returns (p, m) uint8.
    """
    global LAUNCHES
    check_call(w, fold_parity, refold)
    if not isinstance(B, torch.Tensor):
        raise TypeError(f"B must be a tensor, got {type(B).__name__}")
    if tile is not None and tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    if B.device.type == "cpu":
        return gf_matmul_pack2_plain(A, B)
    if B.device.type != "cuda":
        raise ValueError(f"gf_matmul_pack2 runs on cuda or cpu tensors, got {B.device}")
    if B.dtype != torch.uint8 or B.dim() != 2 or not B.is_contiguous():
        raise ValueError(f"B must be a contiguous 2-D uint8 tensor, got {B.dtype} {tuple(B.shape)}")
    k, m = B.shape
    tile = tile_cols(tile, m)
    A = coefficients(A, k, 8)
    p = A.shape[0]
    pad = m % 2
    m2 = (m + pad) // 2
    C = torch.empty((p, 2 * m2), dtype=torch.uint8, device=B.device)
    if p == 0 or m == 0:
        return C[:, :m]
    if k == 0:
        return C.zero_()[:, :m]
    if pad:
        B = torch.nn.functional.pad(B, (0, 1))
    lib = _lib()
    op = _operator(A, B.device)
    with torch.cuda.device(B.device):
        err = lib.rs_gf_pack2(op.data_ptr(), B.data_ptr(), C.data_ptr(), k, p, m2, tile,
                              torch.cuda.current_stream(B.device).cuda_stream)
    _build.check(lib, err, "gf_pack2")
    LAUNCHES += 1
    return C[:, :m].contiguous() if pad else C
