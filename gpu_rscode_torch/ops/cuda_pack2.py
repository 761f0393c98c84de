"""K2, the packed two-column GF(2^8) GEMM, as a hand-written CUDA kernel:
the counterpart of the JAX package's ``ops/pallas_gemm.py``
``_pallas_matmul_pack2`` (``gf_matmul_pallas(expand="pack2")``).

Two adjacent data bytes share one uint16 lane; bit plane s of both is
``(v >> s) & 0x0101``; the (p*8, k*8) bit operator selects the planes
summed into each output bit's accumulator; ``acc & 0x0101`` refolded over
the 8 output bits gives both output bytes of the lane.  Each 8-bit field
stays carry-free while the depth is at most 248, so deeper products run as
slices of at most 31 data symbols (30 in the kernel), XORed together.

``gf_matmul_pack2`` launches ``csrc/gf_pack2.cu`` for a CUDA tensor and
takes :func:`gf_matmul_pack2_plain` only for a CPU tensor.  The kernel runs
the product on the fp16 tensor cores with the operator as the A operand of
``mma.sync.m16n8k16`` (:func:`pack_fragments`).  Nothing catches a build or
launch error.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np
import torch

from . import _build
from .gemm import PLAIN_BLOCK_COLS, _dot_bits, coefficients, expand_bitmatrix

# Kernel launches since the counts were last reset.  Only the launch below
# adds to LAUNCHES (an eager launch) or CAPTURED (a launch recorded into a
# CUDA graph, which runs nothing then); the plan layer adds to REPLAYED the
# launches its graph replays ran.  Every addition holds COUNT_LOCK.
LAUNCHES = 0
CAPTURED = 0
REPLAYED = 0
COUNT_LOCK = threading.Lock()

K_SLICE = 31  # data symbols per carry-free depth slice: 31 * 8 = 248 < 256
TILE_STEP = 128  # the kernel's column granularity: one warp step
DEFAULT_TILE = 2048  # columns per block
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
    """The columns a block covers: ``tile`` rounded up to a multiple of
    :data:`TILE_STEP`, at most ``m`` rounded up the same way."""
    tile = DEFAULT_TILE if tile is None else int(tile)
    if tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    return min(-(-tile // TILE_STEP) * TILE_STEP, max(TILE_STEP, -(-m // TILE_STEP) * TILE_STEP))


def check_call(w: int, fold_parity: bool, refold) -> None:
    """The refusals of the JAX package's pack2 path, in its order and words."""
    if w != 8:
        raise ValueError(f"expand='pack2' is a GF(2^8) (byte-granular) strategy, got w={w}")
    if not fold_parity:
        raise ValueError("pack2 cannot emit pre-parity accumulators")
    if refold is not None:
        raise ValueError("pack2 has a fixed f32/packed-refold pipeline; acc_dtype and refold do not apply")


def pack_fragments(A: np.ndarray) -> np.ndarray:
    """(p, k) GF(2^8) matrix -> (mt, ks, 32, 4) uint32 A fragments of
    ``mma.m16n8k16`` in fp16: ``expand_bitmatrix(A)`` (0/1, (p*8, k*8))
    zero-padded to ``16 * mt`` rows (mt = ceil(p/2)) and ``16 * ks`` depth
    (ks = ceil(k/2)).

    Lane ``g*4 + t`` of tile (mt, ks) holds, in its registers 0..3, the
    depth pairs t*2, t*2 + 1 (regs 0, 1) and 8 + t*2, 9 + t*2 (regs 2, 3) of
    rows g (regs 0, 2) and g + 8 (regs 1, 3), the lower depth in the low
    half."""
    p, k = A.shape
    mt, ks = -(-p // 2), -(-k // 2)
    padded = np.zeros((16 * mt, 16 * ks), dtype=np.float16)
    padded[:p * 8, :k * 8] = expand_bitmatrix(A, 8).numpy()
    # rows: (mt, h, g) with row = mt*16 + h*8 + g; depth: (ks, kh, t, q)
    x = padded.view(np.uint16).reshape(mt, 2, 8, ks, 2, 4, 2)
    x = x.transpose(0, 3, 2, 5, 4, 1, 6)  # (mt, ks, g, t, kh, h, q)
    return np.ascontiguousarray(x).reshape(mt, ks, 32, 8).view("<u4")


def _operator(A: np.ndarray, device: torch.device) -> torch.Tensor:
    return _build.cached_operator(
        ("gf_pack2", A.shape, A.tobytes(), str(device)),
        lambda: torch.from_numpy(pack_fragments(A).view(np.int32)).to(device),
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
    ``tile``: columns per CUDA block (rounded up to a multiple of 128, at
    most ``m`` rounded up the same way; default 2048).
    Returns (p, m) uint8.
    """
    global LAUNCHES, CAPTURED
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
    capturing = torch.cuda.is_current_stream_capturing()
    with COUNT_LOCK:
        if capturing:
            CAPTURED += 1
        else:
            LAUNCHES += 1
    return C[:, :m].contiguous() if pad else C
