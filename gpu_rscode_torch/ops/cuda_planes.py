"""K3, the bit-plane GF(2^8) GEMMs on the int8 tensor cores and the copy
floor, as hand-written CUDA kernels: the counterpart of the JAX package's
``tools/kernel_sweep.py`` (``make_fn`` and its bodies) and of the expansion
and refold variants of ``ops/pallas_gemm.py`` (``_kernel_body``).

``gf_matmul_planes(A, B, expand, refold, tile, pinned)`` computes
``C = A . B`` over GF(2^8): each data byte is expanded into int8 planes
(``expand``), multiplied by the (p*8, k*8) bit operator, or by the
(p*8, k*32) one-hot-nibble operator for ``"nibble"``, and the parity of
each accumulator is refolded into output bytes by a shift-sum (``"sum"``) or
by a second product with the (p, p*8) bit-weight operator F (``"dot"``).
With ``pinned=True`` every block of ``tile`` columns computes on the first
block's columns: the compute-only ceiling, whose result is the first
block's output repeated.

``copy_floor(B, p, tile)`` returns ``B[:p]`` after bringing each whole
(k, tile) block of B on chip: the copy floor, moving exactly the bytes K1
moves.

On a CUDA tensor each wrapper launches ``csrc/gf_planes.cu`` or raises; the
plain versions (``gf_matmul_planes_plain``, ``copy_floor_plain``) run only
for a CPU tensor.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build
from .gemm import PLAIN_BLOCK_COLS, _dot_bits, coefficients, expand_bitmatrix, expand_nibblematrix

# Launches since the counts were last reset; only the launches below add.
LAUNCHES = 0  # the GEMM
COPY_LAUNCHES = 0  # the copy floor

EXPANDS = {"shift": 0, "shift_raw": 1, "cmp": 2, "sign": 3, "nibble": 4}
REFOLDS = {"sum": 0, "dot": 1}
# The kernel source instantiates every (expand, refold) pair.
PAIRS = tuple((e, r) for e in EXPANDS for r in REFOLDS)
DEFAULT_TILE = 8192
SOURCES = [_build.CSRC / "gf_planes.cu"]


def _lib() -> ctypes.CDLL:
    lib = _build.load("gf_planes", SOURCES)
    if not hasattr(lib, "_rs_bound"):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rs_gf_planes.argtypes = [vp, vp, vp, vp, i32, i32, i64, i32, i32, i32, i32, vp]
        lib.rs_gf_planes.restype = i32
        lib.rs_gf_planes_smem.argtypes = [i32, i32, i32, i32]
        lib.rs_gf_planes_smem.restype = i64
        lib.rs_gf_planes_smem_limit.argtypes = []
        lib.rs_gf_planes_smem_limit.restype = i32
        lib.rs_copy_floor.argtypes = [vp, vp, i32, i32, i64, i32, vp]
        lib.rs_copy_floor.restype = i32
        lib._rs_bound = True
    return lib


def tile_cols(tile: int | None, m: int) -> int:
    """The columns a block covers: ``tile`` rounded up to a multiple of 32
    and clamped to ``m`` rounded up the same way."""
    tile = DEFAULT_TILE if tile is None else int(tile)
    if tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    return min(-(-tile // 32) * 32, max(32, -(-m // 32) * 32))


def _check_pair(expand: str, refold: str) -> None:
    if expand not in EXPANDS:
        raise ValueError(f"unknown expand {expand!r}; choose from {', '.join(EXPANDS)}")
    if refold not in REFOLDS:
        raise ValueError(f"unknown refold {refold!r}; choose from {', '.join(REFOLDS)}")


# --- plain versions --------------------------------------------------------

def _wrap8(x: torch.Tensor) -> torch.Tensor:
    """int32 values -> the int8 they wrap to, as int32."""
    return ((x + 128) & 255) - 128


def expand_planes(B: torch.Tensor, expand: str) -> torch.Tensor:
    """(k, m) uint8 -> int8-valued int32 planes: (k*8, m), row i*8 + s for
    bit s of symbol i, or (k*32, m) for ``"nibble"`` (high-nibble one-hot
    over low-nibble one-hot per symbol)."""
    k, m = B.shape
    b = B.to(torch.int32)[:, None, :]
    s = torch.arange(8, dtype=torch.int32, device=B.device)[None, :, None]
    if expand == "shift":
        planes = (b >> s) & 1
    elif expand == "shift_raw":
        planes = _wrap8(b >> s)  # the int8 cast wraps; parity is unchanged
    elif expand == "cmp":
        planes = ((b & (1 << s)) != 0).to(torch.int32)
    elif expand == "sign":
        bts = _wrap8(b)  # the byte seen as int8
        planes = _wrap8(bts << (7 - s)) >> 7  # {0, -1}
    elif expand == "nibble":
        v = torch.arange(16, dtype=torch.int32, device=B.device)[None, :, None]
        planes = torch.cat([(b >> 4) == v, (b & 0xF) == v], dim=1).to(torch.int32)
        return planes.reshape(k * 32, m)
    else:
        raise ValueError(f"unknown expand {expand!r}")
    return planes.reshape(k * 8, m)


def fold_operator(p: int) -> np.ndarray:
    """The (p, p*8) bit-weight operator F: F[i, i*8 + s] = 2^s."""
    return np.kron(np.eye(p, dtype=np.int64), (1 << np.arange(8, dtype=np.int64))[None, :])


def _operator_bits(A: np.ndarray, expand: str, device=None) -> torch.Tensor:
    if expand == "nibble":
        return expand_nibblematrix(A, 8, device)
    return expand_bitmatrix(A, 8, device)


def _planes_block(a_op: torch.Tensor, F, B: torch.Tensor, expand: str, refold: str) -> torch.Tensor:
    p = a_op.shape[0] // 8
    planes = expand_planes(B, expand).to(torch.int8)
    acc = _dot_bits(a_op, planes)
    bits = acc & 1
    if refold == "dot":
        out = _dot_bits(F, bits)
    else:
        s = torch.arange(8, dtype=torch.int32, device=B.device)[None, :, None]
        out = (bits.reshape(p, 8, -1) << s).sum(dim=1, dtype=torch.int32)
    return out.to(torch.uint8)


def gf_matmul_planes_plain(A, B: torch.Tensor, expand: str, refold: str, tile: int | None = None,
                           pinned: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K3's GEMM: the same expansion, product and
    refold, in column blocks.  int32 matmul on the CPU; float32 with TF32
    off on CUDA (|sums| <= 128 * depth, far below 2^24)."""
    _check_pair(expand, refold)
    k, m = B.shape
    A = coefficients(A, k, 8)
    if pinned:
        t = min(tile_cols(tile, m), m)
        first = gf_matmul_planes_plain(A, B[:, :t], expand, refold)
        reps = -(-m // t) if t else 0
        return first.repeat(1, reps)[:, :m].contiguous()
    p = A.shape[0]
    a_op = _operator_bits(A, expand, B.device)
    F = torch.as_tensor(fold_operator(p), device=B.device) if refold == "dot" else None
    out = torch.empty((p, m), dtype=torch.uint8, device=B.device)
    for lo in range(0, m, PLAIN_BLOCK_COLS):
        hi = min(m, lo + PLAIN_BLOCK_COLS)
        out[:, lo:hi] = _planes_block(a_op, F, B[:, lo:hi], expand, refold)
    return out


def copy_floor_plain(B: torch.Tensor, p: int, tile: int | None = None) -> torch.Tensor:
    """Plain version of the copy floor: ``B[:p]``, block by block."""
    k, m = B.shape
    t = tile_cols(tile, m)
    out = torch.empty((p, m), dtype=B.dtype, device=B.device)
    for lo in range(0, m, t):
        out[:, lo:lo + t] = B[:p, lo:lo + t]
    return out


# --- the kernels ------------------------------------------------------------

def pack_fragments(op: np.ndarray, rows: int, depth: int) -> np.ndarray:
    """(R, D) 8-bit operator -> (mt, kc, 32, 4) uint32 A fragments of
    mma.m16n8k32, zero-padded to ``rows`` (16 * mt) by ``depth`` (32 * kc).

    Lane ``g*4 + t`` of tile (mt, kc) holds, in its registers 0..3, the 4
    bytes at depth t*4.. (regs 0, 1) and 16 + t*4.. (regs 2, 3) of rows g
    (regs 0, 2) and g + 8 (regs 1, 3), the lowest depth in the low byte."""
    R, D = op.shape
    padded = np.zeros((rows, depth), dtype=np.uint8)
    padded[:R, :D] = op.astype(np.int64) & 0xFF
    mt, kc = rows // 16, depth // 32
    # rows: (mt, h, g) with row = mt*16 + h*8 + g; depth: (kc, kh, t, q)
    x = padded.reshape(mt, 2, 8, kc, 2, 4, 4)
    x = x.transpose(0, 3, 2, 5, 4, 1, 6)  # (mt, kc, g, t, kh, h, q)
    return np.ascontiguousarray(x).reshape(mt, kc, 32, 4, 4).view("<u4").reshape(mt, kc, 32, 4)


def _dims(k: int, p: int, expand: str) -> tuple[int, int, int, int]:
    mt = -(-p * 8 // 16)
    kc = k if expand == "nibble" else -(-k * 8 // 32)
    return mt, kc, -(-p // 16), -(-mt * 16 // 32)


def _operators(A: np.ndarray, expand: str, refold: str, device: torch.device):
    def make():
        p, k = A.shape
        mt, kc, mf, kf = _dims(k, p, expand)
        opA = pack_fragments(_operator_bits(A, expand).numpy(), 16 * mt, 32 * kc)
        opA = torch.from_numpy(opA.view(np.int32)).to(device)
        opF = None
        if refold == "dot":
            opF = pack_fragments(fold_operator(p), 16 * mf, 32 * kf)
            opF = torch.from_numpy(opF.view(np.int32)).to(device)
        return opA, opF

    return _build.cached_operator(("gf_planes", A.shape, A.tobytes(), expand, refold, str(device)), make)


def _check_data(B: torch.Tensor, what: str) -> None:
    if not isinstance(B, torch.Tensor):
        raise TypeError(f"B must be a tensor, got {type(B).__name__}")
    if B.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {B.device}")
    if B.dtype != torch.uint8 or B.dim() != 2:
        raise ValueError(f"B must be a 2-D uint8 tensor, got {B.dtype} {tuple(B.shape)}")
    if B.device.type == "cuda" and not B.is_contiguous():
        raise ValueError("B must be contiguous")


def gf_matmul_planes(A, B: torch.Tensor, expand: str, refold: str, tile: int | None = None,
                     pinned: bool = False) -> torch.Tensor:
    """``C = A . B`` over GF(2^8) through K3's GEMM with the ``expand`` /
    ``refold`` formulation (a key of :data:`EXPANDS` and of :data:`REFOLDS`).

    ``A``: (p, k) coefficients; ``B``: (k, m) uint8 tensor.  ``tile``:
    columns per CUDA block (rounded up to a multiple of 32; default 8192).
    Returns (p, m) uint8.
    """
    global LAUNCHES
    _check_pair(expand, refold)
    _check_data(B, "gf_matmul_planes")
    k, m = B.shape
    t = tile_cols(tile, m)
    if B.device.type == "cpu":
        return gf_matmul_planes_plain(A, B, expand, refold, t, pinned)
    A = coefficients(A, k, 8)
    p = A.shape[0]
    C = torch.empty((p, m), dtype=torch.uint8, device=B.device)
    if p == 0 or m == 0:
        return C
    if k == 0:
        return C.zero_()
    lib = _lib()
    e, r = EXPANDS[expand], REFOLDS[refold]
    smem = lib.rs_gf_planes_smem(k, p, e, r)
    if smem > lib.rs_gf_planes_smem_limit():
        raise ValueError(f"K3 needs {smem} bytes of shared memory at k={k} p={p} ({expand}+{refold}); "
                         f"the card allows {lib.rs_gf_planes_smem_limit()}")
    opA, opF = _operators(A, expand, refold, B.device)
    with torch.cuda.device(B.device):
        err = lib.rs_gf_planes(opA.data_ptr(), opF.data_ptr() if opF is not None else None, B.data_ptr(),
                               C.data_ptr(), k, p, m, t, e, r, int(pinned),
                               torch.cuda.current_stream(B.device).cuda_stream)
    _build.check(lib, err, "gf_planes")
    LAUNCHES += 1
    return C


def copy_floor(B: torch.Tensor, p: int, tile: int | None = None) -> torch.Tensor:
    """``B[:p]`` through K3's copy floor: every (k, tile) block of B is
    brought into shared memory and rows 0..p-1 are written out."""
    global COPY_LAUNCHES
    _check_data(B, "copy_floor")
    k, m = B.shape
    if not 0 < p <= k:
        raise ValueError(f"copy_floor needs 0 < p <= k, got p={p} k={k}")
    t = tile_cols(tile, m)
    if B.device.type == "cpu":
        return copy_floor_plain(B, p, t)
    C = torch.empty((p, m), dtype=torch.uint8, device=B.device)
    if m == 0:
        return C
    lib = _lib()
    with torch.cuda.device(B.device):
        err = lib.rs_copy_floor(B.data_ptr(), C.data_ptr(), k, p, m, t,
                                torch.cuda.current_stream(B.device).cuda_stream)
    _build.check(lib, err, "copy_floor")
    COPY_LAUNCHES += 1
    return C
