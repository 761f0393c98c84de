"""K3, the bit-plane GF(2^w) GEMMs on the int8 tensor cores and the copy
floor, as hand-written CUDA kernels: the counterpart of the JAX package's
``tools/kernel_sweep.py`` (``make_fn`` and its bodies) and of the expansion
and refold variants of ``ops/pallas_gemm.py`` (``_kernel_body``).

``gf_matmul_planes(A, B, expand, refold, tile, pinned, w)`` computes
``C = A . B`` over GF(2^w): each data symbol is expanded into int8 planes
(``expand``), multiplied by the (p*w, k*w) bit operator, or by the
(p*8, k*32) one-hot-nibble operator for ``"nibble"``, and the parity of
each accumulator is refolded into output symbols by a shift-sum
(``"sum"``) or by a second product with the bit-weight operator F
(``"dot"``); ``"none"`` returns the (p*w, m) int32 accumulators instead
(the pre-parity form, the JAX package's ``fold_parity=False``).  Every
expansion runs at w=8; ``shift``, ``shift_raw`` and ``sign`` also at w=16
(:data:`WIDE_EXPANDS`), ``shift`` and ``shift_raw`` at w=4
(:data:`NARROW_EXPANDS`; one symbol a uint8, bits 4-7 ignored).  Every
instance runs one of three kernels, by its refold: ``"sum"``
``gf_planes_sum_kernel``, ``"dot"`` ``gf_planes_dot_kernel``, ``"none"``
``gf_planes_none_kernel``, each templated on w (a 16-bit symbol as two
byte-symbols; a 4-bit symbol a byte, 8 symbols a 32-deep chunk).  The
operator is scaled by 2^s and packed for four-symbol plane words
(:func:`sum_operator`; :func:`nibble_operator` for the nibble's PRMT
tables; as B fragments for the dot kernel, whose F is
:func:`dot_fold_operator`), and unscaled for the none kernel.
:func:`route` says where a launch reads its operator and data from.
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
import threading

import numpy as np
import torch

from . import _build
from .gemm import (PLAIN_BLOCK_COLS, _dot_bits, _narrow, _widen, coefficients, expand_bitmatrix,
                   expand_nibblematrix)

# Launches since the counts were last reset, by kernel kind (KINDS, see
# kind()): eager launches in LAUNCHES, launches recorded into a CUDA graph
# (which run nothing then) in CAPTURED, and those the plan layer's graph
# replays ran in REPLAYED (added by the plan layer).  Every addition holds
# COUNT_LOCK.
KINDS = ("sum", "dot", "w4", "w16", "preparity", "preparity_w4_w16", "copy")
LAUNCHES = dict.fromkeys(KINDS, 0)
CAPTURED = dict.fromkeys(KINDS, 0)
REPLAYED = dict.fromkeys(KINDS, 0)
COUNT_LOCK = threading.Lock()

EXPANDS = {"shift": 0, "shift_raw": 1, "cmp": 2, "sign": 3, "nibble": 4}
REFOLDS = {"sum": 0, "dot": 1, "none": 2}
# The expansions the kernel source instantiates at w=16 and at w=4 (every
# refold).
WIDE_EXPANDS = ("shift", "shift_raw", "sign")
NARROW_EXPANDS = ("shift", "shift_raw")
# The folded (expand, refold) pairs at w=8.
PAIRS = tuple((e, r) for e in EXPANDS for r in ("sum", "dot"))
# Every (w, expand, refold) instance the kernel source holds.
INSTANCES = (tuple((8, e, r) for e in EXPANDS for r in REFOLDS)
             + tuple((16, e, r) for e in WIDE_EXPANDS for r in REFOLDS)
             + tuple((4, e, r) for e in NARROW_EXPANDS for r in REFOLDS))
# The expansions at w=8 (all of them).
SUM_EXPANDS = ("shift", "shift_raw", "cmp", "sign", "nibble")
DEFAULT_TILE = 8192  # columns a block of the copy floor covers by default
TILE_STEP = 64  # columns of gf_planes_sum_kernel's warp step; tiles are multiples
# Columns a block of the sum, dot and none kernels covers by default: with
# 8192, a grid the card holds at once left SMs idle (w=16's segment: 410
# blocks), and 1024 was within 3 % of the best tile at every shape timed
# (tools/k3_tile_sweep.py; PERF.md, section 6).
MMA_TILE = 1024
SOURCES = [_build.CSRC / "gf_planes.cu"]


def _lib() -> ctypes.CDLL:
    lib = _build.load("gf_planes", SOURCES)
    if not hasattr(lib, "_rs_bound"):
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.rs_gf_planes.argtypes = [vp, vp, vp, vp, i32, i32, i64, i32, i32, i32, i32, i32, vp]
        lib.rs_gf_planes.restype = i32
        lib.rs_gf_planes_smem.argtypes = [i32, i32, i32, i32, i32]
        lib.rs_gf_planes_smem.restype = i64
        lib.rs_gf_planes_route.argtypes = [i32, i32, i32, i32, i32]
        lib.rs_gf_planes_route.restype = i32
        lib.rs_gf_planes_smem_limit.argtypes = []
        lib.rs_gf_planes_smem_limit.restype = i32
        lib.rs_copy_floor.argtypes = [vp, vp, i32, i32, i64, i32, vp]
        lib.rs_copy_floor.restype = i32
        lib._rs_bound = True
    return lib


def tile_cols(tile: int | None, m: int) -> int:
    """The columns a block covers: ``tile`` rounded up to a multiple of
    :data:`TILE_STEP` and clamped to ``m`` rounded up the same way."""
    tile = DEFAULT_TILE if tile is None else int(tile)
    if tile <= 0:
        raise ValueError(f"tile must be positive, got {tile}")
    return min(-(-tile // TILE_STEP) * TILE_STEP, max(TILE_STEP, -(-m // TILE_STEP) * TILE_STEP))


def block_cols(tile: int | None, m: int) -> int:
    """:func:`tile_cols` for a GEMM instance: without a ``tile``, MMA_TILE
    (the sum, dot and none kernels' default)."""
    return tile_cols(MMA_TILE if tile is None else tile, m)


def runs_mma(expand: str, refold: str, w: int = 8) -> bool:
    """Whether (w, expand, refold) is an instance of the kernel source: every
    one runs the sum, dot or none kernel, by its refold."""
    return (w, expand, refold) in INSTANCES


def is_sum_pair(expand: str, refold: str, w: int = 8) -> bool:
    """Whether (expand, refold) at w runs gf_planes_sum_kernel."""
    return refold == "sum" and runs_mma(expand, refold, w)


def is_dot_pair(expand: str, refold: str, w: int = 8) -> bool:
    """Whether (expand, refold) at w runs gf_planes_dot_kernel."""
    return refold == "dot" and runs_mma(expand, refold, w)


def is_none_pair(expand: str, refold: str, w: int = 8) -> bool:
    """Whether (expand, refold) at w runs gf_planes_none_kernel."""
    return refold == "none" and runs_mma(expand, refold, w)


def kind(w: int, expand: str, refold: str) -> str:
    """The count an instance's launch adds to, by width: "sum" and "dot"
    (gf_planes_sum_kernel and gf_planes_dot_kernel at w=8), "w16" and "w4"
    (the same two kernels at w=16 and w=4), "preparity"
    (gf_planes_none_kernel at w=8) and "preparity_w4_w16" (the none kernel
    at w=4 and 16)."""
    if refold == "none":
        return "preparity" if w == 8 else "preparity_w4_w16"
    return refold if w == 8 else f"w{w}"


def reset_counts() -> None:
    with COUNT_LOCK:
        for counts in (LAUNCHES, CAPTURED, REPLAYED):
            counts.update(dict.fromkeys(KINDS, 0))


def runs(name: str) -> int:
    """Kernels of kind ``name`` that ran since the counts were reset: eager
    launches and launches inside graph replays."""
    return LAUNCHES[name] + REPLAYED[name]


def _count(name: str) -> None:
    capturing = torch.cuda.is_current_stream_capturing()
    with COUNT_LOCK:
        (CAPTURED if capturing else LAUNCHES)[name] += 1


def _check_pair(expand: str, refold: str, w: int = 8) -> None:
    if expand not in EXPANDS:
        raise ValueError(f"unknown expand {expand!r}; choose from {', '.join(EXPANDS)}")
    if refold not in REFOLDS:
        raise ValueError(f"unknown refold {refold!r}; choose from {', '.join(REFOLDS)}")
    if w not in (4, 8, 16):
        raise ValueError(f"K3 runs at w=4, 8 and 16, got w={w}")
    if expand == "sign" and w == 4:
        raise ValueError(f"expand='sign' needs a lane-width field (w=8 or 16), got w={w}; "
                         "use expand='shift' for other widths")
    if w != 8 and expand not in WIDE_EXPANDS:
        raise ValueError(f"expand={expand!r} is a GF(2^8) (byte-granular) strategy, got w={w}")


# --- plain versions --------------------------------------------------------

def _wrap8(x: torch.Tensor) -> torch.Tensor:
    """int32 values -> the int8 they wrap to, as int32."""
    return ((x + 128) & 255) - 128


def expand_planes(B: torch.Tensor, expand: str, w: int = 8) -> torch.Tensor:
    """(k, m) symbols -> int8-valued int32 planes: (k*w, m), row i*w + s for
    bit s of symbol i, or (k*32, m) for ``"nibble"`` (high-nibble one-hot
    over low-nibble one-hot per byte)."""
    k, m = B.shape
    b = _widen(B)[:, None, :]
    s = torch.arange(w, dtype=torch.int32, device=B.device)[None, :, None]
    if expand == "shift":
        planes = (b >> s) & 1
    elif expand == "shift_raw":
        planes = _wrap8(b >> s)  # the int8 cast wraps; parity is unchanged
    elif expand == "cmp":
        planes = ((b & (1 << s)) != 0).to(torch.int32)
    elif expand == "sign":
        planes = -((b >> s) & 1)  # {0, -1}
    elif expand == "nibble":
        v = torch.arange(16, dtype=torch.int32, device=B.device)[None, :, None]
        planes = torch.cat([(b >> 4) == v, (b & 0xF) == v], dim=1).to(torch.int32)
        return planes.reshape(k * 32, m)
    else:
        raise ValueError(f"unknown expand {expand!r}")
    return planes.reshape(k * w, m)


def fold_operator(p: int, w: int = 8) -> np.ndarray:
    """The (p, p*w) bit-weight operator F: F[i, i*w + s] = 2^s."""
    return np.kron(np.eye(p, dtype=np.int64), (1 << np.arange(w, dtype=np.int64))[None, :])


def _operator_bits(A: np.ndarray, expand: str, w: int = 8, device=None) -> torch.Tensor:
    if expand == "nibble":
        return expand_nibblematrix(A, 8, device)
    return expand_bitmatrix(A, w, device)


def _planes_block(a_op: torch.Tensor, F, B: torch.Tensor, expand: str, refold: str, w: int) -> torch.Tensor:
    p = a_op.shape[0] // w
    planes = expand_planes(B, expand, w).to(torch.int8)
    acc = _dot_bits(a_op, planes)
    if refold == "none":
        return acc
    bits = acc & 1
    if refold == "dot":
        out = _dot_bits(F, bits)
    else:
        s = torch.arange(w, dtype=torch.int32, device=B.device)[None, :, None]
        out = (bits.reshape(p, w, -1) << s).sum(dim=1, dtype=torch.int32)
    return _narrow(out, w)


def _out(p: int, m: int, refold: str, w: int, device) -> torch.Tensor:
    """The result tensor: (p, m) symbols, or (p*w, m) int32 for refold none."""
    if refold == "none":
        return torch.empty((p * w, m), dtype=torch.int32, device=device)
    return torch.empty((p, m), dtype=torch.uint8 if w <= 8 else torch.uint16, device=device)


def gf_matmul_planes_plain(A, B: torch.Tensor, expand: str, refold: str, tile: int | None = None,
                           pinned: bool = False, w: int = 8) -> torch.Tensor:
    """Plain PyTorch version of K3's GEMM: the same expansion, product and
    refold, in column blocks.  int32 matmul on the CPU; float32 with TF32
    off on CUDA (|sums| <= 128 * depth, far below 2^24)."""
    _check_pair(expand, refold, w)
    k, m = B.shape
    A = coefficients(A, k, w)
    if pinned:
        t = min(block_cols(tile, m), m)
        first = _widen(gf_matmul_planes_plain(A, B[:, :t], expand, refold, w=w))
        picked = first[:, torch.arange(m, device=B.device) % max(t, 1)]
        return picked if refold == "none" else _narrow(picked, w)
    p = A.shape[0]
    a_op = _operator_bits(A, expand, w, B.device)
    F = torch.as_tensor(fold_operator(p, w), device=B.device) if refold == "dot" else None
    out = _out(p, m, refold, w, B.device)
    for lo in range(0, m, PLAIN_BLOCK_COLS):
        hi = min(m, lo + PLAIN_BLOCK_COLS)
        out[:, lo:hi] = _planes_block(a_op, F, B[:, lo:hi], expand, refold, w)
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


def sum_operator(A: np.ndarray, w: int = 8, scaled: bool = True) -> np.ndarray:
    """The sum, dot and none kernels' operator: the (p*w, k*w) bit operator
    read as the (p'*8, k'*8) one over byte-symbols (p' = p, k' = k at w=8;
    2p, 2k at w=16, a symbol's low byte then its high byte), with row
    i*8 + s times 2^s (``scaled``; the none kernel's is 0/1), zero-padded
    to (16 * mt, 32 * kc) uint8 with mt even (the kernels run m-tiles in
    pairs), its columns in four-symbol plane-word order: depth
    32c + 16h + 4t + q of chunk c is plane 4h + t of byte-symbol 4c + q.
    At w=4 (4 planes a symbol) row i*4 + s is times 2^s and depth
    32c + 16h + 4t + q is plane t of symbol 8c + 4h + q."""
    p, k = A.shape
    if w == 4:
        mt, kc = 2 * -(-p // 8), -(-k // 8)
        op = expand_bitmatrix(A, 4).numpy().astype(np.int64)
        if scaled:
            op <<= np.tile(np.arange(4), p)[:, None]
        padded = np.zeros((16 * mt, kc, 2, 4, 4), dtype=np.uint8)  # (row, c, h, q, s)
        padded[:p * 4].reshape(p * 4, 8 * kc, 4)[:, :k] = op.reshape(p * 4, k, 4)
        # s = t -> (c, h, t, q)
        return np.ascontiguousarray(padded.transpose(0, 1, 2, 4, 3)).reshape(16 * mt, 32 * kc)
    p8, k8 = p * w // 8, k * w // 8
    mt, kc = 2 * -(-p8 // 4), -(-k8 // 4)
    op = expand_bitmatrix(A, w).numpy().astype(np.int64)
    if scaled:
        op <<= np.tile(np.arange(8), p8)[:, None]
    padded = np.zeros((16 * mt, kc, 4, 8), dtype=np.uint8)  # (row, c, q, s)
    padded[:p8 * 8].reshape(p8 * 8, 4 * kc, 8)[:, :k8] = op.reshape(p8 * 8, k8, 8)
    # s = 4h + t -> (c, h, t, q)
    return np.ascontiguousarray(padded.reshape(16 * mt, kc, 4, 2, 4).transpose(0, 1, 3, 4, 2)).reshape(16 * mt, 32 * kc)


def nibble_operator(A: np.ndarray, scaled: bool = True) -> np.ndarray:
    """The sum, dot and none kernels' nibble operator: the (p*8, k*32)
    one-hot-nibble operator with row i*8 + s times 2^s (``scaled``; the
    none kernel's is 0/1), zero-padded to (16 * mt, 32 * nc) uint8 (mt
    even, nc: k rounded up to pairs), its columns in the PRMT tables'
    order: depth 32c + 16h + 4t + q of chunk c = 2j + e is one-hot plane
    v = 8e + 4h + t of symbol 2j + q // 2's low (q even) or high (q odd)
    nibble."""
    p, k = A.shape
    mt, nc = 2 * -(-p // 4), 2 * -(-k // 2)
    op = expand_nibblematrix(A, 8).numpy().astype(np.int64)
    if scaled:
        op <<= np.tile(np.arange(8), p)[:, None]
    j, e, h, t, q = np.meshgrid(*(np.arange(n) for n in (nc // 2, 2, 2, 4, 4)), indexing="ij")
    sym, v = (2 * j + q // 2).ravel(), (8 * e + 4 * h + t).ravel()
    col = sym * 32 + np.where(q.ravel() % 2, v, 16 + v)  # high nibble's one-hot first, as the operator has it
    padded = np.zeros((16 * mt, 32 * nc), dtype=np.uint8)
    padded[:p * 8, sym < k] = op[:, col[sym < k]]
    return padded


def pack_b_fragments(op: np.ndarray) -> np.ndarray:
    """(16 * nt2, 32 * kc) 8-bit operator -> (nt2, kc, 32, 4) uint32 B
    fragments of mma.m16n8k32 (gf_planes_dot_kernel, whose operator is the
    B operand): two 8-row n-tiles a uint4.  Lane ``g*4 + t`` of (nt2, kc)
    holds the 4 bytes at depth t*4.. (regs 0, 2) and 16 + t*4.. (regs 1, 3)
    of rows g (regs 0, 1) and g + 8 (regs 2, 3), the lowest depth in the
    low byte: :func:`pack_fragments`' registers 1 and 2 swapped."""
    return np.ascontiguousarray(pack_fragments(op, *op.shape)[..., [0, 2, 1, 3]])


def dot_fold_operator(w: int = 8) -> np.ndarray:
    """gf_planes_dot_kernel's F, 0/1: (2, 32, 2) uint32 B fragments, one a
    pass of an 8-symbol output tile.  The second product's depth 16h + 4t + e
    of pass q is bit 2t + (e & 1) of n-tile 2h + e // 2, that is of the
    tile's symbol 4q + 2h + e // 2, and F takes it to that column.  At w=4
    a pass is a whole tile, (1, 32, 2): n-tile 2h + e // 2 holds symbols
    2(2h + e // 2) and the next, and depth 16h + 4t + e is bit
    2(t & 1) + (e & 1) of symbol 4h + 2(e // 2) + t // 2."""
    passes = 1 if w == 4 else 2
    F = np.zeros((passes, 2, 4, 4, 8), dtype=np.uint8)  # (q, h, t, e, symbol)
    for q, h, t, e in np.ndindex(passes, 2, 4, 4):
        F[q, h, t, e, 4 * h + 2 * (e // 2) + t // 2 if w == 4 else 4 * q + 2 * h + e // 2] = 1
    # lane g*4 + t, register h, byte e: depth 16h + 4t + e of column g
    frag = np.ascontiguousarray(F.transpose(0, 4, 2, 1, 3))  # (q, g, t, h, e)
    return frag.reshape(passes, 32, 2, 4).view("<u4")[..., 0]


def _operators(A: np.ndarray, expand: str, refold: str, w: int, device: torch.device):
    def make():
        opF = None
        op = nibble_operator(A, refold != "none") if expand == "nibble" else sum_operator(A, w, refold != "none")
        if refold == "dot":
            opA, opF = pack_b_fragments(op), dot_fold_operator(w)
        else:
            opA = pack_fragments(op, *op.shape)
        opA = torch.from_numpy(opA.view(np.int32)).to(device)
        if opF is not None:
            opF = torch.from_numpy(np.ascontiguousarray(opF).view(np.int32)).to(device)
        return opA, opF

    return _build.cached_operator(("gf_planes", A.shape, A.tobytes(), w, expand, refold, str(device)), make)


def _check_data(B: torch.Tensor, what: str, w: int = 8) -> None:
    if not isinstance(B, torch.Tensor):
        raise TypeError(f"B must be a tensor, got {type(B).__name__}")
    if B.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what} runs on cuda or cpu tensors, got {B.device}")
    want = torch.uint8 if w <= 8 else torch.uint16
    if B.dtype != want or B.dim() != 2:
        raise ValueError(f"B must be a 2-D {want} tensor at w={w}, got {B.dtype} {tuple(B.shape)}")
    if B.device.type == "cuda" and not B.is_contiguous():
        raise ValueError("B must be contiguous")


def smem_bytes(k: int, p: int, expand: str, refold: str, w: int = 8) -> tuple[int, int]:
    """(needed, limit): the dynamic shared memory K3 takes at (k, p) for the
    instance (by its :func:`route`, with one step buffer a warp), and the
    most a block may have, from the kernel library."""
    lib = _lib()
    return lib.rs_gf_planes_smem(k, p, w, EXPANDS[expand], REFOLDS[refold]), lib.rs_gf_planes_smem_limit()


ROUTES = {0: "smem", 1: "l1", 2: "direct"}


def route(k: int, p: int, expand: str, refold: str, w: int = 8) -> str | None:
    """Where a launch at (k, p) reads from, from the kernel library:
    "smem" (operator and data staged in shared memory), "l1" (the operator
    through L1 beside the staged data: nibble's sum and dot kernels past
    their edge), "direct" (both through L1 from device memory: every
    instance but w=8's folded byte expansions, past its edge), or None
    (refused)."""
    return ROUTES.get(_lib().rs_gf_planes_route(k, p, w, EXPANDS[expand], REFOLDS[refold]))


def gf_matmul_planes(A, B: torch.Tensor, expand: str, refold: str, tile: int | None = None,
                     pinned: bool = False, w: int = 8) -> torch.Tensor:
    """``C = A . B`` over GF(2^w) through K3's GEMM with the ``expand`` /
    ``refold`` formulation (a key of :data:`EXPANDS` and of :data:`REFOLDS`;
    at w=16 one of :data:`WIDE_EXPANDS`, at w=4 of :data:`NARROW_EXPANDS`).

    ``A``: (p, k) coefficients; ``B``: (k, m) uint8 (w=4 or 8) or uint16
    (w=16) tensor.  ``tile``: columns per CUDA block (rounded up to a multiple of
    :data:`TILE_STEP`; default :func:`block_cols`).  Returns (p, m) symbols of B's type,
    or for ``refold="none"`` the (p*w, m) int32 accumulators.  An operator
    past the card's shared memory raises ``ValueError`` before any launch.
    """
    _check_pair(expand, refold, w)
    _check_data(B, "gf_matmul_planes", w)
    k, m = B.shape
    t = block_cols(tile, m)
    if B.device.type == "cpu":
        return gf_matmul_planes_plain(A, B, expand, refold, t, pinned, w)
    A = coefficients(A, k, w)
    p = A.shape[0]
    C = _out(p, m, refold, w, B.device)
    if p == 0 or m == 0:
        return C
    if k == 0:
        return C.zero_()
    smem, limit = smem_bytes(k, p, expand, refold, w)
    if smem > limit:
        raise ValueError(f"K3 needs {smem} bytes of shared memory at k={k} p={p} w={w} ({expand}+{refold}); "
                         f"the card allows {limit}")
    lib = _lib()
    opA, opF = _operators(A, expand, refold, w, B.device)
    with torch.cuda.device(B.device):
        err = lib.rs_gf_planes(opA.data_ptr(), opF.data_ptr() if opF is not None else None, B.data_ptr(),
                               C.data_ptr(), k, p, m, t, w, EXPANDS[expand], REFOLDS[refold], int(pinned),
                               torch.cuda.current_stream(B.device).cuda_stream)
    _build.check(lib, err, "gf_planes")
    _count(kind(w, expand, refold))
    return C


def copy_floor(B: torch.Tensor, p: int, tile: int | None = None) -> torch.Tensor:
    """``B[:p]`` through K3's copy floor: every (k, tile) block of B is
    brought into shared memory and rows 0..p-1 are written out."""
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
    _count("copy")
    return C
