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
(:mod:`.cuda_planes`), folded or pre-parity, at w=8, (``shift``,
``shift_raw``, ``sign``) w=16 and (``shift``, ``shift_raw``) w=4.  Both
kernels of K1 and K3's GEMM take GF(2^4) symbols one to a byte, in the
low nibble, and ignore bits 4-7, as the JAX package does.  The lane-width
variants were ways around
the TPU compiler's refusals; on the card one 32-bit register already holds
four bytes, so their algebra is the base expansion's.

The JAX package's environment knobs choose the formulation of every
dispatch that names none: ``RS_PALLAS_EXPAND``, ``RS_PALLAS_REFOLD``
(``sum``, ``dot`` or ``autotune``) and ``RS_PALLAS_TILE``, resolved, with
their warnings on an unknown or inapplicable value, as
``gf_matmul_pallas`` resolves them.  With no knob set and no ``expand``,
``refold`` or ``tile`` given, a dispatch runs K1.  ``refold="autotune"``
times the sum and the dot refold once per dispatch class on the actual
operands (:func:`_time_refold`) and keeps the faster (dot only when it
takes under :data:`_AUTOTUNE_MARGIN` of sum's time) in a lock-guarded
cache (:func:`autotune_decisions`, :func:`clear_autotune_cache`); a plan
times its own candidates (:func:`calibrate_aot_refold`) and the mesh takes
:func:`static_refold`.  Unlike the JAX package's calibration, nothing
catches a candidate's failure: on CUDA a variant that fails raises.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
import warnings

import numpy as np
import torch

from . import _build
from ..obs import metrics as _obs_metrics
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
# Of the eager launches, those of the pre-parity form (the popcount kernel,
# the mesh's stripe mode).
PREPARITY = 0
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
# GEMM with the named expansion.  "cmp" and "signc" are the sweep's names.
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
# The names gf_matmul_pallas takes, which RS_PALLAS_EXPAND may name.
JAX_NAMES = frozenset(EXPANSIONS) - {"cmp", "signc"}
DEFAULT_EXPAND = "shift_raw"
KNOBS = ("RS_PALLAS_EXPAND", "RS_PALLAS_REFOLD", "RS_PALLAS_TILE")


def knobs_set() -> bool:
    """Whether any of the RS_PALLAS_* knobs is set (non-empty)."""
    return any(os.environ.get(var) for var in KNOBS)


def _default_refold(w: int) -> str:
    """"dot" at w=8, "sum" elsewhere, as the JAX package defaults."""
    return "dot" if w == 8 else "sum"


def _env_fallback(reason: str, to, label: str | None = None):
    """The JAX package's warn-and-fall-back for an unknown or inapplicable
    RS_PALLAS_* value: one warning naming the default taken."""
    warnings.warn(f"{reason}; using {label or repr(to)}", stacklevel=3)
    return to


# refold="autotune" decisions by dispatch class (the JAX package's key
# without acc_dtype, with the device in place of interpret), written once a
# key under the lock.  Readers use autotune_decisions().
_AUTOTUNE_CACHE: dict = {}
_AUTOTUNE_LOCK = threading.Lock()
# dot ships only when it takes under this share of sum's time: ties and
# noise go to the stable sum, as in the JAX package.
_AUTOTUNE_MARGIN = 0.9


def autotune_decisions() -> dict:
    """A copy of the refold="autotune" decisions: dispatch class -> "sum"
    or "dot"."""
    with _AUTOTUNE_LOCK:
        return dict(_AUTOTUNE_CACHE)


def clear_autotune_cache() -> None:
    """Drop every refold="autotune" decision (the plan cache's clear does
    this too)."""
    with _AUTOTUNE_LOCK:
        _AUTOTUNE_CACHE.clear()


def _sync(out) -> None:
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def _time_refold(run) -> float:
    """Best-of-2 wall seconds of ``run()`` after one warm-up call, each
    call synchronised with the card.  Module-level so that tests can
    replace it; nothing catches what the warm-up raises."""
    _sync(run())
    best = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        _sync(run())
        best = min(best, time.perf_counter() - t0)
    return best


def _choose(times: dict, mode: str, w: int) -> str:
    choice = "dot" if times["dot"] < _AUTOTUNE_MARGIN * times["sum"] else "sum"
    _obs_metrics.counter("rs_pallas_autotune_total", "refold autotune calibrations by winning candidate").labels(
        choice=choice, mode=mode, w=w).inc()
    return choice


def _dtype_name(x) -> str:
    if isinstance(x, torch.Tensor):
        return str(x.dtype).removeprefix("torch.")
    return np.asarray(x).dtype.name


def _autotune_refold(A, B: torch.Tensor, w: int, tile: int | None, expand: str) -> str:
    """refold="autotune" resolved to "sum" or "dot": both K3 variants timed
    once on the actual operands at the dispatch's tile (None: the kernels'
    default, keyed as cuda_planes.DEFAULT_TILE), the decision cached by
    dispatch class."""
    from . import cuda_planes

    key = (tuple(np.shape(A)), _dtype_name(A), tuple(B.shape), _dtype_name(B), w,
           cuda_planes.DEFAULT_TILE if tile is None else tile, expand, str(B.device))
    with _AUTOTUNE_LOCK:
        hit = _AUTOTUNE_CACHE.get(key)
    if hit is not None:
        return hit
    kexp = EXPANSIONS[expand]
    times = {cand: _time_refold(lambda cand=cand: cuda_planes.gf_matmul_planes(A, B, kexp, cand, tile, w=w))
             for cand in ("sum", "dot")}
    choice = _choose(times, "eager", w)
    with _AUTOTUNE_LOCK:
        return _AUTOTUNE_CACHE.setdefault(key, choice)


def static_refold(w: int) -> str | None:
    """RS_PALLAS_REFOLD resolved with no calibration and no warning for
    "autotune" (the per-width default), as the JAX package's mesh path
    resolves it.  None where no refold applies: no knob is set (the
    dispatch runs K1) or RS_PALLAS_EXPAND is pack2 at w=8.  An unknown
    value warns and takes the default."""
    if not knobs_set() or (os.environ.get("RS_PALLAS_EXPAND") == "pack2" and w == 8):
        return None
    env = os.environ.get("RS_PALLAS_REFOLD")
    if env in ("sum", "dot"):
        return env
    if env and env != "autotune":
        return _env_fallback(f"RS_PALLAS_REFOLD={env!r} is unknown", _default_refold(w))
    return _default_refold(w)


def plan_refold_resolution(w: int) -> str | None:
    """The refold a plan pins: :func:`static_refold`, or "autotune" when
    RS_PALLAS_REFOLD asks for it and a refold applies (the plan then times
    its own candidates, :func:`calibrate_aot_refold`)."""
    s = static_refold(w)
    if s is not None and os.environ.get("RS_PALLAS_REFOLD") == "autotune":
        return "autotune"
    return s


def calibrate_aot_refold(w: int, run_variant) -> str:
    """A plan's refold="autotune": ``run_variant(refold)`` (the plan's own
    dispatch with that refold, on its operands) timed for "sum" and "dot".
    The eager decision cache is neither read nor written."""
    times = {cand: _time_refold(lambda cand=cand: run_variant(cand)) for cand in ("sum", "dot")}
    return _choose(times, "aot", w)


def gf_matmul_cuda(A, B: torch.Tensor, w: int = 8, fold_parity: bool = True, expand: str | None = None,
                   refold: str | None = None, tile: int | None = None) -> torch.Tensor:
    """``C = A . B`` over GF(2^w) through the CUDA kernels.

    ``A``: (p, k) coefficient matrix (NumPy or tensor, entries < 2^w).
    ``B``: (k, m) contiguous tensor of uint8 (w=4 or 8; at w=4 one symbol
    a byte, bits 4-7 ignored) or uint16 (w=16).
    Returns (p, m) symbols of B's dtype or, with ``fold_parity=False``, the
    (p*w, m) int32 bit-plane accumulators (pre-parity form).

    With no ``expand``, ``refold`` or ``tile`` and no RS_PALLAS_* knob set
    this runs K1 (the bit-sliced kernel, or with ``fold_parity=False`` the
    popcount kernel).  Otherwise the formulation resolves as
    ``gf_matmul_pallas`` resolves it: ``expand`` from the argument, then
    RS_PALLAS_EXPAND, then "shift_raw"; a name of :data:`EXPANSIONS` runs
    K2 (pack2, w=8, folded) or K3 at w=4, 8 or 16.  ``refold`` ("sum",
    "dot" or "autotune"; then RS_PALLAS_REFOLD) defaults to "dot" at w=8
    and "sum" at w=4 and 16; the pre-parity form has no refold.  ``tile`` (then
    RS_PALLAS_TILE) is the columns a CUDA block covers.
    """
    if expand is None and refold is None and tile is None and not knobs_set():
        return _gf_matmul_k1(A, B, w, fold_parity)
    return _gf_matmul_expand(A, B, w, fold_parity, expand, refold, tile)


def _env_tile():
    env = os.environ.get("RS_PALLAS_TILE")
    if not env:
        return None
    try:
        tile = int(env)
        if tile <= 0:
            raise ValueError(env)
    except ValueError:
        return _env_fallback(f"RS_PALLAS_TILE={env!r} is not a positive integer", None, label="the measured default")
    if tile % 128:
        aligned = -(-tile // 128) * 128
        warnings.warn(f"RS_PALLAS_TILE={tile} is not a multiple of the 128-lane width; rounding up to {aligned}",
                      stacklevel=3)
        tile = aligned
    return tile


def _gf_matmul_expand(A, B, w, fold_parity, expand, refold, tile) -> torch.Tensor:
    from . import cuda_pack2, cuda_planes

    from_env = False
    if expand is None:
        env = os.environ.get("RS_PALLAS_EXPAND")
        from_env = bool(env)
        if from_env:
            expand = env
            applies = expand in JAX_NAMES and (expand not in BYTE_ONLY or w == 8) and (expand != "sign" or w in (8, 16))
            if not applies:
                expand = _env_fallback(f"RS_PALLAS_EXPAND={expand!r} is unknown or does not apply at w={w}",
                                       DEFAULT_EXPAND)
        else:
            expand = DEFAULT_EXPAND
    if expand not in EXPANSIONS:
        raise ValueError(f"unknown expand {expand!r}")
    if expand == "sign" and w not in (8, 16):
        raise ValueError(
            f"expand='sign' needs a lane-width field (w=8 or 16), got w={w}; use expand='shift' for other widths"
        )
    if expand in BYTE_ONLY and w != 8:
        raise ValueError(f"expand={expand!r} is a GF(2^8) (byte-granular) strategy, got w={w}")
    if expand == "pack2" and not fold_parity:
        why = "pack2 cannot emit pre-parity accumulators"
        if from_env:
            expand = _env_fallback(f"RS_PALLAS_EXPAND=pack2 does not apply here ({why})", DEFAULT_EXPAND)
        else:
            raise ValueError(why)
    if tile is None:
        tile = _env_tile()
    if expand == "pack2":
        return cuda_pack2.gf_matmul_pack2(A, B, w, fold_parity, refold, tile)
    if refold is None:
        default = _default_refold(w)
        refold = os.environ.get("RS_PALLAS_REFOLD") or default
        if refold not in ("sum", "dot", "autotune"):
            refold = _env_fallback(f"RS_PALLAS_REFOLD={refold!r} is unknown", default)
    if refold not in ("sum", "dot", "autotune"):
        raise ValueError(f"unknown refold {refold!r}")
    if refold == "autotune":
        if not fold_parity:
            # The pre-parity form has no refold stage to tune.
            refold = _default_refold(w)
        elif isinstance(B, torch.Tensor) and B.is_cuda and torch.cuda.is_current_stream_capturing():
            # A capture runs nothing: there is nothing to time.
            refold = _env_fallback("refold='autotune' cannot calibrate under a CUDA graph capture; call the "
                                   "dispatch eagerly to calibrate", _default_refold(w))
        else:
            cuda_planes._check_data(B, "gf_matmul_cuda", w)
            refold = _autotune_refold(A, B, w, tile, expand)
    _obs_metrics.counter("rs_pallas_refold_total", "resolved refold choices at kernel dispatch").labels(
        refold=refold, expand=expand, w=w).inc()
    return cuda_planes.gf_matmul_planes(A, B, EXPANSIONS[expand], refold if fold_parity else "none", tile, w=w)


def _gf_matmul_k1(A, B: torch.Tensor, w: int, fold_parity: bool) -> torch.Tensor:
    global LAUNCHES, CAPTURED, PREPARITY
    if not isinstance(B, torch.Tensor):
        raise TypeError(f"B must be a tensor, got {type(B).__name__}")
    if B.device.type == "cpu":
        return gf_matmul_bitplane(A, B, w, fold_parity)
    if B.device.type != "cuda":
        raise ValueError(f"gf_matmul_cuda runs on cuda or cpu tensors, got {B.device}")
    if w not in (4, 8, 16):
        raise ValueError(f"the CUDA kernels support w=4, 8 and 16, got w={w}")
    want = torch.uint8 if w <= 8 else torch.uint16
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
            PREPARITY += not fold_parity
    return C
