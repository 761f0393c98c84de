"""Native host IO (``rs_native_io.cpp``) through ``ctypes``: the IO half of
the JAX package's native layer.

The library is built by ``g++`` at first use into
``build/gpu_rscode_torch/rs_native_io-<hash>/`` (:func:`.ops._build.build`;
the hash covers the source, the flags, and the build machine's CPU,
compiler and C library, since it is built with ``-march=native``).  Every
entry point has a NumPy fallback for a machine with no toolchain: the
library is a speed feature, the Python path is the contract.  :data:`NATIVE_CALLS` and
:data:`FALLBACK_CALLS` count which of the two served each call, so a run
can show that the fallback did not.

``stripe_read``, ``gather_rows`` and ``interleave_read`` take ``dst=``: a
(k, cols) C-contiguous uint8 array to read into (the pipeline passes a view
of a pinned buffer), in place of a fresh one.  ``interleave_read`` and
``deinterleave_write`` are the interleaved layout's staging pair: one
contiguous file range transposed into the k rows of a segment, and back.

The GEMM/invert half (``rs_native_gemm.cpp``, a library of its own built
the same way) is the host GF(2^8) codec behind ``strategy="cpu"``:
:func:`gemm` and :func:`invert`.  :func:`available` says whether it
builds; ``RSCodec(strategy="cpu")`` is refused when it does not, so the
strategy never names the NumPy oracle.  Called directly without a
toolchain, :func:`gemm` and :func:`invert` take the oracle, counted in
:data:`GEMM_FALLBACK_CALLS` (the library's calls in :data:`GEMM_CALLS`).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

from ..obs import metrics as _obs_metrics
from ..ops import _build

SRC = Path(__file__).resolve().parent / "rs_native_io.cpp"
GEMM_SRC = Path(__file__).resolve().parent / "rs_native_gemm.cpp"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False
_gemm_lib: ctypes.CDLL | None = None
_gemm_build_failed = False

# Calls served by the library and by the NumPy fallback since the counts
# were last reset (prefetch and writer threads add to them at once).
NATIVE_CALLS = 0
FALLBACK_CALLS = 0
# GEMM and invert calls served by the library and by the NumPy oracle.
GEMM_CALLS = 0
GEMM_FALLBACK_CALLS = 0
_count_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    """The library could not be built or loaded (no ``g++``)."""


def _count_io(direction: str, call: str, nbytes: int, seconds: float) -> None:
    """``rs_io_*`` accounting of one staging call, as the JAX package
    counts it: ``direction`` "read" or "write", ``call`` the primitive."""
    _obs_metrics.counter(f"rs_io_{direction}_bytes_total", f"bytes {direction} by the staging-I/O layer").labels(
        call=call).inc(nbytes)
    _obs_metrics.counter(f"rs_io_{direction}_seconds_total", f"wall seconds in staging-I/O {direction} calls").labels(
        call=call).inc(seconds)


def _count(native: bool) -> None:
    global NATIVE_CALLS, FALLBACK_CALLS
    with _count_lock:
        if native:
            NATIVE_CALLS += 1
        else:
            FALLBACK_CALLS += 1


def _count_gemm(native: bool) -> None:
    global GEMM_CALLS, GEMM_FALLBACK_CALLS
    with _count_lock:
        if native:
            GEMM_CALLS += 1
        else:
            GEMM_FALLBACK_CALLS += 1


def _machine_salt() -> bytes:
    """What a library built here depends on beyond its source: the CPU
    (``-march=native``), the compiler and the C library.  A build directory
    copied to another machine is then not reused there."""
    import platform

    try:
        with open("/proc/cpuinfo", "rb") as fp:
            cpu = b"\n".join(sorted({ln for ln in fp.read().splitlines() if ln.startswith((b"model name", b"flags"))}))
    except OSError:
        cpu = platform.processor().encode()
    gxx = subprocess.run(["g++", "--version"], capture_output=True, check=True).stdout.split(b"\n", 1)[0]
    return b"\n".join([cpu, gxx, " ".join(platform.libc_ver()).encode()])


def library_path() -> Path:
    """Where the library is (built at first call)."""
    return _build.build("rs_native_io", [SRC], compiler="g++", flags=FLAGS, salt=_machine_salt())


def get_lib() -> ctypes.CDLL:
    """The loaded library, built at first use; raises
    :class:`NativeUnavailable` when it cannot be built or loaded."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed:
            raise NativeUnavailable("the native IO library failed to build earlier in this process")
        try:
            lib = ctypes.CDLL(str(library_path()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _build_failed = True
            raise NativeUnavailable(f"cannot build or load rs_native_io: {e}") from e
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        i32, i64 = ctypes.c_int, ctypes.c_longlong
        lib.rs_stripe_read.argtypes = [ctypes.c_char_p, u8p, i64, i32, i64, i64, i64]
        lib.rs_stripe_read.restype = i64
        lib.rs_gather_rows.argtypes = [ctypes.POINTER(i32), u8p, i32, i64, i64]
        lib.rs_gather_rows.restype = i32
        lib.rs_scatter_write.argtypes = [ctypes.POINTER(i32), u8p, i32, i64, i64]
        lib.rs_scatter_write.restype = i32
        lib.rs_interleave_read.argtypes = [ctypes.c_char_p, u8p, i32, i32, i64, i64, i64]
        lib.rs_interleave_read.restype = i64
        lib.rs_deinterleave_write.argtypes = [i32, ctypes.POINTER(ctypes.c_void_p), i32, i32, i64, i64, i64]
        lib.rs_deinterleave_write.restype = i32
        _lib = lib
        return lib


def _native():
    try:
        return get_lib()
    except NativeUnavailable:
        return None


def gemm_library_path() -> Path:
    """Where the GEMM/invert library is (built at first call)."""
    return _build.build("rs_native_gemm", [GEMM_SRC], compiler="g++", flags=FLAGS, salt=_machine_salt())


def get_gemm_lib() -> ctypes.CDLL:
    """The loaded GEMM/invert library, built at first use; raises
    :class:`NativeUnavailable` when it cannot be built or loaded."""
    global _gemm_lib, _gemm_build_failed
    with _lock:
        if _gemm_lib is not None:
            return _gemm_lib
        if _gemm_build_failed:
            raise NativeUnavailable("the native GEMM library failed to build earlier in this process")
        try:
            lib = ctypes.CDLL(str(gemm_library_path()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _gemm_build_failed = True
            raise NativeUnavailable(f"cannot build or load rs_native_gemm: {e}") from e
        u8p = np.ctypeslib.ndpointer(dtype=np.uint8, flags="C_CONTIGUOUS")
        lib.rs_gf_init.restype = ctypes.c_int
        lib.rs_gemm.argtypes = [u8p, u8p, u8p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int]
        lib.rs_gemm.restype = None
        lib.rs_invert.argtypes = [u8p, u8p, ctypes.c_int]
        lib.rs_invert.restype = ctypes.c_int
        lib.rs_gf_init()
        _gemm_lib = lib
        return lib


def available() -> bool:
    """Whether the GEMM/invert library builds and loads here."""
    try:
        get_gemm_lib()
        return True
    except NativeUnavailable:
        return False


def gemm(A: np.ndarray, B: np.ndarray, nthreads: int = 0) -> np.ndarray:
    """(p, k) x (k, m) -> (p, m) over GF(2^8) on the host, on ``nthreads``
    threads (0: every core).  Without the library, the NumPy oracle
    (counted in :data:`GEMM_FALLBACK_CALLS`)."""
    A = np.ascontiguousarray(A, dtype=np.uint8)
    B = np.ascontiguousarray(B, dtype=np.uint8)
    p, k = A.shape
    if B.ndim != 2 or B.shape[0] != k:
        raise ValueError(f"shape mismatch {A.shape} @ {B.shape}")
    try:
        lib = get_gemm_lib()
    except NativeUnavailable:
        from ..ops.gf import get_field

        _count_gemm(False)
        return get_field(8).matmul(A, B)
    _count_gemm(True)
    C = np.empty((p, B.shape[1]), dtype=np.uint8)
    lib.rs_gemm(A, B, C, p, k, B.shape[1], nthreads or os.cpu_count() or 1)
    return C


def invert(M: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse of a k x k GF(2^8) matrix on the host; raises
    :class:`..ops.inverse.SingularMatrixError` when it is singular.
    Without the library, the NumPy inverter (counted in
    :data:`GEMM_FALLBACK_CALLS`)."""
    from ..ops.inverse import SingularMatrixError, invert_matrix

    M = np.ascontiguousarray(M, dtype=np.uint8)
    if M.ndim != 2 or M.shape[0] != M.shape[1]:
        raise ValueError(f"invert needs a square matrix, got {M.shape}")
    try:
        lib = get_gemm_lib()
    except NativeUnavailable:
        _count_gemm(False)
        return invert_matrix(M)
    _count_gemm(True)
    out = np.empty_like(M)
    if lib.rs_invert(M, out, M.shape[0]) != 0:
        raise SingularMatrixError("matrix not invertible (native)")
    return out


def _dst(dst: np.ndarray | None, rows: int, cols: int) -> np.ndarray:
    if dst is None:
        return np.empty((rows, cols), dtype=np.uint8)
    if dst.dtype != np.uint8 or dst.shape != (rows, cols) or not dst.flags.c_contiguous:
        raise ValueError(f"dst must be a C-contiguous uint8 ({rows}, {cols}) array, got {dst.dtype}{dst.shape}")
    return dst


def stripe_read(path: str, chunk: int, k: int, off: int, cols: int, total_size: int,
                fallback_src: np.ndarray | None = None, dst: np.ndarray | None = None) -> np.ndarray:
    """(k, cols) stripe segment of a file: row i holds bytes ``[i*chunk +
    off, ...)`` up to the chunk's end and ``total_size``, zero-padded.
    ``fallback_src``: an open memmap of ``path`` for the fallback (saves a
    mapping per segment).  A file shorter than ``total_size`` raises
    ``OSError``."""
    t0 = time.perf_counter()
    dst = _dst(dst, k, cols)
    lib = _native()
    if lib is not None:
        _count(True)
        if lib.rs_stripe_read(path.encode(), dst, chunk, k, off, cols, total_size) < 0:
            raise OSError(f"rs_stripe_read failed for {path!r} (I/O error or truncated file)")
        _count_io("read", "stripe_read", dst.nbytes, time.perf_counter() - t0)
        return dst
    _count(False)
    src = fallback_src if fallback_src is not None else np.memmap(path, dtype=np.uint8, mode="r")

    def read_row(i: int) -> None:
        lo = i * chunk + off
        hi = max(lo, min(lo + cols, (i + 1) * chunk, total_size))
        got = src[lo:hi]
        if got.shape[0] != hi - lo:
            raise OSError(f"short read from {path!r} at byte {lo} (truncated file)")
        dst[i, : hi - lo] = got
        dst[i, hi - lo :] = 0

    from ..parallel.io_executor import run_rows

    run_rows(k, read_row)
    _count_io("read", "stripe_read", dst.nbytes, time.perf_counter() - t0)
    return dst


def gather_rows(files, off: int, cols: int, fallback_maps=None, dst: np.ndarray | None = None) -> np.ndarray:
    """(k, cols) segment at byte ``off`` of k open chunk files, the decode
    twin of :func:`stripe_read`.  ``fallback_maps``: memmaps of the files
    for the fallback.  A file that ends before ``off + cols`` raises
    ``OSError``."""
    t0 = time.perf_counter()
    k = len(files)
    dst = _dst(dst, k, cols)
    lib = _native()
    if lib is not None:
        _count(True)
        fds = (ctypes.c_int * k)(*[f.fileno() for f in files])
        if lib.rs_gather_rows(fds, dst, k, off, cols) != 0:
            raise OSError("rs_gather_rows failed (short read)")
        _count_io("read", "gather_rows", dst.nbytes, time.perf_counter() - t0)
        return dst
    _count(False)
    maps = fallback_maps if fallback_maps is not None else [np.memmap(f.name, dtype=np.uint8, mode="r") for f in files]

    def read_row(i: int) -> None:
        got = maps[i][off : off + cols]
        if got.shape[0] != cols:
            raise OSError(f"short read from chunk {i} at byte {off}")
        dst[i] = got

    from ..parallel.io_executor import run_rows

    run_rows(k, read_row)
    _count_io("read", "gather_rows", dst.nbytes, time.perf_counter() - t0)
    return dst


def scatter_write(files, arr: np.ndarray, off: int) -> None:
    """Row j of (p, cols) ``arr`` to open binary file j at byte ``off``."""
    t0 = time.perf_counter()
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    p, cols = arr.shape
    if len(files) != p:
        raise ValueError(f"{len(files)} files for {p} rows")
    lib = _native()
    if lib is None:
        _count(False)
        for fp, row in zip(files, arr):
            fp.seek(off)
            fp.write(row)
    else:
        _count(True)
        for fp in files:
            fp.flush()  # nothing buffered may straddle the pwrite
        fds = (ctypes.c_int * p)(*[fp.fileno() for fp in files])
        if lib.rs_scatter_write(fds, arr, p, cols, off) != 0:
            raise OSError("rs_scatter_write failed (short write)")
    _count_io("write", "scatter_write", arr.nbytes, time.perf_counter() - t0)


def interleave_read(path: str, k: int, sym: int, off: int, cols: int, total_size: int,
                    fallback_src: np.ndarray | None = None, dst: np.ndarray | None = None) -> np.ndarray:
    """(k, cols) interleaved segment at chunk bytes ``[off, off + cols)``:
    the file bytes ``[off*k, (off + cols)*k)``, cut at ``total_size`` and
    zero-padded, with file symbol j of the range at row ``j % k``, column
    ``j // k``.  ``off`` and ``cols`` are multiples of ``sym``.  A file
    shorter than ``total_size`` raises ``OSError``."""
    dst = _dst(dst, k, cols)
    lib = _native()
    if lib is not None:
        _count(True)
        if lib.rs_interleave_read(path.encode(), dst, k, sym, off, cols, total_size) < 0:
            raise OSError(f"rs_interleave_read failed for {path!r} (I/O error or truncated file)")
        return dst
    _count(False)
    src = fallback_src if fallback_src is not None else np.memmap(path, dtype=np.uint8, mode="r")
    lo = off * k
    hi = max(lo, min(lo + cols * k, total_size))
    got = src[lo:hi]
    if got.shape[0] != hi - lo:
        raise OSError(f"short read from {path!r} at byte {lo} (truncated file)")
    full = (hi - lo) // (k * sym)
    out = dst.reshape(k, cols // sym, sym)
    out[:, :full] = got[: full * k * sym].reshape(full, k, sym).transpose(1, 0, 2)
    if full < cols // sym:
        tail = np.zeros(k * sym, dtype=np.uint8)
        tail[: hi - lo - full * k * sym] = got[full * k * sym :]
        out[:, full] = tail.reshape(k, sym)
        out[:, full + 1 :] = 0
    return dst


def deinterleave_write(fp, rows, sym: int, off: int, total_size: int) -> None:
    """Write the k rows (each the chunk bytes ``[off, off + cols)`` of one
    native) to the open binary file ``fp`` as the contiguous file bytes
    ``[off*k, (off + cols)*k)``, cut at ``total_size``."""
    rows = [np.ascontiguousarray(r, dtype=np.uint8) for r in rows]
    k, cols = len(rows), rows[0].shape[0]
    lo = off * k
    hi = min(lo + cols * k, total_size)
    if hi <= lo:
        return
    lib = _native()
    if lib is None:
        _count(False)
        buf = np.empty((cols // sym, k, sym), dtype=np.uint8)
        for i, r in enumerate(rows):
            buf[:, i] = r.reshape(cols // sym, sym)
        fp.seek(lo)
        fp.write(buf.reshape(-1)[: hi - lo])
        return
    _count(True)
    fp.flush()  # nothing buffered may straddle the pwrite
    ptrs = (ctypes.c_void_p * k)(*[r.ctypes.data for r in rows])
    if lib.rs_deinterleave_write(fp.fileno(), ptrs, k, sym, off, cols, total_size) != 0:
        raise OSError("rs_deinterleave_write failed (short write)")
