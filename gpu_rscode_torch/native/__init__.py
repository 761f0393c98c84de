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

``stripe_read`` and ``gather_rows`` take ``dst=``: a (k, cols) C-contiguous
uint8 array to read into (the pipeline passes a view of a pinned buffer),
in place of a fresh one.
"""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops import _build

SRC = Path(__file__).resolve().parent / "rs_native_io.cpp"
FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_build_failed = False

# Calls served by the library and by the NumPy fallback since the counts
# were last reset (prefetch and writer threads add to them at once).
NATIVE_CALLS = 0
FALLBACK_CALLS = 0
_count_lock = threading.Lock()


class NativeUnavailable(RuntimeError):
    """The library could not be built or loaded (no ``g++``)."""


def _count(native: bool) -> None:
    global NATIVE_CALLS, FALLBACK_CALLS
    with _count_lock:
        if native:
            NATIVE_CALLS += 1
        else:
            FALLBACK_CALLS += 1


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
        _lib = lib
        return lib


def _native():
    try:
        return get_lib()
    except NativeUnavailable:
        return None


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
    dst = _dst(dst, k, cols)
    lib = _native()
    if lib is not None:
        _count(True)
        if lib.rs_stripe_read(path.encode(), dst, chunk, k, off, cols, total_size) < 0:
            raise OSError(f"rs_stripe_read failed for {path!r} (I/O error or truncated file)")
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
    return dst


def gather_rows(files, off: int, cols: int, fallback_maps=None, dst: np.ndarray | None = None) -> np.ndarray:
    """(k, cols) segment at byte ``off`` of k open chunk files, the decode
    twin of :func:`stripe_read`.  ``fallback_maps``: memmaps of the files
    for the fallback.  A file that ends before ``off + cols`` raises
    ``OSError``."""
    k = len(files)
    dst = _dst(dst, k, cols)
    lib = _native()
    if lib is not None:
        _count(True)
        fds = (ctypes.c_int * k)(*[f.fileno() for f in files])
        if lib.rs_gather_rows(fds, dst, k, off, cols) != 0:
            raise OSError("rs_gather_rows failed (short read)")
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
    return dst


def scatter_write(files, arr: np.ndarray, off: int) -> None:
    """Row j of (p, cols) ``arr`` to open binary file j at byte ``off``."""
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
        return
    _count(True)
    for fp in files:
        fp.flush()  # nothing buffered may straddle the pwrite
    fds = (ctypes.c_int * p)(*[fp.fileno() for fp in files])
    if lib.rs_scatter_write(fds, arr, p, cols, off) != 0:
        raise OSError("rs_scatter_write failed (short write)")
