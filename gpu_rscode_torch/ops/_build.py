"""Build and load the port's native libraries.

Each CUDA kernel library is compiled by ``nvcc`` from the sources under
``ops/csrc/`` at first use, into ``build/gpu_rscode_torch/<name>-<hash>/``
at the root of the checkout (the host IO library of :mod:`..native` the
same way, by ``g++``).  The hash covers the sources and the flags, so an
edited source rebuilds and an unchanged one is reused; a build lands under
a pid-suffixed name and is renamed into place, so processes that build at
once never load a half-written library.  The library has a plain C
interface and is loaded with ``ctypes``; no PyTorch header is compiled.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}
# Per library: the compiler's output (register and shared-memory use from
# -Xptxas=-v) and the build's wall seconds (0.0 when an earlier build of the
# same sources was reused).
BUILD_LOG: dict[str, str] = {}
BUILD_SECONDS: dict[str, float] = {}
# Device operators packed from coefficient matrices, shared by the kernels'
# wrappers; emptied when full.
_OPERATORS: dict = {}
_MAX_OPERATORS = 64


def build_root() -> Path:
    return Path(__file__).resolve().parents[2] / "build" / "gpu_rscode_torch"


def find_nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        return "/usr/local/cuda/bin/nvcc"
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _digest(sources: list[Path], flags, salt: bytes) -> str:
    h = hashlib.sha256(" ".join(flags).encode() + salt)
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(name: str, sources: list[Path], *, compiler: str | None = None, flags=NVCC_FLAGS,
          salt: bytes = b"") -> Path:
    """Compile ``sources`` into ``lib<name>.so`` unless an identical build
    exists; returns the library's path.  ``compiler`` defaults to ``nvcc``;
    ``salt`` enters the hash beside the sources and flags (the host IO
    library passes the build machine's CPU, compiler and C library, since
    it is built for that machine).  A
    failed build raises with the compiler's output."""
    out_dir = build_root() / f"{name}-{_digest(sources, flags, salt)}"
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        BUILD_SECONDS.setdefault(name, 0.0)
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"lib{name}.so.{os.getpid()}.tmp"
    cmd = [compiler or find_nvcc(), *flags, "-o", str(tmp), *map(str, sources)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(
                f"{os.path.basename(cmd[0])} failed for {name} (exit {proc.returncode}):\n{BUILD_LOG[name]}"
            )
        os.replace(tmp, lib)
    finally:
        if tmp.exists():
            tmp.unlink()
    return lib


def build_many(libs: dict[str, list[Path]]) -> None:
    """Run one ``nvcc`` per library, all at once; raises the first failure
    after every build has ended."""
    with ThreadPoolExecutor(max_workers=max(1, len(libs))) as pool:
        futures = [pool.submit(build, name, sources) for name, sources in libs.items()]
    for fut in futures:
        fut.result()


def load(name: str, sources: list[Path]) -> ctypes.CDLL:
    """The loaded library, built at first use (once per process).  Every
    library exports ``rs_cuda_error_string``, bound here."""
    with _LOCK:
        if name not in _LIBS:
            lib = ctypes.CDLL(str(build(name, sources)))
            lib.rs_cuda_error_string.argtypes = [ctypes.c_int]
            lib.rs_cuda_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return _LIBS[name]


def cached_operator(key: tuple, make):
    """The operator for ``key``, made by ``make()`` at first use and kept;
    the key names the kernel, the coefficient matrix and the device."""
    op = _OPERATORS.get(key)
    if op is None:
        if len(_OPERATORS) >= _MAX_OPERATORS:
            # A kernel queued on another stream may still read an operator
            # about to be freed: let the device finish first.
            if torch.cuda.is_initialized():
                torch.cuda.synchronize()
            _OPERATORS.clear()
        op = _OPERATORS[key] = make()
    return op


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(
            f"{what} kernel launch failed: {lib.rs_cuda_error_string(err).decode()} (cudaError {err})"
        )
