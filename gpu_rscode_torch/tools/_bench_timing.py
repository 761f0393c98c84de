"""Device timing shared by the measurement tools: the counterpart of the
JAX package's ``tools/_bench_timing.py``.

On CUDA a loop of calls sized to about ``target_s`` is timed with CUDA
events (no host round trip to subtract); on the CPU the same loop is timed
with ``perf_counter``.  Trials land in a :class:`..utils.timing.PhaseTimer`,
whose per-phase minimum is the best of the trials.
"""

from __future__ import annotations

import time

import torch

from ..utils.timing import PhaseTimer


def _loop_seconds(fn, iters: int, device: torch.device, timer: PhaseTimer, name: str) -> None:
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        timer.add(name, start.elapsed_time(end) / 1e3)
    else:
        with timer.phase(name):
            for _ in range(iters):
                fn()


def best_host_seconds(fn, trials: int, device: torch.device | None = None) -> float:
    """Best host-clock seconds of one call of ``fn`` over ``trials`` calls,
    each ended by a synchronise of ``device`` when it is a CUDA device:
    what a caller waits for, launch and copies included."""
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        fn()
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)
        best = min(best, time.perf_counter() - t0)
    return best


def time_device_fn(fn, trials: int = 2, target_s: float = 1.5) -> float:
    """Best per-call seconds of ``fn`` (a thunk returning a tensor) over
    ``trials`` loops of about ``target_s`` each."""
    out = fn()  # warm-up: builds kernels, fills operator caches
    device = out.device
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t = PhaseTimer()
    _loop_seconds(fn, 1, device, t, "probe")
    iters = max(1, min(2000, int(target_s / max(t.best["probe"], 1e-6))))
    for _ in range(trials):
        _loop_seconds(fn, iters, device, t, "loop")
    return t.best["loop"] / iters
