"""What ``strategy="auto"`` means: the per-backend GEMM-strategy autotuner,
the counterpart of the JAX package's ``tune.py``.

* **prior mode** (the default): the static per-backend choice (``cuda`` on
  a CUDA device, ``bitplane`` on the CPU) unless a decision for this
  (backend, k, p, w) class is already known: measured in this process, or
  persisted in the schedule store.
* **measure mode** (``RS_STRATEGY_AUTOTUNE=measure``): the first ``auto``
  resolution of a class times every candidate on an encode-shaped stripe
  (a warm-up run, then the best of :data:`_MEASURE_REPS`), keeps the winner
  for the process and appends it to the store.
* ``RS_STRATEGY_AUTOTUNE=off``: always the static prior.

**Persisted decisions**: a measured verdict appends a ``kind:
"rs_autotune"`` record, keyed (host, backend, k, p, w), to the schedule
store (:func:`.obs.runlog.store_path`), in the JAX package's format.  In
prior mode a fresh process resolves from the store before the static
prior (``decisions()`` reports those with ``source: "ledger"``), so both
packages read each other's records.  The backend label is ``"cuda"`` on
the card and ``"other"`` on the CPU, the JAX package's label off a TPU.
A record whose strategy is no candidate here (the JAX package's
``"pallas"``, or ``cpu`` where the native codec does not build) is
skipped at resolution (the stale-record check), and the static prior
stands.

Candidates are timed the way the pipeline dispatches them: through
:func:`.plan.dispatch` on a staged stripe, so on the card ``cuda``,
``xor`` and ``ring`` are timed as graph replays; ``cpu`` reads a host
array.  On CUDA each timed run ends in a synchronize.  A candidate that
does not apply is left out by :func:`candidate_strategies`; one that is
measured and fails raises.
"""

from __future__ import annotations

import os
import socket
import threading
import time

import numpy as np
import torch

__all__ = [
    "VALID_STRATEGIES", "candidate_strategies", "resolve_auto",
    "autotune_decision", "decisions", "clear_decisions", "mode",
    "static_choice",
]

# Every strategy the codec accepts ("auto" resolves to one of the rest).
VALID_STRATEGIES = ("auto", "cuda", "bitplane", "table", "xor", "ring", "cpu")
# Strategies a store record may name: the JAX package's TPU kernel too, a
# well-formed record that is never a candidate here (the stale-record
# check drops it), so both packages resolve one store alike.
_STORE_STRATEGIES = VALID_STRATEGIES + ("pallas",)

_DECISIONS: dict[tuple, dict] = {}
_LOCK = threading.Lock()
_MEASURE_LOCK = threading.Lock()  # one candidate sweep at a time

# (backend, k, p, w) -> persisted rs_autotune record for this host, read
# from the store once per process (reset by clear_decisions()).
_LEDGER_INDEX: dict[tuple, dict] | None = None

_MEASURE_COLS = 256 * 1024  # bytes per chunk in the probe stripe
_MEASURE_REPS = 3


def mode() -> str:
    """``prior`` (default) | ``measure`` | ``off``, from ``RS_STRATEGY_AUTOTUNE``."""
    v = os.environ.get("RS_STRATEGY_AUTOTUNE", "prior").lower()
    if v in ("measure", "1", "on"):
        return "measure"
    if v in ("off", "0", "false", "no"):
        return "off"
    return "prior"


def _backend(device) -> str:
    return "cuda" if torch.device(device).type == "cuda" else "other"


def static_choice(w: int = 8, device="cpu") -> str:
    """The zero-cost prior: the hand-written kernel on the card, the plain
    bitplane path elsewhere."""
    return "cuda" if _backend(device) == "cuda" else "bitplane"


def candidate_strategies(w: int = 8, device="cpu") -> tuple:
    """Strategies ``auto`` may pick for ``device``, fastest prior first."""
    if _backend(device) == "cuda":
        cands = ["cuda", "bitplane", "xor", "table"]
    else:
        cands = ["bitplane", "xor", "table"]
    if w not in (8, 16):
        cands.remove("xor")
    if w == 8:
        # The ring lowering's plane expansion is 2.125x at w=8 and 16x at
        # w=16: ring at w=16 is a correctness rung, never a candidate.
        cands.insert(cands.index("xor") + 1, "ring")
    if w == 8:
        from . import native

        if native.available():
            cands.append("cpu")
    return tuple(cands)


def decisions() -> dict:
    """The decisions known to this process, keyed ``backend|k|p|w``."""
    with _LOCK:
        return {"|".join(map(str, key)): dict(val) for key, val in _DECISIONS.items()}


def clear_decisions() -> None:
    global _LEDGER_INDEX
    with _LOCK:
        _DECISIONS.clear()
        _LEDGER_INDEX = None  # re-read the store at the next resolution


def _count_source(source: str) -> None:
    from .obs import metrics as _metrics

    _metrics.counter("rs_autotune_source_total", "strategy-auto resolutions by decision source").labels(
        source=source).inc()


def _rec_ts(rec: dict) -> float:
    try:
        return float(rec.get("ts") or 0.0)
    except (TypeError, ValueError):
        return 0.0


def _ledger_decisions() -> dict[tuple, dict]:
    """Persisted verdicts for this host, keyed (backend, k, p, w); the
    newest timestamp wins (rotation may carry old records after fresh
    ones).  Malformed records, and records of strategies neither package
    has, are skipped: the store is a cache."""
    global _LEDGER_INDEX
    with _LOCK:
        if _LEDGER_INDEX is not None:
            return _LEDGER_INDEX
    from .obs import runlog as _runlog

    p = _runlog.store_path()
    idx: dict[tuple, dict] = {}
    if p:
        host = socket.gethostname()
        for rec in _runlog.read_records(p):
            if rec.get("kind") != "rs_autotune" or rec.get("host") != host:
                continue
            try:
                key = (str(rec["backend"]), int(rec["k"]), int(rec["p"]), int(rec["w"]))
                strategy = str(rec["strategy"])
            except (KeyError, TypeError, ValueError):
                continue
            if strategy not in _STORE_STRATEGIES or strategy == "auto":
                continue
            cur = idx.get(key)
            if cur is None or _rec_ts(rec) >= _rec_ts(cur):
                idx[key] = rec
    with _LOCK:
        if _LEDGER_INDEX is None:
            _LEDGER_INDEX = idx
        return _LEDGER_INDEX


def _persist_decision(decision: dict) -> None:
    """Append a measured verdict to the store (when there is one)."""
    from .obs import runlog as _runlog

    p = _runlog.store_path()
    if not p:
        return
    rec = {
        "kind": "rs_autotune",
        "schema": _runlog.SCHEMA_VERSION,
        "host": socket.gethostname(),
        "backend": decision["backend"],
        "k": decision["k"],
        "p": decision["p"],
        "w": decision["w"],
        "strategy": decision["strategy"],
        "gbps": decision["gbps"],
        "ts": decision["ts"],
        "run": _runlog.run_id(),
    }
    _runlog.append(rec, p)
    key = (decision["backend"], decision["k"], decision["p"], decision["w"])
    with _LOCK:
        if _LEDGER_INDEX is not None:
            _LEDGER_INDEX[key] = rec


def _measure_one(strategy: str, A, B, w: int) -> float:
    """Best-of-reps seconds of one warm dispatch of ``strategy``.

    ``B`` lies where the strategy reads it: a staged
    :class:`.plan.StagedSegment` on the device (a host one for ``cpu``),
    so no timed run includes a transfer the pipeline does not pay.  The
    first run absorbs the plan's build and its graph capture.
    """
    from . import plan as _plan

    cuda = B.array.device.type == "cuda"

    def run():
        if _plan.enabled():
            _plan.dispatch(A, B, w=w, strategy=strategy, cap=B.cap, cols=B.cols)
        else:
            _plan.eager(strategy, A, B.array, w)
        if cuda:
            torch.cuda.synchronize(B.array.device)

    run()
    best = float("inf")
    for _ in range(_MEASURE_REPS):
        t0 = time.perf_counter()
        run()
        best = min(best, time.perf_counter() - t0)
    return best


def autotune_decision(k: int, p: int, w: int = 8, generator: str = "vandermonde", device="cpu") -> dict:
    """Measure every candidate on an encode-shaped stripe on ``device`` and
    keep the winner for this (backend, k, p, w) class."""
    from . import plan as _plan
    from .models.vandermonde import generator_matrix
    from .ops.gemm import to_tensor
    from .ops.gf import get_field

    device = torch.device(device)
    backend = _backend(device)
    key = (backend, k, p, w)
    # A store-sourced entry never satisfies an explicit measure: measuring
    # again (and overwriting the record) is how a hardware change shows.
    with _LOCK:
        hit = _DECISIONS.get(key)
    if hit is not None and hit.get("source") == "measured":
        return hit
    with _MEASURE_LOCK:
        with _LOCK:
            hit = _DECISIONS.get(key)
        if hit is not None and hit.get("source") == "measured":
            return hit
        gf = get_field(w)
        A = generator_matrix(generator, p, k, gf)
        m = max(1, _MEASURE_COLS // int(np.dtype(gf.dtype).itemsize))
        rng = np.random.default_rng(20260804)
        Bh = rng.integers(0, gf.size, size=(k, m)).astype(gf.dtype)
        host = _plan.StagedSegment(to_tensor(Bh), m, None)
        staged, slot = host, None
        if device.type == "cuda":
            # A staging buffer of the pool, as the segment loops stage into:
            # the graph strategies are timed as replays.
            slot = _plan.STAGING.acquire(device, Bh.nbytes)
            arr = slot.tensor.view(to_tensor(Bh).dtype).view(k, m)
            arr.copy_(to_tensor(Bh))
            staged = _plan.StagedSegment(arr, m, None, slot=slot)
        table: dict[str, float] = {}
        data_bytes = k * m * int(np.dtype(gf.dtype).itemsize)
        best_name, best_gbps = None, -1.0
        try:
            for name in candidate_strategies(w, device):
                dt = _measure_one(name, A, host if name == "cpu" else staged, w)
                gbps = data_bytes / dt / 1e9 if dt > 0 else 0.0
                table[name] = round(gbps, 4)
                if gbps > best_gbps:
                    best_name, best_gbps = name, gbps
        finally:
            if slot is not None:
                done = torch.cuda.Event()
                done.record(torch.cuda.current_stream(device))
                _plan.STAGING.release(slot, done)
        decision = {
            "strategy": best_name,
            "source": "measured",
            "backend": backend,
            "k": k,
            "p": p,
            "w": w,
            "gbps": table,
            "ts": time.time(),
        }
        from .obs import metrics as _metrics

        _metrics.counter("rs_strategy_autotune_total", "strategy-autotune measurements by backend and winner").labels(
            backend=backend, winner=best_name).inc()
        _count_source("measured")
        _persist_decision(decision)
        with _LOCK:
            _DECISIONS[key] = decision  # overwrites a store-sourced entry
            return decision


def resolve_auto(k: int, p: int, w: int = 8, *, device="cpu", generator: str = "vandermonde") -> str:
    """The strategy ``auto`` means for a codec of this shape on ``device``.

    ``off`` mode takes the static prior; otherwise a measured decision of
    this process wins, then (prior mode) a decision persisted in the store
    for this (host, backend, k, p, w) class whose strategy is still a
    candidate here, then the static prior.  ``measure`` mode measures
    instead of trusting the store, and overwrites its record.
    """
    if mode() == "off":
        return static_choice(w, device)
    backend = _backend(device)
    key = (backend, k, p, w)
    with _LOCK:
        hit = _DECISIONS.get(key)
    if hit is not None and (mode() != "measure" or hit.get("source") == "measured"):
        _count_source(hit.get("source") or "measured")
        return hit["strategy"]
    if mode() == "measure":
        return autotune_decision(k, p, w, generator, device)["strategy"]
    led = _ledger_decisions().get(key)
    if led is not None and led["strategy"] not in candidate_strategies(w, device):
        # The persisted winner cannot run here any more (the native codec
        # does not build, a card host became CPU-only): the prior stands;
        # measure mode measures and overwrites when asked.
        led = None
    if led is not None:
        decision = {
            "strategy": led["strategy"],
            "source": "ledger",
            "backend": backend,
            "k": k,
            "p": p,
            "w": w,
            "gbps": led.get("gbps"),
            "ts": led.get("ts"),
        }
        with _LOCK:
            decision = _DECISIONS.setdefault(key, decision)
        _count_source("ledger")
        return decision["strategy"]
    _count_source("prior")
    return static_choice(w, device)
