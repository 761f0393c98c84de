"""Span tracing with Chrome-trace / Perfetto JSON export: the port's copy
of the JAX package's ``obs/tracing.py``.

A :func:`session` (``RS_TRACE=<path>`` or an explicit path) collects
:func:`span`\\ s on named *lanes*, :func:`instant` markers, :func:`counter`
samples and retroactive :func:`complete` events, and exports one JSON file
that ``chrome://tracing`` or https://ui.perfetto.dev loads.  The file's
events and envelope are the JAX package's, key for key; only the
``process_name`` metadata names this package.

Event model: Chrome trace "complete" events (``ph="X"`` with ``ts``/``dur``
in microseconds), so a crashed run still loads with every finished span;
lanes map to ``tid`` with ``thread_name`` metadata events; counter tracks
are ``ph="C"`` events.

Off by default: with no active session, :func:`span` returns a shared
``nullcontext`` and :func:`instant` / :func:`counter` return at once, one
module-global read.

Import cost: the standard library only.
"""

from __future__ import annotations

import functools
import json
import os
import socket
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext

_NULL_CM = nullcontext()

# Multi-process alignment state: the shared epoch is the wall clock taken
# right after the process group's initialisation returns (a barrier every
# process crosses at nearly the same time), so per-process trace timelines
# can be fused onto one time axis.  Set by mark_epoch(); None in
# single-process runs.
_EPOCH: float | None = None
_PROCESS_INDEX: int | None = None


def mark_epoch(process_index: int | None = None,
               epoch: float | None = None) -> None:
    """Record the shared alignment epoch (and this process's index) that
    every subsequent trace export embeds in ``otherData`` — called once,
    right after distributed init, when all processes are in lockstep."""
    global _EPOCH, _PROCESS_INDEX
    _EPOCH = time.time() if epoch is None else epoch
    if process_index is not None:
        _PROCESS_INDEX = int(process_index)


class Tracer:
    """Collects events for one tracing session.

    Thread-safe by construction: events land in a ``deque`` (atomic
    append), lane-id assignment takes the only lock.  Timestamps are
    microseconds since the tracer's creation (Chrome trace's unit).
    """

    def __init__(self, path: str | None = None):
        self.path = path
        self._events: deque = deque()
        self._t0 = time.perf_counter()
        # Monotonic clock at t0: anchors retroactive events recorded
        # from time.monotonic() stamps (the request lifecycle plane,
        # obs/reqtrace.py) onto this tracer's timeline without assuming
        # perf_counter and monotonic share an epoch.
        self._mono_t0 = time.monotonic()
        # Wall clock at t0: lets the aggregator place this trace's
        # relative timestamps on a shared cross-host axis.
        self.wall_t0 = time.time()
        self._lanes: dict[str, int] = {}
        self._lock = threading.Lock()

    # -- recording -----------------------------------------------------------

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _tid(self, lane: str) -> int:
        with self._lock:
            tid = self._lanes.get(lane)
            if tid is None:
                tid = self._lanes[lane] = len(self._lanes) + 1
            return tid

    @contextmanager
    def span(self, name: str, lane: str = "host", **args):
        """Record a complete ("X") event covering the ``with`` body."""
        t0 = self._now_us()
        try:
            yield self
        finally:
            t1 = self._now_us()
            ev = {
                "name": name,
                "ph": "X",
                "ts": t0,
                "dur": t1 - t0,
                "pid": 1,
                "tid": self._tid(lane),
            }
            if args:
                ev["args"] = args
            self._events.append(ev)

    def instant(self, name: str, lane: str = "host", **args) -> None:
        ev = {
            "name": name,
            "ph": "i",
            "s": "t",
            "ts": self._now_us(),
            "pid": 1,
            "tid": self._tid(lane),
        }
        if args:
            ev["args"] = args
        self._events.append(ev)

    def counter(self, name: str, **values) -> None:
        """Counter-track sample (Perfetto renders these as value lanes)."""
        self._events.append({
            "name": name,
            "ph": "C",
            "ts": self._now_us(),
            "pid": 1,
            "args": values,
        })

    def complete(self, name: str, lane: str, t0_mono: float,
                 t1_mono: float, **args) -> None:
        """Record a complete ("X") event RETROACTIVELY from a pair of
        ``time.monotonic()`` stamps — the request lifecycle plane stamps
        stages as a request flows and emits the spans once, at ack, so
        every span carries the finished request's identity args."""
        ev = {
            "name": name,
            "ph": "X",
            "ts": (t0_mono - self._mono_t0) * 1e6,
            "dur": max(0.0, (t1_mono - t0_mono) * 1e6),
            "pid": 1,
            "tid": self._tid(lane),
        }
        if args:
            ev["args"] = args
        self._events.append(ev)

    # -- export --------------------------------------------------------------

    def events(self) -> list[dict]:
        """Snapshot of the recorded events, safe against a concurrent
        appender (a leaked worker thread still inside a span): a mutated-
        during-iteration copy retries, then falls back to an atomic
        popleft drain — a crashed copy must never fail the file operation
        that owns the session."""
        for _ in range(5):
            try:
                return list(self._events)
            except RuntimeError:  # deque mutated during iteration
                continue
        drained: list[dict] = []
        while True:
            try:
                drained.append(self._events.popleft())
            except IndexError:
                self._events.extend(drained)
                return drained

    def export(self, path: str | None = None) -> str:
        """Write the Chrome-trace JSON file; returns the path written."""
        path = path or self.path
        if not path:
            raise ValueError("no trace path given")
        with self._lock:
            lanes = sorted(self._lanes.items(), key=lambda kv: kv[1])
        meta = [
            {
                "name": "thread_name",
                "ph": "M",
                "pid": 1,
                "tid": tid,
                "args": {"name": lane},
            }
            for lane, tid in lanes
        ] + [{
            "name": "process_name",
            "ph": "M",
            "pid": 1,
            "args": {"name": "gpu_rscode_torch"},
        }]
        # otherData rides the standard Chrome-trace envelope (ignored by
        # viewers): identity + alignment anchors for obs/aggregate.py.
        other = {"rs_wall_t0": self.wall_t0, "rs_host": socket.gethostname()}
        if _EPOCH is not None:
            other["rs_epoch"] = _EPOCH
        if _PROCESS_INDEX is not None:
            other["rs_process_index"] = _PROCESS_INDEX
        payload = {
            "traceEvents": meta + self.events(),
            "displayTimeUnit": "ms",
            "otherData": other,
        }
        tmp = path + ".rs_tmp"
        try:
            with open(tmp, "w") as fp:
                # default=str: span args are caller-supplied (numpy
                # scalars etc.) — degrade them to strings rather than
                # lose the whole trace to one non-serializable value.
                json.dump(payload, fp, default=str)
            os.replace(tmp, path)
        except BaseException:
            # Never leave a half-written temp behind (the chunk-commit
            # paths keep the same contract for their .rs_tmp files).
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        return path


# -- module-level session ----------------------------------------------------

_ACTIVE: Tracer | None = None
_SESSION_LOCK = threading.Lock()


def active() -> Tracer | None:
    """The session tracer, or None when tracing is off."""
    return _ACTIVE


def span(name: str, lane: str = "host", **args):
    """Record a span on the active session; no-op context manager when
    tracing is off (the hot-path entry point — one global read)."""
    t = _ACTIVE
    if t is None:
        return _NULL_CM
    return t.span(name, lane, **args)


def instant(name: str, lane: str = "host", **args) -> None:
    t = _ACTIVE
    if t is not None:
        t.instant(name, lane, **args)


def counter(name: str, **values) -> None:
    t = _ACTIVE
    if t is not None:
        t.counter(name, **values)


def complete(name: str, lane: str, t0_mono: float, t1_mono: float,
             **args) -> None:
    """Retroactive complete event on the active session from
    ``time.monotonic()`` stamps; no-op when tracing is off."""
    t = _ACTIVE
    if t is not None:
        t.complete(name, lane, t0_mono, t1_mono, **args)


def traced(name: str | None = None, lane: str = "host"):
    """Decorator form of :func:`span` (zero overhead when tracing is off)."""

    def deco(fn):
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a, **kw):
            t = _ACTIVE
            if t is None:
                return fn(*a, **kw)
            with t.span(label, lane):
                return fn(*a, **kw)

        return wrapper

    return deco


@contextmanager
def session(path: str | None = None):
    """Activate tracing for a region and export on exit.

    ``path`` defaults to the ``RS_TRACE`` env var; with neither set this is
    a no-op.  Reentrant: a session opened inside an active one joins it
    (records into the outer tracer, which owns the export) — so
    ``auto_decode_file`` -> ``decode_file`` and ``repair_fleet`` ->
    ``repair_file`` produce ONE coherent trace, not an inner overwrite.
    The session is process-global, so a concurrent SIBLING (another thread
    asking for a different path while one is active) also joins the active
    tracer — its own path is never written; that case warns so the missing
    file is explained.  Yields the active tracer (or None).
    """
    global _ACTIVE
    path = path or os.environ.get("RS_TRACE") or None
    owner = None
    with _SESSION_LOCK:
        if path and _ACTIVE is None:
            owner = _ACTIVE = Tracer(path)
        elif path and _ACTIVE is not None and path != _ACTIVE.path:
            import warnings

            warnings.warn(
                f"a trace session is already active (exporting to "
                f"{_ACTIVE.path!r}); spans record there and {path!r} "
                "will not be written",
                stacklevel=3,
            )
    try:
        yield _ACTIVE
    finally:
        if owner is not None:
            with _SESSION_LOCK:
                _ACTIVE = None
            try:
                owner.export()
            except (OSError, TypeError, ValueError) as e:
                # Tracing is observability: a bad RS_TRACE path (or a
                # serialization surprise in caller-supplied span args)
                # must neither fail a file operation that succeeded nor
                # bury the real exception of one that did not.
                import warnings

                warnings.warn(
                    f"trace export to {owner.path!r} failed: "
                    f"{type(e).__name__}: {e}",
                    stacklevel=2,
                )
