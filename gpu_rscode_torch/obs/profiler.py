"""Per-dispatch stage profiler: where ONE GEMM dispatch's wall goes.

The counterpart of the JAX package's ``obs/profiler.py``, with the same
knobs, stage vocabulary and wide event:

* **Opt-in, sampled**: ``RS_PROF`` truthy (or :func:`force_enable`)
  turns the plane on; ``RS_PROF_SAMPLE=1/N`` profiles one dispatch in N.
  Stage timing synchronises between stages, which undoes the overlap of
  the segment pipeline, so a daemon samples sparsely.  With ``RS_PROF``
  unset, :func:`begin` returns None after one env read, no stage dict is
  allocated and nothing registers (``tests/test_torch_profiler.py``).
* **One wide event per profiled dispatch**: op, strategy, width, bucket,
  bytes, per-stage seconds, coverage and cache attribution (plan bucket
  hit / miss, packed operand reused / packed, schedule memory / store /
  built, the optimizer's wall), fanned out to (1) the run ledger as
  ``kind=rs_perf`` (``rs perf``'s evidence), (2) the
  ``rs_prof_stage_seconds{stage,strategy,op}`` quantiles and (3)
  retroactive ``prof:<stage>`` spans in an active trace.
* **Thread-local**: the seams live layers apart (the codec names the op,
  the plan opens the profile, the xor / ring pipelines time their
  stages), and concurrent daemon workers each profile their own
  dispatches.

On the card a stage is timed by synchronising the stream it was enqueued
on: the current stream of the dispatching thread, which in a segment loop
is its :class:`..parallel.pipeline.StreamLoop`'s compute stream and during
a graph replay the stream the replay runs on, never the default stream of
another thread.  No stage is timed while the current stream is capturing
a CUDA graph (a synchronise is illegal there): the plan layer suspends
the profile around a capture and times the whole capture dispatch as
``compile`` (:func:`suspended`), and :func:`run_stage` refuses to time a
stage inside a capture.

Import cost: the standard library; torch only when a stage is timed.
"""

from __future__ import annotations

import os
import threading
import time
from contextlib import contextmanager

from . import metrics as _metrics, runlog as _runlog, tracing as _tracing

# The stage vocabulary.  ``h2d`` (staging) is observed into the same
# quantile family but kept out of the stages dict: staging happens before
# the dispatch opens, so it is not part of the dispatch wall.
STAGES = ("pack", "chain", "ring_in", "shift_acc", "ring_out", "unpack", "compile")

_TRUTHY = ("1", "true", "on", "yes")

_FORCED = False

_LOCK = threading.Lock()
_SEEN = 0  # dispatches seen since process start: the sampling clock

_TLS = threading.local()


def enabled() -> bool:
    """Whether the profiler plane is on: ``RS_PROF`` truthy (read per
    call) or :func:`force_enable` latched."""
    return _FORCED or os.environ.get("RS_PROF", "").lower() in _TRUTHY


def force_enable(on: bool = True) -> None:
    """Latch the profiler on (off) regardless of ``RS_PROF``."""
    global _FORCED
    _FORCED = on


def sample_every() -> int:
    """``RS_PROF_SAMPLE``: profile one dispatch in N (``1/N`` or bare
    ``N``; default 1).  A malformed value means 1: a typo widens the
    observation instead of silently turning it off."""
    v = os.environ.get("RS_PROF_SAMPLE", "").strip()
    if not v:
        return 1
    if "/" in v:
        v = v.split("/", 1)[1].strip()
    try:
        return max(1, int(v))
    except ValueError:
        return 1


def _sampled() -> bool:
    global _SEEN
    n = sample_every()
    with _LOCK:
        _SEEN += 1
        return n <= 1 or _SEEN % n == 1  # the first dispatch is always sampled


def reset() -> None:
    """Drop all thread-local and sampling state (tests)."""
    global _SEEN
    with _LOCK:
        _SEEN = 0
    for attr in ("prof", "op", "staging", "last"):
        try:
            delattr(_TLS, attr)
        except AttributeError:
            pass


class DispatchProfile:
    """The in-flight record of one profiled dispatch."""

    __slots__ = ("op", "strategy", "w", "bucket", "bytes_in", "bytes_out", "t0", "stages", "spans", "cache",
                 "staging_s", "staging_bytes")

    def __init__(self, *, op, strategy, w, bucket, bytes_in):
        self.op = op
        self.strategy = strategy
        self.w = w
        self.bucket = bucket
        self.bytes_in = bytes_in
        self.bytes_out = None
        self.t0 = time.monotonic()
        self.stages: dict[str, float] = {}
        self.spans: list[tuple[str, float, float]] = []
        self.cache: dict = {}
        self.staging_s = 0.0
        self.staging_bytes = 0

    def add(self, name: str, dt: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + dt


def note_op(op: str) -> None:
    """Name the file-level op the NEXT dispatch on this thread serves (the
    codec calls this right before its GEMM).  Without one a profiled
    dispatch reports ``op="matmul"``."""
    if enabled():
        _TLS.op = op


def note_staging(dt: float, nbytes: int) -> None:
    """Record one host-to-device staging wall; folded into the NEXT
    profile opened on this thread (staging precedes its dispatch)."""
    if not enabled():
        return
    s, b = getattr(_TLS, "staging", (0.0, 0))
    _TLS.staging = (s + dt, b + int(nbytes))


def begin(*, strategy, w=None, bucket=None, bytes_in=None):
    """Open a profile for the dispatch starting now, or None when the plane
    is off or this dispatch is not sampled.  Consumes the noted op and the
    pending staging walls either way."""
    if not enabled():
        return None
    op = getattr(_TLS, "op", None)
    _TLS.op = None
    staging = getattr(_TLS, "staging", None)
    _TLS.staging = (0.0, 0)
    # force_enable() means "profile this dispatch": the sampling knob must
    # not skip it.
    if not _sampled() and not _FORCED:
        return None
    prof = DispatchProfile(op=op or "matmul", strategy=str(strategy), w=w, bucket=bucket, bytes_in=bytes_in)
    if staging is not None:
        prof.staging_s, prof.staging_bytes = staging
    _TLS.prof = prof
    return prof


def active():
    """The profile open on this thread, or None."""
    return getattr(_TLS, "prof", None)


def discard(prof) -> None:
    """Drop an open profile without emitting (the dispatch raised)."""
    if prof is not None and getattr(_TLS, "prof", None) is prof:
        _TLS.prof = None


@contextmanager
def suspended():
    """No profile is active inside (it yields the suspended one, or None):
    the plan layer wraps a graph capture in it, so no stage of the captured
    call is timed or synchronised."""
    prof = getattr(_TLS, "prof", None)
    _TLS.prof = None
    try:
        yield prof
    finally:
        _TLS.prof = prof


def _capturing() -> bool:
    import torch

    return torch.cuda.is_available() and torch.cuda.is_current_stream_capturing()


def sync(out):
    """Wait until ``out`` is computed: on the card, synchronise the current
    stream of ``out``'s device (the stream its stage was enqueued on); a
    host result is ready when it returns."""
    import torch

    t = out[0] if isinstance(out, (tuple, list)) and out else out
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()
    return out


def run_stage(name: str, fn, *args):
    """Run ``fn(*args)`` as stage ``name`` of the active profile, timed to
    its completion on the device, with a retroactive span.  With no active
    profile the call is forwarded untouched.  Inside a graph capture it
    raises: a stage there cannot be timed."""
    prof = active()
    if prof is None:
        return fn(*args)
    if _capturing():
        raise RuntimeError(f"profiler stage {name!r} inside a CUDA graph capture")
    t0 = time.monotonic()
    out = sync(fn(*args))
    t1 = time.monotonic()
    prof.add(name, t1 - t0)
    prof.spans.append((name, t0, t1))
    return out


def attr(**kv) -> None:
    """Attach cache-attribution fields to the active profile."""
    prof = active()
    if prof is not None:
        prof.cache.update(kv)


def add_compile(dt: float) -> None:
    """Fold a build wall (plan build, graph capture) into the active
    profile's ``compile`` stage."""
    prof = active()
    if prof is not None and dt > 0:
        prof.add("compile", dt)


def note_opt(dt: float, **kv) -> None:
    """Attribute one XOR-optimizer pass: its wall into the cache block
    (build work, not a dispatch stage) with the pass's counters."""
    prof = active()
    if prof is None:
        return
    prof.cache["opt_s"] = round(prof.cache.get("opt_s", 0.0) + dt, 6)
    for k, v in kv.items():
        prof.cache[k] = v


def last_event() -> dict | None:
    """The most recent wide event emitted on this thread."""
    return getattr(_TLS, "last", None)


def finish(prof, out=None) -> dict | None:
    """Close a profile: wait for the dispatch output, stamp the wall, build
    the wide event and fan it out (ledger ``kind=rs_perf``,
    ``rs_prof_stage_seconds``, retroactive spans).  Returns the event; None
    for ``prof=None``."""
    if prof is None:
        return None
    if getattr(_TLS, "prof", None) is prof:
        _TLS.prof = None
    if out is not None:
        try:
            out = sync(out)
            prof.bytes_out = getattr(out, "nbytes", None)
        except Exception:  # noqa: BLE001 - profiling must never fail the dispatch it observes
            pass
    wall = time.monotonic() - prof.t0
    stages = {k: round(v, 9) for k, v in prof.stages.items() if v > 0}
    event = {
        "kind": "rs_perf",
        "op": prof.op,
        "strategy": prof.strategy,
        "w": prof.w,
        "bucket": prof.bucket,
        "bytes": prof.bytes_in,
        "bytes_out": prof.bytes_out,
        "wall_s": round(wall, 9),
        "stages": stages,
        "coverage": round(sum(stages.values()) / wall, 4) if wall > 0 else None,
        "cache": dict(prof.cache),
    }
    if prof.staging_s > 0:
        event["staging_s"] = round(prof.staging_s, 9)
        event["staging_bytes"] = prof.staging_bytes
    q = _metrics.quantile(
        "rs_prof_stage_seconds",
        "per-dispatch stage walls (pack/chain/ring_in/shift_acc/ring_out/unpack/compile + h2d staging), "
        "streaming quantiles",
    )
    for name, dt in stages.items():
        q.labels(stage=name, strategy=prof.strategy, op=prof.op).observe(dt)
    if prof.staging_s > 0:
        q.labels(stage="h2d", strategy=prof.strategy, op=prof.op).observe(prof.staging_s)
    if _tracing.active() is not None:
        for name, t0, t1 in prof.spans:
            _tracing.complete(name, f"prof:{name}", t0, t1, strategy=prof.strategy, op=prof.op)
    if _runlog.enabled():
        _runlog.record(dict(event))
    _TLS.last = event
    return event
