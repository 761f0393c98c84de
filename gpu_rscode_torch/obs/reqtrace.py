"""Request lifecycle tracing — per-request stage timeline + ring buffer.

The port's copy of the JAX package's ``obs/reqtrace.py``: the same names,
knobs, records and payloads.

The reference CUDA tool proves its overlap design by attributing wall
time per stage (PCIe copy vs kernel); the serve daemon needs the same
attribution per REQUEST: a slow `/encode` is unactionable when the only
numbers are two coarse quantiles and a service time derived by
subtraction.  This module is the daemon's lifecycle plane
(docs/SERVE.md "Request lifecycle"):

* **Request ids** — minted at admission (or accepted from the client's
  ``X-RS-Request-Id`` header when it validates) and echoed on EVERY
  response, rejections included, so client logs join daemon telemetry.
* **Stage timeline** — monotonic stamps at
  ``admit -> dequeue -> batch_formed -> dispatch -> device_done ->
  drain_done -> ack`` collected on the request object (a dict only
  allocated when the plane is enabled) and folded into one canonical
  *wide event* per request: tenant, op, bytes, batch/group ids, outcome
  and the stage offsets — consecutive, non-overlapping, summing to the
  request wall by construction.
* **Fan-out** — each wide event lands in (1) a bounded in-process ring
  (``RS_REQTRACE_RING`` entries; the ``GET /debug/requests?n=``
  payload), (2) the run ledger as a ``kind=rs_request`` record when
  ``RS_RUNLOG`` is set (the `rs slo --runlog` replay input), (3) the
  ``rs_serve_stage_seconds{stage,op}`` quantile series, and (4)
  request-id-tagged spans on the active trace session, so a daemon
  Perfetto timeline is attributable to individual requests.

Off by default: with ``RS_METRICS`` off (and not force-enabled) and no
``RS_SLO`` objectives configured, :func:`begin` leaves the request's
stage dict unallocated and :func:`emit` returns without registering
anything — the same disabled-path contract as the metrics registry and
the fault plane, guarded by a tier-1 test (tests/test_reqtrace.py).
The request id itself is always minted: it is one short string, and
rejection traceability must not depend on telemetry being on.

Import cost: the standard library only.
"""

from __future__ import annotations

import os
import re
import threading
import time
import uuid
from collections import deque

from . import metrics as _metrics, runlog as _runlog, tracing as _tracing

# Canonical stage order: offsets in a wide event appear in this order and
# are non-decreasing (a stage the path cannot observe is simply absent).
STAGES = ("admit", "dequeue", "batch_formed", "dispatch", "device_done",
          "drain_done", "ack")

# Stage-duration names: the interval ENDING at each stamp.
_DURATIONS = {
    "dequeue": "queue_wait",
    "batch_formed": "batch_form",
    "dispatch": "dispatch_wait",
    "device_done": "device",
    "drain_done": "drain",
    "ack": "ack_write",
}

DEFAULT_RING = 256

_ID_RE = re.compile(r"^[A-Za-z0-9._-]{1,64}$")

_RING_LOCK = threading.Lock()
_RING: deque = deque(maxlen=DEFAULT_RING)


def new_request_id() -> str:
    """A fresh request id (16 hex chars)."""
    return uuid.uuid4().hex[:16]


def accept_request_id(text: str | None) -> str:
    """The id a request runs under: the client's ``X-RS-Request-Id``
    when it validates (one [A-Za-z0-9._-]{1,64} token — it lands in
    logs, headers and ledger lines), else a freshly minted one.  Never
    rejects: traceability is best-effort, a malformed id must not fail
    the request carrying it."""
    if text is not None and _ID_RE.fullmatch(text):
        return text
    return new_request_id()


def ring_capacity() -> int:
    """``RS_REQTRACE_RING``: wide events retained for
    ``GET /debug/requests`` (default 256; 0 retains nothing — events
    still fan out to the ledger/metrics/trace)."""
    try:
        return max(0, int(os.environ.get("RS_REQTRACE_RING",
                                         DEFAULT_RING)))
    except ValueError:
        return DEFAULT_RING


def enabled() -> bool:
    """Whether the lifecycle plane records: metrics on (``RS_METRICS`` /
    force_enable) or SLO objectives configured (``RS_SLO``) — either
    consumer needs the stage stamps; with neither, requests carry only
    their id."""
    if _metrics.enabled():
        return True
    return bool(os.environ.get("RS_SLO"))


def begin(req) -> None:
    """Start the stage timeline on an admitted request: allocates the
    stage dict (only when :func:`enabled`) anchored at the request's
    arrival stamp."""
    if enabled():
        req.stages = {"admit": req.arrival}


def mark(req, stage: str, t: float | None = None) -> None:
    """Stamp ``stage`` at ``t`` (default now, ``time.monotonic``).
    No-op on requests whose timeline never began (plane disabled, or a
    bare Request built outside the daemon)."""
    stages = getattr(req, "stages", None)
    if stages is not None:
        stages[stage] = time.monotonic() if t is None else t


def _ring() -> deque:
    global _RING
    cap = ring_capacity()
    if cap != (_RING.maxlen or 0):
        _RING = deque(_RING, maxlen=cap) if cap else deque(maxlen=0)
    return _RING


def recent(n: int = 50) -> list[dict]:
    """The last ``n`` wide events, oldest first (the
    ``GET /debug/requests`` payload).  ``n <= 0`` returns nothing
    (``events[-0:]`` would be everything — the opposite)."""
    if n <= 0:
        return []
    with _RING_LOCK:
        events = list(_ring())
    return events[-n:]


def reset() -> None:
    """Drop the ring (tests)."""
    with _RING_LOCK:
        _ring().clear()


def stage_offsets(req) -> dict | None:
    """The request's stage offsets (seconds since admit, canonical
    order), or None when no timeline was recorded."""
    stages = getattr(req, "stages", None)
    if not stages:
        return None
    t0 = stages.get("admit")
    if t0 is None:
        return None
    return {s: round(stages[s] - t0, 6) for s in STAGES if s in stages}


def emit(req, *, status: int | None = None) -> dict | None:
    """Fold a finished request into its canonical wide event and fan it
    out (ring, ledger ``kind=rs_request``, stage quantiles, trace
    spans).  Returns the event, or None when the plane is disabled for
    this request (no timeline was begun)."""
    offsets = stage_offsets(req)
    if offsets is None:
        return None
    outcome = req.outcome
    if outcome is None:
        outcome = "rejected" if status in (429, 503) else (
            "aborted" if status is None else "error")
    # status None with an outcome set = the op finished but the CLIENT
    # vanished before the response landed; `acked` makes that state
    # unambiguous (outcome "ok" + acked false = committed, not
    # delivered).
    event = {
        "kind": "rs_request",
        "req_id": req.req_id,
        "tenant": req.tenant,
        "op": req.op,
        "name": req.name,
        "bytes": req.cost,
        "batch_id": req.batch_id,
        "batch": req.batch_size,
        "group_id": req.group_id,
        "outcome": outcome,
        "status": status,
        "acked": status is not None,
        "stages": offsets,
        "wall_s": max(offsets.values()),
        "service_s": round(req.service_s, 6),
        "error": type(req.error).__name__ if req.error else None,
    }
    # object_get read-plane fields (serve/objcache.py): the cache
    # verdict and the lane that produced the bytes — absent for every
    # other op so the event schema stays lean.
    if getattr(req, "cache", None) is not None:
        event["cache"] = req.cache
    if getattr(req, "path", None) is not None:
        event["path"] = req.path
    with _RING_LOCK:
        ring = _ring()
        if ring.maxlen:
            ring.append(event)
    # Stage-duration quantiles: the interval between consecutive PRESENT
    # stamps, attributed to the later stamp's duration name.
    q = _metrics.quantile(
        "rs_serve_stage_seconds",
        "per-request stage durations (admit->dequeue->batch->dispatch->"
        "device->drain->ack), streaming quantiles",
    )
    present = [(s, offsets[s]) for s in STAGES if s in offsets]
    for (_, t_prev), (stage, t_cur) in zip(present, present[1:]):
        q.labels(stage=_DURATIONS[stage], op=req.op).observe(
            t_cur - t_prev)
    if _tracing.active() is not None:
        t0 = req.stages["admit"]
        for (_, o_prev), (stage, o_cur) in zip(present, present[1:]):
            _tracing.complete(
                _DURATIONS[stage], f"req:{_DURATIONS[stage]}",
                t0 + o_prev, t0 + o_cur,
                req_id=req.req_id, op=req.op, tenant=req.tenant,
                batch=req.batch_id,
            )
    if _runlog.enabled():
        _runlog.record(dict(event))
    return event
