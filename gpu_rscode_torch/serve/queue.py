"""Bounded admission queue with per-tenant fairness and deadline ordering.

The port's copy of the JAX package's ``serve/queue.py``: the same names,
knobs, records and payloads.

The serving discipline (docs/SERVE.md): a resident daemon in front of one
accelerator must (1) bound its memory — past ``RS_SERVE_DEPTH`` queued
requests new arrivals are REJECTED (HTTP 429), never buffered without
limit; (2) keep one greedy tenant from starving the others — requests are
scheduled by *deficit round-robin* over per-tenant subqueues, the classic
O(1) byte-fair scheduler (each visit grants a tenant ``RS_SERVE_QUANTUM``
bytes of credit; a request is released only when the tenant's accumulated
deficit covers its cost, so many small requests from tenant B interleave
fairly with tenant A's large ones); and (3) respect deadlines — within a
tenant, requests order by their ``X-RS-Deadline-Ms`` deadline (earliest
first, arrival order breaking ties), and the dispatcher fails requests
whose deadline already passed instead of wasting device time on them.

Thread-safe: handler threads ``submit()``, the scheduler thread ``pop()``s,
and drain flips admission off under one condition variable.

Import cost: stdlib only.
"""

from __future__ import annotations

import bisect
import math
import threading
import time

from ..obs import metrics as _metrics, reqtrace as _reqtrace
from ..utils.env import int_env as _int_env

DEFAULT_DEPTH = 64
DEFAULT_QUANTUM = 256 * 1024  # bytes of credit per DRR visit


class QueueFull(RuntimeError):
    """Admission rejected: the queue is at ``RS_SERVE_DEPTH`` (HTTP 429)."""


class Draining(RuntimeError):
    """Admission rejected: the daemon is draining (HTTP 503)."""


class Request:
    """One admitted unit of work, carried from handler to executor.

    ``cost`` is the request's payload size in bytes (the DRR currency);
    ``deadline`` is an absolute ``time.monotonic()`` instant or None.
    The handler thread blocks on ``done``; the executor fills ``outcome``
    (ok | error | expired), ``result`` / ``error``, and the observability
    fields before setting it.
    """

    __slots__ = (
        "op", "tenant", "name", "spool", "upload", "k", "p", "w",
        "strategy", "generator", "checksums", "syndrome", "keep", "cost",
        "at", "layout", "key", "stripe_bytes", "seq", "arrival",
        "deadline", "batch_size",
        "queue_wait_s", "service_s", "outcome", "result", "error", "done",
        "req_id", "batch_id", "group_id", "t_dispatch", "stages",
        "cache", "path", "job", "lock_key",
    )

    def __init__(self, op: str, tenant: str, name: str, spool: str, *,
                 k: int = 0, p: int = 0, w: int = 8, strategy: str = "auto",
                 generator: str = "vandermonde", checksums: bool = True,
                 syndrome: bool = False, keep: bool = False,
                 at: int = 0, layout: str = "row",
                 key: str | None = None, stripe_bytes: int | None = None,
                 cost: int = 1, deadline: float | None = None,
                 req_id: str | None = None):
        self.op = op
        self.tenant = tenant
        self.name = name
        self.spool = spool
        # Encode uploads land in a per-request temp first; the executor
        # promotes it onto ``spool`` under the daemon's per-name lock
        # (concurrent same-name uploads must never interleave bytes).
        self.upload: str | None = None
        self.k, self.p, self.w = k, p, w
        self.strategy = strategy
        self.generator = generator
        self.checksums = checksums
        self.syndrome = syndrome
        self.keep = keep
        self.at = int(at)         # update: byte offset of the edit
        self.layout = layout      # encode: chunk layout (docs/UPDATE.md)
        self.key = key            # object ops: the object key (/o/ paths)
        self.stripe_bytes = stripe_bytes  # object_put bucket creation
        self.cost = max(1, int(cost))
        self.seq = 0  # assigned at submit (admission order)
        self.arrival = time.monotonic()
        self.deadline = deadline
        self.batch_size = 1
        self.queue_wait_s = 0.0
        self.service_s = 0.0
        self.outcome: str | None = None
        self.result = None
        self.error: BaseException | None = None
        self.done = threading.Event()
        # Lifecycle identity (docs/SERVE.md "Request lifecycle"): the
        # request id is ALWAYS minted (rejection traceability must not
        # depend on telemetry); the stage-stamp dict is allocated only
        # when the reqtrace plane is enabled (obs/reqtrace.py).
        self.req_id = req_id if req_id else _reqtrace.new_request_id()
        self.batch_id = 0         # assigned when the batcher forms a batch
        self.group_id: str | None = None  # write-combined group join
        self.t_dispatch = 0.0     # execution start (service_s anchor)
        self.stages: dict | None = None
        # object_get read-plane observability (serve/objcache.py):
        # cache verdict (hit|miss|bypass) and the lane that produced the
        # bytes (cached|fast|degraded) — wide-event + response-header
        # fields, None for every other op.
        self.cache: str | None = None
        self.path: str | None = None
        # Maintenance-plane requests (op="maint", docs/MAINT.md): the
        # zero-arg job closure the executor runs, and the foreground
        # (tenant, name) lock the job must serialize against (a repair
        # of tenant alpha's archive must exclude alpha's own writes to
        # it, not just other maint jobs).
        self.job = None
        self.lock_key: tuple | None = None

    def shape_key(self) -> tuple:
        """The plan-cache shape bucket this request dispatches under —
        requests sharing a key share one warm plan, so the
        batcher coalesces exactly along it.  Update/append requests key
        by (tenant, archive) instead: writes against ONE archive harvested
        in the same window execute as one group-committed batch (one
        journal fsync chain + one metadata commit — docs/UPDATE.md
        "Group commit"), and mixing updates with appends in that group is
        exactly what the group engine's sequential semantics handle.
        Object PUTs key by (tenant, bucket) the same way: a same-bucket
        PUT burst harvested in one window commits as ONE grouped stripe
        append + ONE index fsync (store/bucket.py put_many)."""
        if self.op in ("update", "append"):
            return ("write", self.tenant, self.name, self.k, self.p,
                    self.w, self.strategy)
        if self.op == "object_put":
            return ("objput", self.tenant, self.name)
        if self.op in ("object_get", "object_delete"):
            # Reads/deletes serialize under the bucket lock anyway;
            # grouping buys nothing — keep them solo batches.
            return (self.op, self.tenant, self.name, self.seq)
        if self.op == "maint":
            # Maintenance jobs are opaque closures — nothing to coalesce.
            return (self.op, self.tenant, self.seq)
        return (self.op, self.k, self.p, self.w, self.strategy,
                self.generator, self.layout)

    def sort_key(self) -> tuple:
        # Earliest deadline first; deadline-less requests behind any
        # deadlined one; admission order breaks ties.
        return (self.deadline if self.deadline is not None else math.inf,
                self.seq)

    def __lt__(self, other: "Request") -> bool:
        return self.sort_key() < other.sort_key()

    def expired(self, now: float | None = None) -> bool:
        return (self.deadline is not None
                and (now if now is not None else time.monotonic())
                > self.deadline)

    def finish(self, outcome: str, result=None,
               error: BaseException | None = None) -> None:
        self.outcome = outcome
        self.result = result
        self.error = error
        self.done.set()


class AdmissionQueue:
    """Bounded multi-tenant queue: DRR across tenants, deadline order
    within one (module doc).  ``depth``/``quantum`` default from
    ``RS_SERVE_DEPTH`` / ``RS_SERVE_QUANTUM``."""

    def __init__(self, depth: int | None = None,
                 quantum: int | None = None):
        self.max_depth = max(1, depth if depth is not None
                             else _int_env("RS_SERVE_DEPTH", DEFAULT_DEPTH))
        self.quantum = max(1, quantum if quantum is not None
                           else _int_env("RS_SERVE_QUANTUM",
                                         DEFAULT_QUANTUM))
        self._cond = threading.Condition()
        self._queues: dict[str, list[Request]] = {}
        self._deficit: dict[str, int] = {}
        self._active: list[str] = []  # tenants with queued work, RR order
        self._rr = 0
        self._count = 0
        self._seq = 0
        self._draining = False
        self.admitted = 0
        self.rejected = 0

    # -- admission -----------------------------------------------------------

    def submit(self, req: Request) -> Request:
        """Admit ``req`` or raise :class:`QueueFull` / :class:`Draining`.
        Assigns the admission sequence number used for tie-breaking."""
        with self._cond:
            if self._draining:
                self.rejected += 1
                _metrics.counter(
                    "rs_serve_admission_rejects_total",
                    "serve requests rejected at admission",
                ).labels(tenant=req.tenant, reason="draining").inc()
                raise Draining("daemon is draining; not admitting")
            if self._count >= self.max_depth:
                self.rejected += 1
                _metrics.counter(
                    "rs_serve_admission_rejects_total",
                    "serve requests rejected at admission",
                ).labels(tenant=req.tenant, reason="depth").inc()
                raise QueueFull(
                    f"queue at RS_SERVE_DEPTH={self.max_depth}"
                )
            self._seq += 1
            req.seq = self._seq
            q = self._queues.get(req.tenant)
            if q is None:
                q = self._queues[req.tenant] = []
                self._active.append(req.tenant)
                self._deficit.setdefault(req.tenant, 0)
            bisect.insort(q, req)
            self._count += 1
            self.admitted += 1
            _metrics.gauge(
                "rs_serve_queue_depth", "admitted requests waiting"
            ).set(self._count)
            self._cond.notify()
        return req

    # -- scheduling ----------------------------------------------------------

    def _pop_locked(self) -> Request | None:
        if not self._count:
            return None
        if len(self._active) == 1:
            # Single active tenant: no one to be fair to — grant directly
            # instead of spinning quantum-increments up to a large cost.
            t = self._active[0]
            self._deficit[t] = 0
            req = self._queues[t].pop(0)
        else:
            while True:
                self._rr %= len(self._active)
                t = self._active[self._rr]
                head = self._queues[t][0]
                if self._deficit[t] < head.cost:
                    # One quantum per visit, then move to the next tenant
                    # (textbook DRR) — a huge head request accrues credit
                    # across rounds while small tenants keep flowing.
                    self._deficit[t] += self.quantum
                    self._rr += 1
                    continue
                self._deficit[t] -= head.cost
                req = self._queues[t].pop(0)
                break
        if not self._queues[req.tenant]:
            del self._queues[req.tenant]
            idx = self._active.index(req.tenant)
            self._active.pop(idx)
            if idx < self._rr:
                self._rr -= 1  # keep the pointer on the same next tenant
            self._deficit[req.tenant] = 0  # empty queue forfeits credit
        self._count -= 1
        _metrics.gauge(
            "rs_serve_queue_depth", "admitted requests waiting"
        ).set(self._count)
        return req

    def pop(self, timeout: float | None = None) -> Request | None:
        """Next request under the fairness discipline; blocks up to
        ``timeout``.  Returns None on timeout, or immediately when the
        queue is draining and empty (the scheduler's exit signal)."""
        deadline = (time.monotonic() + timeout) if timeout is not None \
            else None
        with self._cond:
            while True:
                req = self._pop_locked()
                if req is not None:
                    now = time.monotonic()
                    req.queue_wait_s = now - req.arrival
                    _reqtrace.mark(req, "dequeue", now)
                    return req
                if self._draining:
                    return None
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return None
                    self._cond.wait(remaining)

    # -- lifecycle / introspection ------------------------------------------

    def drain(self) -> None:
        """Stop admitting (new submits raise :class:`Draining`); queued
        work keeps draining through ``pop`` until empty."""
        with self._cond:
            self._draining = True
            self._cond.notify_all()

    @property
    def draining(self) -> bool:
        return self._draining

    def depth(self) -> int:
        with self._cond:
            return self._count

    def snapshot(self) -> dict:
        with self._cond:
            return {
                "depth": self._count,
                "max_depth": self.max_depth,
                "quantum": self.quantum,
                "draining": self._draining,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "tenants": {t: len(q) for t, q in self._queues.items()},
                "deficits": {t: d for t, d in self._deficit.items() if d},
            }
