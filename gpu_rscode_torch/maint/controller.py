"""The maintenance control loop: the port's copy of the JAX package's
``maint/controller.py``.

:class:`MaintController` drains three work sources into idempotent,
resumable jobs (docs/MAINT.md):

* **repair** — :func:`obs.health.work_queue` items with damaged chunks,
  most-at-risk first, rebuilt through :func:`api.repair_file`.  The
  emitted ``rs_damage`` repair record (plus the follow-up clean scan)
  clears the queue entry: convergence is ledger-driven, never
  in-memory, so killing the process mid-repair loses nothing — the next
  pass replays the ledger and sees exactly what remains.
* **scrub** — age/update-driven re-verification via
  :func:`api.scan_file`, honoring ``RS_HEALTH_SCRUB_MAX_AGE_S``.
  Update-aware: archives whose only signal is ``generation >
  scrub_generation`` (content changed since last verified) re-verify
  before merely age-stale ones, and the clean-scan verdict they emit
  decays their risk score.
* **compaction** — store buckets whose sealed archives crossed
  ``RS_STORE_COMPACT_DEAD_FRAC`` (``pending_compactions > 0`` in
  :meth:`store.bucket.Bucket.stats`) compact through the existing
  all-or-nothing :func:`api.compact_bucket` path.

Two throttles pace the loop.  A **burn-rate governor** polls the SLO
engine (obs/slo.py): any foreground tenant burning error budget
(``burn_rate >= RS_MAINT_BURN_PAUSE``) pauses maintenance dispatch, and
it stays paused until every objective drops back under
``RS_MAINT_RESUME`` — hysteresis, so maintenance does not flap at the
boundary.  A **token bucket** caps device bytes per second
(``RS_MAINT_BYTES_PER_S``) — the only throttle when no SLO is
configured.

Cross-process safety is leases, not lock files: a job claims its
archive in the damage ledger (:func:`obs.health.record_claim`) before
touching it, other :func:`~obs.health.work_queue` consumers skip live
claims, and the claim clears on the completing repair/scan event or on
lease expiry (``RS_MAINT_LEASE_S``) if the claimant died.

Every job runs on the controller's ``device`` (None: CUDA, raising with
no GPU present when a job runs), carried into each ``repair_file``,
``scan_file`` and ``compact_bucket`` call.

Import cost: the standard library only — jobs import the api (and
PyTorch) lazily when they actually run.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import threading
import time
from collections import deque

from ..obs import health as _health
from ..obs import metrics as _metrics
from ..obs import runlog as _runlog

# DRR cost inflation for maintenance requests: admission charges
# cost-in-bytes against each tenant's quantum, so billing maintenance
# 4x its real bytes gives the maint tenant ~1/4 of a foreground
# tenant's byte share when both are backlogged — the "dedicated
# low-weight tenant" semantics without a second scheduler.
MAINT_COST_WEIGHT = 4

# Consecutive failures per target before the controller stops retrying
# it within this process (the ledger's repair_failed history and lease
# expiry pace retries across processes).
MAX_ATTEMPTS = 3


class MaintCrash(RuntimeError):
    """Synthetic mid-job crash (``RS_MAINT_CRASH=kind:stage``) — the
    chaos harness and tests inject process death at job stages with it;
    production never raises it."""


class MaintBackpressure(RuntimeError):
    """The daemon's admission queue refused the job (full or draining);
    the current pass stops and retries next interval."""


def enabled() -> bool:
    """``RS_MAINT`` truthiness: the daemon auto-starts the plane when
    set (``rs serve --maint`` forces it on for one process)."""
    val = os.environ.get("RS_MAINT", "").strip().lower()
    return val not in ("", "0", "false", "no", "off")


def tenant_env() -> str:
    """``RS_MAINT_TENANT`` — the admission-queue tenant maintenance
    jobs bill against (default ``maint``)."""
    return os.environ.get("RS_MAINT_TENANT", "").strip() or "maint"


def burn_pause_env() -> float:
    """``RS_MAINT_BURN_PAUSE`` — pause maintenance when any foreground
    objective's burn rate reaches this (default 1.0: exactly on
    budget)."""
    try:
        return float(os.environ.get("RS_MAINT_BURN_PAUSE", 1.0))
    except ValueError:
        return 1.0


def burn_resume_env() -> float:
    """``RS_MAINT_RESUME`` — resume only once every foreground burn
    rate is back under this (default 0.5; clamped to the pause
    threshold)."""
    try:
        return float(os.environ.get("RS_MAINT_RESUME", 0.5))
    except ValueError:
        return 0.5


def bytes_per_s_env() -> float:
    """``RS_MAINT_BYTES_PER_S`` — token-bucket cap on maintenance
    device bytes (default 64 MiB/s)."""
    try:
        return float(os.environ.get("RS_MAINT_BYTES_PER_S", 64 * 2**20))
    except ValueError:
        return float(64 * 2**20)


def interval_env() -> float:
    """``RS_MAINT_INTERVAL_S`` — watch-loop poll interval (default
    5 s)."""
    try:
        return float(os.environ.get("RS_MAINT_INTERVAL_S", 5.0))
    except ValueError:
        return 5.0


def _crash_point(kind: str, stage: str) -> None:
    """Raise :class:`MaintCrash` when ``RS_MAINT_CRASH`` names this
    (kind, stage) — the harness's deterministic kill switch."""
    spec = os.environ.get("RS_MAINT_CRASH", "")
    if not spec:
        return
    want_kind, _, want_stage = spec.partition(":")
    if want_kind == kind and (not want_stage or want_stage == stage):
        raise MaintCrash(f"injected crash at {kind}:{stage}")


class TokenBucket:
    """Bytes-per-second pacing with a small burst allowance.  Debt
    model: :meth:`take` always succeeds and returns how long the caller
    must sleep before proceeding, so one oversized job borrows against
    future refill instead of deadlocking."""

    def __init__(self, rate: float, capacity: float | None = None,
                 clock=time.monotonic):
        self.rate = max(1.0, float(rate))
        # ~2 s of burst by default: enough to not meter every tiny job,
        # small enough that a pause takes effect within seconds.
        self.capacity = float(capacity if capacity is not None
                              else self.rate * 2.0)
        self._tokens = self.capacity
        self._clock = clock
        self._t = clock()
        self._lock = threading.Lock()
        self.taken = 0

    def take(self, n: float) -> float:
        """Consume ``n`` tokens; returns seconds to wait before the
        consumption is paid for (0.0 when within the burst)."""
        n = max(0.0, float(n))
        with self._lock:
            now = self._clock()
            self._tokens = min(self.capacity,
                               self._tokens + (now - self._t) * self.rate)
            self._t = now
            self._tokens -= n
            self.taken += int(n)
            if self._tokens >= 0:
                return 0.0
            return -self._tokens / self.rate


class BurnGovernor:
    """Pause/resume hysteresis over the SLO report's burn rates.

    Any *foreground* (non-maint-tenant) objective at or past
    ``pause_at`` pauses dispatch; dispatch resumes only when every
    foreground burn rate is back under ``resume_at``.  Cells with no
    traffic in a window report no burn and never pause — absence of
    evidence is not a breach."""

    def __init__(self, *, pause_at: float | None = None,
                 resume_at: float | None = None,
                 maint_tenant: str = "maint"):
        self.pause_at = (burn_pause_env() if pause_at is None
                         else float(pause_at))
        self.resume_at = (burn_resume_env() if resume_at is None
                          else float(resume_at))
        if self.resume_at > self.pause_at:
            self.resume_at = self.pause_at
        self.maint_tenant = maint_tenant
        self.paused = False
        self.pause_events = 0
        self.resume_events = 0
        self.last_burn = 0.0
        self.worst_cell = None  # (tenant, op, window, objective)
        self.events: deque = deque(maxlen=32)

    def observe(self, report: dict | None) -> bool:
        """Fold one SLO report; returns the (possibly new) paused
        state."""
        worst, cell = 0.0, None
        for row in (report or {}).get("cells", []):
            if row.get("tenant") == self.maint_tenant:
                continue  # our own traffic must not pause us
            for win, rates in (row.get("windows") or {}).items():
                for name, vals in (rates.get("objectives") or {}).items():
                    burn = vals.get("burn_rate")
                    if isinstance(burn, (int, float)) and burn > worst:
                        worst = float(burn)
                        cell = (row.get("tenant"), row.get("op"),
                                win, name)
        self.last_burn = worst
        self.worst_cell = cell
        if not self.paused and worst >= self.pause_at:
            self.paused = True
            self.pause_events += 1
            self.events.append({"action": "pause", "burn": round(worst, 4),
                                "cell": cell})
        elif self.paused and worst < self.resume_at:
            self.paused = False
            self.resume_events += 1
            self.events.append({"action": "resume",
                                "burn": round(worst, 4)})
        try:
            _metrics.gauge(
                "rs_maint_paused",
                "1 while the burn-rate governor has maintenance paused",
            ).set(int(self.paused))
        except Exception:
            pass
        return self.paused


class MaintController:
    """The maintenance state machine: discover -> throttle -> claim ->
    execute -> let the ledger converge.

    ``submit`` (when given — the daemon wires it) dispatches a job
    closure through the admission queue as the maint tenant under the
    per-name locks and blocks until it ran; without it (CLI mode) jobs
    execute inline.  Either way every job is idempotent and all
    progress lives in the ledger/store, so a crash at any point
    converges on the next pass."""

    def __init__(self, *, ledger_path: str | None = None,
                 store_roots=None, owner: str | None = None,
                 tenant: str | None = None, slo_report=None,
                 submit=None, bytes_per_s: float | None = None,
                 burn_pause: float | None = None,
                 burn_resume: float | None = None,
                 lease_s: float | None = None,
                 interval_s: float | None = None, device=None):
        self.ledger_path = ledger_path  # None -> ambient $RS_RUNLOG
        self.device = device  # where every job's GEMMs run
        # store_roots: list of directories containing buckets, or a
        # zero-arg callable returning one (the daemon's tenant dirs
        # appear over time).
        self.store_roots = store_roots
        self.owner = owner or f"{socket.gethostname()}:maint:{os.getpid()}"
        self.tenant = tenant or tenant_env()
        self.slo_report = slo_report  # zero-arg callable -> report dict
        self.submit = submit
        self.lease_s = float(lease_s if lease_s is not None
                             else _health.claim_lease_s())
        self.interval_s = float(interval_s if interval_s is not None
                                else interval_env())
        self.bucket = TokenBucket(bytes_per_s if bytes_per_s is not None
                                  else bytes_per_s_env())
        self.governor = BurnGovernor(pause_at=burn_pause,
                                     resume_at=burn_resume,
                                     maint_tenant=self.tenant)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.started_at: float | None = None
        self.jobs: dict = {}          # kind -> {outcome -> count}
        self.bytes_total = 0
        self.passes = 0
        self.loop_errors = 0
        self.last_error: str | None = None
        self.last_jobs: deque = deque(maxlen=16)
        self._fail_counts: dict = {}  # (kind, target) -> consecutive fails

    # -- discovery -----------------------------------------------------------

    def _roots(self) -> list[str]:
        roots = self.store_roots
        if callable(roots):
            try:
                roots = roots()
            except Exception:
                roots = []
        return [r for r in (roots or []) if isinstance(r, str)]

    def discover(self, now: float | None = None) -> dict:
        """One snapshot of actionable work, in dispatch order: repairs
        (most-at-risk first), then scrubs (update-dirtied before merely
        age-stale), then compactions.  Items claimed by a live foreign
        lease or past :data:`MAX_ATTEMPTS` local failures are excluded
        (and counted) — a drain over only-blocked work must terminate,
        not spin."""
        now = time.time() if now is None else float(now)
        jobs: list[dict] = []
        skipped_claimed = skipped_failing = 0
        state = _health.load(self.ledger_path)
        if state is not None:
            repairs, scrubs = [], []
            for item in _health.work_queue(state, now=now):
                claimant = item.get("claimed_by")
                if claimant is not None and claimant != self.owner:
                    skipped_claimed += 1
                    continue
                job = {"kind": item["action"], "target": item["archive"],
                       "risk": item["risk"], "lost": item["lost"],
                       "reason": item.get("reason")}
                if self._fail_counts.get(
                        (job["kind"], job["target"]), 0) >= MAX_ATTEMPTS:
                    skipped_failing += 1
                    continue
                (repairs if item["action"] == "repair"
                 else scrubs).append(job)
            # Update-aware scrub ordering: content that changed since
            # its last verified scan re-verifies before content that is
            # merely old (stable within each class — risk rank holds).
            scrubs.sort(key=lambda j: 0 if j.get("reason") == "update"
                        else 1)
            jobs.extend(repairs)
            jobs.extend(scrubs)
        for root in self._roots():
            try:
                from .. import store as _store
                names = _store.list_buckets(root)
            except Exception:
                continue
            for name in names:
                target = os.path.join(root, name)
                if self._fail_counts.get(
                        ("compact", target), 0) >= MAX_ATTEMPTS:
                    skipped_failing += 1
                    continue
                try:
                    bucket = (_store.cached_bucket(root, name)
                              or _store.open_bucket(root, name,
                                                    device=self.device))
                    stats = bucket.stats()
                except Exception:
                    continue
                pending = stats.get("pending_compactions", 0)
                if pending > 0:
                    dead = sum(
                        a.get("dead_bytes", 0)
                        for a in stats.get("archives", {}).values()
                        if a.get("compaction_candidate"))
                    jobs.append({"kind": "compact", "target": target,
                                 "root": root, "bucket": name,
                                 "pending": pending,
                                 "dead_bytes": dead})
        return {"jobs": jobs, "skipped_claimed": skipped_claimed,
                "skipped_failing": skipped_failing}

    # -- execution -----------------------------------------------------------

    def _job_bytes(self, job: dict) -> int:
        """Device-byte estimate for the token bucket: the chunk bytes a
        repair/scrub must read (k+p chunk files) or the live bytes a
        compaction rewrites.  Best effort — a fallback floor keeps the
        bucket meaningful when metadata is unreadable."""
        try:
            if job["kind"] == "compact":
                return max(1, int(job.get("dead_bytes") or 0))
            meta = job["target"] + ".METADATA"
            if os.path.exists(meta):
                from ..utils import fileformat as _ff
                m = _ff.read_archive_meta(meta)
                total, p, k = m.total_size, m.parity_num, m.native_num
                return max(1, int(total) * max(1, k + p) // max(1, k))
            if os.path.exists(job["target"]):
                return max(1, os.path.getsize(job["target"]))
            return 1 << 16
        except Exception:
            return 1 << 16

    def _make_work(self, job: dict):
        """The idempotent job closure.  Claims ride the damage ledger
        and clear on the completing repair/scan event; crash points are
        the chaos harness's kill stages."""
        kind, target = job["kind"], job["target"]
        ledger = self.ledger_path
        device = self.device

        def work():
            from .. import api as _api
            if kind == "repair":
                _health.record_claim(target, self.owner,
                                     lease_s=self.lease_s,
                                     ledger_path=ledger)
                _crash_point("repair", "claimed")
                rebuilt = _api.repair_file(target, device=device)
                _crash_point("repair", "mid")
                # The follow-up full scan emits the clean verdict that
                # decays risk AND clears the claim (ledger-driven).
                _api.scan_file(target, device=device)
                return {"rebuilt": len(rebuilt)}
            if kind == "scrub":
                _health.record_claim(target, self.owner,
                                     lease_s=self.lease_s,
                                     ledger_path=ledger)
                _crash_point("scrub", "claimed")
                report = _api.scan_file(target, device=device)
                bad = (len(report.get("corrupt") or [])
                       + len(report.get("missing") or [])) \
                    if isinstance(report, dict) else 0
                return {"bad_chunks": bad}
            if kind == "compact":
                _crash_point("compact", "claimed")
                out = _api.compact_bucket(job["root"], job["bucket"],
                                          device=device)
                _crash_point("compact", "done")
                return {"retired": len(out.get("archives_retired") or []),
                        "bytes_moved": out.get("bytes_moved", 0)}
            raise ValueError(f"unknown maint job kind {kind!r}")

        return work

    def run_job(self, job: dict) -> str:
        """Throttle, dispatch and account one job; returns the outcome
        (``ok``/``error``/``deferred``/``aborted``).  A
        :class:`MaintCrash` propagates — that IS the simulated process
        death."""
        est = self._job_bytes(job)
        wait = self.bucket.take(est)
        deadline = time.monotonic() + wait
        while wait > 0 and not self._stop.is_set():
            time.sleep(min(0.05, wait))
            wait = deadline - time.monotonic()
        if self._stop.is_set():
            self._account(job, "aborted", 0, 0.0)
            return "aborted"
        work = self._make_work(job)
        t0 = time.monotonic()
        outcome, detail = "ok", {}
        try:
            if self.submit is not None:
                detail = self.submit(work, name=job["target"],
                                     cost=est * MAINT_COST_WEIGHT)
            else:
                detail = work()
        except MaintCrash:
            self._account(job, "crash", est, time.monotonic() - t0)
            raise
        except MaintBackpressure:
            outcome, detail = "deferred", {}
        except Exception as e:  # noqa: BLE001 — the no-wedge contract
            outcome = "error"
            detail = {"error": f"{type(e).__name__}: {e}"}
            self.last_error = detail["error"]
        self._account(job, outcome, est, time.monotonic() - t0,
                      detail if isinstance(detail, dict) else {})
        key = (job["kind"], job["target"])
        if outcome == "ok":
            self._fail_counts.pop(key, None)
        elif outcome == "error":
            self._fail_counts[key] = self._fail_counts.get(key, 0) + 1
        return outcome

    def _account(self, job: dict, outcome: str, est: int,
                 wall: float, detail: dict | None = None) -> None:
        with self._lock:
            per = self.jobs.setdefault(job["kind"], {})
            per[outcome] = per.get(outcome, 0) + 1
            if outcome != "deferred":
                self.bytes_total += est
            self.last_jobs.append({
                "kind": job["kind"],
                "target": job["target"],
                "outcome": outcome,
                "wall_s": round(wall, 4),
                "bytes": est,
                **({"detail": detail} if detail else {}),
            })
        try:
            _metrics.counter(
                "rs_maint_jobs_total",
                "maintenance jobs dispatched, by kind and outcome",
            ).labels(kind=job["kind"], outcome=outcome).inc()
            if outcome != "deferred":
                _metrics.counter(
                    "rs_maint_bytes_total",
                    "estimated device bytes moved by maintenance jobs",
                ).inc(est)
        except Exception:
            pass

    # -- the loop ------------------------------------------------------------

    def step(self, max_jobs: int | None = None) -> dict:
        """One controller pass: poll the governor, discover, run.
        Re-polls the governor between jobs so a foreground burn that
        starts mid-pass stops dispatch within one job."""
        if self.governor.observe(self.slo_report()
                                 if self.slo_report else None):
            with self._lock:
                self.passes += 1
            return {"ran": 0, "paused": True, "deferred": False,
                    "pending": None}
        found = self.discover()
        ran = 0
        deferred = False
        for job in found["jobs"]:
            if self._stop.is_set():
                break
            if max_jobs is not None and ran >= max_jobs:
                break
            if ran and self.governor.observe(
                    self.slo_report() if self.slo_report else None):
                break
            outcome = self.run_job(job)
            if outcome == "deferred":
                deferred = True
                break
            if outcome != "aborted":
                ran += 1
        with self._lock:
            self.passes += 1
        return {"ran": ran, "paused": self.governor.paused,
                "deferred": deferred,
                "pending": max(0, len(found["jobs"]) - ran)}

    def drain(self, max_jobs: int | None = None) -> dict:
        """Run passes until a pass finds nothing actionable (the
        one-shot ``rs maint --drain`` semantics).  Paused passes wait
        one interval and retry; blocked work (foreign claims, failing
        targets) does not count as actionable, so a drain over a
        contended root terminates."""
        total = passes = 0
        while not self._stop.is_set():
            out = self.step(max_jobs=None if max_jobs is None
                            else max(0, max_jobs - total))
            passes += 1
            total += out["ran"]
            if out["paused"] or out["deferred"]:
                if self._stop.wait(min(1.0, self.interval_s)):
                    break
                continue
            if out["ran"] == 0:
                break
            if max_jobs is not None and total >= max_jobs:
                break
        found = self.discover()
        return {"jobs": total, "passes": passes,
                "remaining": len(found["jobs"]),
                "skipped_claimed": found["skipped_claimed"],
                "skipped_failing": found["skipped_failing"]}

    def start(self) -> None:
        """Spawn the watch thread (the daemon's always-on mode)."""
        if self._thread is not None:
            return
        self._stop.clear()
        self.started_at = time.time()
        self._thread = threading.Thread(target=self._watch,
                                        name="rs-maint", daemon=True)
        self._thread.start()

    def _watch(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except MaintCrash as e:
                # Injected process death: the thread dies here exactly
                # like a kill -9 would take it, and the ledger carries
                # the recovery state.
                with self._lock:
                    self.last_error = str(e)
                    self.loop_errors += 1
                return
            except Exception as e:  # noqa: BLE001
                with self._lock:
                    self.last_error = f"{type(e).__name__}: {e}"
                    self.loop_errors += 1

    def stop(self, wait: bool = True, timeout: float = 30.0) -> None:
        self._stop.set()
        th = self._thread
        if th is not None and wait:
            th.join(timeout=timeout)
        self._thread = None

    # -- introspection -------------------------------------------------------

    def stats(self, include_queue: bool = False) -> dict:
        with self._lock:
            out = {
                "owner": self.owner,
                "tenant": self.tenant,
                "running": self._thread is not None
                and self._thread.is_alive(),
                "paused": self.governor.paused,
                "pause_events": self.governor.pause_events,
                "resume_events": self.governor.resume_events,
                "last_burn": round(self.governor.last_burn, 4),
                "worst_cell": list(self.governor.worst_cell)
                if self.governor.worst_cell else None,
                "burn_pause": self.governor.pause_at,
                "burn_resume": self.governor.resume_at,
                "bytes_per_s": self.bucket.rate,
                "bytes_total": self.bytes_total,
                "lease_s": self.lease_s,
                "interval_s": self.interval_s,
                "passes": self.passes,
                "loop_errors": self.loop_errors,
                "last_error": self.last_error,
                "jobs": {k: dict(v) for k, v in sorted(self.jobs.items())},
                "jobs_total": sum(n for per in self.jobs.values()
                                  for n in per.values()),
                "last_jobs": list(self.last_jobs),
                "governor_events": list(self.governor.events),
            }
        if include_queue:
            try:
                found = self.discover()
                depth = {"repair": 0, "scrub": 0, "compact": 0}
                for job in found["jobs"]:
                    depth[job["kind"]] = depth.get(job["kind"], 0) + 1
                out["queue"] = {
                    **depth,
                    "skipped_claimed": found["skipped_claimed"],
                    "skipped_failing": found["skipped_failing"],
                }
            except Exception as e:  # noqa: BLE001
                out["queue"] = {"error": f"{type(e).__name__}: {e}"}
        return out


# -- the `rs maint` CLI ------------------------------------------------------


def main(argv: list[str] | None = None) -> int:
    """The ``rs maint`` subcommand: one-shot ``--drain`` / periodic
    ``--watch`` for CLI-only deployments (no daemon), or the default
    dry-run listing of what a drain would do."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="rs maint",
        description="Background-maintenance control loop: drain the "
        "risk-ranked repair/scrub work queue and compact dead-heavy "
        "store buckets (docs/MAINT.md).",
    )
    ap.add_argument("--ledger", default=None,
                    help="damage-ledger path (default: $RS_RUNLOG)")
    ap.add_argument("--root", action="append", default=[],
                    metavar="DIR",
                    help="store root to scan for compaction work "
                    "(repeatable)")
    ap.add_argument("--drain", action="store_true",
                    help="run jobs until a pass finds nothing actionable")
    ap.add_argument("--watch", nargs="?", type=float, const=None,
                    default=False, metavar="SECS",
                    help="poll forever at SECS intervals (default "
                    "$RS_MAINT_INTERVAL_S)")
    ap.add_argument("--count", type=int, default=0,
                    help="with --watch: stop after N passes (0 = forever)")
    ap.add_argument("--max-jobs", type=int, default=0,
                    help="with --drain: stop after N jobs (0 = no cap)")
    ap.add_argument("--owner", default=None,
                    help="claim-lease owner identity (default "
                    "host:maint-cli:pid)")
    ap.add_argument("--bytes-per-s", type=float, default=None,
                    help="token-bucket byte rate override "
                    "(default $RS_MAINT_BYTES_PER_S)")
    ap.add_argument("--device", default=None,
                    help="where the jobs' GEMMs run (default cuda; cpu runs "
                    "the plain PyTorch path; with no GPU and no --device "
                    "the command refuses)")
    ap.add_argument("--json", action="store_true",
                    help="emit JSON instead of the table")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)

    ledger = args.ledger or _runlog.path()
    if not ledger and not args.root:
        print("rs maint: no work sources (set RS_RUNLOG or pass "
              "--ledger / --root)", file=sys.stderr)
        return 2
    from ..utils.backend import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"rs maint: {e}", file=sys.stderr)
        return 1
    ctl = MaintController(
        ledger_path=ledger, store_roots=list(args.root),
        owner=args.owner
        or f"{socket.gethostname()}:maint-cli:{os.getpid()}",
        bytes_per_s=args.bytes_per_s, device=device)

    if args.watch is not False:
        if args.watch is not None:
            ctl.interval_s = max(0.1, float(args.watch))
        n = 0
        while True:
            out = ctl.step()
            n += 1
            row = {"kind": "rs_maint_pass", **out, **ctl.stats()}
            if args.json:
                print(json.dumps(row), flush=True)
            else:
                print(f"maint pass {n}: ran {out['ran']} job(s), "
                      f"pending {out['pending']}, "
                      f"{'PAUSED' if out['paused'] else 'active'} "
                      f"(burn {ctl.governor.last_burn})", flush=True)
            if args.count and n >= args.count:
                return 0
            try:
                time.sleep(max(0.1, ctl.interval_s))
            except KeyboardInterrupt:
                return 0

    if args.drain:
        out = ctl.drain(max_jobs=args.max_jobs or None)
        doc = {"kind": "rs_maint_drain", **out, "stats": ctl.stats()}
        if args.json:
            print(json.dumps(doc))
        else:
            print(f"maint drain: {out['jobs']} job(s) over "
                  f"{out['passes']} pass(es); remaining {out['remaining']} "
                  f"(claimed elsewhere {out['skipped_claimed']}, "
                  f"failing {out['skipped_failing']})")
        return 0 if out["remaining"] == 0 else 1

    # Default: dry run — list what a drain would do, touch nothing.
    found = ctl.discover()
    if args.json:
        print(json.dumps({"kind": "rs_maint_queue", **found}))
    else:
        jobs = found["jobs"]
        print(f"maint queue: {len(jobs)} job(s) "
              f"(claimed elsewhere {found['skipped_claimed']}, "
              f"failing {found['skipped_failing']})")
        for job in jobs:
            extra = (f"risk {job['risk']:.3f} lost {job['lost']} "
                     f"[{job.get('reason')}]"
                     if job["kind"] != "compact"
                     else f"pending {job['pending']} "
                     f"dead {job['dead_bytes']}B")
            print(f"  {job['kind']:<8} {extra:<36} {job['target']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
