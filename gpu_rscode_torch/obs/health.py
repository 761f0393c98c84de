"""Fleet durability-health plane — damage ledger -> stripe risk scoring.

The port's copy of the JAX package's ``obs/health.py``: the same names,
knobs, records and payloads.

Scrub, syndrome sweeps, decode, repair and partial-stripe update all
*detect* damage, but until now each detection was a point-in-time counter
(``rs_scrub_chunks_total{state}``) or a transient JSON line: nothing
durable answered "which archive is closest to data loss right now".
This module is that answer — the measurement half of a repair
scheduler (build the measurement plane first, then close the loop, the
same sequencing as the SLO engine):

* **Damage events** — every damage-detection site in api.py appends one
  ``kind: "rs_damage"`` record to the run ledger via
  :func:`record_damage`: full-archive scans (``event: "scan"``, whose
  per-chunk state map is also the scrub-freshness signal — a clean scan
  CLEARS prior damage), ``--syndrome`` silent-bitrot attributions
  (``"syndrome"``), decode survivor-open failures (``"decode_failure"``),
  chunk rebuilds (``"repair"``), unrecoverable verdicts
  (``"repair_failed"``) and generation bumps from partial-stripe updates
  (``"update"`` — an update invalidates the last scrub: the archive
  changed since it was verified).  Records carry ``cls: "damage"`` so
  :func:`runlog.filter_records(cls="damage") <..obs.runlog.filter_records>`
  selects them without scanning every file-op record.
* **Replayed state** — :func:`replay` folds the event stream (oldest
  first, rotated generation included) into per-archive/per-chunk health
  state: the damaged-chunk map, bitrot recurrence, repair-failure
  history, scrub freshness and the metadata generation the last scrub
  verified.
* **Crash-atomic snapshots** — :func:`write_snapshot` checkpoints the
  state as a ``kind: "rs_health_snapshot"`` ledger record with the same
  ``algo_version``-before-digest discipline as the schedule store
  (ops/ring_gemm.py): a loader first rejects foreign ``algo_version``
  values, then malformed payloads, then digest mismatches — corrupt
  snapshots are skipped and the deltas still replay.  Snapshots ride the
  ledger's rotation carry (:data:`runlog._PRESERVED_KINDS`), so the
  replay window after rotation is bounded by the latest checkpoint, and
  replay dedupes the carried copy by ``snap_id`` so post-snapshot deltas
  in the rotated generation are never lost.
* **Risk scoring** — :func:`risk` scores each archive by its
  distance-to-data-loss margin (``n - k - lost`` — the erasures the
  stripe can still absorb), weighted by bitrot recurrence, scrub
  staleness and repair-failure history; docs/HEALTH.md derives the
  formula and its knobs (``RS_HEALTH_SCRUB_MAX_AGE_S``,
  ``RS_HEALTH_AT_RISK``).
* **Four surfaces** — the ``rs health`` CLI (risk-ranked fleet table,
  ``--json``, ``--watch``), the serve daemon's ``GET /health`` +
  ``rs_durability_*`` Prometheus gauges, an ``rs doctor`` section, and
  :func:`work_queue` — the deterministic risk-ordered iterator the
  repair scheduler will consume verbatim.

Import cost: the standard library only: like the rest of the ledger
plane, emission must be affordable from every file operation.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import time
import uuid

from . import metrics as _metrics, runlog as _runlog

DAMAGE_KIND = "rs_damage"
SNAPSHOT_KIND = "rs_health_snapshot"

# Bump when the state-machine semantics change: a loader that replays
# deltas on top of a foreign-algorithm snapshot would mix incompatible
# state, so algo_version is checked BEFORE the payload digest (the
# schedule store's discipline) and a mismatch falls back to pure-delta replay.
HEALTH_ALGO = 1

# Risk-formula weights (docs/HEALTH.md).  The margin term dominates by
# construction: its full range is 1.0 while the modifiers sum to 0.5,
# so no amount of staleness can outrank an archive that actually lost
# chunks at the same margin.
W_BITROT = 0.2
W_STALE = 0.15
W_FAIL = 0.15

BUCKETS = ("ok", "watch", "at_risk", "critical")

# States a scan event may attribute to a chunk that count toward bitrot
# RECURRENCE (media rotting under the fleet, as opposed to operational
# loss like an unlinked file).
_BITROT_STATES = ("crc_mismatch", "silent_bitrot")


def scrub_max_age_s() -> float:
    """Scrub-staleness horizon: an archive whose last clean scan is this
    old scores the full staleness weight (``RS_HEALTH_SCRUB_MAX_AGE_S``,
    default one day)."""
    try:
        return float(os.environ.get("RS_HEALTH_SCRUB_MAX_AGE_S", 86400.0))
    except ValueError:
        return 86400.0


def at_risk_threshold() -> float:
    """Risk score at which an archive counts as at-risk
    (``RS_HEALTH_AT_RISK``, default 0.5 — one lost chunk of a p=2
    stripe, or a never-scrubbed archive with bitrot history)."""
    try:
        return float(os.environ.get("RS_HEALTH_AT_RISK", 0.5))
    except ValueError:
        return 0.5


def claim_lease_s() -> float:
    """How long a maintenance claim on a work-queue item stays live
    (``RS_MAINT_LEASE_S``, default 300 s).  Leases, not lock files: a
    claimant that dies mid-job leaves only a ledger record that other
    consumers stop honoring once it ages out — no cross-process
    filesystem state to leak or clean up."""
    try:
        return float(os.environ.get("RS_MAINT_LEASE_S", 300.0))
    except ValueError:
        return 300.0


# -- damage-event emission (the api.py detection sites call this) ------------


def record_damage(
    event: str,
    archive: str,
    *,
    chunks=None,
    states: dict | None = None,
    k: int | None = None,
    p: int | None = None,
    w: int | None = None,
    generation: int | None = None,
    verdict: str | None = None,
    ledger_path: str | None = None,
) -> None:
    """Append one ``rs_damage`` event record to the run ledger.

    No-op when the ledger is disabled; never raises — damage emission is
    observability and must not fail the operation that detected the
    damage.  ``states`` maps chunk index -> damage state (a ``scan``
    event's full verdict: an EMPTY map is meaningful, it clears prior
    damage); ``chunks`` is a bare index list (syndrome attributions,
    rebuilt chunks).
    """
    try:
        if ledger_path is None and not _runlog.enabled():
            return
        fields: dict = {
            "kind": DAMAGE_KIND,
            "cls": "damage",
            "event": str(event),
            "archive": os.path.abspath(archive),
        }
        if chunks is not None:
            fields["chunks"] = sorted(int(c) for c in chunks)
        if states is not None:
            fields["states"] = {
                str(int(i)): str(s)
                for i, s in sorted(states.items(), key=lambda kv: int(kv[0]))
            }
        for name, v in (("k", k), ("p", p), ("w", w),
                        ("generation", generation)):
            if v is not None:
                fields[name] = int(v)
        if verdict is not None:
            fields["verdict"] = str(verdict)
        _runlog.record(fields, ledger_path)
        _metrics.counter(
            "rs_durability_damage_events_total",
            "damage-plane events appended to the run ledger",
        ).labels(event=str(event)).inc()
    except Exception:
        pass  # never fail the detecting operation


def record_claim(archive: str, owner: str, *,
                 lease_s: float | None = None,
                 ledger_path: str | None = None) -> None:
    """Append a ``claim`` event: ``owner`` is about to work on
    ``archive``, and other :func:`work_queue` consumers should skip it
    until the lease expires or a completing ``repair``/``scan`` event
    clears it.  Rides the damage ledger (``kind=rs_damage``), so older
    readers skip it via the unknown-event branch.  Never raises."""
    try:
        if ledger_path is None and not _runlog.enabled():
            return
        _runlog.record({
            "kind": DAMAGE_KIND,
            "cls": "damage",
            "event": "claim",
            "archive": os.path.abspath(archive),
            "owner": str(owner),
            "lease_s": float(lease_s if lease_s is not None
                             else claim_lease_s()),
        }, ledger_path)
        _metrics.counter(
            "rs_durability_damage_events_total",
            "damage-plane events appended to the run ledger",
        ).labels(event="claim").inc()
    except Exception:
        pass  # claiming is advisory; never fail the maintenance job


def record_release(archive: str, owner: str, *,
                   ledger_path: str | None = None) -> None:
    """Append a ``release`` event: ``owner`` gives up its claim without
    completing the job (e.g. backing off a repeatedly failing archive).
    Only the claim holder's release clears the claim.  Never raises."""
    try:
        if ledger_path is None and not _runlog.enabled():
            return
        _runlog.record({
            "kind": DAMAGE_KIND,
            "cls": "damage",
            "event": "release",
            "archive": os.path.abspath(archive),
            "owner": str(owner),
        }, ledger_path)
        _metrics.counter(
            "rs_durability_damage_events_total",
            "damage-plane events appended to the run ledger",
        ).labels(event="release").inc()
    except Exception:
        pass


# -- per-archive state machine (docs/HEALTH.md) ------------------------------


def _new_archive() -> dict:
    return {
        "k": None,
        "p": None,
        "w": None,
        "generation": 0,
        # damaged-chunk map: {str(idx): {state, first_ts, last_ts, events}}
        "chunks": {},
        # lifetime counters — repair clears the chunk map, NOT these:
        # recurrence is the signal that an archive keeps rotting.
        "bitrot_events": 0,
        "repairs": 0,
        "repair_failures": 0,
        "updates": 0,
        "last_scrub_ts": None,
        # the metadata generation the last full scan verified; an update
        # bumps "generation" past it, which forces the staleness term to
        # 1.0 until the archive is re-scrubbed.
        "scrub_generation": None,
        "last_damage_ts": None,
        "last_repair_ts": None,
        "last_event_ts": None,
    }


def new_state() -> dict:
    return {
        "archives": {},
        "events": 0,
        "events_since_snapshot": 0,
        "snapshots": 0,
        "snapshots_corrupt": 0,
        "snapshot_ts": None,
    }


def _mark_chunk(a: dict, idx, st: str, ts: float) -> None:
    """Record one damaged-chunk observation; bitrot recurrence counts
    distinct observations (new chunk, or a state transition), not every
    re-scan of the same rot."""
    idx = str(int(idx))
    prev = a["chunks"].get(idx)
    if prev is None or prev.get("state") != st:
        if st in _BITROT_STATES:
            a["bitrot_events"] += 1
        a["chunks"][idx] = {
            "state": st,
            "first_ts": ts,
            "last_ts": ts,
            "events": (prev or {}).get("events", 0) + 1,
        }
    else:
        prev["last_ts"] = ts
        prev["events"] = prev.get("events", 0) + 1


def _apply_event(state: dict, rec: dict) -> None:
    archive = rec.get("archive")
    event = rec.get("event")
    if not isinstance(archive, str) or not isinstance(event, str):
        return
    a = state["archives"].setdefault(archive, _new_archive())
    try:
        ts = float(rec.get("ts") or 0.0)
    except (TypeError, ValueError):
        ts = 0.0
    for f in ("k", "p", "w"):
        v = rec.get(f)
        if isinstance(v, int) and not isinstance(v, bool):
            a[f] = v
    if ts > (a["last_event_ts"] or 0.0):
        a["last_event_ts"] = ts

    if event == "scan":
        gen = rec.get("generation")
        if isinstance(gen, int) and not isinstance(gen, bool):
            a["generation"] = gen
        # A scan's state map is the archive's FULL damage verdict: it
        # replaces the chunk map (clearing chunks the scan found healthy
        # again) and refreshes scrub freshness.
        states = rec.get("states")
        states = states if isinstance(states, dict) else {}
        prior, a["chunks"] = a["chunks"], {}
        for idx, st in states.items():
            try:
                idx = str(int(idx))
            except (TypeError, ValueError):
                continue
            st = str(st)
            prev = prior.get(idx)
            if prev is None or prev.get("state") != st:
                if st in _BITROT_STATES:
                    a["bitrot_events"] += 1
                a["chunks"][idx] = {
                    "state": st, "first_ts": ts, "last_ts": ts,
                    "events": (prev or {}).get("events", 0) + 1,
                }
            else:
                ent = dict(prev)
                ent["last_ts"] = ts
                ent["events"] = ent.get("events", 0) + 1
                a["chunks"][idx] = ent
        a["last_scrub_ts"] = ts
        a["scrub_generation"] = a["generation"]
        if a["chunks"]:
            a["last_damage_ts"] = ts
        # A full scan is a completed maintenance pass: whoever held the
        # claim is done with it (ledger-driven convergence — no separate
        # release write on the happy path).
        a.pop("claim", None)
    elif event == "syndrome":
        located = rec.get("chunks") or []
        for idx in located:
            try:
                _mark_chunk(a, idx, "silent_bitrot", ts)
            except (TypeError, ValueError):
                continue
        if located:
            a["last_damage_ts"] = ts
    elif event == "decode_failure":
        bad = rec.get("chunks") or []
        for idx in bad:
            try:
                _mark_chunk(a, idx, "decode_failure", ts)
            except (TypeError, ValueError):
                continue
        if bad:
            a["last_damage_ts"] = ts
    elif event == "repair":
        for idx in rec.get("chunks") or []:
            try:
                a["chunks"].pop(str(int(idx)), None)
            except (TypeError, ValueError):
                continue
        a["repairs"] += 1
        a["last_repair_ts"] = ts
        a.pop("claim", None)  # job completion clears the claim
    elif event == "repair_failed":
        # Deliberately does NOT clear the claim: lease expiry paces
        # retries of an archive that keeps failing to repair.
        a["repair_failures"] += 1
    elif event == "claim":
        # The claim key exists ONLY while a claim is live — never in
        # _new_archive() — so canonical() stays byte-identical for
        # claim-free fleets (the chaos digests' replay witness).
        try:
            lease = float(rec.get("lease_s"))
        except (TypeError, ValueError):
            lease = claim_lease_s()
        a["claim"] = {
            "owner": str(rec.get("owner") or "?"),
            "ts": ts,
            "lease_s": lease,
        }
    elif event == "release":
        claim = a.get("claim")
        if isinstance(claim, dict) and \
                claim.get("owner") == str(rec.get("owner") or "?"):
            a.pop("claim", None)
    elif event == "update":
        gen = rec.get("generation")
        if isinstance(gen, int) and not isinstance(gen, bool):
            a["generation"] = gen
        else:
            a["generation"] = (a["generation"] or 0) + 1
        a["updates"] += 1
    else:
        return  # unknown event from a newer writer: skip, don't guess
    state["events"] += 1
    state["events_since_snapshot"] += 1


# -- snapshot + delta persistence (the schedule store's discipline) ---------


def payload_digest(archives: dict) -> str:
    blob = json.dumps(archives, sort_keys=True, separators=(",", ":"))
    return hashlib.blake2b(blob.encode(), digest_size=8).hexdigest()


def canonical(state: dict) -> str:
    """Canonical JSON of the per-archive state — the byte-identity the
    chaos harness compares across daemon kill/restart replays."""
    return json.dumps(state["archives"], sort_keys=True,
                      separators=(",", ":"))


def _snapshot_from_record(rec: dict) -> dict:
    # Discipline order matters: a FOREIGN algo_version is not corruption
    # and must be rejected before the digest (its digest may be valid for
    # semantics this loader would misapply); only then is a digest
    # mismatch meaningful as corruption.
    if rec.get("algo_version") != HEALTH_ALGO:
        raise ValueError("health snapshot algo_version mismatch")
    payload = rec.get("archives")
    if not isinstance(payload, dict):
        raise ValueError("malformed health snapshot payload")
    if rec.get("payload_digest") != payload_digest(payload):
        raise ValueError("health snapshot digest mismatch")
    return json.loads(json.dumps(payload))  # private deep copy


def snapshot_record(state: dict) -> dict:
    """The checkpoint record for the current state (fields only; the
    runlog envelope — ts/run/host — is added on append)."""
    payload = state["archives"]
    return {
        "kind": SNAPSHOT_KIND,
        "algo_version": HEALTH_ALGO,
        # Identity for replay dedup: rotation carries the latest snapshot
        # into the live file, so the same checkpoint can appear in both
        # generations; replay applies each snap_id once and keeps the
        # rotated generation's post-snapshot deltas.
        "snap_id": uuid.uuid4().hex[:12],
        "archives": payload,
        "payload_digest": payload_digest(payload),
        "events_folded": state.get("events", 0),
    }


def write_snapshot(state: dict, ledger_path: str | None = None) -> dict:
    rec = snapshot_record(state)
    _runlog.record(rec, ledger_path)
    return rec


def replay(records: list[dict], use_snapshots: bool = True) -> dict:
    """Fold a ledger record stream (oldest first) into health state.

    A valid, not-yet-applied snapshot REPLACES the state; ``rs_damage``
    deltas apply in file order.  ``use_snapshots=False`` ignores
    checkpoints entirely (pure-delta replay) — the differential the
    tests and the chaos harness use to prove snapshot+delta replay is
    byte-identical to replaying every event from genesis.
    """
    state = new_state()
    applied: set = set()
    for rec in records:
        if not isinstance(rec, dict):
            continue
        kind = rec.get("kind")
        if kind == SNAPSHOT_KIND:
            if not use_snapshots:
                continue
            try:
                payload = _snapshot_from_record(rec)
            except Exception:
                state["snapshots_corrupt"] += 1
                continue
            sid = rec.get("snap_id") or rec.get("payload_digest")
            if sid in applied:
                continue
            applied.add(sid)
            state["archives"] = payload
            state["snapshots"] += 1
            state["snapshot_ts"] = rec.get("ts")
            state["events_since_snapshot"] = 0
        elif kind == DAMAGE_KIND:
            _apply_event(state, rec)
    return state


def load(ledger_path: str | None = None,
         use_snapshots: bool = True) -> dict | None:
    """Replay the configured ledger into health state (None when no
    ledger is configured)."""
    p = ledger_path or _runlog.path()
    if not p:
        return None
    return replay(_runlog.read_records(p), use_snapshots=use_snapshots)


# -- risk scoring (docs/HEALTH.md derives the formula) -----------------------


def risk(a: dict, now: float | None = None) -> dict:
    """Score one archive's distance to data loss.

    ``margin = p - lost`` is the erasures the stripe can still absorb
    (``n - k - lost``); the base term ``min(1, lost/(p+1))`` saturates at
    1.0 exactly when the stripe is past recovery.  Modifiers (bitrot
    recurrence, scrub staleness, repair-failure history) add at most 0.5,
    so they reorder archives WITHIN a margin class but never above one.
    """
    now = time.time() if now is None else float(now)
    p = a.get("p")
    p = p if isinstance(p, int) and not isinstance(p, bool) and p >= 0 else 0
    lost = len(a.get("chunks") or {})
    margin = p - lost
    base = min(1.0, lost / float(p + 1))
    rot = min(1.0, (a.get("bitrot_events") or 0) / 4.0)
    fails = min(1.0, (a.get("repair_failures") or 0) / 2.0)
    tau = scrub_max_age_s()
    last = a.get("last_scrub_ts")
    if last is None or a.get("scrub_generation") != a.get("generation"):
        # Never scrubbed, or updated since the last scrub (generation
        # moved past the verified one): the scrub verdict is void.
        stale = 1.0
        age = None if last is None else max(0.0, now - last)
    else:
        age = max(0.0, now - last)
        stale = min(1.0, age / tau) if tau > 0 else 0.0
    score = base + W_BITROT * rot + W_STALE * stale + W_FAIL * fails
    return {
        "risk": round(score, 4),
        "margin": margin,
        "lost": lost,
        "scrub_age_s": None if age is None else round(age, 3),
        "scrub_stale": round(stale, 4),
        "terms": {
            "margin": round(base, 4),
            "bitrot": round(W_BITROT * rot, 4),
            "stale": round(W_STALE * stale, 4),
            "repair_failures": round(W_FAIL * fails, 4),
        },
    }


def bucket(row: dict) -> str:
    """Stripe-risk bucket for the Prometheus gauge and the table."""
    if row["lost"] > 0 and row["margin"] <= 0:
        return "critical"  # the next erasure (or this one) IS data loss
    thresh = at_risk_threshold()
    if row["risk"] >= thresh:
        return "at_risk"
    if row["lost"] > 0 or row["risk"] >= thresh / 2.0:
        return "watch"
    return "ok"


def _rank_key(row: dict):
    # Total order: highest risk first, then most chunks lost, thinnest
    # margin, path as the final tiebreak — deterministic for equal state
    # regardless of dict insertion order.
    return (-row["risk"], -row["lost"], row["margin"], row["archive"])


def live_claim(a: dict, now: float | None = None) -> str | None:
    """The owner of a still-live claim on this archive, or None once the
    lease has expired (or no claim was ever recorded)."""
    claim = a.get("claim")
    if not isinstance(claim, dict):
        return None
    now = time.time() if now is None else float(now)
    try:
        ts = float(claim.get("ts") or 0.0)
        lease = float(claim.get("lease_s") or 0.0)
    except (TypeError, ValueError):
        return None
    if now >= ts + lease:
        return None  # lease expired: the claimant is presumed dead
    return claim.get("owner")


def work_queue(state: dict, now: float | None = None) -> list[dict]:
    """The risk-ordered maintenance queue — the iterator a repair
    scheduler consumes.

    An archive enters the queue when it needs REPAIR (damaged chunks
    outstanding) or a SCRUB (never scanned, generation moved past the
    last verified scan, or the scan aged past the staleness horizon).
    ``reason`` says why (``damage``/``update``/``never_scanned``/
    ``stale``); ``claimed_by`` carries the live lease holder (or None)
    so a one-shot ``rs maint --drain`` and a live daemon sharing a root
    never double-repair the same archive.  Ordering is the same
    deterministic rank as the fleet table.
    """
    now = time.time() if now is None else float(now)
    tau = scrub_max_age_s()
    items = []
    for archive, a in state["archives"].items():
        row = risk(a, now=now)
        last = a.get("last_scrub_ts")
        if row["lost"] > 0:
            action, reason = "repair", "damage"
        elif last is None:
            action, reason = "scrub", "never_scanned"
        elif a.get("scrub_generation") != a.get("generation"):
            action, reason = "scrub", "update"
        elif tau > 0 and now - last >= tau:
            action, reason = "scrub", "stale"
        else:
            continue
        items.append({
            "archive": archive,
            "action": action,
            "reason": reason,
            "risk": row["risk"],
            "margin": row["margin"],
            "lost": row["lost"],
            "claimed_by": live_claim(a, now),
        })
    items.sort(key=_rank_key)
    return items


def fleet_report(state: dict, now: float | None = None) -> dict:
    """The full ranked fleet view — the payload behind ``rs health
    --json`` and ``GET /health``."""
    now = time.time() if now is None else float(now)
    rows = []
    for archive, a in state["archives"].items():
        row = {
            "archive": archive,
            "k": a.get("k"),
            "p": a.get("p"),
            "w": a.get("w"),
            "generation": a.get("generation"),
            "bitrot_events": a.get("bitrot_events") or 0,
            "repairs": a.get("repairs") or 0,
            "repair_failures": a.get("repair_failures") or 0,
            "updates": a.get("updates") or 0,
            "chunks": {
                i: (e or {}).get("state")
                for i, e in sorted((a.get("chunks") or {}).items(),
                                   key=lambda kv: int(kv[0]))
            },
        }
        row.update(risk(a, now=now))
        row["bucket"] = bucket(row)
        rows.append(row)
    rows.sort(key=_rank_key)
    counts = {b: 0 for b in BUCKETS}
    for row in rows:
        counts[row["bucket"]] += 1
    wq = work_queue(state, now=now)
    return {
        "kind": "rs_health",
        "schema": _runlog.SCHEMA_VERSION,
        "algo_version": HEALTH_ALGO,
        "ts": now,
        "total": len(rows),
        "at_risk": counts["at_risk"] + counts["critical"],
        "buckets": counts,
        "work_queue_depth": len(wq),
        "work_queue": wq,
        "events": state.get("events", 0),
        "events_since_snapshot": state.get("events_since_snapshot", 0),
        "snapshots": state.get("snapshots", 0),
        "snapshots_corrupt": state.get("snapshots_corrupt", 0),
        "snapshot_ts": state.get("snapshot_ts"),
        "archives": rows,
    }


def export_metrics(report: dict) -> None:
    """Refresh the ``rs_durability_*`` gauges from a fleet report
    (no-op registry when RS_METRICS is off; the daemon force-enables)."""
    try:
        _metrics.gauge(
            "rs_durability_archives_tracked",
            "archives with health state in the damage ledger",
        ).set(report["total"])
        _metrics.gauge(
            "rs_durability_archives_at_risk",
            "archives scored at_risk or critical",
        ).set(report["at_risk"])
        g = _metrics.gauge(
            "rs_durability_stripe_risk",
            "archives per stripe-risk bucket",
        )
        for b in BUCKETS:
            g.labels(bucket=b).set(report["buckets"].get(b, 0))
        _metrics.gauge(
            "rs_durability_work_queue_depth",
            "archives queued for repair or scrub",
        ).set(report["work_queue_depth"])
        age = _metrics.gauge(
            "rs_durability_scrub_age_seconds",
            "seconds since each archive's last full scan",
        )
        for row in report["archives"]:
            if row.get("scrub_age_s") is not None:
                age.labels(archive=os.path.basename(row["archive"])).set(
                    row["scrub_age_s"])
    except Exception:
        pass  # exposition must never fail the caller


# -- the `rs health` CLI -----------------------------------------------------


def _fmt_age(s: float | None) -> str:
    if s is None:
        return "-"
    if s < 120:
        return f"{s:.0f}s"
    if s < 7200:
        return f"{s / 60:.0f}m"
    if s < 172800:
        return f"{s / 3600:.1f}h"
    return f"{s / 86400:.1f}d"


def render_table(report: dict, top: int | None = None) -> str:
    lines = [
        f"fleet: {report['total']} archives tracked, "
        f"{report['at_risk']} at risk, "
        f"work queue {report['work_queue_depth']} "
        f"(events {report['events']}, snapshots {report['snapshots']})"
    ]
    rows = report["archives"][:top] if top else report["archives"]
    if not rows:
        lines.append("(no archives in the damage ledger yet — run a scrub)")
        return "\n".join(lines)
    lines.append(
        f"{'RISK':>6} {'BUCKET':<8} {'MARGIN':>6} {'LOST':>4} "
        f"{'ROT':>3} {'FAIL':>4} {'SCRUB-AGE':>9}  ARCHIVE"
    )
    for row in rows:
        lines.append(
            f"{row['risk']:>6.3f} {row['bucket']:<8} {row['margin']:>6d} "
            f"{row['lost']:>4d} {row['bitrot_events']:>3d} "
            f"{row['repair_failures']:>4d} "
            f"{_fmt_age(row['scrub_age_s']):>9}  {row['archive']}"
        )
    return "\n".join(lines)


def main(argv: list[str] | None = None) -> int:
    """The ``rs health`` subcommand."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="rs health",
        description="Risk-ranked fleet durability report replayed from "
        "the damage ledger (docs/HEALTH.md).",
    )
    ap.add_argument("--ledger", default=None,
                    help="ledger path (default: $RS_RUNLOG)")
    ap.add_argument("--json", action="store_true",
                    help="one JSON report per refresh instead of the table")
    ap.add_argument("--top", type=int, default=0,
                    help="show only the N riskiest archives")
    ap.add_argument("--watch", nargs="?", type=float, const=2.0,
                    default=None, metavar="SECS",
                    help="refresh every SECS seconds (default 2)")
    ap.add_argument("--count", type=int, default=0,
                    help="with --watch: stop after N refreshes (0 = forever)")
    ap.add_argument("--snapshot", action="store_true",
                    help="checkpoint the replayed state back to the ledger "
                    "as an rs_health_snapshot record (bounds the replay "
                    "window after rotation)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    ledger = args.ledger or _runlog.path()
    if not ledger:
        print("rs health: no ledger configured (set RS_RUNLOG or pass "
              "--ledger)", file=sys.stderr)
        return 2
    n = 0
    while True:
        state = replay(_runlog.read_records(ledger))
        report = fleet_report(state)
        export_metrics(report)
        if args.snapshot and n == 0:
            write_snapshot(state, ledger)
        if args.json:
            print(json.dumps(report), flush=True)
        else:
            print(render_table(report, top=args.top or None), flush=True)
        n += 1
        if args.watch is None or (args.count and n >= args.count):
            return 0
        try:
            time.sleep(max(0.1, args.watch))
        except KeyboardInterrupt:
            return 0
