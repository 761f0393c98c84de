"""Per-tenant SLO objectives — ``RS_SLO`` parsing, rolling attainment,
burn rates.

The port's copy of the JAX package's ``obs/slo.py``: the same names,
knobs, records and payloads.

Scheduler features (SLO classes, priorities, preemption, quotas) all
need the same substrate first: a definition of "meeting the
objective" that is measured, per tenant, from real request outcomes.
This module is that substrate (docs/SERVE.md "Request lifecycle"):

* **Spec** — ``RS_SLO`` holds ``;``-separated objectives, each
  ``TENANT:OP:KEY=VAL[,KEY=VAL...]``::

      RS_SLO='default:encode:p99=250ms,avail=99.9;*:decode:p99=1s'

  ``TENANT``/``OP`` may be ``*`` (any).  Keys: ``p50``/``p90``/``p99``
  with a duration value (``250ms``, ``0.25s``, bare number = ms) and
  ``avail`` with a percentage.  The most specific objective wins per
  (tenant, op): exact tenant+op, then exact tenant, then exact op, then
  ``*:*``.
* **SLIs** — per matched request: *latency* (request wall, admission to
  response, against each percentile target: a ``p99=250ms`` objective
  means >= 99 % of requests complete within 250 ms) and *availability*
  (HTTP 200; rejections and errors both burn the availability budget —
  a 429 is the daemon refusing work it was offered).
* **Rolling multi-window attainment + burn rate** — events are kept in
  per-cell deques and evaluated over ``RS_SLO_WINDOWS`` (default
  ``60,300,3600`` seconds).  Burn rate is the SRE convention: the
  fraction of the error budget consumed per unit of budget —
  ``bad_fraction / allowed_fraction`` — so ``1.0`` means exactly on
  budget, ``> 1`` means the objective fails if the window's rate
  holds.
* **Surfaces** — ``rs_slo_requests_total{tenant,op,verdict}`` counts
  every matched request; :meth:`SLOEngine.export_gauges` refreshes
  ``rs_slo_attainment`` / ``rs_slo_burn_rate{tenant,op,objective,
  window}`` gauges (the daemon does this on every ``/metrics`` scrape
  and ``GET /slo``); ``rs slo`` renders the same report from a live
  daemon (``--url``) or offline from ``kind=rs_request`` ledger records
  (``--runlog``).

Import cost: the standard library only.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from collections import deque

from . import metrics as _metrics

DEFAULT_WINDOWS = (60.0, 300.0, 3600.0)

# Bounded per-cell history: at most this many events are consulted per
# (tenant, op) — a daemon serving far more than this inside its largest
# window reports on the most recent slice (the cap is noted in /slo).
MAX_EVENTS_PER_CELL = 8192

_QUANTILE_KEYS = {"p50": 0.50, "p90": 0.90, "p99": 0.99}


class SLOSpecError(ValueError):
    """``RS_SLO`` (or ``--slo``) did not parse."""


class Objective:
    """One parsed objective row: who it matches and what it demands."""

    __slots__ = ("tenant", "op", "latency", "avail", "spec")

    def __init__(self, tenant: str, op: str,
                 latency: dict[float, float], avail: float | None,
                 spec: str):
        self.tenant = tenant      # tenant name or "*"
        self.op = op              # op name or "*"
        self.latency = latency    # {quantile: threshold_seconds}
        self.avail = avail        # e.g. 99.9 (percent) or None
        self.spec = spec          # the original token (reports echo it)

    def matches(self, tenant: str, op: str) -> bool:
        return (self.tenant in ("*", tenant)
                and self.op in ("*", op))

    def specificity(self) -> int:
        return (self.tenant != "*") * 2 + (self.op != "*")

    def describe(self) -> dict:
        return {
            "tenant": self.tenant,
            "op": self.op,
            "latency": {f"p{int(q * 100)}": thr
                        for q, thr in sorted(self.latency.items())},
            "avail": self.avail,
            "spec": self.spec,
        }


def _parse_duration_s(text: str, where: str) -> float:
    t = text.strip().lower()
    try:
        if t.endswith("ms"):
            return float(t[:-2]) / 1e3
        if t.endswith("s"):
            return float(t[:-1])
        return float(t) / 1e3  # bare number: milliseconds
    except ValueError:
        raise SLOSpecError(
            f"{where}: bad duration {text!r} (want e.g. 250ms or 0.25s)"
        ) from None


def parse_slo(spec: str | None) -> list[Objective]:
    """Parse an ``RS_SLO`` spec into objectives (empty list for
    None/blank).  Raises :class:`SLOSpecError` with the offending token
    on any malformed piece — a half-understood objective must not
    silently gate on the wrong numbers."""
    out: list[Objective] = []
    if not spec or not spec.strip():
        return out
    for token in spec.split(";"):
        token = token.strip()
        if not token:
            continue
        parts = token.split(":", 2)
        if len(parts) != 3:
            raise SLOSpecError(
                f"objective {token!r}: want TENANT:OP:KEY=VAL[,...]")
        tenant, op, body = (p.strip() for p in parts)
        if not tenant or not op or not body:
            raise SLOSpecError(
                f"objective {token!r}: empty tenant/op/targets")
        latency: dict[float, float] = {}
        avail: float | None = None
        for kv in body.split(","):
            key, sep, val = kv.partition("=")
            key = key.strip().lower()
            if not sep:
                raise SLOSpecError(
                    f"objective {token!r}: target {kv!r} needs KEY=VAL")
            if key in _QUANTILE_KEYS:
                latency[_QUANTILE_KEYS[key]] = _parse_duration_s(
                    val, f"objective {token!r}")
            elif key == "avail":
                try:
                    avail = float(val)
                except ValueError:
                    raise SLOSpecError(
                        f"objective {token!r}: bad avail {val!r}"
                    ) from None
                if not 0 < avail < 100:
                    raise SLOSpecError(
                        f"objective {token!r}: avail must be in (0, 100)"
                    )
            else:
                raise SLOSpecError(
                    f"objective {token!r}: unknown target {key!r} "
                    f"(want p50/p90/p99/avail)")
        if not latency and avail is None:
            raise SLOSpecError(f"objective {token!r}: no targets")
        out.append(Objective(tenant, op, latency, avail, token))
    return out


def windows() -> tuple[float, ...]:
    """``RS_SLO_WINDOWS``: comma-separated rolling window lengths in
    seconds (default ``60,300,3600``)."""
    raw = os.environ.get("RS_SLO_WINDOWS")
    if not raw:
        return DEFAULT_WINDOWS
    try:
        vals = tuple(sorted(float(v) for v in raw.split(",") if v.strip()))
    except ValueError:
        return DEFAULT_WINDOWS
    return tuple(v for v in vals if v > 0) or DEFAULT_WINDOWS


def configured() -> bool:
    """Whether any SLO objectives are configured via the environment."""
    return bool(os.environ.get("RS_SLO", "").strip())


class SLOEngine:
    """Rolling per-(tenant, op) SLO evaluation over a bounded event
    history.  Thread-safe: handler threads :meth:`observe`, scrape
    threads :meth:`report`."""

    def __init__(self, spec: str | None = None,
                 window_lengths: tuple[float, ...] | None = None):
        self.objectives = parse_slo(
            os.environ.get("RS_SLO") if spec is None else spec)
        self.windows = tuple(window_lengths) if window_lengths else \
            windows()
        self._lock = threading.Lock()
        # (tenant, op) -> deque[(t, wall_s, ok)]
        self._events: dict[tuple, deque] = {}

    def match(self, tenant: str, op: str) -> Objective | None:
        best = None
        for obj in self.objectives:
            if obj.matches(tenant, op) and (
                    best is None
                    or obj.specificity() > best.specificity()):
                best = obj
        return best

    def observe(self, tenant: str, op: str, wall_s: float, ok: bool,
                t: float | None = None) -> None:
        """Record one finished request (``wall_s`` = admission to
        response; ``ok`` = HTTP 200).  Requests no objective matches are
        ignored — the engine costs nothing for unconfigured traffic."""
        obj = self.match(tenant, op)
        if obj is None:
            return
        t = time.monotonic() if t is None else t
        with self._lock:
            cell = self._events.get((tenant, op))
            if cell is None:
                cell = self._events[(tenant, op)] = deque(
                    maxlen=MAX_EVENTS_PER_CELL)
            cell.append((t, float(wall_s), bool(ok)))
        verdict = "good"
        if not ok:
            verdict = "error"
        elif any(wall_s > thr for thr in obj.latency.values()):
            verdict = "slow"
        _metrics.counter(
            "rs_slo_requests_total",
            "requests matched by an SLO objective, by per-request verdict",
        ).labels(tenant=tenant, op=op, verdict=verdict).inc()

    # -- reporting -----------------------------------------------------------

    @staticmethod
    def _window_rates(events: list[tuple], obj: Objective) -> dict:
        """Attainment + burn for one window's event slice.

        Latency SLIs are computed over SERVED (ok) requests only: a
        window of sub-millisecond 429s must not mask the one successful
        request that blew the target (rejections already burn the
        availability budget — counting their walls as latency-good
        would let an overloaded daemon never fail its latency SLO).  A
        window with traffic but zero served requests reports the
        latency objective with ``attainment: None`` / ``met: None`` —
        no latency evidence is not a latency pass."""
        total = len(events)
        out: dict = {"total": total, "objectives": {}}
        if not total:
            return out
        walls = sorted(e[1] for e in events if e[2])  # served only
        oks = len(walls)
        out["served"] = oks
        for q, thr in sorted(obj.latency.items()):
            entry: dict = {"target_s": thr, "target_fraction": q}
            if oks:
                good = sum(1 for w in walls if w <= thr)
                frac = good / oks
                allowed = 1.0 - q
                burn = ((1.0 - frac) / allowed) if allowed > 0 else None
                entry.update(
                    attainment=round(frac, 6),
                    burn_rate=round(burn, 4) if burn is not None
                    else None,
                    met=frac >= q,
                )
            else:
                entry.update(attainment=None, burn_rate=None, met=None)
            out["objectives"][f"p{int(q * 100)}"] = entry
        if obj.avail is not None:
            frac = oks / total
            target = obj.avail / 100.0
            allowed = 1.0 - target
            burn = ((1.0 - frac) / allowed) if allowed > 0 else None
            out["objectives"]["avail"] = {
                "target_fraction": target,
                "attainment": round(frac, 6),
                "burn_rate": round(burn, 4) if burn is not None else None,
                "met": frac >= target,
            }
        return out

    def report(self, now: float | None = None) -> dict:
        """The full SLO document (the ``GET /slo`` payload): per matched
        (tenant, op) cell, attainment and burn rate over every rolling
        window, plus the parsed objective table."""
        now = time.monotonic() if now is None else now
        with self._lock:
            cells = {key: list(dq) for key, dq in self._events.items()}
        rows = []
        for (tenant, op), events in sorted(cells.items()):
            obj = self.match(tenant, op)
            if obj is None:  # objective removed after traffic flowed
                continue
            row = {
                "tenant": tenant, "op": op, "objective": obj.describe(),
                "history_capped": len(events) >= MAX_EVENTS_PER_CELL,
                "windows": {},
            }
            for w in self.windows:
                cut = now - w
                row["windows"][str(int(w))] = self._window_rates(
                    [e for e in events if e[0] >= cut], obj)
            rows.append(row)
        return {
            "kind": "rs_slo",
            "configured": bool(self.objectives),
            "objectives": [o.describe() for o in self.objectives],
            "windows_s": list(self.windows),
            "cells": rows,
        }

    def export_gauges(self, now: float | None = None) -> dict:
        """Refresh the ``rs_slo_attainment`` / ``rs_slo_burn_rate``
        gauges from a fresh report (rolling windows age out even with no
        new traffic, so gauges are recomputed at scrape time, not at
        observe time).  Returns the report it exported."""
        report = self.report(now)
        att = _metrics.gauge(
            "rs_slo_attainment",
            "fraction of requests meeting the objective, rolling window")
        burn = _metrics.gauge(
            "rs_slo_burn_rate",
            "error-budget burn rate (1.0 = exactly on budget), rolling "
            "window")
        for row in report["cells"]:
            for win, rates in row["windows"].items():
                for name, vals in rates.get("objectives", {}).items():
                    labels = dict(tenant=row["tenant"], op=row["op"],
                                  objective=name, window=win)
                    if vals["attainment"] is not None:
                        att.labels(**labels).set(vals["attainment"])
                    if vals["burn_rate"] is not None:
                        burn.labels(**labels).set(vals["burn_rate"])
        return report


def breaches(report: dict) -> list[dict]:
    """Every (cell, window, objective) in ``report`` currently missing
    its target — the gate `rs loadgen --slo` and `rs slo --check` fail
    on.  Empty windows never breach (no traffic is not a violation)."""
    out = []
    for row in report.get("cells", []):
        for win, rates in row.get("windows", {}).items():
            for name, vals in rates.get("objectives", {}).items():
                if vals.get("met") is False:
                    out.append({
                        "tenant": row["tenant"], "op": row["op"],
                        "window": win, "objective": name,
                        "attainment": vals["attainment"],
                        "burn_rate": vals["burn_rate"],
                    })
    return out


def render(report: dict) -> str:
    """Human-readable SLO report: one line per (cell, window,
    objective)."""
    lines = []
    if not report.get("configured"):
        lines.append("slo: no objectives configured (set RS_SLO)")
    else:
        specs = ", ".join(o["spec"] for o in report["objectives"])
        lines.append(f"slo objectives: {specs}")
    for row in report.get("cells", []):
        for win, rates in sorted(row["windows"].items(),
                                 key=lambda kv: float(kv[0])):
            total = rates["total"]
            if not total:
                continue
            for name, vals in rates["objectives"].items():
                if vals["met"] is None:  # traffic but nothing served
                    lines.append(
                        f"[--] {row['tenant']}/{row['op']} {name} "
                        f"@{win}s: no served requests "
                        f"({total} total, all rejected/failed)")
                    continue
                mark = "ok" if vals["met"] else "!!"
                burn = vals["burn_rate"]
                lines.append(
                    f"[{mark}] {row['tenant']}/{row['op']} {name} "
                    f"@{win}s: attainment "
                    f"{vals['attainment'] * 100:.3f}% "
                    f"(target {vals['target_fraction'] * 100:g}%), "
                    f"burn {burn if burn is not None else '-'} "
                    f"over {total} requests")
    if len(lines) == 1 and report.get("configured"):
        lines.append("(no matched traffic yet)")
    return "\n".join(lines)


def replay_ledger(path: str, spec: str | None = None) -> dict:
    """Offline report: feed ``kind=rs_request`` ledger records (the
    reqtrace wide events, docs/OBSERVABILITY.md) through a fresh engine.
    Windows are evaluated relative to the newest record's wall-clock
    ``ts``."""
    from . import runlog as _runlog

    engine = SLOEngine(spec=spec)
    records = [r for r in _runlog.read_records(path)
               if r.get("kind") == "rs_request"]
    last_ts = 0.0
    for rec in records:
        ts = float(rec.get("ts") or 0.0)
        last_ts = max(last_ts, ts)
        wall = rec.get("wall_s")
        if not isinstance(wall, (int, float)):
            continue
        engine.observe(rec.get("tenant") or "default",
                       rec.get("op") or "?", float(wall),
                       ok=rec.get("outcome") == "ok", t=ts)
    report = engine.report(now=last_ts)
    report["records"] = len(records)
    report["source"] = path
    return report


def main(argv=None) -> int:
    """The ``rs slo`` subcommand."""
    import argparse
    import urllib.request

    ap = argparse.ArgumentParser(
        prog="rs slo",
        description="Per-tenant SLO attainment + burn rates: scrape a "
        "live daemon's GET /slo, or replay kind=rs_request ledger "
        "records offline (docs/SERVE.md 'Request lifecycle').",
    )
    ap.add_argument("--url", default=None,
                    help="daemon base URL (e.g. http://127.0.0.1:9470)")
    ap.add_argument("--runlog", default=None,
                    help="offline: replay rs_request records from this "
                    "ledger (default $RS_RUNLOG when --url is absent)")
    ap.add_argument("--slo", metavar="SPEC", default=None,
                    help="objective spec for --runlog replay (default "
                    "$RS_SLO)")
    ap.add_argument("--check", action="store_true",
                    help="exit 4 when any window misses its objective "
                    "(the CI/cron gate form)")
    ap.add_argument("--json", action="store_true",
                    help="emit the report document as JSON")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)

    if args.url:
        try:
            with urllib.request.urlopen(
                    args.url.rstrip("/") + "/slo", timeout=10) as resp:
                report = json.loads(resp.read())
        except Exception as e:
            print(f"rs slo: cannot scrape {args.url}: "
                  f"{type(e).__name__}: {e}", file=sys.stderr)
            return 1
    else:
        ledger = args.runlog or os.environ.get("RS_RUNLOG")
        if not ledger:
            print("rs slo: pass --url, or --runlog/RS_RUNLOG for an "
                  "offline replay", file=sys.stderr)
            return 2
        try:
            report = replay_ledger(ledger, spec=args.slo)
        except SLOSpecError as e:
            print(f"rs slo: bad SLO spec: {e}", file=sys.stderr)
            return 2
        except OSError as e:
            print(f"rs slo: cannot read {ledger!r}: {e}", file=sys.stderr)
            return 1

    if args.json:
        print(json.dumps(report))
    else:
        print(render(report))
    if args.check:
        bad = breaches(report)
        if bad:
            for b in bad:
                print(f"rs slo: BREACH {b['tenant']}/{b['op']} "
                      f"{b['objective']} @{b['window']}s: attainment "
                      f"{b['attainment']}, burn {b['burn_rate']}",
                      file=sys.stderr)
            return 4
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
