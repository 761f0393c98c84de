"""Perf baselines and the drift gate: ``rs perf``.

The counterpart of the JAX package's ``obs/perfbase.py``, record for
record: the same samples, cells, baseline records and gate, so a baseline
one package blesses the other reads.

* **Samples**: every throughput stream in the ledger's vocabulary:
  ``kind=rs_perf`` profiler events (bytes / wall; an event whose wall is
  mostly a cold build is left out), ``rs_run`` file-op records
  (:func:`..obs.runlog.throughput_gbps`) and the rows of measurement
  captures (``xor_ab`` per-arm GB/s under their capture headers).
* **Cells**: samples aggregate per (host, backend, strategy, op, shape
  bucket), the bucket being the payload's power-of-two byte class; a
  cell's current value is the median of its newest samples (default 32).
* **Baselines**: ``rs perf --record`` blesses the current cells as one
  ``kind=rs_perf_baseline`` record per (host, backend): ``algo_version``
  checked before the payload digest, an invalid record ignored, carried
  across ledger rotation; prior cells not observed again are carried
  forward.
* **The gate**: ``rs perf --check`` exits 4 when the worst cell falls
  below ``RS_PERF_DRIFT_FRAC`` (default 0.85) of its baseline, and 2 with
  no baseline or no overlapping evidence.

The port's backend label is ``cuda`` on the card and ``cpu`` elsewhere
(:func:`..obs.runlog.backend_name`), so the card's cells never mix with
the host's.

Import cost: the standard library.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import socket
import sys

from . import metrics as _metrics, runlog as _runlog

ALGO_VERSION = 1
DEFAULT_DRIFT_FRAC = 0.85
DEFAULT_WINDOW = 32

# A profiled dispatch whose `compile` stage exceeds this share of its
# wall measured a cold build, not steady-state throughput.
_COMPILE_SHARE_MAX = 0.10


def drift_frac() -> float:
    """``RS_PERF_DRIFT_FRAC``: the gate fires when a cell's current
    throughput falls below this fraction of its baseline (default
    0.85).  Malformed values fall back to the default."""
    try:
        v = float(os.environ.get("RS_PERF_DRIFT_FRAC",
                                 DEFAULT_DRIFT_FRAC))
        return v if 0 < v <= 1 else DEFAULT_DRIFT_FRAC
    except ValueError:
        return DEFAULT_DRIFT_FRAC


def bucket_label(nbytes) -> str | None:
    """Power-of-two shape-bucket label for a payload size (``16MiB``):
    coarse enough that repeated runs of one workload share a cell,
    fine enough that a 4 KiB probe never averages into a 20 MiB
    stripe's baseline."""
    if not isinstance(nbytes, (int, float)) or nbytes <= 0:
        return None
    b = 1
    while b < nbytes:
        b <<= 1
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if b < 1024:
            return f"{b}{unit}"
        b //= 1024
    return f"{b}PiB"


def cell_key(strategy: str, op: str, bucket: str) -> str:
    return f"{strategy}|{op}|{bucket}"


def collect_samples(records: list[dict]) -> list[dict]:
    """Fold ledger records + capture rows into throughput samples:
    ``{host, backend, strategy, op, bucket, gbps, ts}``.  Capture rows
    inherit host/backend/ts from the ``capture_header`` above them, the
    same stamp-once convention ``rs history`` reads."""
    out: list[dict] = []
    header: dict = {}
    for r in records:
        kind = r.get("kind")
        if kind == "capture_header":
            header = r
            continue
        host = r.get("host", header.get("host"))
        backend = r.get("backend", header.get("backend"))
        ts = r.get("ts", header.get("ts"))
        if kind == "rs_perf":
            nbytes, wall = r.get("bytes"), r.get("wall_s")
            if not (isinstance(nbytes, (int, float)) and nbytes > 0
                    and isinstance(wall, (int, float)) and wall > 0):
                continue
            stages = r.get("stages") or {}
            if stages.get("compile", 0.0) > _COMPILE_SHARE_MAX * wall:
                continue  # cold dispatch: a compile measurement
            bucket = bucket_label(nbytes)
            if bucket is None or not r.get("strategy"):
                continue
            out.append({
                "host": host, "backend": backend,
                "strategy": str(r["strategy"]),
                "op": str(r.get("op") or "matmul"),
                "bucket": bucket,
                "gbps": nbytes / wall / 1e9, "ts": ts,
            })
        elif kind == "xor_ab":
            bucket = bucket_label(r.get("bytes"))
            gbps = r.get("gbps")
            if bucket is None or not isinstance(gbps, dict):
                continue
            for arm, g in gbps.items():
                if isinstance(g, (int, float)) and g > 0:
                    out.append({
                        "host": host, "backend": backend,
                        "strategy": str(arm),
                        "op": str(r.get("op") or "encode"),
                        "bucket": bucket, "gbps": float(g), "ts": ts,
                    })
        else:
            # Plain op-measurement stream (rs_run and bench rows with a
            # bytes/wall pair): only rows that name a strategy can form
            # a cell.
            strategy = (r.get("config") or {}).get("strategy")
            op = r.get("op")
            g = _runlog.throughput_gbps(r)
            bucket = bucket_label(r.get("bytes"))
            if strategy and op and g and bucket:
                out.append({
                    "host": host, "backend": backend,
                    "strategy": str(strategy), "op": str(op),
                    "bucket": bucket, "gbps": g, "ts": ts,
                })
    return out


def _median(vals: list[float]) -> float:
    s = sorted(vals)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else (s[mid - 1] + s[mid]) / 2.0


def current_cells(samples: list[dict], host: str, backend: str,
                  window: int = DEFAULT_WINDOW) -> dict:
    """Aggregate one measurement context's samples into cells:
    ``{cell_key: {"gbps": median-of-newest, "n": count, "ts": newest}}``."""
    per: dict[str, list[dict]] = {}
    for s in samples:
        if s["host"] == host and s["backend"] == backend:
            per.setdefault(
                cell_key(s["strategy"], s["op"], s["bucket"]), []
            ).append(s)
    out = {}
    for key, ss in per.items():
        ss.sort(key=lambda s: s.get("ts") or 0)
        recent = ss[-max(1, window):]
        out[key] = {
            "gbps": round(_median([s["gbps"] for s in recent]), 4),
            "n": len(ss),
            "ts": recent[-1].get("ts"),
        }
    return out


def payload_digest(cells: dict) -> str:
    return hashlib.sha256(
        json.dumps(cells, sort_keys=True).encode()
    ).hexdigest()[:16]


def valid_baseline(rec: dict) -> bool:
    """Store-record validation, ``algo_version`` BEFORE the digest: a
    record written by a different aggregation algorithm is stale even
    when intact, and a digest mismatch means torn/hand-edited — either
    way it is ignored, never trusted and never fatal."""
    if rec.get("kind") != "rs_perf_baseline":
        return False
    if rec.get("algo_version") != ALGO_VERSION:
        return False
    cells = rec.get("cells")
    if not isinstance(cells, dict) or not cells:
        return False
    return rec.get("payload_digest") == payload_digest(cells)


def load_baseline(records: list[dict], host: str,
                  backend: str) -> dict | None:
    """The newest VALID blessed baseline for (host, backend), or None."""
    best = None
    for r in records:
        if (r.get("kind") == "rs_perf_baseline"
                and r.get("host") == host
                and r.get("backend") == backend
                and valid_baseline(r)):
            best = r  # records are oldest-first: last wins
    return best


def bless(ledger_path: str, records: list[dict], host: str,
          backend: str, window: int = DEFAULT_WINDOW) -> dict | None:
    """Bless the current cells as the new baseline record (appended to
    the ledger, crash-atomic one-line write).  Prior baseline cells not
    observed in the current evidence are carried forward.  Returns the
    record, or None when there is no evidence to bless."""
    cur = current_cells(collect_samples(records), host, backend,
                        window)
    if not cur:
        return None
    prior = load_baseline(records, host, backend)
    cells = dict((prior or {}).get("cells") or {})
    cells.update(cur)
    fields = {
        "kind": "rs_perf_baseline",
        "algo_version": ALGO_VERSION,
        "host": host,
        "backend": backend,
        "cells": cells,
        "payload_digest": payload_digest(cells),
    }
    _runlog.record(fields, ledger_path)
    return fields


def compare(baseline: dict | None, current: dict,
            frac: float | None = None) -> dict:
    """Current cells vs a blessed baseline.

    Returns ``{"rows": [...], "worst": row|None, "breach": bool}`` —
    rows carry ``status`` ``ok``/``drift`` (both baselined and
    currently observed), ``new`` (no baseline cell yet) or ``stale``
    (baselined, no current evidence); ``worst`` is the lowest-ratio
    compared row, and only compared rows can breach."""
    frac = drift_frac() if frac is None else frac
    rows = []
    worst = None
    base_cells = (baseline or {}).get("cells") or {}
    for key in sorted(set(base_cells) | set(current)):
        strategy, op, bucket = (key.split("|") + ["?", "?"])[:3]
        row = {
            "cell": key, "strategy": strategy, "op": op,
            "bucket": bucket,
            "base_gbps": (base_cells.get(key) or {}).get("gbps"),
            "cur_gbps": (current.get(key) or {}).get("gbps"),
            "n": (current.get(key) or {}).get("n", 0),
            "ratio": None,
        }
        if key not in base_cells:
            row["status"] = "new"
        elif key not in current:
            row["status"] = "stale"
        else:
            base, cur = row["base_gbps"], row["cur_gbps"]
            row["ratio"] = round(cur / base, 4) if base else None
            row["status"] = (
                "drift" if row["ratio"] is not None
                and row["ratio"] < frac else "ok"
            )
            if row["ratio"] is not None and (
                worst is None or row["ratio"] < worst["ratio"]
            ):
                worst = row
        rows.append(row)
    return {
        "rows": rows,
        "worst": worst,
        "breach": worst is not None and worst["ratio"] < frac,
        "drift_frac": frac,
    }


def report(records: list[dict], *, host: str | None = None,
           backend: str | None = None,
           window: int = DEFAULT_WINDOW) -> dict:
    """The one perf-plane summary (CLI table, daemon ``GET /perf``,
    doctor section): resolved context, blessed baseline, current cells
    and the drift comparison.  Schema-stable — every key present even
    with an empty ledger."""
    samples = collect_samples(records)
    host = host or socket.gethostname()
    if backend is None:
        mine = [s for s in samples if s["host"] == host
                and s.get("ts") is not None]
        backend = (
            max(mine, key=lambda s: s["ts"])["backend"] if mine
            else _runlog.backend_name()
        )
    current = current_cells(samples, host, backend, window)
    baseline = load_baseline(records, host, backend)
    cmp = compare(baseline, current)
    return {
        "kind": "rs_perf_report",
        "host": host,
        "backend": backend,
        "samples": len(samples),
        "baseline": bool(baseline),
        "baseline_ts": (baseline or {}).get("ts"),
        "baseline_cells": len((baseline or {}).get("cells") or {}),
        "current_cells": len(current),
        "drift_frac": cmp["drift_frac"],
        "rows": cmp["rows"],
        "worst": cmp["worst"],
        "breach": cmp["breach"],
    }


def export_gauges(rep: dict) -> None:
    """Mirror a perf report into scrape-time gauges (the daemon calls
    this per ``/metrics`` render; no-op with metrics off)."""
    if not _metrics.enabled():
        return
    base = _metrics.gauge(
        "rs_perf_baseline_gbps",
        "blessed baseline throughput per perf cell",
    )
    cur = _metrics.gauge(
        "rs_perf_baseline_current_gbps",
        "current (median) throughput per perf cell",
    )
    ratio = _metrics.gauge(
        "rs_perf_baseline_ratio",
        "current/baseline throughput ratio per perf cell "
        "(< RS_PERF_DRIFT_FRAC = drifting)",
    )
    for row in rep.get("rows", []):
        labels = {"strategy": row["strategy"], "op": row["op"],
                  "bucket": row["bucket"]}
        if row.get("base_gbps") is not None:
            base.labels(**labels).set(row["base_gbps"])
        if row.get("cur_gbps") is not None:
            cur.labels(**labels).set(row["cur_gbps"])
        if row.get("ratio") is not None:
            ratio.labels(**labels).set(row["ratio"])
    _metrics.gauge(
        "rs_perf_baseline_cells",
        "perf cells in the blessed baseline",
    ).set(rep.get("baseline_cells", 0))
    _metrics.gauge(
        "rs_perf_baseline_breach",
        "1 when the worst perf cell is below the drift gate",
    ).set(1 if rep.get("breach") else 0)


_ARROWS = (
    (1.05, "↗"),   # improving
    (0.95, "→"),   # flat
    (0.0, "↘"),    # declining
)


def _trend(row: dict, frac: float) -> str:
    r = row.get("ratio")
    if r is None:
        return {"new": "+", "stale": "?"}.get(row.get("status"), " ")
    if r < frac:
        return "!!"
    for floor, arrow in _ARROWS:
        if r >= floor:
            return arrow
    return "↘"


def render(rep: dict) -> str:
    lines = [
        f"perf baselines @ {rep['host']}/{rep['backend']}  "
        f"(samples={rep['samples']}, drift gate "
        f"<{rep['drift_frac']:.2f}x, algo v{ALGO_VERSION})"
    ]
    if not rep["baseline"]:
        lines.append(
            "  no blessed baseline for this host/backend — run "
            "`rs perf --record` on known-good numbers first"
        )
    if not rep["rows"]:
        lines.append("  no perf evidence in the ledger "
                     "(RS_PROF profiled dispatches, op records and "
                     "--captures rows all feed this)")
        return "\n".join(lines)
    width = max(len(r["cell"]) for r in rep["rows"])
    lines.append(
        f"  {'cell'.ljust(width)}  {'baseline':>9}  {'current':>9}  "
        f"{'n':>4}  trend"
    )
    for row in rep["rows"]:
        fmt = lambda v: f"{v:9.4f}" if isinstance(v, (int, float)) \
            else f"{'-':>9}"
        ratio = (f" {row['ratio']:.3f}x"
                 if row.get("ratio") is not None else "")
        lines.append(
            f"  {row['cell'].ljust(width)}  {fmt(row['base_gbps'])}  "
            f"{fmt(row['cur_gbps'])}  {row['n']:>4}  "
            f"{_trend(row, rep['drift_frac'])}{ratio}"
        )
    return "\n".join(lines)


def _read_evidence(ledger: str, captures: list[str]) -> list[dict]:
    records = _runlog.read_records(ledger)
    for pattern in captures:
        paths = sorted(glob.glob(os.path.join(pattern, "*.jsonl"))) \
            if os.path.isdir(pattern) else sorted(glob.glob(pattern))
        for p in paths:
            records.extend(_runlog.read_records(p,
                                                include_rotated=False))
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="rs perf",
        description="Per-cell perf baselines + drift gate over the run "
        "ledger's rs_perf/op evidence (and optional bench captures): "
        "renders the baseline table; --record blesses the current "
        "numbers; --check exits 4 when the worst cell drifts below "
        "RS_PERF_DRIFT_FRAC of baseline.",
    )
    ap.add_argument("--runlog", default=None,
                    help="ledger path (default $RS_RUNLOG)")
    ap.add_argument("--captures", action="append", default=[],
                    help="bench-capture dir or glob to fold in "
                    "(repeatable; e.g. bench_captures)")
    ap.add_argument("--host", default=None,
                    help="measurement host (default this host)")
    ap.add_argument("--backend", default=None,
                    help="backend cell class (default: newest sample's)")
    ap.add_argument("--window", type=int, default=DEFAULT_WINDOW,
                    help="newest samples per cell for the median "
                    f"(default {DEFAULT_WINDOW})")
    ap.add_argument("--drift-frac", type=float, default=None,
                    help="override RS_PERF_DRIFT_FRAC for --check")
    ap.add_argument("--record", action="store_true",
                    help="bless current cells as the new baseline")
    ap.add_argument("--check", action="store_true",
                    help="gate: exit 4 on drift below the threshold, "
                    "2 when there is no evidence to judge")
    ap.add_argument("--json", action="store_true")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)

    ledger = args.runlog or os.environ.get("RS_RUNLOG")
    if not ledger:
        print("rs perf: no ledger — pass --runlog or set RS_RUNLOG",
              file=sys.stderr)
        return 2
    if not (os.path.exists(ledger) or os.path.exists(ledger + ".1")):
        print(f"rs perf: ledger not found: {ledger}", file=sys.stderr)
        return 1

    records = _read_evidence(ledger, args.captures)

    if args.record:
        host = args.host or socket.gethostname()
        backend = args.backend
        if backend is None:
            rep = report(records, host=host, window=args.window)
            backend = rep["backend"]
        rec = bless(ledger, records, host, backend, args.window)
        if rec is None:
            print(f"rs perf: nothing to bless — no throughput samples "
                  f"for {host}/{backend} in {ledger}", file=sys.stderr)
            return 2
        print(f"rs perf: blessed {len(rec['cells'])} cell(s) for "
              f"{host}/{backend} -> {ledger}", file=sys.stderr)
        records = _read_evidence(ledger, args.captures)

    rep = report(records, host=args.host, backend=args.backend,
                 window=args.window)
    if args.drift_frac is not None:
        cmp = compare(
            load_baseline(records, rep["host"], rep["backend"]),
            current_cells(collect_samples(records), rep["host"],
                          rep["backend"], args.window),
            args.drift_frac,
        )
        rep.update(drift_frac=cmp["drift_frac"], rows=cmp["rows"],
                   worst=cmp["worst"], breach=cmp["breach"])

    if args.json:
        print(json.dumps(rep, default=str))
    else:
        print(render(rep))

    if not args.check:
        return 0
    if not rep["baseline"]:
        print("rs perf: CHECK INCONCLUSIVE — no blessed baseline "
              "(no evidence is not a pass; run `rs perf --record`)",
              file=sys.stderr)
        return 2
    if rep["worst"] is None:
        print("rs perf: CHECK INCONCLUSIVE — baseline exists but no "
              "current samples overlap it", file=sys.stderr)
        return 2
    w = rep["worst"]
    if rep["breach"]:
        print(
            f"rs perf: DRIFT BREACH — worst cell {w['cell']}: "
            f"{w['cur_gbps']} GB/s vs baseline {w['base_gbps']} GB/s "
            f"({w['ratio']:.3f}x < {rep['drift_frac']:.2f}x)",
            file=sys.stderr,
        )
        return 4
    print(
        f"rs perf: CHECK OK — worst cell {w['cell']} at "
        f"{w['ratio']:.3f}x of baseline "
        f"(gate {rep['drift_frac']:.2f}x)",
        file=sys.stderr,
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
