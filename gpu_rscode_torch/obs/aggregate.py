"""Multi-process telemetry aggregation: merge per-process snapshots and
traces.  The port's copy of the JAX package's ``obs/aggregate.py``; its
merge rules, output and exit codes are the JAX package's.

A multi-process job (the ``--devices`` CLI under torchrun's ``WORLD_SIZE``
/ ``RANK``) runs the same instrumented program in every process, so each
process writes its own metrics snapshot and its own Chrome trace, named
``{path}.p{rank}`` (:func:`part_path`).  This module fuses them:

* **Snapshot merge** (:func:`merge_snapshots`): counters sum, gauges keep
  the max (the peak across the job) plus the per-process last values,
  histograms sum bucket-wise (cumulative ``le`` counts, ``+Inf``
  included, ``_sum`` and ``_count``), so the merged histogram is the one a
  single process observing every event would have produced; quantile
  series merge their estimator states.
* **Trace fusion** (:func:`merge_traces`): each process becomes one
  Perfetto process lane (distinct ``pid``, labelled with host and process
  index), keeping its thread lanes, with timestamps aligned on one axis
  through the shared epoch marked right after the process group's init
  barrier (``otherData.rs_epoch`` / ``rs_wall_t0``, obs/tracing.py).

CLI (``rs aggregate``)::

    python -m gpu_rscode_torch.obs.aggregate --snapshot-out merged.json  m.json
    python -m gpu_rscode_torch.obs.aggregate --trace-out fleet.trace     t.json

where each input is an explicit part file or a base path whose ``.p0,
.p1, ...`` parts are discovered (:func:`find_parts`).

Import cost: the standard library only, so the aggregator runs on a
machine that saw none of the work.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

from . import percentile as _percentile

_PART_RE = re.compile(r"\.p(\d+)$")


def find_parts(base: str) -> list[str]:
    """Per-process part files for ``base``: ``base.p0, base.p1, ...``
    sorted by process index (numeric — ``.p10`` after ``.p9``).  Falls
    back to ``[base]`` when no parts exist but the base file does (a
    single-process run needs no merge but should flow through the same
    pipeline)."""
    d = os.path.dirname(base) or "."
    name = os.path.basename(base)
    parts = []
    try:
        entries = os.listdir(d)
    except OSError:
        entries = []
    for e in entries:
        if e.startswith(name):
            m = _PART_RE.fullmatch(e[len(name):])
            if m:
                parts.append((int(m.group(1)), os.path.join(d, e)))
    if parts:
        return [p for _, p in sorted(parts)]
    return [base] if os.path.exists(base) else []


def part_path(base: str, process_index: int, process_count: int) -> str:
    """Where one process of a multi-process job dumps its telemetry:
    ``base.p{i}`` when the job spans processes, ``base`` itself when it
    does not (so single-process behavior is unchanged)."""
    return f"{base}.p{process_index}" if process_count > 1 else base


# -- snapshot merge ----------------------------------------------------------


def _is_histogram_value(v) -> bool:
    return isinstance(v, dict) and "buckets" in v


def _is_quantile_value(v) -> bool:
    return isinstance(v, dict) and "reservoir" in v


def _merge_quantile(acc: dict | None, v: dict) -> dict:
    """Fold one part's estimator state into the accumulator: exact
    count/sum/min/max, count-weighted reservoir merge (the
    obs/percentile.py contract — a part that saw 10x the events
    contributes ~10x the samples), percentile family recomputed from the
    merged reservoir."""
    merged = _percentile.merge_states([acc, v] if acc else [v])
    merged["quantiles"] = _percentile.state_quantiles(merged)
    return merged


def _merge_histogram(acc: dict | None, v: dict) -> dict:
    if acc is None:
        acc = {"count": 0, "sum": 0.0, "buckets": {}}
    out_buckets = dict(acc["buckets"])
    for le, cum in v.get("buckets", {}).items():
        out_buckets[le] = out_buckets.get(le, 0) + cum
    return {
        "count": acc["count"] + v.get("count", 0),
        "sum": acc["sum"] + v.get("sum", 0.0),
        "buckets": out_buckets,
    }


def merge_snapshots(snaps: list[dict]) -> dict:
    """Merge N per-process REGISTRY snapshots into one.

    Input/output shape is ``Registry.snapshot()``'s:
    ``{name: {"type", "help", "values": {label_str: value}}}``.  Merge
    semantics per metric type:

    - **counter** — sum per labeled series (the fleet's total).
    - **gauge** — max per series (the fleet-wide peak: queue depths,
      ring occupancy — the saturation question "did ANY worker max out"),
      with every process's final value preserved under ``"last"``
      (``{label_str: [v_p0, v_p1, ...]}``) so per-host residue is not
      lost.
    - **histogram** — bucket-wise sum of the cumulative ``le`` counts
      (``+Inf`` preserved), plus summed ``sum``/``count`` — equal to the
      single-process histogram of the union of events.

    A name carrying different types across parts raises ValueError
    (summing a gauge into a counter would corrupt the series).
    """
    out: dict = {}
    for snap in snaps:
        for name, fam in snap.items():
            dst = out.get(name)
            if dst is None:
                dst = out[name] = {
                    "type": fam.get("type", "untyped"),
                    "help": fam.get("help", ""),
                    "values": {},
                }
                if fam.get("type") == "gauge":
                    dst["last"] = {}
            elif dst["type"] != fam.get("type", "untyped"):
                raise ValueError(
                    f"metric {name!r} has conflicting types across parts: "
                    f"{dst['type']} vs {fam.get('type')}"
                )
            kind = dst["type"]
            for label, v in fam.get("values", {}).items():
                if kind == "histogram" or _is_histogram_value(v):
                    dst["values"][label] = _merge_histogram(
                        dst["values"].get(label), v
                    )
                elif kind == "quantile" or _is_quantile_value(v):
                    dst["values"][label] = _merge_quantile(
                        dst["values"].get(label), v
                    )
                elif kind == "gauge":
                    prev = dst["values"].get(label)
                    dst["values"][label] = v if prev is None else max(prev, v)
                    dst["last"].setdefault(label, []).append(v)
                else:  # counter (and untyped numerics): sum
                    dst["values"][label] = dst["values"].get(label, 0) + v
    return out


# Plan-cache fields that are configured BOUNDS, not accumulations:
# summing them would claim a limit no process has.
_NON_ADDITIVE_KEYS = frozenset({"max_size"})


def _sum_numeric_tree(parts: list, key: str | None = None):
    """Fold plan-cache style stat dicts: numeric leaves sum (bound-style
    keys like ``max_size`` take the max instead), lists concatenate (so
    a merged ``plans`` list stays consistent with its summed
    ``executables`` count), dict leaves recurse, anything else keeps the
    first part's value."""
    if not parts:
        return None
    first = parts[0]
    if isinstance(first, bool):
        return first
    if isinstance(first, (int, float)):
        nums = [p for p in parts if isinstance(p, (int, float))]
        return max(nums) if key in _NON_ADDITIVE_KEYS else sum(nums)
    if isinstance(first, list):
        return [item for p in parts if isinstance(p, list) for item in p]
    if isinstance(first, dict):
        keys: list = []
        for p in parts:
            if isinstance(p, dict):
                keys.extend(k for k in p if k not in keys)
        return {
            k: _sum_numeric_tree(
                [p[k] for p in parts if isinstance(p, dict) and k in p], k
            )
            for k in keys
        }
    return first


def merge_unified_snapshots(snaps: list[dict]) -> dict:
    """Merge N ``obs.metrics.unified_snapshot()`` dumps (what
    ``--metrics-json`` writes per process): the ``metrics`` registries
    merge per :func:`merge_snapshots`, the plan-cache stats sum their
    numeric counters, and the autotune decisions union (first writer
    wins on a key conflict — every process autotunes the same shapes)."""
    out: dict = {
        "metrics_enabled": any(s.get("metrics_enabled") for s in snaps),
        "merged_from": len(snaps),
        "metrics": merge_snapshots([s.get("metrics", {}) for s in snaps]),
    }
    for key in ("plan_cache", "mesh_plan_cache"):
        present = [s[key] for s in snaps if key in s]
        if present:
            out[key] = _sum_numeric_tree(present)
    autotune: dict = {}
    for s in snaps:
        for k, v in (s.get("autotune_decisions") or {}).items():
            autotune.setdefault(k, v)
    out["autotune_decisions"] = autotune
    return out


def merge_snapshot_files(paths: list[str]) -> dict:
    snaps = []
    for p in paths:
        with open(p) as fp:
            snaps.append(json.load(fp))
        if not isinstance(snaps[-1], dict):
            raise ValueError(f"{p} is not a snapshot (expected a JSON "
                             "object)")
        if "traceEvents" in snaps[-1]:
            raise ValueError(f"{p} is a trace payload — merge traces "
                             "with --trace-out")
    if not snaps:
        raise ValueError("no snapshot parts to merge")
    # any(), not all(): a process that crashed before dump_metrics leaves
    # its part as the CLI's "{}" writability-probe placeholder — an empty
    # part contributes nothing but must not reroute (or crash) the merge
    # of the parts that did land.
    if any("metrics" in s or "metrics_enabled" in s for s in snaps):
        return merge_unified_snapshots(snaps)
    return merge_snapshots(snaps)


def render_text(metrics_snapshot: dict) -> str:
    """Prometheus text exposition of a (merged) registry snapshot — the
    scrape-format counterpart of ``Registry.render_text()`` for snapshots
    that no longer have a live registry behind them."""
    lines = []
    for name in sorted(metrics_snapshot):
        fam = metrics_snapshot[name]
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        ftype = fam.get("type", "untyped")
        # Prometheus has no native "quantile" type; the closest scrape
        # vocabulary is a summary (pre-computed quantile labels).
        lines.append(
            f"# TYPE {name} {'summary' if ftype == 'quantile' else ftype}"
        )
        for label, v in sorted(fam.get("values", {}).items()):
            if _is_quantile_value(v):
                inner = label[1:-1] if label else ""
                sep = "," if inner else ""
                qs = v.get("quantiles") or _percentile.state_quantiles(v)
                for q, qv in sorted(qs.items(), key=lambda kv: float(kv[0])):
                    if qv is not None:
                        lines.append(
                            f'{name}{{{inner}{sep}quantile="{q}"}} {qv}'
                        )
                lines.append(f"{name}_sum{label} {v.get('sum', 0.0)}")
                lines.append(f"{name}_count{label} {v.get('count', 0)}")
                if v.get("max") is not None:
                    lines.append(f"{name}_max{label} {v['max']}")
            elif _is_histogram_value(v):
                inner = label[1:-1] if label else ""
                sep = "," if inner else ""
                for le, cum in v["buckets"].items():
                    lines.append(
                        f'{name}_bucket{{{inner}{sep}le="{le}"}} {cum}'
                    )
                lines.append(f"{name}_sum{label} {v['sum']}")
                lines.append(f"{name}_count{label} {v['count']}")
            else:
                lines.append(f"{name}{label} {v}")
    return "\n".join(lines) + ("\n" if lines else "")


# -- trace fusion ------------------------------------------------------------


def merge_traces(payloads: list[dict], labels: list[str] | None = None) -> dict:
    """Fuse per-process Chrome-trace payloads into one Perfetto file.

    Each input becomes one process lane: its events keep their thread
    (``tid``) structure but get a distinct ``pid`` (process index + 1),
    and its ``process_name`` metadata is rewritten to identify the host
    (``rs_host``) and process index.  Timestamps are aligned onto a
    shared axis:

    - every part carries ``otherData.rs_epoch`` (the barrier wall clock
      marked after the process group's init barrier) → each part shifts by
      ``(rs_wall_t0 - rs_epoch)``, placing all lanes relative to the
      common barrier;
    - otherwise, parts with ``rs_wall_t0`` align to the earliest part's
      wall clock;
    - with no anchors at all, lanes share t=0 (overlap is approximate).
    """
    if not payloads:
        raise ValueError("no trace parts to merge")
    others = [p.get("otherData", {}) for p in payloads]
    wall = [o.get("rs_wall_t0") for o in others]
    epoch = [o.get("rs_epoch") for o in others]
    if all(e is not None and w is not None for e, w in zip(epoch, wall)):
        offsets = [(w - e) * 1e6 for w, e in zip(wall, epoch)]
    elif all(w is not None for w in wall):
        base = min(wall)
        offsets = [(w - base) * 1e6 for w in wall]
    else:
        offsets = [0.0] * len(payloads)

    events: list[dict] = []
    merged_other: dict = {"rs_merged_parts": len(payloads)}
    for i, payload in enumerate(payloads):
        pid = i + 1
        other = others[i]
        host = other.get("rs_host", "?")
        proc = other.get("rs_process_index", i)
        label = labels[i] if labels else f"p{proc} {host}"
        off = offsets[i]
        saw_process_name = False
        for ev in payload.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            if ev.get("ph") == "M" and ev.get("name") == "process_name":
                base_name = (ev.get("args") or {}).get("name", "")
                ev["args"] = {"name": f"{base_name} [{label}]"}
                saw_process_name = True
            elif "ts" in ev:
                ev["ts"] = ev["ts"] + off
            events.append(ev)
        if not saw_process_name:
            events.append({
                "name": "process_name", "ph": "M", "pid": pid,
                "args": {"name": label},
            })
        merged_other[f"part{i}"] = {"host": host, "process_index": proc,
                                    "offset_us": off}
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": merged_other,
    }


def merge_trace_files(paths: list[str]) -> dict:
    payloads = []
    for p in paths:
        with open(p) as fp:
            payloads.append(json.load(fp))
        if not isinstance(payloads[-1], dict) or \
                "traceEvents" not in payloads[-1]:
            # The mirror of merge_snapshot_files' guard: a snapshot fed
            # to the trace fuser would silently emit an empty-lane file.
            raise ValueError(f"{p} is not a trace payload (no "
                             "traceEvents) — merge snapshots with "
                             "--snapshot-out")
    return merge_traces(payloads)


# -- CLI ---------------------------------------------------------------------


def _resolve_inputs(inputs: list[str]) -> list[str]:
    paths: list[str] = []
    for inp in inputs:
        if _PART_RE.search(inp):  # explicit part file
            if not os.path.exists(inp):
                raise FileNotFoundError(f"part file not found: {inp!r}")
            found = [inp]
        else:
            found = find_parts(inp)
            if not found:
                raise FileNotFoundError(f"no parts found for {inp!r}")
        paths.extend(found)
    return paths


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gpu_rscode_torch.obs.aggregate",
        description="Merge per-process metrics snapshots and/or Chrome "
        "traces from a multi-host run (inputs may be base paths whose "
        ".p<N> parts are discovered).",
    )
    ap.add_argument("inputs", nargs="+", help="part files or base paths")
    ap.add_argument("--snapshot-out", help="write the merged snapshot JSON")
    ap.add_argument("--trace-out", help="write the merged Perfetto JSON")
    ap.add_argument(
        "--text", action="store_true",
        help="with --snapshot-out (or alone): also print the merged "
        "metrics as Prometheus text exposition",
    )
    try:
        args = ap.parse_args(argv)
        if not (args.snapshot_out or args.trace_out or args.text):
            ap.error("pick --snapshot-out, --trace-out and/or --text")
    except SystemExit as e:
        # Same int-return contract as the other rs subcommands: argparse
        # must not raise through a programmatic main() caller.
        return int(e.code or 0)
    try:
        paths = _resolve_inputs(args.inputs)
        print(f"# merging {len(paths)} parts: {', '.join(paths)}",
              file=sys.stderr)
        if args.trace_out:
            merged = merge_trace_files(paths)
            with open(args.trace_out, "w") as fp:
                json.dump(merged, fp)
            print(f"# wrote {args.trace_out}", file=sys.stderr)
        if args.snapshot_out or args.text:
            merged = merge_snapshot_files(paths)
            if args.snapshot_out:
                with open(args.snapshot_out, "w") as fp:
                    json.dump(merged, fp)
                    fp.write("\n")
                print(f"# wrote {args.snapshot_out}", file=sys.stderr)
            if args.text:
                print(render_text(merged.get("metrics", merged)), end="")
    except (OSError, ValueError) as e:
        # Missing/corrupt part files (json.JSONDecodeError is a
        # ValueError) or conflicting metric types: print-and-exit like
        # every other rs subcommand, never a traceback.
        print(f"aggregate: {type(e).__name__}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
