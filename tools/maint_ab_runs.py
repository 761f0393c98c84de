#!/usr/bin/env python3
"""Repeat chip_smoke.py's maint A/B (phase 5h, step d) on one card and log
its distribution.

    python3 tools/maint_ab_runs.py --runs 8                 # this checkout
    python3 tools/maint_ab_runs.py --runs 8 --tree build/ab/parent --tree .
    python3 tools/maint_ab_runs.py --runs 3 --serve-workers 2 --serve-workers 4

Each run is a fresh interpreter in a tree's root: it builds the kernels
(cached on disk after a tree's first run), calls that tree's
``chip_smoke._maint_ab`` on cuda:0 and prints one JSON line
(``"kind": "maint_ab_run"``): the gate's ratio, whether the gate held, and
for each arm the foreground p50 and p99, offered and achieved req/s, and
the (tenant, op) cell that sets the arm's p99 with the number of samples
behind it.  With several trees, or several ``--serve-workers`` counts
(each run's ``RS_SERVE_WORKERS``, the daemons' executor threads), the
runs alternate over every pair of them (A B, B A, ...).  The
last lines are one summary per tree and nvidia-smi's name and power limit.
Each worker's whole output goes to ``chiprun_out/maint_ab_runs/``.  A run
writes a few GiB (its archives, spools and encodes); the card machine ends
a call whose disk writes pass about 45 GiB, so split many runs over
several calls.

A gate failure is a result here, counted and printed; the smoke itself
still fails on it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

OUT_DIR = os.path.join("chiprun_out", "maint_ab_runs")
FOREGROUND = ("alpha", "beta")


def _arm_stats(report: dict) -> dict:
    """What one arm's open loop gives the gate: its worst foreground
    encode / decode p50 and p99 (loadgen._fg_latency's cells), the cell
    behind the p99 and its sample count, and the arm's rates."""
    cells = [row for row in report["tenants"] if row["tenant"] in FOREGROUND and row["op"] in ("encode", "decode")]
    worst = max(cells, key=lambda row: row["latency_s"].get("0.99") or 0.0)
    summary = report["summary"]
    return {"fg_p50_s": max(row["latency_s"].get("0.5") or 0.0 for row in cells),
            "fg_p99_s": worst["latency_s"].get("0.99"),
            "p99_cell": {"tenant": worst["tenant"], "op": worst["op"], "samples": worst["ok"]},
            "cells": {f"{row['tenant']}:{row['op']}": row["ok"] for row in cells},
            "offered_rps": summary["offered_rps"], "achieved_rps": summary["achieved_rps"],
            "duration_s": summary["duration_s"], "ok": summary["ok"], "failed": summary["failed"]}


def worker(tree: str) -> int:
    tree = os.path.abspath(tree)
    os.chdir(tree)
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from gpu_rscode_torch.serve import loadgen

    chip_smoke.phase_build()
    reports = []
    open_loop = loadgen.run_open_loop

    def keep(*args, **kwargs):
        reports.append(open_loop(*args, **kwargs))
        return reports[-1]

    loadgen.run_open_loop = keep
    os.makedirs(os.path.join(tree, "build"), exist_ok=True)
    work = tempfile.mkdtemp(dir=os.path.join(tree, "build"))
    row = {"kind": "maint_ab_run", "tree": tree, "seconds": chip_smoke.MAINT_AB_SECONDS,
           "rate": chip_smoke.MAINT_AB_RATE, "serve_workers": os.environ.get("RS_SERVE_WORKERS")}
    try:
        res = chip_smoke._maint_ab(work, torch.device("cuda", 0))
        row.update(gate="held", p99_ratio=res["p99_ratio"], converge_wait_s=res["converge_wait_s"])
    except RuntimeError as e:  # the gate's own error: a result of this run
        row.update(gate="failed", error=str(e))
    finally:
        loadgen.run_open_loop = open_loop
    arms = dict(zip(("maint_off", "maint_on"), (_arm_stats(r) for r in reports)))
    row["arms"] = arms
    if len(arms) == 2 and arms["maint_off"]["fg_p99_s"]:
        row["ratio"] = arms["maint_on"]["fg_p99_s"] / arms["maint_off"]["fg_p99_s"]
    print(json.dumps(row), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--runs", type=int, default=8, help="runs of each tree")
    ap.add_argument("--tree", action="append", default=None, help="a checkout's root (default: this one)")
    ap.add_argument("--serve-workers", type=int, action="append", default=None,
                    help="RS_SERVE_WORKERS for a run (repeat to alternate; default: the environment's)")
    ap.add_argument("--worker", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        return worker(args.worker)
    trees = args.tree or [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
    arms = [(tree, n) for tree in trees for n in (args.serve_workers or [None])]
    os.makedirs(OUT_DIR, exist_ok=True)
    rows: dict = {arm: [] for arm in arms}
    for i in range(args.runs):
        for tree, n in arms if i % 2 == 0 else arms[::-1]:
            env = dict(os.environ, **({"RS_SERVE_WORKERS": str(n)} if n else {}))
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", tree],
                                  capture_output=True, text=True, timeout=900, env=env)
            name = f"{os.path.basename(os.path.abspath(tree)) or 'tree'}{f'-w{n}' if n else ''}-{i}"
            with open(os.path.join(OUT_DIR, f"{name}.log"), "w") as fp:
                fp.write(proc.stdout + proc.stderr)
            got = [json.loads(line) for line in proc.stdout.splitlines()
                   if line.startswith("{") and '"maint_ab_run"' in line]
            if proc.returncode != 0 or not got:
                print(json.dumps({"kind": "maint_ab_run", "tree": tree, "run": i, "rc": proc.returncode,
                                  "stderr_tail": proc.stderr[-2000:]}), flush=True)
                return 1
            got[0]["run"] = i
            rows[(tree, n)].append(got[0])
            print(json.dumps(got[0]), flush=True)
    for (tree, n), runs in rows.items():
        ratios = sorted(r.get("ratio") for r in runs if r.get("ratio") is not None)
        print(json.dumps({"kind": "maint_ab_summary", "tree": tree, "serve_workers": n, "runs": len(runs),
                          "failed": sum(r["gate"] == "failed" for r in runs), "ratios": ratios,
                          "samples_behind_worst_p99": sorted({r["arms"][a]["p99_cell"]["samples"]
                                                              for r in runs for a in r["arms"]})}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
