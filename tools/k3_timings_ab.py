#!/usr/bin/env python3
"""Run chip_smoke.py's phase 9 (the K2 and K3 kernel timings) in two trees
on one card, in turns, and compare rows by label.

    git archive <parent> | tar -x -C build/ab/parent
    python3 tools/k3_timings_ab.py --tree build/ab/parent --tree .
    python3 tools/k3_timings_ab.py --tree build/ab/parent --tree . --labels "w16 shift_raw+sum,shift_raw+none"

Each run is a fresh interpreter in a tree's root that imports that tree's
own ``chip_smoke`` (and with it that tree's kernels, built on first use
into the tree's git-ignored build directory) and calls its
``phase_new_timings`` on cuda:0.  The trees run in the order A B B A (or
A B ... B A for --rounds above 1).  Every ``kernel_timing`` row is kept;
the last lines are one JSON summary per label (each tree's ms in run
order, its best, and the ratio of the bests, tree 2 over tree 1) and
nvidia-smi's name and power limit.  Each run's whole output goes to
``chiprun_out/k3_timings_ab/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

OUT_DIR = os.path.join("chiprun_out", "k3_timings_ab")
DEFAULT_LABELS = ("w16 shift+sum", "w16 shift+dot", "w16 shift_raw+sum", "w16 shift_raw+dot", "w16 sign+sum",
                  "w16 sign+dot", "shift+none", "shift_raw+none", "cmp+none", "sign+none", "nibble+none",
                  "shift+sum", "shift_raw+dot")
RUN = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as s; "
       "s.phase_new_timings(torch.device('cuda', 0))")


def run_tree(tree: str, index: int) -> list[dict]:
    """Phase 9 in ``tree``; returns its kernel_timing rows."""
    proc = subprocess.run([sys.executable, "-c", RUN], cwd=tree, capture_output=True, text=True)
    name = f"run{index:02d}_{os.path.basename(os.path.abspath(tree)) or 'tree'}.log"
    with open(os.path.join(OUT_DIR, name), "w") as fp:
        fp.write(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"phase 9 failed in {tree} (exit {proc.returncode}); see {OUT_DIR}/{name}:\n"
                         + proc.stderr[-4000:])
    rows = []
    for line in proc.stdout.splitlines():
        if line.startswith("{"):
            row = json.loads(line)
            if row.get("phase") == "kernel_timing":
                rows.append(row)
    return rows


def label_of(row: dict) -> str:
    return row["shape"].split("(", 1)[1].rsplit(")", 1)[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tree", action="append", required=True, help="a tree's root (give two)")
    ap.add_argument("--rounds", type=int, default=1, help="A B B A repeated this many times")
    ap.add_argument("--labels", default=",".join(DEFAULT_LABELS), help="comma-separated phase-9 labels to sum up")
    args = ap.parse_args()
    if len(args.tree) != 2:
        raise SystemExit("give two --tree")
    os.makedirs(OUT_DIR, exist_ok=True)
    order = [0, 1, 1, 0] * args.rounds
    ms: dict[str, list[list[float]]] = {}
    for i, t in enumerate(order):
        for row in run_tree(args.tree[t], i):
            print(json.dumps({"kind": "k3_timing", "tree": args.tree[t], "run": i, **row}), flush=True)
            ms.setdefault(label_of(row), [[], []])[t].append(row["ms"])
    for label in args.labels.split(","):
        a, b = ms.get(label, [[], []])
        best = [min(x) if x else None for x in (a, b)]
        print(json.dumps({"kind": "k3_timing_ab", "label": label, "trees": args.tree, "ms": [a, b], "best": best,
                          "ratio": best[1] / best[0] if all(best) else None}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
