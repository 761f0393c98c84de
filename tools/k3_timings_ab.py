#!/usr/bin/env python3
"""Run chip_smoke.py's phase 9 (the K2 and K3 kernel timings) in two trees
on one card, in turns, and compare rows by label.

    git archive <parent> | tar -x -C build/ab/parent
    python3 tools/k3_timings_ab.py --tree build/ab/parent --tree .
    python3 tools/k3_timings_ab.py --tree build/ab/parent --tree . --labels "w16 shift_raw+sum,shift_raw+none"
    python3 tools/k3_timings_ab.py --tree build/ab/parent --tree . --time "w16 shift_raw+none,w4 shift+sum"

Each run is a fresh interpreter in a tree's root that imports that tree's
own ``chip_smoke`` (and with it that tree's kernels, built on first use
into the tree's git-ignored build directory) and calls its
``phase_new_timings`` on cuda:0.  ``--time`` adds, in the same process,
instances timed straight through the tree's
``cuda_planes.gf_matmul_planes`` at phase 9's shapes (k=10, p=4, the
encode segment; half its columns at w=16), each checked against its plain
version first: a label the parent's phase 9 lacks gets a parent figure
too.  Those rows are summed up as ``direct <label>``.  The trees run in
the order A B B A (or A B ... B A for --rounds above 1).  Every row is
kept; the last lines are one JSON summary per label (each tree's ms in run
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
DEFAULT_LABELS = ("w4 shift+sum", "w4 shift_raw+sum", "w4 shift+dot", "w4 shift_raw+dot", "w4 shift+none",
                  "w4 shift_raw+none", "w16 shift+none", "w16 shift_raw+none", "w16 sign+none", "w16 shift+sum",
                  "w16 shift_raw+sum", "w16 shift_raw+dot", "shift_raw+none", "shift+sum", "shift_raw+dot")
RUN = ("import sys, torch; sys.path.insert(0, '.'); import chip_smoke as s; "
       "s.phase_new_timings(torch.device('cuda', 0))")
# Loads this file in the tree's process for --time.
RUN_DIRECT = ("; import importlib.util as u; spec = u.spec_from_file_location('k3ab', {path!r}); "
              "ab = u.module_from_spec(spec); spec.loader.exec_module(ab); ab.time_instances(s, {labels!r})")


def time_instances(smoke, labels: list[str]) -> None:
    """Time each ``[w4 |w16 ]expand+refold`` label through the tree's
    ``cuda_planes.gf_matmul_planes`` at phase 9's shapes, after checking it
    against the plain version; prints one ``kernel_timing_direct`` JSON row
    a label.  ``smoke``: the tree's chip_smoke module."""
    import torch

    from gpu_rscode_torch.ops import cuda_planes

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(smoke.SEED + 9)
    k, p = 10, 4
    for label in labels:
        width, pair = label.split(" ") if label.startswith(("w4 ", "w16 ")) else ("w8", label)
        w = int(width[1:])
        expand, refold = pair.split("+")
        m = smoke.SEGMENT_COLS // 2 if w == 16 else smoke.SEGMENT_COLS
        A = smoke.RSCodec(k, p, w=w, device=dev).parity_block
        B = smoke._rand_u16(gen, (k, m), dev) if w == 16 else smoke._rand_u8(gen, (k, m), dev)

        def run():
            return cuda_planes.gf_matmul_planes(A, B, expand, refold, w=w)

        def wide(x):
            return x.view(torch.int16).to(torch.int64) if x.dtype == torch.uint16 else x.to(torch.int64)

        err = int((wide(run()) - wide(cuda_planes.gf_matmul_planes_plain(A, B, expand, refold, w=w))).abs().max())
        if err:
            raise SystemExit(f"{label}: the kernel differs from its plain version by {err}")
        print(json.dumps({"phase": "kernel_timing_direct", "label": label, "shape": f"k={k} p={p} m={m} w={w}",
                          "ms": smoke.time_ms(run, iters=100, reps=3), "max_abs_err": err}), flush=True)


def run_tree(tree: str, index: int, direct: list[str]) -> list[dict]:
    """Phase 9 in ``tree`` (and the ``direct`` labels); returns its rows."""
    code = RUN + (RUN_DIRECT.format(path=os.path.abspath(__file__), labels=direct) if direct else "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True)
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
            if row.get("phase") in ("kernel_timing", "kernel_timing_direct"):
                rows.append(row)
    return rows


def label_of(row: dict) -> str:
    if row["phase"] == "kernel_timing_direct":
        return f"direct {row['label']}"
    return row["shape"].split("(", 1)[1].rsplit(")", 1)[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tree", action="append", required=True, help="a tree's root (give two)")
    ap.add_argument("--rounds", type=int, default=1, help="A B B A repeated this many times")
    ap.add_argument("--labels", default=",".join(DEFAULT_LABELS), help="comma-separated phase-9 labels to sum up")
    ap.add_argument("--time", default="", help="comma-separated labels to time through gf_matmul_planes in both trees")
    args = ap.parse_args()
    if len(args.tree) != 2:
        raise SystemExit("give two --tree")
    direct = [label for label in args.time.split(",") if label]
    os.makedirs(OUT_DIR, exist_ok=True)
    order = [0, 1, 1, 0] * args.rounds
    ms: dict[str, list[list[float]]] = {}
    for i, t in enumerate(order):
        for row in run_tree(args.tree[t], i, direct):
            print(json.dumps({"kind": "k3_timing", "tree": args.tree[t], "run": i, **row}), flush=True)
            ms.setdefault(label_of(row), [[], []])[t].append(row["ms"])
    for label in [*args.labels.split(","), *(f"direct {d}" for d in direct)]:
        a, b = ms.get(label, [[], []])
        best = [min(x) if x else None for x in (a, b)]
        print(json.dumps({"kind": "k3_timing_ab", "label": label, "trees": args.tree, "ms": [a, b], "best": best,
                          "ratio": best[1] / best[0] if all(best) else None}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
