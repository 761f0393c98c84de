#!/usr/bin/env python3
"""The JAX package's serving daemon and the port's under the same open loop
on the CPU: does the port keep the offered rate where the reference does?

    JAX_PLATFORMS=cpu PYTHONPATH= python3 tools/daemon_ab_cpu.py \
        --size-kb 1024 --rate 8 --duration 10 --rounds 2

Each package runs in a fresh interpreter of its own, one after the other
(jax, torch, torch, jax, ... for ``--rounds``): a ``ServeDaemon`` at its
default knobs on 127.0.0.1 (the port's on ``device="cpu"``), warmed at the
request size, under ``loadgen.run_open_loop`` with the maint A/B's
foreground (tenants alpha:3 and beta:1, ``decode_frac=0.3``, seed
20260807, k=10, p=4), with ``RS_METRICS=1`` so that the lifecycle ring
stamps every request; ``--autotune`` sets both packages'
``RS_STRATEGY_AUTOTUNE``.  One JSON line a run: offered and achieved req/s,
the open loop's wall, each (tenant, op) cell's samples, p50 and p99, and
the median of each stage (queue wait ``dequeue``, ``batch_formed``,
``dispatch``, ``device_done``, ``drain_done``, ``ack``) per op from the
ring.  The achieved rate is the loadgen's own: requests answered over the
wall from the first arrival to the last answer, so a tail of slow answers
lowers it even where every request was served on time.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile

PACKAGES = {"jax": "gpu_rscode_tpu", "torch": "gpu_rscode_torch"}
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(pkg: str, size: int, rate: float, duration: float) -> int:
    sys.path.insert(0, REPO)
    name = PACKAGES[pkg]
    daemon_mod = importlib.import_module(f"{name}.serve.daemon")
    loadgen = importlib.import_module(f"{name}.serve.loadgen")
    reqtrace = importlib.import_module(f"{name}.obs.reqtrace")
    with tempfile.TemporaryDirectory() as root:
        kwargs = {"device": "cpu"} if pkg == "torch" else {}
        daemon = daemon_mod.ServeDaemon(root, port=0, **kwargs)
        daemon.start()
        try:
            daemon.warm(10, 4, w=8, file_bytes=size)
            report = loadgen.run_open_loop(f"http://127.0.0.1:{daemon.port}", duration_s=duration, rate=rate,
                                           tenants=[("alpha", 3.0), ("beta", 1.0)], size_bytes=size, k=10, p=4,
                                           decode_frac=0.3, seed=20260807, quiet=True)
            events = reqtrace.recent(reqtrace.ring_capacity())
        finally:
            daemon.close(drain=True, timeout=120)
    stages: dict = {}
    for ev in events:
        present = [(s, ev["stages"][s]) for s in reqtrace.STAGES if s in ev["stages"]]
        for (_, a), (stage, b) in zip(present, present[1:]):
            stages.setdefault(ev["op"], {}).setdefault(stage, []).append(1e3 * (b - a))
    summary = report["summary"]
    print(json.dumps({
        "kind": "daemon_ab_cpu", "package": name, "autotune": os.environ.get("RS_STRATEGY_AUTOTUNE"),
        "size_bytes": size, "rate": rate, "duration_s": duration,
        "offered_rps": summary["offered_rps"], "achieved_rps": summary["achieved_rps"],
        "wall_s": summary["duration_s"], "ok": summary["ok"], "failed": summary["failed"],
        "rejected": summary["rejected"],
        "cells": {f"{r['tenant']}:{r['op']}": {"n": r["ok"], "p50_s": r["latency_s"].get("0.5"),
                                               "p99_s": r["latency_s"].get("0.99")} for r in report["tenants"]},
        "stage_p50_ms": {op: {s: statistics.median(v) for s, v in by.items()} for op, by in stages.items()},
    }), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size-kb", type=int, default=1024, help="request body KiB")
    ap.add_argument("--rate", type=float, default=8.0, help="offered req/s")
    ap.add_argument("--duration", type=float, default=10.0, help="open-loop seconds")
    ap.add_argument("--rounds", type=int, default=2, help="runs of each package, in turns")
    ap.add_argument("--autotune", choices=("prior", "measure"), default="prior",
                    help="RS_STRATEGY_AUTOTUNE for both daemons: prior runs each package's plain CPU GEMM "
                         "(bitplane), measure lets each pick its fastest CPU strategy")
    ap.add_argument("--worker", choices=sorted(PACKAGES), default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    size = args.size_kb * 1024
    if args.worker:
        return worker(args.worker, size, args.rate, args.duration)
    env = dict(os.environ, JAX_PLATFORMS="cpu", RS_METRICS="1", RS_STRATEGY_AUTOTUNE=args.autotune)
    for i in range(args.rounds):
        for pkg in (("jax", "torch") if i % 2 == 0 else ("torch", "jax")):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker", pkg,
                                   "--size-kb", str(args.size_kb), "--rate", str(args.rate),
                                   "--duration", str(args.duration)],
                                  capture_output=True, text=True, env=env, timeout=600, cwd=REPO)
            lines = [line for line in proc.stdout.splitlines() if '"daemon_ab_cpu"' in line]
            if proc.returncode != 0 or not lines:
                sys.stderr.write(proc.stderr[-4000:])
                return 1
            print(lines[-1], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
