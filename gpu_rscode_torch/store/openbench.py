"""``rs object openbench`` — bucket open-cost A/B: snapshot+tail vs
full log replay (docs/STORE.md "Index snapshots & segments").

The snapshot plane's claim is O(segments-since-snapshot) open instead
of O(total-index-history).  This harness measures it honestly: build
ONE overwrite-heavy bucket (``--puts`` PUTs over ``--keys`` distinct
keys — the workload whose log grows without bound while the live set
does not) with pruning disabled, so the SAME on-disk history can be
opened both ways:

* **snapshot arm** — the default open ladder: newest valid snapshot +
  sealed-segment tail + active-log replay.
* **full_replay arm** — ``RS_STORE_SNAPSHOT_DISABLE=1``: the read-side
  seam ignores every snapshot and folds the complete segment chain
  from record one.

Both arms open the IDENTICAL bytes (best of ``--trials``, bucket cache
dropped before each open — the process-restart seam), and a sample of
objects is byte-verified against an in-memory mirror under EACH arm, so
a fast open that loaded a wrong index cannot score.  The margin row records the speedup and the tail-replay bound
(``records_replayed <= --snapshot-records`` on the snapshot arm).

Build-phase pruning is disabled (``RS_STORE_SNAPSHOT_KEEP`` huge) —
the full-replay arm is only meaningful while the segment chain is
contiguous from 1; a production bucket prunes and simply cannot fall
that far down the ladder.
"""

from __future__ import annotations

import json
import os
import random
import sys
import time

from ..obs import runlog as _runlog
from ..obs.percentile import quantile_of


def _build(root: str, bucket: str, *, puts: int, keys: int, batch: int,
           object_bytes: int, k: int, p: int, w: int,
           seed: int, quiet: bool, device) -> dict:
    """The overwrite-heavy corpus: ``puts`` PUTs round-robin+random over
    ``keys`` keys, batched ``batch`` per group commit.  Returns the
    final expected payload per key (the verification mirror)."""
    from . import open_bucket

    rng = random.Random(seed)
    b = open_bucket(root, bucket, create=True, k=k, p=p, w=w,
                    stripe_bytes=1 << 30,  # one open stripe: the A/B
                    device=device)
    # measures index replay, not archive-count effects
    mirror: dict[str, bytes] = {}
    done = 0
    t0 = time.monotonic()
    while done < puts:
        n = min(batch, puts - done)
        items = []
        for i in range(n):
            # First pass touches every key (the live set), then the
            # zipf-free uniform overwrite churn that bloats the log.
            idx = (done + i) if done + i < keys \
                else rng.randrange(keys)
            key = f"k{idx:06d}"
            data = rng.randbytes(max(1, object_bytes))
            items.append((key, data))
            mirror[key] = data
        b.put_many(items)
        done += n
        if not quiet and done % (batch * 40) == 0:
            print(f"rs object openbench: {done}/{puts} puts "
                  f"({time.monotonic() - t0:.1f}s)", file=sys.stderr)
    return mirror


def _open_arm(root: str, bucket: str, arm: str, trials: int,
              mirror: dict, sample: int, seed: int, device) -> dict:
    """Time ``trials`` cold opens (bucket cache dropped — the process
    restart seam) and byte-verify ``sample`` mirror keys once."""
    from . import drop_cached, open_bucket

    walls, report = [], {}
    for _ in range(max(1, trials)):
        drop_cached()
        t0 = time.monotonic()
        b = open_bucket(root, bucket, device=device)
        report = b.open_report  # forces the load
        walls.append(time.monotonic() - t0)
    rng = random.Random(seed ^ 0x5A11)
    for key in rng.sample(sorted(mirror), min(sample, len(mirror))):
        if b.get(key) != mirror[key]:
            raise RuntimeError(
                f"{arm} arm byte verification failed at {key!r}")
    return {
        "kind": "store_open_ab", "arm": arm,
        "open_wall_s": round(min(walls), 6),
        "trial_walls_s": [round(wl, 6) for wl in walls],
        "open_p50_s": round(quantile_of(walls, 0.5), 6),
        "source": report.get("source"),
        "snapshot": report.get("snapshot"),
        "segments_replayed": report.get("segments_replayed"),
        "records_replayed": report.get("records_replayed"),
        "verified": True,
    }


def main(argv=None) -> int:
    import argparse
    import tempfile

    ap = argparse.ArgumentParser(
        prog="rs object openbench",
        description="Bucket open-cost A/B: snapshot+tail open vs full "
        "index-log replay over the same on-disk history "
        "(docs/STORE.md).",
    )
    ap.add_argument("--puts", type=int, default=100_000,
                    help="total PUTs (default 100000)")
    ap.add_argument("--keys", type=int, default=10_000,
                    help="distinct keys — live set size (default 10000)")
    ap.add_argument("--batch", type=int, default=250,
                    help="PUTs per group commit (default 250)")
    ap.add_argument("--object-bytes", type=int, default=64,
                    help="payload size (default 64 — the A/B measures "
                    "index replay, not data volume)")
    ap.add_argument("--trials", type=int, default=3,
                    help="cold opens per arm, best wall wins (default 3)")
    ap.add_argument("--sample", type=int, default=64,
                    help="objects byte-verified per arm (default 64)")
    ap.add_argument("--snapshot-records", type=int, default=8192,
                    help="RS_STORE_SNAPSHOT_RECORDS for the build "
                    "(default 8192 — the shipped default)")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--w", type=int, default=8, choices=(8, 16))
    ap.add_argument("--seed", type=int, default=20260806)
    ap.add_argument("--workdir", default=None,
                    help="build directory (default: a temp dir)")
    ap.add_argument("--capture", default=None,
                    help="capture JSONL path (default bench_captures/"
                    "store_open_ab_<ts>.jsonl; '-' disables)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default=None,
                    help="where the bucket's GEMMs run (default cuda; cpu "
                    "runs the plain PyTorch path)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    if args.keys <= 0 or args.puts < args.keys:
        print("rs object openbench: need --puts >= --keys > 0",
              file=sys.stderr)
        return 2

    # Build with pruning parked: the full-replay arm needs the segment
    # chain contiguous from 1 (module doc), and the read-side disable
    # seam refuses anything less — loudly, not wrongly.
    env_saved = {name: os.environ.get(name) for name in (
        "RS_STORE_SNAPSHOT_KEEP", "RS_STORE_SNAPSHOT_RECORDS",
        "RS_STORE_SNAPSHOT_DISABLE")}
    os.environ["RS_STORE_SNAPSHOT_KEEP"] = str(1 << 30)
    os.environ["RS_STORE_SNAPSHOT_RECORDS"] = str(args.snapshot_records)
    os.environ.pop("RS_STORE_SNAPSHOT_DISABLE", None)

    tmp_ctx = None
    workdir = args.workdir
    if workdir is None:
        tmp_ctx = tempfile.TemporaryDirectory(prefix="rs_openbench_")
        workdir = tmp_ctx.name
    try:
        t0 = time.monotonic()
        mirror = _build(workdir, "openbench", puts=args.puts,
                        keys=args.keys, batch=max(1, args.batch),
                        object_bytes=args.object_bytes, k=args.k,
                        p=args.p, w=args.w, seed=args.seed,
                        quiet=args.json, device=args.device)
        build_s = time.monotonic() - t0

        row_snap = _open_arm(workdir, "openbench", "snapshot",
                             args.trials, mirror, args.sample,
                             args.seed, args.device)
        os.environ["RS_STORE_SNAPSHOT_DISABLE"] = "1"
        try:
            row_full = _open_arm(workdir, "openbench", "full_replay",
                                 args.trials, mirror, args.sample,
                                 args.seed, args.device)
        finally:
            os.environ.pop("RS_STORE_SNAPSHOT_DISABLE", None)
        from . import drop_cached

        drop_cached()
    finally:
        for name, val in env_saved.items():
            if val is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = val
        if tmp_ctx is not None:
            tmp_ctx.cleanup()

    speedup = (row_full["open_wall_s"] / row_snap["open_wall_s"]
               if row_snap["open_wall_s"] else None)
    margin = {
        "kind": "store_open_ab_margin",
        "puts": args.puts, "keys": args.keys, "batch": args.batch,
        "object_bytes": args.object_bytes,
        "snapshot_records": args.snapshot_records,
        "trials": max(1, args.trials),
        "build_wall_s": round(build_s, 3),
        "snapshot_open_s": row_snap["open_wall_s"],
        "full_replay_open_s": row_full["open_wall_s"],
        "speedup": round(speedup, 2) if speedup else None,
        "tail_records": row_snap["records_replayed"],
        "tail_bounded": (row_snap["records_replayed"] is not None
                         and row_snap["records_replayed"]
                         <= args.snapshot_records),
        "full_records": row_full["records_replayed"],
        "config": {"k": args.k, "p": args.p, "w": args.w,
                   "seed": args.seed},
    }
    rows = [row_snap, row_full, margin]
    if not args.json:
        print(f"rs object openbench: open {row_full['open_wall_s']:.3f}s "
              f"(full replay, {row_full['records_replayed']} records) vs "
              f"{row_snap['open_wall_s']:.3f}s (snapshot + "
              f"{row_snap['records_replayed']}-record tail) -> "
              f"{speedup:.1f}x over {args.puts} puts", file=sys.stderr)

    capture = args.capture
    if capture is None:
        os.makedirs("bench_captures", exist_ok=True)
        stamp = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        capture = os.path.join(
            "bench_captures", f"store_open_ab_{stamp}.jsonl")
    if capture != "-":
        with open(capture, "w") as fp:
            fp.write(json.dumps(_runlog.capture_header("store_open_ab"))
                     + "\n")
            for row in rows:
                fp.write(json.dumps(row) + "\n")
        print(f"rs object openbench: capture -> {capture}",
              file=sys.stderr)
    if args.json:
        print(json.dumps({"rows": rows, "capture": capture}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
