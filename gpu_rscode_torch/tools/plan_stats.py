"""Execution-plan cache inspector: the counterpart of the JAX package's
``tools/plan_stats.py``, over :func:`..obs.metrics.unified_snapshot`.

Runs a synthetic multi-tail encode workload (files whose chunk sizes give
different tail-segment widths, the shapes the bucket ladder folds into
few plans) and dumps the unified snapshot: the plan cache's counters and
plans and, under ``RS_METRICS=1``, the metrics registry.  The last stdout
line is one JSON object; ``--no-workload`` dumps what the process has
without encoding.  ``rs stats --workload`` runs the same
:func:`run_workload`.  ``mesh_registered`` counts the mesh plan cache's
entries and ``autotune_decisions`` the refold="autotune" decisions.

Usage: python -m gpu_rscode_torch.tools.plan_stats \
           [--k 4] [--p 2] [--seg-kb 4] [--tails 520 652 776 1000] [--w 8] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np


def _ladder_bound(seg_cols: int) -> int:
    """Most distinct buckets one segment loop can produce under one cap,
    counted with :func:`..plan.bucket_cols` itself."""
    from .. import plan

    return len({plan.bucket_cols(m, seg_cols) for m in range(1, seg_cols + 1)})


def _seg_cols(k: int, seg_bytes: int, w: int) -> int:
    """The segment width in symbols the encode derives (the synthetic
    chunks are wider than one segment, so the 128-column alignment
    applies)."""
    from .. import api

    return api._segment_cols(1 << 62, k, seg_bytes) // (w // 8)


def run_workload(k: int = 4, p: int = 2, seg_bytes: int = 4096, tails=(520, 652, 776, 1000), w: int = 8,
                 device=None) -> int:
    """Clear the plan cache and encode one synthetic multi-tail file per
    tail width on ``device`` (None: the card).  Returns the segment width
    the workload's plan caps derive from."""
    from .. import api, plan

    sym = w // 8
    seg_cols = _seg_cols(k, seg_bytes, w)
    plan.PLAN_CACHE.clear()
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory() as d:
        for tail in tails:
            chunk = (2 * seg_cols + tail) * sym
            path = os.path.join(d, f"t{tail}.bin")
            with open(path, "wb") as fp:
                fp.write(rng.integers(0, 256, size=k * chunk, dtype=np.uint8).tobytes())
            api.encode_file(path, k, p, segment_bytes=seg_bytes, w=w, device=device)
    return seg_cols


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m gpu_rscode_torch.tools.plan_stats")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--seg-kb", type=int, default=4, help="segment_bytes in KiB (small => many segments)")
    ap.add_argument("--tails", type=int, nargs="+", default=[520, 652, 776, 1000],
                    help="tail widths (cols) to synthesize, one file each")
    ap.add_argument("--w", type=int, default=8, choices=(8, 16))
    ap.add_argument("--no-workload", action="store_true", help="dump current process stats without encoding")
    ap.add_argument("--device", default=None, help="where the workload runs (default: the CUDA device)")
    args = ap.parse_args(argv)

    from ..obs import metrics as obs_metrics

    seg_bytes = args.seg_kb * 1024
    if args.no_workload:
        seg_cols = _seg_cols(args.k, seg_bytes, args.w)
    else:
        seg_cols = run_workload(args.k, args.p, seg_bytes, tuple(args.tails), args.w, device=args.device)

    snap = obs_metrics.unified_snapshot()
    stats = snap["plan_cache"]
    encode_execs = [pl for pl in stats["plans"] if pl["a_shape"] == [args.p, args.k]]
    out = {
        "metric": "plan_cache_stats",
        "stats": stats,
        "encode_executables": len(encode_execs),
        "ladder_bound": _ladder_bound(seg_cols),
        "mesh_registered": snap["mesh_plan_cache"]["executables"],
        "autotune_decisions": len(snap["autotune_decisions"]),
        "metrics_enabled": snap["metrics_enabled"],
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
