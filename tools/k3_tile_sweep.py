#!/usr/bin/env python3
"""Time one K3 instance at several tiles (columns a CUDA block covers) on
one card.

    python3 tools/k3_tile_sweep.py --w 8 --expand shift_raw --refold none
    python3 tools/k3_tile_sweep.py --w 16 --expand shift_raw --refold sum --tiles 2048,8192,32768

The data is the main path's encode segment: k=10, p=4 (the codec's parity
block) and 64 MiB of seeded symbols, m rounded down to a multiple of 128
columns as the segment loop does (m = 6,710,784 at w=8, 3,355,392 at
w=16), unless --k, --p, --mb or --cols say otherwise (--cols: m itself,
e.g. an odd m for the byte-wise copies of rows that do not start 16-byte
aligned).  Each tile's output is first
checked against the plain version (tolerance 0), then timed with CUDA
events (--iters launches, best of --reps).  One JSON line a tile: its ms,
blocks, the launch's route (cuda_planes.route) and the bytes bound; the
last line is nvidia-smi's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpu_rscode_torch.codec import RSCodec  # noqa: E402
from gpu_rscode_torch.ops import cuda_planes  # noqa: E402
from gpu_rscode_torch.ops.gemm import _widen  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # the H100 SXM's HBM3 rate (chip_smoke.py's)


def time_ms(fn, iters: int, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--w", type=int, default=8, choices=(4, 8, 16))
    ap.add_argument("--expand", default="shift_raw")
    ap.add_argument("--refold", default="none", choices=tuple(cuda_planes.REFOLDS))
    ap.add_argument("--tiles", default="1024,2048,4096,8192,16384,32768")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--mb", type=int, default=64, help="MiB of data (k rows)")
    ap.add_argument("--cols", type=int, default=None, help="m, the columns (default: from --mb)")
    ap.add_argument("--iters", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    device = torch.device("cuda", 0)
    sym = 2 if args.w == 16 else 1
    m = args.cols or (args.mb << 20) // (args.k * sym) // 128 * 128
    gen = torch.Generator(device=device)
    gen.manual_seed(20261018)
    A = RSCodec(args.k, args.p, w=args.w, device=device).parity_block
    B = torch.randint(0, 1 << max(args.w, 8), (args.k, m), dtype=torch.int32, device=device, generator=gen)
    B = B.to(torch.int16).view(torch.uint16) if args.w == 16 else B.to(torch.uint8)
    out_bytes = 4 * args.p * args.w if args.refold == "none" else args.p * sym
    bound = 1e3 * (args.k * sym + out_bytes) * m / HBM_BYTES_PER_S
    want = _widen(cuda_planes.gf_matmul_planes_plain(A, B, args.expand, args.refold, w=args.w))
    for tile in (int(t) for t in args.tiles.split(",")):
        fn = lambda: cuda_planes.gf_matmul_planes(A, B, args.expand, args.refold, tile, w=args.w)  # noqa: E731
        err = int((_widen(fn()) - want).abs().max().item())
        if err:
            raise SystemExit(f"tile {tile}: kernel != plain (max err {err})")
        t = cuda_planes.tile_cols(tile, m)
        print(json.dumps({"kind": "k3_tile", "w": args.w, "expand": args.expand, "refold": args.refold, "k": args.k,
                          "p": args.p, "m": m, "tile": t, "blocks": -(-m // t),
                          "route": cuda_planes.route(args.k, args.p, args.expand, args.refold, args.w),
                          "ms": time_ms(fn, args.iters, args.reps), "bound_ms": bound, "max_abs_err": err}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
