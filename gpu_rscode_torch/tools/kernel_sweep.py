"""Kernel formulation sweep on the card: the counterpart of the JAX
package's ``tools/kernel_sweep.py``.

Measures, at K=10, P=4, W=8 on ``--mb`` MB of seeded data:

- each body's GEMM throughput (GB/s of input data) across tile sizes, a
  tile being the columns one CUDA block covers;
- the copy floor (``dma_floor``: the kernel brings each whole (k, tile)
  block on chip and writes rows 0..p-1, K1's traffic with no compute) and
  the compute-only ceiling (``compute_only[<body>]``: every block reads
  block 0, so the input comes from L2), both at the best tile.

Every body runs on K3 (``ops/csrc/gf_planes.cu``) with the expansion and
refold of the JAX body of the same name.  The output of each timed call
is first checked against the GF oracle (``B[:P]`` for the copy floor) on
columns spread over every block; a mismatch, a build or a launch error ends
the tool with a non-zero exit.

Output, one JSON object per line: the capture header, one
``{"<body>@<tile>": GB/s}`` per measurement, the two floors, then
``{"mb": ..., "results": {...}}``.

Usage: python -m gpu_rscode_torch.tools.kernel_sweep [--mb 64] [--trials 2]
       [--tiles 8192,16384,32768,65536] [--bodies ...] [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.vandermonde import vandermonde_matrix
from ..obs.runlog import capture_header
from ..ops import cuda_planes
from ..ops.gf import get_field
from ..utils.backend import resolve_device
from ._bench_timing import time_device_fn
from ._check import check_columns, sample_columns

K, P, W = 10, 4, 8

# Body -> (expand, refold) of K3's GEMM; "dma" is the copy floor.
BODIES = {
    "base": ("shift", "sum"),
    "cmp": ("cmp", "sum"),
    "dma": None,
    "sign": ("sign", "sum"),
    "signc": ("sign", "sum"),
    "signf": ("sign", "dot"),
    "nibble": ("nibble", "sum"),
    "raw_dot": ("shift_raw", "dot"),
}


def make_fn(name: str, A: np.ndarray, B: torch.Tensor, tile: int, pinned: bool = False):
    """The thunk that runs body ``name`` once over all of ``B``."""
    if BODIES[name] is None:
        return lambda: cuda_planes.copy_floor(B, P, tile)
    expand, refold = BODIES[name]
    return lambda: cuda_planes.gf_matmul_planes(A, B, expand, refold, tile, pinned=pinned)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mb", type=int, default=64, help="stripe data MB")
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--tiles", type=str, default="8192,16384,32768,65536")
    ap.add_argument("--bodies", type=str, default="base,cmp,sign,signc,signf,nibble,raw_dot",
                    help="comma-separated subset of kernel bodies to sweep")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    bodies = [b.strip() for b in args.bodies.split(",") if b.strip()]
    unknown = [b for b in bodies if b not in BODIES]
    if unknown:
        ap.error(f"unknown --bodies {unknown}; choose from {sorted(BODIES)}")
    tiles = [int(t) for t in args.tiles.split(",")]
    device = resolve_device(args.device)

    print(json.dumps(capture_header("kernel_sweep")), flush=True)
    m = args.mb * 1024 * 1024 // K
    m = (m // 512) * 512
    A = vandermonde_matrix(P, K)
    rng = np.random.default_rng(0)
    B_host = rng.integers(0, 256, size=(K, m), dtype=np.uint8)
    B = torch.from_numpy(B_host).to(device)
    gf = get_field(W)
    cols = sample_columns(m, [cuda_planes.tile_cols(t, m) for t in tiles])
    oracle, copied = gf.matmul(A, B_host[:, cols]), B_host[:P, cols]
    data_bytes = K * m

    results: dict[str, float] = {}
    for name in bodies:
        want = copied if BODIES[name] is None else oracle
        for tile in tiles:
            key = f"{name}@{tile}"
            fn = make_fn(name, A, B, tile)
            check_columns(key, fn(), P, m, cols, want)
            results[key] = data_bytes / time_device_fn(fn, trials=args.trials) / 1e9
            print(json.dumps({key: results[key]}), flush=True)

    def tile_best(t):
        return max((results[f"{b}@{t}"] for b in bodies), default=0.0)

    best_tile = max(tiles, key=tile_best)
    # The ceiling is measured on the production formulation when the sweep
    # includes it, else on "base".
    ceiling_body = "raw_dot" if "raw_dot" in bodies else "base"
    for name, pinned in (("dma", False), (ceiling_body, True)):
        key = "dma_floor" if name == "dma" else f"compute_only[{name}]"
        fn = make_fn(name, A, B, best_tile, pinned=pinned)
        # Pinned, every block computes on block 0: column c holds the
        # product of column c mod the block width.
        block0 = min(cuda_planes.tile_cols(best_tile, m), m)
        want = copied if name == "dma" else gf.matmul(A, B_host[:, cols % block0])
        check_columns(key, fn(), P, m, cols, want)
        results[key] = data_bytes / time_device_fn(fn, trials=args.trials) / 1e9
        print(json.dumps({key: results[key]}), flush=True)

    print(json.dumps({"mb": args.mb, "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
