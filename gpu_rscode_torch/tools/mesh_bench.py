"""The sharded GEMM on a mesh of the job's devices: the counterpart of the
JAX package's ``tools/mesh_bench.py``.

Builds a ``(stripe, cols)`` mesh over the job's devices (on the checking
machine one card: a (1, 1) mesh of cuda:0) and dispatches the production
sharded paths, ``parallel.sharded.sharded_gf_matmul``, directly:

* ``cols_cuda``: cols mode, each column shard through K1's folded form
  (``gf_bitslice_kernel``); the JAX tool's ``cols_pallas``.
* ``stripe_cuda``: stripe mode, each k-slice through K1's pre-parity form
  (``gf_popcount_kernel``), the int8 sums added on the device and, across
  processes, all-reduced, then folded; the JAX tool's ``stripe_pallas``.
  On one device it still runs the pre-parity kernel, the narrowing and the
  fold.
* ``cols_bitplane``: cols mode through the plain bit-plane GEMM, for the
  same-shape comparison.

Each mode's output is checked against the GF oracle
(``GaloisField.matmul``) on columns spread over every block K1 launched
before it is timed (CUDA events); a mismatch, a build or a launch error
ends the tool.  One ``{"<mode>": GB/s}`` line a mode after the capture
header, then the JAX tool's summary line (``metric``, ``unit``,
``devices``, ``mb``, ``results``).  Dropped from the JAX tool: its
catch-all around each mode (a refusal there was the TPU compiler's
verdict; here a failure ends the tool).

Usage: python -m gpu_rscode_torch.tools.mesh_bench [--mb 320] [--trials 3]
       [--k 10] [--p 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..models.vandermonde import vandermonde_matrix
from ..obs.runlog import capture_header
from ..ops.gf import get_field
from ..parallel.mesh import make_mesh
from ..parallel.sharded import put_sharded, sharded_gf_matmul
from ..utils.backend import resolve_device
from ._bench_timing import time_device_fn
from ._check import K1_BLOCKS, check_columns, sample_columns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mb", type=int, default=320, help="data MB per call")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(json.dumps(capture_header("mesh_bench")), flush=True)
    k, p = args.k, args.p
    m = (args.mb * 1024 * 1024) // k
    m = (m // 1024) * 1024  # one shape for every mode
    cols_mesh = make_mesh(None, stripe=1, device=device.type)
    n_dev = cols_mesh.devices.size
    stripe_n = n_dev if k % n_dev == 0 else 1
    stripe_mesh = make_mesh(stripe_n, stripe=stripe_n, device=device.type)
    print(f"# mesh bench on {device}: {n_dev} device(s), k={k} p={p} data={k * m / 1e6:.0f} MB "
          f"trials={args.trials}", file=sys.stderr, flush=True)

    A = vandermonde_matrix(p, k)
    rng = np.random.default_rng(0)
    B_host = rng.integers(0, 256, size=(k, m), dtype=np.uint8)
    shard_cols = m // cols_mesh.devices.shape[1]
    cols = sample_columns(m, [shard_cols] + [b for b in K1_BLOCKS if b < shard_cols])
    oracle = get_field(8).matmul(A, B_host[:, cols])

    cases = {
        "cols_cuda": (cols_mesh, False, "cuda"),
        "stripe_cuda": (stripe_mesh, True, "cuda"),
        "cols_bitplane": (cols_mesh, False, "bitplane"),
    }
    results: dict[str, float] = {}
    for name, (mesh, stripe_sharded, strategy) in cases.items():
        Bd = put_sharded(torch.from_numpy(B_host), mesh, stripe_sharded)

        def run(mesh=mesh, stripe_sharded=stripe_sharded, strategy=strategy, Bd=Bd):
            return sharded_gf_matmul(A, Bd, mesh=mesh, w=8, strategy=strategy, stripe_sharded=stripe_sharded)

        check_columns(name, run(), p, m, cols, oracle)
        results[name] = k * m / time_device_fn(run, trials=args.trials) / 1e9
        print(json.dumps({name: results[name]}), flush=True)

    print(json.dumps({"metric": f"mesh_gemm_bandwidth_k{k}_p{p}_{device.type}", "unit": "GB/s", "devices": n_dev,
                      "mb": round(k * m / 1e6), "results": results}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
