"""What a mesh adds to each segment: the counterpart of the JAX package's
``tools/mesh_overhead.py``.

The file layer pays, for each segment it runs on a mesh, the placement of
the segment on the mesh (``parallel.sharded.put_sharded``) and the sharded
dispatch (``sharded_gf_matmul``).  This tool times both on the job's mesh
(one card: a (1, 1) mesh of cuda:0) against the single-device path (the
copy to the device and K1's own dispatch, ``gf_matmul_cuda``), at a tiny
and a large segment, each call ended by a synchronise (best of
``--trials``, host clock), in three modes: ``single``, ``cols`` (K1
folded on each column shard) and ``stripe`` (K1's pre-parity form on each
k-slice, the int8 sums reduced, then folded).

Rows, after the capture header, with the JAX tool's keys: one a mode with
``put_ms[<mb>mb]`` and ``dispatch_ms[<mb>mb]`` for each size,
``dispatches_per_s_tiny`` and, for stripe mode,
``psum_bytes_per_seg_per_dev`` (the int8 partials of the large segment,
p * 8 bytes a column); then one ``mesh_overhead_ratio`` row for each mesh
mode (``overhead_vs_single``, ``put_vs_single`` at the tiny size).  Every
dispatch's output is checked against the GF oracle on columns spread over
every K1 block before it is timed.

Usage: python -m gpu_rscode_torch.tools.mesh_overhead [--mb 1 32]
       [--trials 3] [--k 10] [--p 4] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np
import torch

from ..models.vandermonde import vandermonde_matrix
from ..obs.runlog import capture_header
from ..ops.cuda_gemm import gf_matmul_cuda
from ..ops.gf import get_field
from ..parallel.mesh import make_mesh
from ..parallel.sharded import put_sharded, sharded_gf_matmul
from ..utils.backend import resolve_device
from ._bench_timing import best_host_seconds
from ._check import K1_BLOCKS, check_columns, sample_columns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mb", type=int, nargs=2, default=[1, 32], help="tiny and large segment sizes (MB)")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(json.dumps(capture_header("mesh_overhead")), flush=True)
    k, p = args.k, args.p
    mesh = make_mesh(None, stripe=1, device=device.type)
    n_dev = mesh.devices.size
    stripe_n = math.gcd(k, n_dev)
    stripe_mesh = make_mesh(n_dev, stripe=stripe_n, device=device.type)
    home = mesh.home
    print(f"# mesh overhead on {device}: {n_dev} device(s), k={k} p={p} segments {args.mb} MB, "
          f"stripe axis {stripe_n}, trials={args.trials}", file=sys.stderr, flush=True)

    rng = np.random.default_rng(0)
    A = vandermonde_matrix(p, k)
    gf = get_field(8)
    rows = []
    for mode, msh, stripe_sharded in (("single", None, False), ("cols", mesh, False), ("stripe", stripe_mesh, True)):
        row = {"metric": f"mesh_overhead_{device.type}", "mode": mode, "devices": 1 if msh is None else n_dev}
        for mb in args.mb:
            m = max(1, mb * 1024 * 1024 // k // 128) * 128
            B = torch.from_numpy(rng.integers(0, 256, size=(k, m), dtype=np.uint8))
            if msh is None:
                def put(B=B):
                    return B.to(home)

                def dispatch(Bd):
                    return gf_matmul_cuda(A, Bd, 8)
            else:
                def put(B=B, msh=msh, ss=stripe_sharded):
                    return put_sharded(B, msh, ss)

                def dispatch(Bd, msh=msh, ss=stripe_sharded):
                    return sharded_gf_matmul(A, Bd, mesh=msh, w=8, strategy="cuda", stripe_sharded=ss)
            Bd = put()  # also the untimed first call
            row[f"put_ms[{mb}mb]"] = 1e3 * best_host_seconds(put, args.trials, home)
            cols = sample_columns(m, [b for b in K1_BLOCKS if b < m], seed=mb)
            check_columns(f"{mode}@{mb}mb", dispatch(Bd), p, m, cols, gf.matmul(A, B.numpy()[:, cols]))
            row[f"dispatch_ms[{mb}mb]"] = 1e3 * best_host_seconds(lambda Bd=Bd: dispatch(Bd), args.trials, home)
        row["dispatches_per_s_tiny"] = 1e3 / max(row[f"dispatch_ms[{args.mb[0]}mb]"], 1e-6)
        if stripe_sharded:
            m2 = max(1, args.mb[1] * 1024 * 1024 // k // 128) * 128
            row["psum_bytes_per_seg_per_dev"] = int(p * 8 * (m2 // (n_dev // stripe_n)))
        rows.append(row)
        print(json.dumps(row), flush=True)

    single, tiny = rows[0], args.mb[0]
    for r in rows[1:]:
        print(json.dumps({
            "metric": f"mesh_overhead_ratio_{device.type}",
            "mode": r["mode"],
            "overhead_vs_single": r[f"dispatch_ms[{tiny}mb]"] / max(single[f"dispatch_ms[{tiny}mb]"], 1e-6),
            "put_vs_single": r[f"put_ms[{tiny}mb]"] / max(single[f"put_ms[{tiny}mb]"], 1e-6),
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
