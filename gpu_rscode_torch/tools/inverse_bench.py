"""Batched k x k inversion on the card against the host loop: the
counterpart of the JAX package's ``tools/inverse_bench.py``, and the
measurement behind ``api._device_invert_min_batch_cuda``.

``api.repair_fleet`` inverts a (k, w) group's survivor submatrices either
in one batched call on the device (``ops.inverse.invert_matrix_torch_batch``,
without pivoting) or one at a time on the host (``invert_matrix`` inside
the subset search).  For B random survivor submatrices of the (2k, k)
total matrix, in the order repair_fleet dispatches them
(``mds_nopivot_order``), this tool times (a) the batched call on the
device, pivoting and not, including the copy of the matrices in and of
the inverses and flags back, as repair_fleet pays them, and (b) the host
loop over the same matrices.  Before any time is printed, every device
inverse that claims success must equal the host inverse, and the first,
middle and last of them must give the identity under the GF oracle
(``GaloisField.matmul``); a mismatch ends the tool.

One JSON line per (k, batch) after the capture header, with the JAX
tool's keys: ``invertible``, ``nopivot_ok``, ``device_dispatch_s``,
``nopivot_dispatch_s``, the per-matrix times and the speedups over the
host loop.  The default grid is the card's routing grid (k in {4, 10, 32,
64, 128} x batch in {1, 3, 16, 64, 256, 1024}); repair_fleet dispatches
the no-pivot call, so ``nopivot_speedup_vs_host_loop`` is the routing's
figure.

Usage: python -m gpu_rscode_torch.tools.inverse_bench [--k 4 10 32 64 128]
       [--batch 1 3 16 64 256 1024] [--trials 3] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..models.vandermonde import total_matrix
from ..obs.runlog import capture_header
from ..ops.gf import get_field
from ..ops.inverse import invert_matrix, invert_matrix_torch_batch, mds_nopivot_order
from ..utils.backend import resolve_device
from ._bench_timing import best_host_seconds

DEFAULT_K = [4, 10, 32, 64, 128]
DEFAULT_BATCH = [1, 3, 16, 64, 256, 1024]


def survivor_batch(k: int, batch: int, rng: np.random.Generator) -> np.ndarray:
    """``batch`` survivor submatrices of the (2k, k) total matrix: k rows
    drawn from natives and parity, each surviving native's identity row at
    its own position (repair_fleet's arrangement)."""
    gf = get_field(8)
    T = total_matrix(k, k, gf)
    return np.stack([T[mds_nopivot_order(np.sort(rng.choice(2 * k, size=k, replace=False)), k)]
                     for _ in range(batch)])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch", type=int, nargs="+", default=DEFAULT_BATCH)
    ap.add_argument("--k", type=int, nargs="+", default=DEFAULT_K)
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(json.dumps(capture_header("inverse_bench")), flush=True)
    print(f"# inverse bench on {device}: k={args.k} batch={args.batch} trials={args.trials}",
          file=sys.stderr, flush=True)
    gf = get_field(8)
    rng = np.random.default_rng(0)
    for k in args.k:
        eye = np.eye(k, dtype=gf.dtype)
        for batch in args.batch:
            subs = survivor_batch(k, batch, rng)

            def run(pivot: bool):
                invs, oks = invert_matrix_torch_batch(subs, 8, pivot=pivot, device=device)
                return invs.cpu().numpy().astype(gf.dtype), oks.cpu().numpy()

            invs, oks = run(True)  # warm-up
            dev_best = best_host_seconds(lambda: run(True), args.trials)
            invs_np, oks_np = run(False)
            nopivot_best = best_host_seconds(lambda: run(False), args.trials)

            ok_idx = np.flatnonzero(oks)
            t0 = time.perf_counter()
            host = [invert_matrix(subs[j], gf) for j in ok_idx]
            host_s = time.perf_counter() - t0
            host_per = host_s / max(1, len(ok_idx))

            for j, want in zip(ok_idx, host):
                if not np.array_equal(invs[j], want):
                    raise AssertionError(f"k={k} batch={batch}: device inverse {j} differs from the host's")
                if oks_np[j] and not np.array_equal(invs_np[j], want):
                    raise AssertionError(f"k={k} batch={batch}: no-pivot inverse {j} differs from the host's")
            for j in sorted({int(ok_idx[0]), int(ok_idx[len(ok_idx) // 2]), int(ok_idx[-1])} if len(ok_idx) else ()):
                if not np.array_equal(gf.matmul(subs[j], invs[j]), eye):
                    raise AssertionError(f"k={k} batch={batch}: inverse {j} times its matrix is not the identity")

            label = device.type
            print(json.dumps({
                "metric": f"batched_inverse_{label}",
                "k": k,
                "batch": batch,
                "invertible": int(len(ok_idx)),
                "nopivot_ok": int(oks_np.sum()),
                "device_dispatch_s": dev_best,
                "nopivot_dispatch_s": nopivot_best,
                "device_per_matrix_us": 1e6 * dev_best / batch,
                "nopivot_per_matrix_us": 1e6 * nopivot_best / batch,
                "host_per_matrix_us": 1e6 * host_per,
                "speedup_vs_host_loop": host_per * batch / dev_best,
                "nopivot_speedup_vs_host_loop": host_per * batch / nopivot_best,
            }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
