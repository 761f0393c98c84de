"""Probe of the GF-GEMM expansion formulations on the card: the counterpart
of the JAX package's ``tools/expand_probe.py``.

Runs ``gf_matmul_cuda(..., expand=e)`` for each named formulation at scale
(``--mb`` MB of seeded data per timed call), after checking the output of
that call against the GF oracle on columns spread over every block, and
prints one ``{"<expand>": GB/s}`` line each after the capture header.
``pack2`` runs on K2 (``ops/csrc/gf_pack2.cu``), every other name on K3's
GEMM (``ops/csrc/gf_planes.cu``) with the expansion it maps to
(``ops.cuda_gemm.EXPANSIONS``).  A mismatch, a build
or a launch error ends the tool with a non-zero exit.

``--refold`` applies to the K3 formulations; pack2 has its own packed
refold and is always run without one.

Usage: python -m gpu_rscode_torch.tools.expand_probe [--mb 320] [--trials 3]
       [--tile T] [--k 10] [--p 4] [--refold sum|dot] [--expand ...]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..models.vandermonde import vandermonde_matrix
from ..obs.runlog import capture_header
from ..ops import cuda_pack2, cuda_planes
from ..ops.cuda_gemm import gf_matmul_cuda
from ..ops.gf import get_field
from ..utils.backend import resolve_device
from ._bench_timing import time_device_fn
from ._check import check_columns, sample_columns

DEFAULT_EXPANDS = ["shift", "shift_raw", "pack2", "packed32", "sign16",
                   "shift_u8", "nibble_const", "nibble32", "sign", "nibble"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mb", type=int, default=320, help="data MB per call")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--tile", type=int, default=None, help="columns per CUDA block (default: the kernel's)")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--refold", choices=["sum", "dot"], default=None,
                    help="parity refold of the K3 formulations (default: dot)")
    ap.add_argument("--expand", nargs="+", default=DEFAULT_EXPANDS)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(json.dumps(capture_header("expand_probe")), flush=True)
    k, p = args.k, args.p
    m = (args.mb * 1024 * 1024) // k
    print(
        f"# expand probe on {device}: k={k} p={p} data={k * m / 1e6:.0f} MB "
        f"tile={args.tile or 'auto'} refold={args.refold or 'auto'} trials={args.trials}",
        file=sys.stderr, flush=True,
    )
    A = vandermonde_matrix(p, k)
    rng = np.random.default_rng(0)
    B_host = rng.integers(0, 256, size=(k, m), dtype=np.uint8)
    B = torch.from_numpy(B_host).to(device)
    # The block widths of K2 and of K3 at this tile.
    cols = sample_columns(m, {cuda_pack2.tile_cols(args.tile, m), cuda_planes.tile_cols(args.tile, m)})
    oracle = get_field(8).matmul(A, B_host[:, cols])

    results: dict[str, float] = {}
    for expand in args.expand:
        refold = None if expand == "pack2" else args.refold

        def run(e=expand, r=refold):
            return gf_matmul_cuda(A, B, 8, expand=e, refold=r, tile=args.tile)

        check_columns(expand, run(), p, m, cols, oracle)
        results[expand] = k * m / time_device_fn(run, trials=args.trials) / 1e9
        print(json.dumps({expand: results[expand]}), flush=True)

    if results:
        best = max(results, key=results.get)
        print(f"# best: {best} @ {results[best]} GB/s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
