"""K1 across stripe depths: the counterpart of the JAX package's
``tools/k_sweep.py``.

The reference documents its throughput falling for k >= ~32
(design.tex:462-466).  This sweep runs K1 (``gf_matmul_cuda``) across
k in ``--ks`` at p=4, in both of its forms: ``folded`` (the bit-sliced
kernel every encode and decode runs) and ``preparity`` (the popcount
kernel's (p*8, m) int32 sums, the mesh's stripe mode).  Data per call
stays at ``--mb`` MB.  Before a form is timed (CUDA events), its output on
a slab of columns spread over every K1 block is checked: folded symbols
against the GF oracle (``GaloisField.matmul``), the pre-parity sums
against the plain version's and, folded, against the oracle.  A mismatch
ends the tool.

One ``{"k<k>_<form>": GB/s}`` line a configuration after the capture
header, then ``{"k<k>_best": {"config", "gbps", "contraction_depth"}}``
for each depth, as the JAX tool prints.  Dropped from the JAX tool: its
``--tiles`` and accumulator axes (K1 takes neither a tile nor an
accumulator type) and its catch-all around each configuration.

Usage: python -m gpu_rscode_torch.tools.k_sweep [--mb 320] [--trials 2]
       [--ks 4,10,32,64,128] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from ..models.vandermonde import vandermonde_matrix
from ..obs.runlog import capture_header
from ..ops.cuda_gemm import gf_matmul_cuda
from ..ops.gemm import from_bitplanes, gf_matmul_bitplane
from ..ops.gf import get_field
from ..utils.backend import resolve_device
from ._bench_timing import time_device_fn
from ._check import K1_BLOCKS, check_columns, sample_columns

P = 4
FORMS = {"folded": True, "preparity": False}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mb", type=int, default=320, help="data MB per call")
    ap.add_argument("--trials", type=int, default=2)
    ap.add_argument("--ks", type=str, default="4,10,32,64,128")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    ks = [int(x) for x in args.ks.split(",")]
    device = resolve_device(args.device)

    print(json.dumps(capture_header("k_sweep")), flush=True)
    print(f"# k-sweep on {device}: p={P} ks={ks} forms={list(FORMS)} data>={args.mb}MB trials={args.trials}",
          file=sys.stderr, flush=True)
    gf = get_field(8)
    rng = np.random.default_rng(0)
    for k in ks:
        m = (args.mb * 1024 * 1024) // k
        m = max(512, (m // 512) * 512)
        A = vandermonde_matrix(P, k)
        B_host = rng.integers(0, 256, size=(k, m), dtype=np.uint8)
        B = torch.from_numpy(B_host).to(device)
        cols = sample_columns(m, [b for b in K1_BLOCKS if b < m])
        slab = torch.from_numpy(np.ascontiguousarray(B_host[:, cols]))
        oracle = gf.matmul(A, B_host[:, cols])
        sums = gf_matmul_bitplane(A, slab, 8, fold_parity=False).numpy()
        best = (None, 0.0)
        for form, fold in FORMS.items():
            key = f"k{k}_{form}"

            def run(fold=fold):
                return gf_matmul_cuda(A, B, 8, fold_parity=fold)

            out = run()
            if fold:
                check_columns(key, out, P, m, cols, oracle)
            else:
                check_columns(key, out, P * 8, m, cols, sums)
                check_columns(key, from_bitplanes(out.index_select(
                    1, torch.from_numpy(cols).to(device)), 8), P, len(cols), np.arange(len(cols)), oracle)
            gbps = k * m / time_device_fn(run, trials=args.trials) / 1e9
            if gbps > best[1]:
                best = (key, gbps)
            print(json.dumps({key: gbps}), flush=True)
        print(json.dumps({f"k{k}_best": {"config": best[0], "gbps": best[1], "contraction_depth": k * 8}}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
