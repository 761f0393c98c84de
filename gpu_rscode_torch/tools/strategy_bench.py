"""One stripe encode under each GEMM strategy: the counterpart of the JAX
package's ``tools/strategy_bench.py`` (the reference's cpu-rs-* study of
multiply strategies, one command).

Reports GB/s of one (k, m) stripe encode per strategy of
``tune.VALID_STRATEGIES``: ``cuda`` (K1, the JAX tool's ``pallas`` row),
``xor`` and ``ring`` (the XOR-chain pipelines), ``bitplane`` and
``table`` (the plain PyTorch GEMMs), on ``--device``; ``cpu`` (the native
host codec, ``native.gemm``) and ``numpy`` (the GF oracle itself,
``GaloisField.matmul``) on the host.  Each strategy's output is checked
against the GF oracle on columns spread over every K1 block before it is
timed (one warm-up call, then ``--iters`` calls between synchronises, host
clock, as the JAX tool times).  One ``{"<strategy>": GB/s}`` line a
strategy after the capture header, then the JAX tool's summary line
(``metric``, ``unit``, ``results``).  Dropped from the JAX tool: its
catch-all around each strategy (a strategy that fails ends the tool).

Usage: python -m gpu_rscode_torch.tools.strategy_bench [--size 64] [--k 10]
       [--p 4] [--iters 3] [--strategies cuda,xor,...] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from .. import native
from ..models.vandermonde import vandermonde_matrix
from ..obs.runlog import capture_header
from ..ops import ring_gemm, xor_gemm
from ..ops.gemm import gf_matmul
from ..ops.gf import get_field
from ..utils.backend import resolve_device
from ._check import K1_BLOCKS, check_columns, sample_columns

STRATEGIES = ("cuda", "xor", "ring", "bitplane", "table", "cpu", "numpy")


def bench_strategy(fn, device: torch.device, warmup: int = 1, iters: int = 3) -> float:
    """Seconds a call of ``fn``: ``iters`` calls after ``warmup``, between
    two synchronises."""

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(warmup):
        fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    sync()
    return (time.perf_counter() - t0) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--size", type=float, default=64.0, help="data MB per stripe")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--strategies", default=",".join(STRATEGIES), help=f"comma list from {','.join(STRATEGIES)}")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    names = [s.strip() for s in args.strategies.split(",") if s.strip()]
    unknown = [s for s in names if s not in STRATEGIES]
    if unknown:
        ap.error(f"unknown --strategies {unknown}; choose from {','.join(STRATEGIES)}")
    device = resolve_device(args.device)

    print(json.dumps(capture_header("strategy_bench")), flush=True)
    k, p = args.k, args.p
    m = int(args.size * 1e6 / k)
    A = vandermonde_matrix(p, k)
    rng = np.random.default_rng(0)
    B = rng.integers(0, 256, size=(k, m), dtype=np.uint8)
    Bd = torch.from_numpy(B).to(device)
    gf = get_field(8)
    cols = sample_columns(m, [b for b in K1_BLOCKS if b < m])
    oracle = gf.matmul(A, B[:, cols])
    host = torch.device("cpu")
    runners = {
        "cuda": (lambda: gf_matmul(A, Bd, 8, "cuda"), device),
        "xor": (lambda: xor_gemm.gf_matmul_xor(A, Bd, 8), device),
        "ring": (lambda: ring_gemm.gf_matmul_ring(A, Bd, 8), device),
        "bitplane": (lambda: gf_matmul(A, Bd, 8, "bitplane"), device),
        "table": (lambda: gf_matmul(A, Bd, 8, "table"), device),
        "cpu": (lambda: native.gemm(A, B), host),
        "numpy": (lambda: gf.matmul(A, B), host),
    }
    results: dict[str, float] = {}
    for name in names:
        fn, where = runners[name]
        check_columns(name, torch.as_tensor(fn()), p, m, cols, oracle)
        dt = bench_strategy(fn, where, iters=args.iters)
        results[name] = k * m / dt / 1e9
        print(f"{name:>9}: {results[name]:8.3f} GB/s   ({1e3 * dt:8.2f} ms / stripe)", file=sys.stderr, flush=True)
        print(json.dumps({name: results[name]}), flush=True)
    print(json.dumps({"metric": f"strategy_bench_k{k}_p{p}_{device.type}", "unit": "GB/s", "results": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
