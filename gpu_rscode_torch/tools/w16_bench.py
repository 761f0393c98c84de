"""The wide-symbol (GF(2^16)) GEMM on the card: the counterpart of the JAX
package's ``tools/w16_bench.py``.

The reference's GF(16) "extend" branch is its fastest kernel
(design.tex:490); this measures the port's w=16 path at k=10, p=4 on
``--mb`` MB of seeded uint16 symbols: ``cuda`` (K1's bit-sliced kernel at
w=16; the JAX tool's ``pallas`` row) over all of it, and ``bitplane`` (the
plain bit-plane GEMM) over a 2 Mi-symbol slice, as the JAX tool bounds its
16x plane expansion.  Each output is checked against the GF oracle
(``GaloisField.matmul``) on columns spread over every K1 block before it
is timed (CUDA events); a mismatch ends the tool.  One
``{"<name>": GB/s}`` line each after the capture header, then the JAX
tool's summary (``metric``, ``unit``, ``mb``, ``results``), with the JAX
tool's ``autotune`` key (the refolds that RS_PALLAS_REFOLD=autotune chose)
when a calibration ran.  Under the RS_PALLAS_* knobs the ``cuda`` row runs
the named expansion they choose (K3 at w=16) instead of K1.  Dropped from
the JAX tool: its catch-all around each case.

Usage: python -m gpu_rscode_torch.tools.w16_bench [--mb 320] [--trials 3]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..models.vandermonde import vandermonde_matrix
from ..obs.runlog import capture_header
from ..ops.cuda_gemm import autotune_decisions, gf_matmul_cuda
from ..ops.gemm import gf_matmul_bitplane
from ..ops.gf import get_field
from ..utils.backend import resolve_device
from ._bench_timing import time_device_fn
from ._check import K1_BLOCKS, check_columns, sample_columns

K, P, W = 10, 4, 16
SEG_SYM = 2 * 1024 * 1024  # the bit-plane slice (bounds its 16x expansion)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mb", type=int, default=320, help="total data MB")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(json.dumps(capture_header("w16_bench")), flush=True)
    m_sym = args.mb * 1024 * 1024 // (K * 2)
    m_sym = max(512, (m_sym // 512) * 512)
    seg = min(SEG_SYM, m_sym)
    gf = get_field(W)
    A = vandermonde_matrix(P, K, gf)
    rng = np.random.default_rng(0)
    B_host = rng.integers(0, 1 << 16, size=(K, m_sym), dtype=np.uint16)
    B = torch.from_numpy(B_host).to(device)
    Bseg = B[:, :seg].contiguous()  # sliced once, outside the timing

    out: dict[str, float] = {}
    cases = (("cuda", lambda: gf_matmul_cuda(A, B, W), m_sym),
             ("bitplane", lambda: gf_matmul_bitplane(A, Bseg, W), seg))
    for name, fn, m in cases:
        cols = sample_columns(m, [b for b in K1_BLOCKS if b < m])
        check_columns(name, fn(), P, m, cols, gf.matmul(A, B_host[:, cols]))
        out[name] = K * m * 2 / time_device_fn(fn, trials=args.trials) / 1e9
        print(json.dumps({name: out[name]}), flush=True)
    summary = {"metric": f"w16_gemm_bandwidth_k{K}_p{P}", "unit": "GB/s", "mb": args.mb, "results": out}
    decisions = autotune_decisions()
    if decisions:
        summary["autotune"] = sorted(set(decisions.values()))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
