#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (gpu_rscode_torch) end to end on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel-vs-plain grid only

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi); CUDA must be present;
  2. build the CUDA kernel from the checkout's sources (timed);
  3. the kernel against its plain PyTorch version on the card, bit-exact,
     over a grid of shapes at w=8 and w=16 (ragged widths, p = k decode
     shapes up to 128, the pre-parity fold_parity=False form);
  4. the main path at the reference's published setting (k=10, n=14): a
     seeded 1 GiB file is encoded with api.encode_file on the card, parity
     is spot-checked against the GF oracle, the first 4 chunks are deleted
     and api.decode_file rebuilds the file from the conf (4 missing natives
     through the kernel); SHA-256 must match and the kernel must have run;
  5. a w=16 round trip with --checksum through the CLI (--device cuda);
  6. timings: file encode/decode GB/s of phase 4, and the kernel at the
     main path's segment shape next to its bound and its plain version.

The last two lines are the kernels JSON and the result JSON; the line
before them is nvidia-smi's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from gpu_rscode_torch import api, cli
from gpu_rscode_torch.codec import RSCodec
from gpu_rscode_torch.models.vandermonde import vandermonde_matrix
from gpu_rscode_torch.ops import _build, cuda_gemm
from gpu_rscode_torch.ops.gemm import _widen, gf_matmul_bitplane, to_tensor
from gpu_rscode_torch.ops.gf import get_field
from gpu_rscode_torch.tools.make_conf import make_conf
from gpu_rscode_torch.utils.fileformat import chunk_file_name
from gpu_rscode_torch.utils.timing import PhaseTimer

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
MiB = 1 << 20
SEED = 20261016
# The reference's published setting is a 1.1 GB file at k=10, n=14.
MAIN_FILE_BYTES = 1024 * MiB


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(p: int, k: int, m: int, w: int) -> float:
    """Least time for C = A.B over GF(2^w) at (p, k, m): B read once and C
    written once at the device-memory rate.  The packed GF(2) product needs
    about p*w*k*w/32 word ANDs, XORs and popcounts per column, which the
    card's integer units issue faster than those bytes arrive."""
    return 1e3 * (k + p) * m * (w // 8) / HBM_BYTES_PER_S


def time_ms(fn, iters: int, warmup: int = 2) -> float:

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fp:
        while True:
            buf = fp.read(64 * MiB)
            if not buf:
                return h.hexdigest()
            h.update(buf)


def random_symbols(rng, shape, w, device):

    dt = np.uint8 if w == 8 else np.uint16
    return to_tensor(rng.integers(0, 1 << w, size=shape).astype(dt), device)


def phase_kernel_grid(device) -> int:
    """Kernel vs plain version on the card; returns the max abs error."""

    shapes = [(2, 4, 256), (4, 10, 5000), (1, 1, 128), (8, 32, 1024), (3, 5, 100)]
    shapes += [(2, 4, m) for m in (64, 2048, 2049, 4097)]
    shapes += [(10, 10, 65537), (4, 10, 1 << 20)]
    wide = {8: [(128, 128, 4097), (64, 200, 3000)], 16: [(64, 64, 4097), (128, 128, 2049)]}
    worst = 0
    cases = 0
    rng = np.random.default_rng(SEED)
    for w in (8, 16):
        for p, k, m in shapes + wide[w]:
            A = rng.integers(0, 1 << w, size=(p, k))
            B = random_symbols(rng, (k, m), w, device)
            for fold in (True, False):
                got = cuda_gemm.gf_matmul_cuda(A, B, w, fold_parity=fold)
                want = gf_matmul_bitplane(A, B, w, fold_parity=fold)
                torch.cuda.synchronize()
                if fold:
                    err = int((_widen(got) - _widen(want)).abs().max().item())
                else:
                    err = int((got - want).abs().max().item())
                worst = max(worst, err)
                cases += 1
                if err:
                    raise AssertionError(f"kernel != plain at w={w} p={p} k={k} m={m} fold={fold}: max err {err}")
    log(phase="kernel_vs_plain", cases=cases, max_abs_err=worst, tolerance=0)
    return worst


def phase_main_path(work: str, seed: int, size: int) -> dict:

    k, n = 10, 14
    path = os.path.join(work, "main.bin")
    rng = np.random.default_rng(seed)
    h = hashlib.sha256()
    with open(path, "wb") as fp:
        left = size
        while left:
            buf = rng.bytes(min(left, 64 * MiB))
            h.update(buf)
            fp.write(buf)
            left -= len(buf)
    want_sha = h.hexdigest()

    cuda_gemm.LAUNCHES = 0
    enc_timer = PhaseTimer()
    t0 = time.perf_counter()
    api.encode_file(path, k, n - k, timer=enc_timer)
    t_enc = time.perf_counter() - t0
    enc_launches = cuda_gemm.LAUNCHES

    # Spot-check parity columns against the host oracle.
    gf = get_field(8)
    chunk = -(-size // k)
    cols = np.sort(rng.choice(chunk, size=4096, replace=False))
    nat = np.stack([np.memmap(chunk_file_name(path, i), dtype=np.uint8, mode="r")[cols] for i in range(k)])
    par = np.stack([np.memmap(chunk_file_name(path, i), dtype=np.uint8, mode="r")[cols] for i in range(k, n)])

    if not np.array_equal(gf.matmul(vandermonde_matrix(n - k, k, gf), nat), par):
        raise AssertionError("parity spot-check against GaloisField.matmul failed")

    for i in range(n - k):
        os.unlink(chunk_file_name(path, i))
    conf = make_conf(n, k, path)
    out = path + ".out"
    dec_timer = PhaseTimer()
    t0 = time.perf_counter()
    api.decode_file(path, conf, out, timer=dec_timer)
    t_dec = time.perf_counter() - t0
    launches = cuda_gemm.LAUNCHES
    got_sha = sha256_file(out)
    if got_sha != want_sha:
        raise AssertionError(f"decoded SHA-256 {got_sha} != input {want_sha}")
    if launches <= 0 or enc_launches <= 0 or launches == enc_launches:
        raise AssertionError(f"kernel launches on the main path: encode {enc_launches}, total {launches}")
    res = dict(
        phase="main_path", bytes=size, k=k, n=n, sha256_match=True,
        encode_s=t_enc, decode_s=t_dec,
        encode_gbps=size / t_enc / 1e9, decode_gbps=size / t_dec / 1e9,
        launches=launches, encode_launches=enc_launches,
        encode_phases_s=dict(enc_timer.acc), decode_phases_s=dict(dec_timer.acc),
    )
    log(**res)
    for name in os.listdir(work):
        os.unlink(os.path.join(work, name))
    return res


def phase_cli_w16(work: str, seed: int, size: int) -> dict:

    k, n = 10, 14
    path = os.path.join(work, "wide.bin")
    data = np.random.default_rng(seed).bytes(size)
    with open(path, "wb") as fp:
        fp.write(data)
    before = cuda_gemm.LAUNCHES
    rc = cli.main(["-k", str(k), "-n", str(n), "-e", path, "--width", "16", "--checksum", "--device", "cuda"])
    if rc != 0:
        raise AssertionError(f"CLI encode exited {rc}")
    with open(path + ".METADATA") as fp:
        meta = fp.read()
    if "# gfwidth 16" not in meta or meta.count("# crc32") != n:
        raise AssertionError("w=16 metadata lacks its gfwidth or crc32 lines")
    for i in range(n - k):
        os.unlink(chunk_file_name(path, i))
    conf = make_conf(n, k, path)
    out = path + ".out"
    rc = cli.main(["-d", "-i", path, "-c", conf, "-o", out, "--device", "cuda"])
    if rc != 0:
        raise AssertionError(f"CLI decode exited {rc}")
    with open(out, "rb") as fp:
        if fp.read() != data:
            raise AssertionError("w=16 CLI round trip changed the bytes")
    res = dict(phase="cli_w16", bytes=size, launches=cuda_gemm.LAUNCHES - before, match=True)
    log(**res)
    for name in os.listdir(work):
        os.unlink(os.path.join(work, name))
    return res


def phase_timings(device) -> list[dict]:
    """The kernel at the main path's shapes vs its bound and plain version."""

    rng = np.random.default_rng(7)
    rows = []
    k = 10
    m8 = api._segment_cols(-(-MAIN_FILE_BYTES // k), k, api.DEFAULT_SEGMENT_BYTES)
    # Decode as the main path launches it: the first 4 chunks are lost, so
    # only the 4 missing natives' rows of the inverse go through the kernel.
    # The whole p = k = 10 inverse is timed beside it.
    for label, w, m, inv_rows in (("encode k=10 p=4", 8, m8, None),
                                  ("decode k=10, 4 missing natives", 8, m8, 4),
                                  ("decode p=k=10", 8, m8, 10),
                                  ("encode w=16 k=10 p=4", 16, m8 // 2, None)):
        codec = RSCodec(k, 4, w=w, device=device)
        A = codec.parity_block if inv_rows is None else codec.decode_matrix(list(range(4, 14)))[:inv_rows]
        p = A.shape[0]
        B = random_symbols(rng, (k, m), w, device)
        got = cuda_gemm.gf_matmul_cuda(A, B, w)
        want = gf_matmul_bitplane(A, B, w)
        err = int((_widen(got) - _widen(want)).abs().max().item())
        if err:
            raise AssertionError(f"kernel != plain at the {label} timing shape")
        ms = time_ms(lambda: cuda_gemm.gf_matmul_cuda(A, B, w), iters=20)
        plain = time_ms(lambda: gf_matmul_bitplane(A, B, w), iters=3, warmup=1)
        row = dict(phase="kernel_timing", shape=label, w=w, p=p, k=k, m=m, ms=ms, plain_ms=plain,
                   bound_ms=bound_ms(p, k, m, w), bound_by="bytes", library_ms=None, max_abs_err=err,
                   gbps=(k + p) * m * (w // 8) / (ms * 1e-3) / 1e9)
        log(**row)
        rows.append(row)
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="build and kernel grid only")
    args = ap.parse_args()


    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 1

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(phase="device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    device = torch.device("cuda", 0)

    t0 = time.perf_counter()
    cuda_gemm._lib()
    ptxas = _build.BUILD_LOG.get("gf_gemm", "")
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
    spills = sorted({int(b) for b in re.findall(r"(\d+) bytes spill stores", ptxas)})
    log(phase="build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.BUILD_SECONDS.get("gf_gemm"),
        kernels=len(regs), max_registers=max(regs, default=None), spill_store_bytes=spills)

    err = phase_kernel_grid(device)
    if args.quick:
        print(smi)
        return 0

    work_root = os.path.join(REPO, "build", "chip_smoke")
    os.makedirs(work_root, exist_ok=True)
    work = tempfile.mkdtemp(dir=work_root)
    try:
        main_res = phase_main_path(work, SEED, MAIN_FILE_BYTES)
        phase_cli_w16(work, SEED + 1, 64 * MiB)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    timings = phase_timings(device)
    t = timings[0]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": "K1 gf_gemm (fused GF(2^w) GEMM)",
        "route": "cuda",
        "source": "gpu_rscode_torch/ops/csrc/gf_gemm.cu",
        "replaces": "gpu_rscode_tpu/ops/pallas_gemm.py:307",
        "launches": main_res["launches"],
        "max_abs_err": err,
        "ms": t["ms"],
        "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"],
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
