#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (gpu_rscode_torch) end to end on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel-vs-plain grids only

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi); CUDA must be present;
  2. build the three CUDA kernel libraries from the checkout's sources, one
     nvcc each, all at once (timed);
  3. K1 against its plain PyTorch version on the card, bit-exact, over a
     grid of shapes at w=8 and w=16 (ragged widths, p = k decode shapes up
     to 128, the pre-parity fold_parity=False form);
  4. the main path at the reference's published setting (k=10, n=14): a
     seeded 1 GiB file is encoded with api.encode_file on the card, parity
     is spot-checked against the GF oracle, the first 4 chunks are deleted
     and api.decode_file rebuilds the file from the conf (4 missing natives
     through K1); SHA-256 must match and K1 must have run;
  5. a w=16 round trip with --checksum through the CLI (--device cuda);
  6. timings: file encode/decode GB/s of phase 4, and K1 at the main path's
     segment shape next to its bound and its plain version;
  7. K2 (pack2) and K3 (every expand+refold pair, the pinned mode, the copy
     floor) against their plain versions on the card, bit-exact, and the
     dispatch of every expansion name through gf_matmul_cuda;
  8. the kernel-formulation tools as entry points on the card at their
     default sizes (kernel_sweep 64 MB, expand_probe 320 MB): every result
     a number, and K2, K3's GEMM and K3's copy floor each launched;
  9. K2, each K3 pair, the compute-only ceiling and the copy floor timed at
     the main path's encode segment next to the bound, the plain version
     and, for the copy floor, B[:p].clone().

The last lines are nvidia-smi's name and power limit, the kernels JSON and
the result JSON.  --quick runs phases 1-3 and 7 and prints the same three
lines, with the times it did not take as null.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import io
import json
import math
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
from gpu_rscode_torch.ops import _build, cuda_gemm, cuda_pack2, cuda_planes
from gpu_rscode_torch.ops.gemm import _widen, gf_matmul_bitplane, to_tensor
from gpu_rscode_torch.ops.gf import get_field
from gpu_rscode_torch.tools import expand_probe, kernel_sweep
from gpu_rscode_torch.tools.make_conf import make_conf
from gpu_rscode_torch.utils.fileformat import chunk_file_name
from gpu_rscode_torch.utils.timing import PhaseTimer

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
MiB = 1 << 20
SEED = 20261016
# The reference's published setting is a 1.1 GB file at k=10, n=14.
MAIN_FILE_BYTES = 1024 * MiB
# Columns of one 64 MiB segment of the main path's encode (6,710,784).
SEGMENT_COLS = api._segment_cols(-(-MAIN_FILE_BYTES // 10), 10, api.DEFAULT_SEGMENT_BYTES)
LIBS = {"gf_gemm": cuda_gemm.SOURCES, "gf_pack2": cuda_pack2.SOURCES, "gf_planes": cuda_planes.SOURCES}


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

    _reset_counts()
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


def _rand_u8(gen, shape, device) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=gen)


class Grid:
    """Bit-exact comparisons of one kernel with its plain version."""

    def __init__(self, name):
        self.name, self.cases, self.worst = name, 0, 0

    def check(self, got, want, what):
        torch.cuda.synchronize()
        if got.shape != want.shape or got.dtype != want.dtype:
            raise AssertionError(f"{self.name} at {what}: {got.dtype}{tuple(got.shape)} != {want.dtype}{tuple(want.shape)}")
        err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max().item()) if got.numel() else 0
        self.worst = max(self.worst, err)
        self.cases += 1
        if err:
            raise AssertionError(f"{self.name} != plain at {what}: max err {err}")


def phase_new_kernels_vs_plain(device) -> dict:
    """K2 and K3 against their plain versions on the card; returns the
    grids by kernel."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rng = np.random.default_rng(SEED + 7)
    k2, planes, copy = Grid("K2"), Grid("K3-planes"), Grid("K3-copy-floor")
    for m in (511, 512, 4097, SEGMENT_COLS):
        for k in (4, 10, 31, 32, 63, 128):
            B = _rand_u8(gen, (k, m), device)
            for p in (1, 4, 10):
                A = rng.integers(0, 256, size=(p, k))
                k2.check(cuda_pack2.gf_matmul_pack2(A, B), cuda_pack2.gf_matmul_pack2_plain(A, B), f"p={p} k={k} m={m}")
    # Wide blocks over a ragged last one.
    A, B = rng.integers(0, 256, size=(4, 10)), _rand_u8(gen, (10, SEGMENT_COLS + 1), device)
    for tile in (8192, 65536):
        k2.check(cuda_pack2.gf_matmul_pack2(A, B, tile=tile), cuda_pack2.gf_matmul_pack2_plain(A, B),
                 f"p=4 k=10 m={SEGMENT_COLS + 1} tile={tile}")
    for expand, refold in cuda_planes.PAIRS:
        for k in (4, 10, 32):
            for m in (4097, 100003):
                B = _rand_u8(gen, (k, m), device)
                for p in (1, 4, 10):
                    A = rng.integers(0, 256, size=(p, k))
                    want = cuda_planes.gf_matmul_planes_plain(A, B, expand, refold)
                    for tile in (256, 8192):
                        planes.check(cuda_planes.gf_matmul_planes(A, B, expand, refold, tile), want,
                                     f"{expand}+{refold} p={p} k={k} m={m} tile={tile}")
        # The sweep's widest tile: four blocks, the last one ragged.
        A, B = rng.integers(0, 256, size=(4, 10)), _rand_u8(gen, (10, 3 * 65536 + 4099), device)
        planes.check(cuda_planes.gf_matmul_planes(A, B, expand, refold, 65536),
                     cuda_planes.gf_matmul_planes_plain(A, B, expand, refold), f"{expand}+{refold} tile=65536")
        for tile in (256, 8192, 65536):
            planes.check(cuda_planes.gf_matmul_planes(A, B, expand, refold, tile, pinned=True),
                         cuda_planes.gf_matmul_planes_plain(A, B, expand, refold, tile, pinned=True),
                         f"{expand}+{refold} pinned tile={tile}")
    for k in (4, 10, 32):
        for m in (4097, 65536, SEGMENT_COLS):  # ragged (byte path) and 16-byte rows
            B = _rand_u8(gen, (k, m), device)
            for p in sorted({1, 4, min(10, k)}):
                for tile in (256, 8192, 65536):
                    copy.check(cuda_planes.copy_floor(B, p, tile), B[:p].clone(), f"p={p} k={k} m={m} tile={tile}")
    # Every expansion name through the public dispatch, against K1's plain version.
    A, B = rng.integers(0, 256, size=(4, 10)), _rand_u8(gen, (10, 4097), device)
    want = gf_matmul_bitplane(A, B, 8)
    for name, kernel in cuda_gemm.EXPANSIONS.items():
        grid = k2 if kernel == "pack2" else planes
        for refold in ((None,) if kernel == "pack2" else (None, "sum", "dot")):
            grid.check(cuda_gemm.gf_matmul_cuda(A, B, 8, expand=name, refold=refold), want, f"expand={name} refold={refold}")
    for grid in (k2, planes, copy):
        log(phase="kernel_vs_plain", kernel=grid.name, cases=grid.cases, max_abs_err=grid.worst, tolerance=0)
    return {grid.name: grid for grid in (k2, planes, copy)}


def _reset_counts() -> None:
    cuda_gemm.LAUNCHES = 0
    cuda_pack2.LAUNCHES = 0
    cuda_planes.LAUNCHES = 0
    cuda_planes.COPY_LAUNCHES = 0


def _counts() -> dict:
    return {"K1": cuda_gemm.LAUNCHES, "K2": cuda_pack2.LAUNCHES,
            "K3-planes": cuda_planes.LAUNCHES, "K3-copy-floor": cuda_planes.COPY_LAUNCHES}


def _run_tool(tool, argv: list[str]) -> list[dict]:
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = tool.main(argv)
    seconds = time.perf_counter() - t0
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    name = tool.__name__.rsplit(".", 1)[-1]
    if rc != 0 or not lines or lines[0].get("kind") != "capture_header":
        raise AssertionError(f"{name} exited {rc} or printed no capture header first")
    rows = [row for row in lines[1:] if "results" not in row]
    values = [v for row in rows for v in row.values()]
    if not rows or not all(isinstance(v, float) and math.isfinite(v) and v > 0 for v in values):
        raise AssertionError(f"{name}: a result is not a positive number: {rows}")
    log(phase="tool", tool=name, argv=argv, seconds=seconds, header=lines[0], results={k: v for r in rows for k, v in r.items()})
    return rows


def phase_tools() -> dict:
    """The slice's entry points at their default sizes; returns the sweep's
    results and the launches the two runs made."""
    _reset_counts()
    sweep = _run_tool(kernel_sweep, ["--trials", "1"])
    probe = _run_tool(expand_probe, ["--trials", "1"])
    launches = _counts()
    for name in ("K2", "K3-planes", "K3-copy-floor"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the tools: {launches}")
    log(phase="tools_launches", **launches)
    return {"sweep": {k: v for r in sweep for k, v in r.items()},
            "probe": {k: v for r in probe for k, v in r.items()}, "launches": launches}


def phase_new_timings(device) -> dict:
    """K2, each K3 pair, the pinned ceiling and the copy floor at the main
    path's encode segment shape."""
    k, p, m = 10, 4, SEGMENT_COLS
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 9)
    A = RSCodec(k, p, device=device).parity_block
    B = _rand_u8(gen, (k, m), device)
    cases = [("K2", "pack2", lambda: cuda_pack2.gf_matmul_pack2(A, B), lambda: cuda_pack2.gf_matmul_pack2_plain(A, B), None)]
    for expand, refold in cuda_planes.PAIRS:
        cases.append(("K3-planes", f"{expand}+{refold}",
                      functools.partial(cuda_planes.gf_matmul_planes, A, B, expand, refold),
                      functools.partial(cuda_planes.gf_matmul_planes_plain, A, B, expand, refold), None))
    cases.append(("K3-planes", "shift_raw+dot pinned (compute-only ceiling)",
                  functools.partial(cuda_planes.gf_matmul_planes, A, B, "shift_raw", "dot", pinned=True),
                  functools.partial(cuda_planes.gf_matmul_planes_plain, A, B, "shift_raw", "dot", pinned=True), None))
    cases.append(("K3-copy-floor", "copy_floor", lambda: cuda_planes.copy_floor(B, p), lambda: cuda_planes.copy_floor_plain(B, p),
                  lambda: B[:p].clone()))
    rows = {}
    for kernel, label, fn, plain, library in cases:
        err = int((fn().to(torch.int32) - plain().to(torch.int32)).abs().max().item())
        if err:
            raise AssertionError(f"{kernel} {label} != plain at the timing shape")
        ms = time_ms(fn, iters=20)
        row = dict(phase="kernel_timing", kernel=kernel, shape=f"encode k={k} p={p} m={m} ({label})", ms=ms,
                   plain_ms=time_ms(plain, iters=3, warmup=1), bound_ms=bound_ms(p, k, m, 8), bound_by="bytes",
                   library_ms=time_ms(library, iters=20) if library else None, max_abs_err=err,
                   data_gbps=k * m / (ms * 1e-3) / 1e9, traffic_gbps=(k + p) * m / (ms * 1e-3) / 1e9,
                   tile=None if kernel == "K2" else cuda_planes.DEFAULT_TILE)
        log(**row)
        rows[label] = row
    return rows


def kernel_entries(k1_err, grids, k1_timing=None, main_launches=None, new_timings=None, tool_launches=None) -> list:
    """The kernels line; without timings (--quick) the times are null."""
    segment = bound_ms(4, 10, SEGMENT_COLS, 8)

    def entry(name, source, replaces, launches, err, row):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": row["ms"] if row else None, "plain_ms": row["plain_ms"] if row else None,
                "bound_ms": row["bound_ms"] if row else segment, "bound_by": "bytes",
                "library_ms": row["library_ms"] if row else None}

    t = new_timings or {}
    tl = tool_launches or {}
    return [
        entry("K1 gf_gemm (fused GF(2^w) GEMM)", "gpu_rscode_torch/ops/csrc/gf_gemm.cu",
              "gpu_rscode_tpu/ops/pallas_gemm.py:307", main_launches, k1_err, k1_timing),
        entry("K2 gf_pack2 (packed two-column GF(2^8) GEMM)", "gpu_rscode_torch/ops/csrc/gf_pack2.cu",
              "gpu_rscode_tpu/ops/pallas_gemm.py:256", tl.get("K2"), grids["K2"].worst, t.get("pack2")),
        entry("K3 gf_planes (bit-plane GEMM on int8 mma; timed: shift_raw+dot)", "gpu_rscode_torch/ops/csrc/gf_planes.cu",
              "gpu_rscode_tpu/tools/kernel_sweep.py:175", tl.get("K3-planes"), grids["K3-planes"].worst,
              t.get("shift_raw+dot")),
        entry("K3 copy_floor (the copy floor, K1's traffic)", "gpu_rscode_torch/ops/csrc/gf_planes.cu",
              "gpu_rscode_tpu/tools/kernel_sweep.py:73", tl.get("K3-copy-floor"), grids["K3-copy-floor"].worst,
              t.get("copy_floor")),
    ]


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build_many(LIBS)
    wall = time.perf_counter() - t0
    for name in LIBS:
        ptxas = _build.BUILD_LOG.get(name, "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
        spills = sorted({int(b) for b in re.findall(r"(\d+) bytes spill stores", ptxas)})
        log(phase="build", library=name, nvcc_seconds=_build.BUILD_SECONDS.get(name), kernels=len(regs),
            max_registers=max(regs, default=None), spill_store_bytes=spills)
    log(phase="build", parallel_wall_seconds=wall)
    cuda_gemm._lib(), cuda_pack2._lib(), cuda_planes._lib()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="build and kernel-vs-plain grids only")
    args = ap.parse_args()
    t_start = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script needs a CUDA card", file=sys.stderr)
        return 1

    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    log(phase="device", nvidia_smi=smi, kind=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    device = torch.device("cuda", 0)

    phase_build()
    k1_err = phase_kernel_grid(device)
    grids = phase_new_kernels_vs_plain(device)
    if args.quick:
        kernels = kernel_entries(k1_err, grids)
    else:
        work_root = os.path.join(REPO, "build", "chip_smoke")
        os.makedirs(work_root, exist_ok=True)
        work = tempfile.mkdtemp(dir=work_root)
        try:
            main_res = phase_main_path(work, SEED, MAIN_FILE_BYTES)
            phase_cli_w16(work, SEED + 1, 64 * MiB)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        timings = phase_timings(device)
        tools = phase_tools()
        new_timings = phase_new_timings(device)
        kernels = kernel_entries(k1_err, grids, timings[0], main_res["launches"], new_timings, tools["launches"])
    log(phase="wall", seconds=time.perf_counter() - t_start, quick=args.quick)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
