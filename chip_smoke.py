#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (gpu_rscode_torch) end to end on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel-vs-plain grids only

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi); CUDA must be present;
  2. build the three CUDA kernel libraries from the checkout's sources, one
     nvcc each, all at once (timed);
  3. K1 against its plain PyTorch version on the card, bit-exact, over a
     grid of shapes at w=8 and w=16 in both forms (the folded bit-sliced
     kernel and the pre-parity popcount kernel): ragged and misaligned
     widths (m = 1, 31, 33, 1639, ...; rows that start off 16-byte
     alignment), shapes that need several output tiles and depth chunks,
     p = k decode shapes up to 128;
  4. the main path at the reference's published setting (k=10, n=14): a
     seeded 1 GiB file is encoded with api.encode_file on the card, parity
     is spot-checked against the GF oracle, the first 4 chunks are deleted
     and api.decode_file rebuilds the file from the conf (4 missing natives
     through K1).  It runs twice in this process: serial (pipeline_depth=1,
     RS_IO_WRITERS=0) and pipelined (depth 2, one writer).  Each run must
     match the input's SHA-256, launch K1 only on the pipeline's compute
     stream, stage every segment from pinned memory and read through the
     native IO library (no NumPy fallback); the 14 chunks and .METADATA
     must be byte-identical (SHA-256) between the two runs.  Each run's
     wall, GB/s and phase seconds are logged (phases summing past the wall
     are the overlap), and K1's share of the wall after phase 6;
  5. a w=16 round trip with --checksum through the CLI (--device cuda);
     api.encode_fleet over three seeded 128 MiB files, each decoded with
     its first 4 chunks lost and checked by SHA-256; a `-s 3 -p 64`
     CLI round trip of one of them; and a 16 MiB file in 128 KiB segments
     at depth 3 with two writers (about 130 segments, so every pinned
     buffer and event is reused many times), w=8 and w=16, whose archive
     must equal the CPU path's byte for byte;
  5b. the resilience reads at the main path's setting (k=10, n=14, a
     seeded 1 GiB file, --checksum, 64 MiB segments): the archive is
     damaged (chunk 0 deleted, chunk 5 one byte short, one byte of parity
     chunk 12 flipped) and scan_file must name the damage; auto_decode_file
     must rebuild the input (SHA-256) from a natives-first conf;
     repair_file must rebuild chunks 0, 5 and 12 to their saved SHA-256
     and leave a clean scan; decode_file with a pool, where a wrapper on
     native.gather_rows truncates a chosen survivor before the 4th
     segment, must swap it once and resume; repair_fleet over three
     128 MiB archives, each with another lost pair, must invert the group
     in one batched call on the card with every inverse verified and no
     host re-solve, and rebuild every chunk byte for byte, then
     decode_fleet must give their SHA-256s; and the archive re-encoded
     without checksums, 64 bytes of one chunk flipped, must be named
     silent_bitrot by scan_file(syndrome=True) and restored by
     locate_decode_file.  Every GEMM runs K1 on the compute stream from
     pinned staging; each operation's wall, GB/s (of the 1 GiB file, or
     of the fleet's bytes) and K1 launches are logged, and the batched
     inversion's device time beside the host loop's;
  6. timings: file encode/decode GB/s of phase 4, and K1 at the main path's
     segment shapes and at phase 5b's syndrome (r=4, depth 14) and repair
     (3 targets, k=10) shapes next to its bound, the logic-op estimate of
     its design and its plain version;
  7. K2 (pack2) and K3 (every expand+refold pair, the pinned mode, the copy
     floor) against their plain versions on the card, bit-exact, and the
     dispatch of every expansion name through gf_matmul_cuda; K3's sum
     kernel for the byte expansions (gf_planes_sum_kernel) also at depths
     1-33, p = 1-10 and its largest sums; K2 also at
     its depth-slice edges, at the largest accumulator a slice can reach,
     at tiles that are not a multiple of its 128-column step, and with
     operators too large for shared memory;
  8. the kernel-formulation tools as entry points on the card at their
     default sizes (kernel_sweep 64 MB, expand_probe 320 MB): every result
     a number, and K2, K3's GEMM and K3's copy floor each launched;
  9. K2, each K3 pair, the compute-only ceiling and the copy floor timed at
     the main path's encode segment next to the bound, the plain version
     and, for the copy floor, B[:p].clone(); K2 and K3's sum kernel beside
     the instruction estimate of their designs.

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
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gpu_rscode_torch import api, cli, native
from gpu_rscode_torch.codec import RSCodec
from gpu_rscode_torch.gf_decode import LocateContext
from gpu_rscode_torch.models.vandermonde import vandermonde_matrix
from gpu_rscode_torch.ops import _build, cuda_gemm, cuda_pack2, cuda_planes
from gpu_rscode_torch.ops.gemm import _widen, gf_matmul_bitplane, to_tensor
from gpu_rscode_torch.ops import inverse
from gpu_rscode_torch.ops.gf import get_field
from gpu_rscode_torch.parallel import pipeline
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
# 32-bit logic operations an sm_90 SM issues per clock (CUDA C++ Programming
# Guide, arithmetic instruction throughput).
LOGIC_OPS_PER_SM_CLOCK = 64
LIBS = {"gf_gemm": cuda_gemm.SOURCES, "gf_pack2": cuda_pack2.SOURCES, "gf_planes": cuda_planes.SOURCES}


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


def smi_line(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def bound_ms(p: int, k: int, m: int, w: int) -> float:
    """Least time for C = A.B over GF(2^w) at (p, k, m): B read once and C
    written once at the device-memory rate.  The GF(2) product itself needs
    no multiply; what K1's design issues per column on the logic pipe is
    estimated beside it (k1_logic_ops_per_col)."""
    return 1e3 * (k + p) * m * (w // 8) / HBM_BYTES_PER_S


def k1_logic_ops_per_col(p: int, k: int, w: int) -> float:
    """An estimate from the bit-sliced design, not a measurement: per column,
    one LOP3 for each (output plane, input plane) pair of every tile, plus
    five logic or shift ops per masked swap of the transposes (log2(w)
    stages of w/2 swaps) on each input row of each tile and on each output
    row, over the thread's 32 columns."""
    rt, tiles, _ = cuda_gemm.bitslice_plan(p, k, w)
    swaps = 5 * int(math.log2(w)) * (w // 2)
    return (tiles * rt * w * k * w + (tiles * k + p) * swaps) / 32


def k2_ops_per_col(p: int, k: int) -> float:
    """An estimate from the tensor-core design of gf_pack2.cu, not a
    measurement: thread instructions per column besides the mma.  A warp
    step covers 128 columns as 8 mma column groups.  Per (step, pass over a
    pair of m-tiles, depth slice) it copies the slice's rows into shared
    memory (8 predicated 16-byte copies a lane with their addresses, about
    60 instructions), controls its loop (about 30) and zeroes 64
    accumulators (32).  Per k16-step and pass it reads 2 rows (4 reads) and
    makes the B fragments with 48 shifts, masks and byte permutes, plus one
    A fragment per m-tile.  Per slice and m-tile it refolds 8 column groups
    at 18 instructions each (4 FADD, 2 PRMT, 2 masks, 2 shifts, 2 selects,
    3 shuffles, 3 OR), and per m-tile it stores with 8 PRMT and two 16-byte
    stores.  Each instruction runs on 32 threads, over 128 columns."""
    groups = 8
    mt, ks = -(-p // 2), -(-k // 2)
    passes, slices = -(-mt // 2), -(-ks // 15)
    warp_instr = (passes * slices * (60 + 30 + 4 * groups) + passes * ks * (groups // 2 + 6 * groups) + ks * mt
                  + slices * mt * 18 * groups + mt * (groups + groups // 4))
    return warp_instr * 32 / (16 * groups)


# Thread instructions that make one plane register from a four-symbol word
# (gf_planes_sum_kernel's plane_word; __vcmpne4 counted as the 4 integer
# instructions it is emulated with).
K3_PLANE_OPS = {"shift": 2, "shift_raw": 1, "cmp": 6, "sign": 5}


def k3_ops_per_col(p: int, k: int, expand: str) -> float:
    """An estimate from the design of gf_planes_sum_kernel, not a
    measurement: thread instructions per column besides the mma, for the
    byte expansions' sum refold.  A warp step covers 64 columns as 8 mma
    column groups.  Per step it copies its k rows into shared memory (a
    predicated 16-byte cp.async per 8 rows a lane, about 6 instructions
    each, and about 20 for the commit, wait and loop).  Per pass over a pair
    of m-tiles it zeroes 64 accumulators (32) and controls its loop (10);
    per depth chunk and pass it reads 4 rows (4 LDS.64), transposes them
    (16 PRMT), makes 16 plane registers and reads one A fragment per m-tile.
    Per m-tile it refolds 8 groups at 10 instructions each (3 PRMT, a mask,
    3 shuffles, 3 OR) and stores with 6 PRMT, its address and one 8-byte
    store (10).  Each instruction runs on 32 threads, over 64 columns."""
    groups, step = 8, 64
    mt, kc = -(-p * 8 // 16), -(-k // 4)
    passes = -(-mt // 2)
    warp_instr = (6 * -(-k // 8) + 20 + passes * (32 + 10)
                  + passes * kc * (4 + 16 + 2 * groups * K3_PLANE_OPS[expand]) + kc * mt
                  + mt * (10 * groups + 10))
    return warp_instr * 32 / step


def time_ms(fn, iters: int, reps: int = 1, warmup: int = 2) -> float:
    """Best milliseconds per call over ``reps`` loops of ``iters`` calls,
    timed with CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / iters)
    return best


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
    """K1 vs its plain version on the card, both forms; returns the max abs
    error."""

    shapes = [(2, 4, 256), (4, 10, 5000), (1, 1, 128), (8, 32, 1024), (3, 5, 100)]
    shapes += [(2, 4, m) for m in (64, 2048, 2049, 4097)]
    shapes += [(10, 10, 65537), (4, 10, 1 << 20)]
    # Ragged and misaligned widths (1639: the last segment of a 1 GiB
    # encode), and depth 33.
    shapes += [(p, k, m) for p, k in ((4, 10), (10, 10)) for m in (1, 31, 33, 1639)] + [(4, 33, 1639), (4, 33, 4097)]
    # Several output tiles and depth chunks of the bit-sliced kernel.
    wide = {8: [(128, 128, 4097), (64, 200, 3000), (16, 50, 1100), (16, 50, 70001)],
            16: [(64, 64, 4097), (128, 128, 2049), (5, 7, 300), (9, 12, 130), (4, 33, 70001)]}
    worst = 0
    cases = 0
    rng = np.random.default_rng(SEED)
    for w in (8, 16):
        # (p, k, m, elements B's first row sits past a 16-byte boundary)
        grid = [(p, k, m, 0) for p, k, m in shapes + wide[w]] + [(4, 10, 65536, 1), (4, 10, 65536, 3)]
        for p, k, m, skew in grid:
            A = rng.integers(0, 1 << w, size=(p, k))
            flat = random_symbols(rng, (skew + k * m,), w, device)
            B = flat[skew:].view(k, m)
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
                    raise AssertionError(f"kernel != plain at w={w} p={p} k={k} m={m} skew={skew} fold={fold}: max err {err}")
    log(phase="kernel_vs_plain", kernel="K1", cases=cases, max_abs_err=worst, tolerance=0)
    return worst


def write_seeded(path: str, seed: int, size: int) -> str:
    """A file of ``size`` seeded random bytes; returns its SHA-256."""
    rng = np.random.default_rng(seed)
    h = hashlib.sha256()
    with open(path, "wb") as fp:
        left = size
        while left:
            buf = rng.bytes(min(left, 64 * MiB))
            h.update(buf)
            fp.write(buf)
            left -= len(buf)
    return h.hexdigest()


def _reset_io_counts() -> None:
    native.NATIVE_CALLS = native.FALLBACK_CALLS = 0
    pipeline.PINNED_STAGES = pipeline.STREAM_DISPATCHES = 0


def _io_counts() -> dict:
    return {"native_io_calls": native.NATIVE_CALLS, "fallback_io_calls": native.FALLBACK_CALLS,
            "pinned_stages": pipeline.PINNED_STAGES, "stream_dispatches": pipeline.STREAM_DISPATCHES}


def check_pipeline(what: str, launches: int, io_counts: dict, staged_ahead: bool = False) -> None:
    """K1 ran, each launch in a dispatch on the pipeline's compute stream
    (one launch a dispatch), every dispatched segment was staged from
    pinned memory, and the native IO library served every read and write.
    ``staged_ahead``: a run that failed and resumed may have staged
    segments it never dispatched."""
    if launches <= 0:
        raise AssertionError(f"{what}: K1 was not launched")
    if io_counts["stream_dispatches"] != launches:
        raise AssertionError(f"{what}: {launches} K1 launches but {io_counts['stream_dispatches']} on the compute stream")
    if io_counts["pinned_stages"] < launches or (io_counts["pinned_stages"] != launches and not staged_ahead):
        raise AssertionError(f"{what}: {io_counts['pinned_stages']} segments staged from pinned memory for {launches} dispatches")
    if io_counts["native_io_calls"] <= 0 or io_counts["fallback_io_calls"]:
        raise AssertionError(f"{what}: native IO calls {io_counts['native_io_calls']}, NumPy fallback calls "
                             f"{io_counts['fallback_io_calls']}")


def archive_digests(path: str, n: int) -> dict:
    """SHA-256 of each chunk and .METADATA, hashed on 8 threads (hashlib
    and the reads release the GIL)."""
    names = [chunk_file_name(path, i) for i in range(n)] + [path + ".METADATA"]
    with ThreadPoolExecutor(max_workers=8) as pool:
        return dict(zip((os.path.basename(f) for f in names), pool.map(sha256_file, names)))


def run_main_path(path: str, want_sha: str, mode: str, depth: int, writers: str | None) -> tuple[dict, dict]:
    """Encode and decode (first 4 chunks lost) of ``path`` at ``depth`` with
    ``RS_IO_WRITERS=writers`` (None: the default); returns the logged
    result and the archive's digests."""
    k, n = 10, 14
    size = os.path.getsize(path)
    saved = os.environ.pop("RS_IO_WRITERS", None)
    if writers is not None:
        os.environ["RS_IO_WRITERS"] = writers
    try:
        _reset_counts()
        _reset_io_counts()
        enc_timer = PhaseTimer()
        t0 = time.perf_counter()
        api.encode_file(path, k, n - k, pipeline_depth=depth, timer=enc_timer)
        t_enc = time.perf_counter() - t0
        enc_launches, enc_io = cuda_gemm.LAUNCHES, _io_counts()
        check_pipeline(f"{mode} encode", enc_launches, enc_io)
        digests = archive_digests(path, n)

        # Spot-check parity columns against the host oracle.
        gf = get_field(8)
        chunk = -(-size // k)
        cols = np.sort(np.random.default_rng(SEED + 2).choice(chunk, size=4096, replace=False))
        nat = np.stack([np.memmap(chunk_file_name(path, i), dtype=np.uint8, mode="r")[cols] for i in range(k)])
        par = np.stack([np.memmap(chunk_file_name(path, i), dtype=np.uint8, mode="r")[cols] for i in range(k, n)])
        if not np.array_equal(gf.matmul(vandermonde_matrix(n - k, k, gf), nat), par):
            raise AssertionError(f"{mode}: parity spot-check against GaloisField.matmul failed")

        for i in range(n - k):
            os.unlink(chunk_file_name(path, i))
        conf = make_conf(n, k, path)
        out = path + ".out"
        _reset_counts()
        _reset_io_counts()
        dec_timer = PhaseTimer()
        t0 = time.perf_counter()
        api.decode_file(path, conf, out, pipeline_depth=depth, timer=dec_timer)
        t_dec = time.perf_counter() - t0
        dec_launches, dec_io = cuda_gemm.LAUNCHES, _io_counts()
        check_pipeline(f"{mode} decode", dec_launches, dec_io)
    finally:
        os.environ.pop("RS_IO_WRITERS", None)
        if saved is not None:
            os.environ["RS_IO_WRITERS"] = saved
    got_sha = sha256_file(out)
    if got_sha != want_sha:
        raise AssertionError(f"{mode}: decoded SHA-256 {got_sha} != input {want_sha}")
    res = dict(
        phase="main_path", mode=mode, pipeline_depth=depth, rs_io_writers=writers or "default", bytes=size, k=k, n=n,
        sha256_match=True, encode_s=t_enc, decode_s=t_dec,
        encode_gbps=size / t_enc / 1e9, decode_gbps=size / t_dec / 1e9,
        launches=enc_launches + dec_launches, encode_launches=enc_launches, decode_launches=dec_launches,
        encode_io=enc_io, decode_io=dec_io,
        encode_phases_s=dict(enc_timer.acc), decode_phases_s=dict(dec_timer.acc),
        encode_phase_sum_s=sum(enc_timer.acc.values()), decode_phase_sum_s=sum(dec_timer.acc.values()),
    )
    log(**res)
    for name in [conf, out, path + ".METADATA"] + [chunk_file_name(path, i) for i in range(n - k, n)]:
        os.unlink(name)
    return res, digests


def phase_main_path(work: str, seed: int, size: int) -> dict:
    """The 1 GiB main path serial, then pipelined; returns both results."""
    path = os.path.join(work, "main.bin")
    want_sha = write_seeded(path, seed, size)
    serial, serial_digests = run_main_path(path, want_sha, "serial", 1, "0")
    piped, piped_digests = run_main_path(path, want_sha, "pipelined", 2, None)
    if serial_digests != piped_digests:
        diff = sorted(name for name in serial_digests if serial_digests[name] != piped_digests.get(name))
        raise AssertionError(f"serial and pipelined archives differ: {diff}")
    log(phase="main_path_archives", identical=True, files=len(piped_digests), digests=piped_digests)
    os.unlink(path)
    return {"serial": serial, "pipelined": piped}


def phase_fleet_and_cli(work: str, seed: int, size: int) -> dict:
    """encode_fleet over three seeded files, each decoded with its first 4
    chunks lost, then a ``-s 3 -p 64`` CLI round trip of the first."""
    k, n = 10, 14
    files = [os.path.join(work, f"fleet{i}.bin") for i in range(3)]
    shas = [write_seeded(f, seed + i, size) for i, f in enumerate(files)]
    _reset_counts()
    _reset_io_counts()
    t0 = time.perf_counter()
    written = api.encode_fleet(files, k, n - k)
    t_fleet = time.perf_counter() - t0
    launches, io_counts = cuda_gemm.LAUNCHES, _io_counts()
    check_pipeline("encode_fleet", launches, io_counts)
    for f, sha in zip(files, shas):
        if written[f] != [chunk_file_name(f, i) for i in range(n)] + [f + ".METADATA"]:
            raise AssertionError(f"encode_fleet wrote {written[f]} for {f}")
        for i in range(n - k):
            os.unlink(chunk_file_name(f, i))
        out = api.decode_file(f, make_conf(n, k, f), f + ".out")
        if sha256_file(out) != sha:
            raise AssertionError(f"encode_fleet: decoded SHA-256 of {f} differs from the input")
    path = files[0]
    before = cuda_gemm.LAUNCHES
    flags = ["-s", "3", "-p", "64", "--device", "cuda"]
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["-k", str(k), "-n", str(n), "-e", path, *flags])
        if rc != 0:
            raise AssertionError(f"CLI encode {flags} exited {rc}")
        for i in range(n - k):
            os.unlink(chunk_file_name(path, i))
        rc = cli.main(["-d", "-i", path, "-c", make_conf(n, k, path), "-o", path + ".cli", *flags])
    if rc != 0:
        raise AssertionError(f"CLI decode {flags} exited {rc}")
    if sha256_file(path + ".cli") != shas[0]:
        raise AssertionError("the -s 3 -p 64 CLI round trip changed the bytes")
    res = dict(phase="fleet_and_cli", files=len(files), bytes_each=size, fleet_encode_s=t_fleet,
               fleet_encode_gbps=len(files) * size / t_fleet / 1e9, fleet_launches=launches, fleet_io=io_counts,
               sha256_match=True, cli_flags=flags, cli_launches=cuda_gemm.LAUNCHES - before, cli_match=True)
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
    """K1 at the main path's shapes vs its bound, its logic-op estimate and
    its plain version: encode and decode (rows 0 and 1, which the compute
    share reads), then the resilience reads' syndrome and repair shapes."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_mhz = float(smi_line("clocks.max.sm").split()[0])
    rng = np.random.default_rng(7)
    k, m8 = 10, SEGMENT_COLS
    gf = get_field(8)
    total = RSCodec(k, 4, device=device).total_matrix
    # Decode as the main path launches it: the first 4 chunks are lost, so
    # only the 4 missing natives' rows of the inverse go through the kernel.
    # The whole p = k = 10 inverse is timed beside it.
    shapes = [("encode k=10 p=4", 8, m8, RSCodec(k, 4, device=device).parity_block),
              ("decode k=10, 4 missing natives", 8, m8, inverse.invert_matrix(total[4:14], gf)[:4]),
              ("decode p=k=10", 8, m8, inverse.invert_matrix(total[4:14], gf)),
              ("encode w=16 k=10 p=4", 16, m8 // 2, RSCodec(k, 4, w=16, device=device).parity_block),
              # The syndrome check of a healthy archive: r=4 rows, depth 14.
              ("syndrome r=4 depth 14", 8, m8, LocateContext(total, k, 4, 8, list(range(14))).check),
              # Repair of chunks 0, 5 and 12 from the first 10 healthy.
              ("repair 3 targets k=10", 8, m8,
               gf.matmul(total[[0, 5, 12]], inverse.invert_matrix(total[[1, 2, 3, 4, 6, 7, 8, 9, 10, 11]], gf)))]
    rows = []
    for label, w, m, A in shapes:
        p, depth = A.shape
        B = random_symbols(rng, (depth, m), w, device)
        got = cuda_gemm.gf_matmul_cuda(A, B, w)
        want = gf_matmul_bitplane(A, B, w)
        err = int((_widen(got) - _widen(want)).abs().max().item())
        if err:
            raise AssertionError(f"kernel != plain at the {label} timing shape")
        ms = time_ms(lambda: cuda_gemm.gf_matmul_cuda(A, B, w), iters=100, reps=3)
        plain = time_ms(lambda: gf_matmul_bitplane(A, B, w), iters=3, warmup=1)
        ops = k1_logic_ops_per_col(p, depth, w)
        row = dict(phase="kernel_timing", shape=label, w=w, p=p, k=depth, m=m, ms=ms, plain_ms=plain,
                   bound_ms=bound_ms(p, depth, m, w), bound_by="bytes", library_ms=None, max_abs_err=err,
                   gbps=(depth + p) * m * (w // 8) / (ms * 1e-3) / 1e9,
                   est_logic_ops_per_col=ops, sms=sms, max_sm_clock_mhz=clock_mhz,
                   est_logic_ms=1e3 * ops * m / (sms * LOGIC_OPS_PER_SM_CLOCK * clock_mhz * 1e6))
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
    planes_sum = Grid("K3-planes-sum")
    # k = 29-32 and 61-63: the edges of the kernel's 30-symbol depth slices
    # and of the plain version's 31-symbol ones.
    for m in (511, 512, 4097, SEGMENT_COLS):
        for k in (4, 10, 29, 30, 31, 32, 61, 62, 63, 128):
            B = _rand_u8(gen, (k, m), device)
            for p in (1, 4, 10):
                A = rng.integers(0, 256, size=(p, k))
                k2.check(cuda_pack2.gf_matmul_pack2(A, B), cuda_pack2.gf_matmul_pack2_plain(A, B), f"p={p} k={k} m={m}")
    # Wide blocks over a ragged last one, and tiles off the 128-column step.
    A, B = rng.integers(0, 256, size=(4, 10)), _rand_u8(gen, (10, SEGMENT_COLS + 1), device)
    for tile in (100, 1000, 4097, 8192, 65536):
        k2.check(cuda_pack2.gf_matmul_pack2(A, B, tile=tile), cuda_pack2.gf_matmul_pack2_plain(A, B),
                 f"p=4 k=10 m={SEGMENT_COLS + 1} tile={tile}")
    # Operators too large for shared memory: A fragments read from device
    # memory, many passes over m-tile pairs, five depth slices.
    for p, k, m in ((64, 128, 4097), (128, 128, 1000)):
        A, B = rng.integers(0, 256, size=(p, k)), _rand_u8(gen, (k, m), device)
        k2.check(cuda_pack2.gf_matmul_pack2(A, B), cuda_pack2.gf_matmul_pack2_plain(A, B), f"p={p} k={k} m={m}")
    # The largest accumulator: every data byte 0xFF (every plane 257) and
    # every coefficient the element whose bit matrix has the most ones in a
    # row, so that row's sum is ones * 30 * (1024 + 257).
    dense = int(get_field(8).bitmats.sum(axis=2).max(axis=1).argmax())
    for k in (30, 31, 62):
        B = torch.full((k, 4097), 0xFF, dtype=torch.uint8, device=device)
        for p in (1, 4, 10):
            A = np.full((p, k), dense)
            k2.check(cuda_pack2.gf_matmul_pack2(A, B), cuda_pack2.gf_matmul_pack2_plain(A, B),
                     f"largest sum: element {dense} p={p} k={k} bytes 0xFF")
    for expand, refold in cuda_planes.PAIRS:
        grid = planes_sum if cuda_planes.is_sum_pair(expand, refold) else planes
        for k in (4, 10, 32):
            for m in (4097, 100003):
                B = _rand_u8(gen, (k, m), device)
                for p in (1, 4, 10):
                    A = rng.integers(0, 256, size=(p, k))
                    want = cuda_planes.gf_matmul_planes_plain(A, B, expand, refold)
                    for tile in (256, 8192):
                        grid.check(cuda_planes.gf_matmul_planes(A, B, expand, refold, tile), want,
                                   f"{expand}+{refold} p={p} k={k} m={m} tile={tile}")
        # The sweep's widest tile: four blocks, the last one ragged.
        A, B = rng.integers(0, 256, size=(4, 10)), _rand_u8(gen, (10, 3 * 65536 + 4099), device)
        grid.check(cuda_planes.gf_matmul_planes(A, B, expand, refold, 65536),
                   cuda_planes.gf_matmul_planes_plain(A, B, expand, refold), f"{expand}+{refold} tile=65536")
        for tile in (256, 8192, 65536):
            grid.check(cuda_planes.gf_matmul_planes(A, B, expand, refold, tile, pinned=True),
                       cuda_planes.gf_matmul_planes_plain(A, B, expand, refold, tile, pinned=True),
                       f"{expand}+{refold} pinned tile={tile}")
    # The sum kernel at depths off its 4-symbol chunks, p off its m-tile
    # pairs, m below one warp step and 16-byte rows at the segment's width,
    # and its largest sums: every byte 0xFF, every coefficient the densest
    # element.
    for expand in cuda_planes.SUM_EXPANDS:
        for k in (1, 3, 5, 33):
            for m in (37, 4097, 65536):
                B = _rand_u8(gen, (k, m), device)
                for p in (1, 2, 4, 10):
                    A = rng.integers(0, 256, size=(p, k))
                    planes_sum.check(cuda_planes.gf_matmul_planes(A, B, expand, "sum"),
                                     cuda_planes.gf_matmul_planes_plain(A, B, expand, "sum"),
                                     f"{expand}+sum p={p} k={k} m={m}")
        for k in (4, 33):
            B = torch.full((k, 4096), 0xFF, dtype=torch.uint8, device=device)
            A = np.full((10, k), dense)
            planes_sum.check(cuda_planes.gf_matmul_planes(A, B, expand, "sum"),
                             cuda_planes.gf_matmul_planes_plain(A, B, expand, "sum"),
                             f"{expand}+sum largest sum: element {dense} k={k} bytes 0xFF")
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
        for refold in ((None,) if kernel == "pack2" else (None, "sum", "dot")):
            grid = k2 if kernel == "pack2" else planes_sum if cuda_planes.is_sum_pair(kernel, refold) else planes
            grid.check(cuda_gemm.gf_matmul_cuda(A, B, 8, expand=name, refold=refold), want, f"expand={name} refold={refold}")
    grids = (k2, planes, planes_sum, copy)
    for grid in grids:
        log(phase="kernel_vs_plain", kernel=grid.name, cases=grid.cases, max_abs_err=grid.worst, tolerance=0)
    return {grid.name: grid for grid in grids}


def _reset_counts() -> None:
    cuda_gemm.LAUNCHES = 0
    cuda_pack2.LAUNCHES = 0
    cuda_planes.LAUNCHES = 0
    cuda_planes.SUM_LAUNCHES = 0
    cuda_planes.COPY_LAUNCHES = 0


def _counts() -> dict:
    return {"K1": cuda_gemm.LAUNCHES, "K2": cuda_pack2.LAUNCHES, "K3-planes": cuda_planes.LAUNCHES,
            "K3-planes-sum": cuda_planes.SUM_LAUNCHES, "K3-copy-floor": cuda_planes.COPY_LAUNCHES}


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
    for name in ("K2", "K3-planes", "K3-planes-sum", "K3-copy-floor"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the tools: {launches}")
    log(phase="tools_launches", **launches)
    return {"sweep": {k: v for r in sweep for k, v in r.items()},
            "probe": {k: v for r in probe for k, v in r.items()}, "launches": launches}


def phase_new_timings(device) -> dict:
    """K2, each K3 pair, the pinned ceiling and the copy floor at the main
    path's encode segment shape."""
    k, p, m = 10, 4, SEGMENT_COLS
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_mhz = float(smi_line("clocks.max.sm").split()[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 9)
    A = RSCodec(k, p, device=device).parity_block
    B = _rand_u8(gen, (k, m), device)
    cases = [("K2", "pack2", lambda: cuda_pack2.gf_matmul_pack2(A, B), lambda: cuda_pack2.gf_matmul_pack2_plain(A, B), None)]
    for expand, refold in cuda_planes.PAIRS:
        cases.append(("K3-planes-sum" if cuda_planes.is_sum_pair(expand, refold) else "K3-planes", f"{expand}+{refold}",
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
        ms = time_ms(fn, iters=100, reps=3)
        row = dict(phase="kernel_timing", kernel=kernel, shape=f"encode k={k} p={p} m={m} ({label})", ms=ms,
                   plain_ms=time_ms(plain, iters=3, warmup=1), bound_ms=bound_ms(p, k, m, 8), bound_by="bytes",
                   library_ms=time_ms(library, iters=20) if library else None, max_abs_err=err,
                   data_gbps=k * m / (ms * 1e-3) / 1e9, traffic_gbps=(k + p) * m / (ms * 1e-3) / 1e9,
                   tile=cuda_pack2.DEFAULT_TILE if kernel == "K2" else cuda_planes.DEFAULT_TILE)
        ops = k2_ops_per_col(p, k) if kernel == "K2" else None
        if kernel == "K3-planes-sum":
            ops = k3_ops_per_col(p, k, label.split("+")[0])
        if ops is not None:
            row.update(est_ops_per_col=ops, sms=sms, max_sm_clock_mhz=clock_mhz,
                       est_ops_ms=1e3 * ops * m / (sms * LOGIC_OPS_PER_SM_CLOCK * clock_mhz * 1e6))
        log(**row)
        rows[label] = row
    return rows


def phase_short_segments(work: str, seed: int, size: int) -> dict:
    """Many short segments (128 KiB, -p 1) at depth 3 with two writers, so
    each pinned buffer, stream and event is reused about 30 times: the
    archive must equal the CPU path's byte for byte (SHA-256), at w=8 and
    w=16, and decode back to the input with its first 4 chunks lost."""
    k, n = 10, 14
    saved = os.environ.pop("RS_IO_WRITERS", None)
    os.environ["RS_IO_WRITERS"] = "2"
    rows = []
    try:
        for w in (8, 16):
            archives, launches = {}, 0
            for dev in ("cuda", "cpu"):
                d = os.path.join(work, f"short_{dev}_{w}")
                os.makedirs(d)
                path = os.path.join(d, "s.bin")
                sha = write_seeded(path, seed, size)
                _reset_counts()
                _reset_io_counts()
                api.encode_file(path, k, n - k, w=w, device=dev, segment_bytes=128 * 1024, pipeline_depth=3,
                                checksums=True)
                if dev == "cuda":
                    launches = cuda_gemm.LAUNCHES
                    check_pipeline(f"short segments w={w}", launches, _io_counts())
                archives[dev] = (path, archive_digests(path, n))
            if archives["cuda"][1] != archives["cpu"][1]:
                raise AssertionError(f"short segments w={w}: the CUDA pipeline's archive differs from the CPU path's")
            path = archives["cuda"][0]
            for i in range(n - k):
                os.unlink(chunk_file_name(path, i))
            out = api.decode_file(path, make_conf(n, k, path), path + ".out", segment_bytes=128 * 1024,
                                  pipeline_depth=3)
            if sha256_file(out) != sha:
                raise AssertionError(f"short segments w={w}: decoded SHA-256 differs from the input")
            rows.append({"w": w, "segments": launches, "archive_equals_cpu": True, "sha256_match": True})
    finally:
        os.environ.pop("RS_IO_WRITERS", None)
        if saved is not None:
            os.environ["RS_IO_WRITERS"] = saved
    res = dict(phase="short_segments", bytes=size, segment_bytes=128 * 1024, pipeline_depth=3, rs_io_writers=2,
               runs=rows)
    log(**res)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    return res


class Ops:
    """Each operation of the resilience phase with the counts set to 0 just
    before it and read just after: its wall, GB/s over ``nbytes`` and K1
    launches.  An operation with a GEMM must launch K1 only on the
    pipeline's compute stream from pinned staging (``check_pipeline``);
    one without must launch nothing."""

    def __init__(self, smi: str):
        self.smi, self.rows = smi, {}

    def run(self, name: str, fn, nbytes: int, gemm: bool = True, staged_ahead: bool = False):
        _reset_counts()
        _reset_io_counts()
        t0 = time.perf_counter()
        result = fn()
        wall = time.perf_counter() - t0
        launches, io_counts = cuda_gemm.LAUNCHES, _io_counts()
        if gemm:
            check_pipeline(name, launches, io_counts, staged_ahead)
        elif launches or io_counts["stream_dispatches"]:
            raise AssertionError(f"{name}: {launches} K1 launches where no GEMM belongs")
        self.rows[name] = dict(wall_s=wall, gbps=nbytes / wall / 1e9, bytes=nbytes, k1_launches=launches,
                               io=io_counts)
        log(phase="resilience_op", op=name, nvidia_smi=self.smi, **self.rows[name])
        return result

    @property
    def launches(self) -> int:
        return sum(row["k1_launches"] for row in self.rows.values())


def _flip(path: str, offsets) -> None:
    """XOR 0xA5 into the bytes of ``path`` at ``offsets``."""
    with open(path, "r+b") as fp:
        for off in offsets:
            fp.seek(int(off))
            b = fp.read(1)[0]
            fp.seek(int(off))
            fp.write(bytes([b ^ 0xA5]))


def _midstream_swap(path: str, want_sha: str, ops: Ops, size: int) -> dict:
    """decode_file from natives 1-9 and parity 10 with the pool [11, 12, 13]:
    a wrapper on native.gather_rows truncates chunk 10 just before the 4th
    segment's gather, whose short read must swap chunk 10 for a pool chunk
    once and resume from the first uncommitted segment."""
    k, n = 10, 14
    chunk = -(-size // k)
    seg_cols = api._segment_cols(chunk, k, api.DEFAULT_SEGMENT_BYTES)
    victim = chunk_file_name(path, 10)
    os.unlink(chunk_file_name(path, 0))
    conf = path + ".swap.conf"
    with open(conf, "w") as fp:
        fp.write("".join(os.path.basename(chunk_file_name(path, i)) + "\n" for i in range(1, 11)))
    real = native.gather_rows
    seen = {"calls": 0, "failures": 0, "failed_off": None, "resume_off": None, "victim_after": False}

    def gather_rows(files, off, cols, fallback_maps=None, dst=None):
        seen["calls"] += 1
        names = [f.name for f in files]
        if seen["calls"] == 4:
            os.truncate(victim, 3 * seg_cols)
        elif seen["failed_off"] is not None:
            seen["resume_off"] = off if seen["resume_off"] is None else seen["resume_off"]
            seen["victim_after"] |= victim in names
        try:
            return real(files, off, cols, fallback_maps=fallback_maps, dst=dst)
        except OSError:
            seen["failures"] += 1
            seen["failed_off"] = off
            raise

    out = path + ".swap.out"
    native.gather_rows = gather_rows
    try:
        ops.run("midstream_swap_decode", lambda: api.decode_file(path, conf, out, _fallback_rows=[11, 12, 13]), size,
                staged_ahead=True)
    finally:
        native.gather_rows = real
    if sha256_file(out) != want_sha:
        raise AssertionError("mid-stream swap: the decoded SHA-256 differs from the input")
    if seen["failures"] != 1 or seen["failed_off"] != 3 * seg_cols or seen["resume_off"] is None:
        raise AssertionError(f"mid-stream swap: expected one failed gather at segment 3 and a resume, saw {seen}")
    resume_seg = seen["resume_off"] // seg_cols
    if resume_seg > 3 or seen["victim_after"]:
        raise AssertionError(f"mid-stream swap: resumed at segment {resume_seg} or still read chunk 10: {seen}")
    os.unlink(out)
    return dict(failed_segment=3, resume_segment=resume_seg, reselects=seen["failures"], gathers=seen["calls"],
                segments=len(api._segment_spans(chunk, seg_cols)))


def _fleet_reads(work: str, seed: int, size: int, ops: Ops, device) -> dict:
    """repair_fleet over three 128 MiB archives, each with another lost
    pair, then decode_fleet with two natives of each lost."""
    k, n = 10, 14
    files = [os.path.join(work, f"rfleet{i}.bin") for i in range(3)]
    shas = [write_seeded(f, seed + i, size) for i, f in enumerate(files)]
    api.encode_fleet(files, k, n - k, checksums=True)
    saved = {f: archive_digests(f, n) for f in files}
    lost = {files[0]: [0, 1], files[1]: [2, 12], files[2]: [5, 13]}
    for f, pair in lost.items():
        for i in pair:
            os.unlink(chunk_file_name(f, i))
    batches, host_solves = [], []
    real_batch, real_select = inverse.invert_matrix_torch_batch, api._select_decodable_subset

    def batch_spy(Ms, w=8, **kw):
        invs, oks = real_batch(Ms, w, **kw)
        batches.append({"shape": list(np.shape(Ms)), "pivot": kw.get("pivot"), "device": str(invs.device),
                        "ok": [bool(v) for v in oks.cpu()]})
        return invs, oks

    def select_spy(scan, **kw):
        host_solves.append(scan.in_file)
        return real_select(scan, **kw)

    api.clear_subset_cache()
    inverse.invert_matrix_torch_batch, api._select_decodable_subset = batch_spy, select_spy
    try:
        got = ops.run("repair_fleet", lambda: api.repair_fleet(files), len(files) * size)
    finally:
        inverse.invert_matrix_torch_batch, api._select_decodable_subset = real_batch, real_select
    if got != lost:
        raise AssertionError(f"repair_fleet rebuilt {got}, expected {lost}")
    if (len(batches) != 1 or batches[0]["shape"] != [3, k, k] or batches[0]["pivot"] is not False
            or batches[0]["device"] != str(device) or not all(batches[0]["ok"]) or host_solves):
        raise AssertionError(f"repair_fleet: batched inversions {batches}, host re-solves {host_solves}")
    for f in files:
        if archive_digests(f, n) != saved[f]:
            raise AssertionError(f"repair_fleet: {f}'s archive differs from the one encoded")

    # The group's inversion alone: the batched call on the card (CUDA
    # events around the H2D of the matrices and the elimination) against
    # the host inverter's loop.
    gf = get_field(8)
    total = api._checked_total_matrix(api.read_archive_meta(files[0] + ".METADATA")).astype(gf.dtype)
    Ms = np.stack([total[inverse.mds_nopivot_order([i for i in range(n) if i not in pair][:k], k)]
                   for pair in lost.values()])
    device_ms = time_ms(lambda: inverse.invert_matrix_torch_batch(Ms, 8, pivot=False, device=device), iters=20)
    t0 = time.perf_counter()
    for _ in range(20):
        for M in Ms:
            inverse.invert_matrix(M, gf)
    host_ms = (time.perf_counter() - t0) * 1e3 / 20

    for f in files:
        for i in (0, 1):
            os.unlink(chunk_file_name(f, i))
    outs = ops.run("decode_fleet", lambda: api.decode_fleet(files, {f: f + ".out" for f in files}), len(files) * size)
    for f, sha in zip(files, shas):
        if sha256_file(outs[f]) != sha:
            raise AssertionError(f"decode_fleet: the decoded SHA-256 of {f} differs from the input")
    return dict(batched_inversions=batches, host_resolves=len(host_solves), invert_batch_device_ms=device_ms,
                invert_host_loop_ms=host_ms, fleet_bytes=len(files) * size, sha256_match=True)


def phase_resilience(work: str, seed: int, size: int, device) -> dict:
    """Scan, auto-decode, repair, the mid-stream swap, the fleets and the
    error-locating reads at k=10, n=14 on ``size`` bytes; returns the
    logged result, with the K1 launches of the whole phase."""
    t0 = time.perf_counter()
    k, n = 10, 14
    smi = smi_line()
    ops = Ops(smi)
    path = os.path.join(work, "res.bin")
    want_sha = write_seeded(path, seed, size)
    chunk = -(-size // k)
    ops.run("encode_checksum", lambda: api.encode_file(path, k, n - k, checksums=True), size)
    saved = archive_digests(path, n)

    os.unlink(chunk_file_name(path, 0))
    os.truncate(chunk_file_name(path, 5), chunk - 1)
    _flip(chunk_file_name(path, 12), [chunk // 2])
    report = ops.run("scan", lambda: api.scan_file(path), size, gemm=False)
    want = dict(healthy=[i for i in range(n) if i not in (0, 5, 12)], corrupt=[5, 12], missing=[0], decodable=True)
    if {key: report[key] for key in want} != want:
        raise AssertionError(f"scan_file reported {report}, expected {want}")

    out = ops.run("auto_decode", lambda: api.auto_decode_file(path, path + ".auto.out"), size)
    if sha256_file(out) != want_sha:
        raise AssertionError("auto_decode_file: the decoded SHA-256 differs from the input")
    with open(path + ".auto.conf") as fp:
        conf = [int(os.path.basename(line).split("_")[1]) for line in fp.read().split()]
    if conf != [1, 2, 3, 4, 6, 7, 8, 9, 10, 11]:
        raise AssertionError(f"auto_decode_file chose {conf}, expected the healthy natives first")
    os.unlink(out)

    rebuilt = ops.run("repair", lambda: api.repair_file(path), size)
    if rebuilt != [0, 5, 12]:
        raise AssertionError(f"repair_file rebuilt {rebuilt}, expected [0, 5, 12]")
    if archive_digests(path, n) != saved:
        raise AssertionError("repair_file: the archive differs from the one encoded")
    clean = api.scan_file(path)
    if clean["healthy"] != list(range(n)) or clean["corrupt"] or clean["missing"]:
        raise AssertionError(f"the scan after repair_file is not clean: {clean}")

    swap = _midstream_swap(path, want_sha, ops, size)
    fleets = _fleet_reads(work, seed + 10, 128 * MiB, ops, device)

    # Silent bitrot: the same input re-encoded without checksums, 64 bytes
    # of chunk 3 flipped at scattered columns.
    ops.run("encode_plain", lambda: api.encode_file(path, k, n - k), size)
    cols = np.sort(np.random.default_rng(seed + 20).choice(chunk, size=64, replace=False))
    _flip(chunk_file_name(path, 3), cols)
    report = ops.run("scan_syndrome", lambda: api.scan_file(path, syndrome=True), size)
    syn = report.get("syndrome", {})
    if (syn.get("verdict") != "silent_bitrot" or syn.get("silent_bitrot") != [3] or syn.get("symbol_errors") != 64
            or report["corrupt"] != [3] or report["decodable"] is not True):
        raise AssertionError(f"scan_file(syndrome=True) reported {report}")
    out = ops.run("locate_decode", lambda: api.locate_decode_file(path, path + ".loc.out"), size)
    if sha256_file(out) != want_sha:
        raise AssertionError("locate_decode_file: the decoded SHA-256 differs from the input")

    res = dict(phase="resilience", nvidia_smi=smi, bytes=size, k=k, n=n, ops=ops.rows, midstream=swap, fleet=fleets,
               silent_bitrot=syn, k1_launches=ops.launches, seconds=time.perf_counter() - t0)
    log(**res)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    return res


def log_compute_share(main_res: dict, timings: list[dict]) -> None:
    """K1's share of each main-path run's wall: its launches times its
    phase-6 time at the encode and the decode segment, over the wall."""
    enc_ms, dec_ms = timings[0]["ms"], timings[1]["ms"]
    for mode, res in main_res.items():
        log(phase="compute_share", mode=mode, k1_encode_ms=enc_ms, k1_decode_ms=dec_ms,
            encode=res["encode_launches"] * enc_ms * 1e-3 / res["encode_s"],
            decode=res["decode_launches"] * dec_ms * 1e-3 / res["decode_s"])


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
        entry("K1 gf_gemm (bit-sliced GF(2^w) GEMM; pre-parity: popcount)", "gpu_rscode_torch/ops/csrc/gf_gemm.cu",
              "gpu_rscode_tpu/ops/pallas_gemm.py:307", main_launches, k1_err, k1_timing),
        entry("K2 gf_pack2 (packed two-column GF(2^8) GEMM)", "gpu_rscode_torch/ops/csrc/gf_pack2.cu",
              "gpu_rscode_tpu/ops/pallas_gemm.py:256", tl.get("K2"), grids["K2"].worst, t.get("pack2")),
        entry("K3 gf_planes (bit-plane GEMM on int8 mma; timed: shift_raw+dot)", "gpu_rscode_torch/ops/csrc/gf_planes.cu",
              "gpu_rscode_tpu/tools/kernel_sweep.py:175", tl.get("K3-planes"), grids["K3-planes"].worst,
              t.get("shift_raw+dot")),
        entry("K3 gf_planes_sum (bit-plane GEMM, byte expansions' sum refold, scaled u8 mma; timed: shift+sum)",
              "gpu_rscode_torch/ops/csrc/gf_planes.cu", "gpu_rscode_tpu/tools/kernel_sweep.py:39",
              tl.get("K3-planes-sum"), grids["K3-planes-sum"].worst, t.get("shift+sum")),
        entry("K3 copy_floor (the copy floor, K1's traffic)", "gpu_rscode_torch/ops/csrc/gf_planes.cu",
              "gpu_rscode_tpu/tools/kernel_sweep.py:73", tl.get("K3-copy-floor"), grids["K3-copy-floor"].worst,
              t.get("copy_floor")),
    ]


def ptxas_kernels(ptxas: str) -> list[dict]:
    """Registers and spilled bytes of each kernel instance in ``-Xptxas=-v``
    output, named ``gf_bitslice_kernel<w,rt>`` / ``gf_popcount_kernel<w,nw,cpt>`` /
    ``gf_pack2_kernel<1>`` (1: operator in shared memory, 0: read from device
    memory) / ``gf_planes_kernel<expand,refold>`` / ``gf_planes_sum_kernel<expand>``."""
    out = []
    for block in ptxas.split("Compiling entry function '")[1:]:
        mangled = block.split("'", 1)[0]
        found = re.search(r"(gf_[a-z0-9_]+_kernel)I((?:L[ib]\d+E)+)", mangled)
        name = mangled
        if found:
            name = f"{found.group(1)}<{','.join(re.findall(r'L[ib](-?[0-9]+)E', found.group(2)))}>"
        regs = re.search(r"Used (\d+) registers", block)
        spill = re.search(r"(\d+) bytes spill stores", block)
        out.append({"kernel": name, "registers": int(regs.group(1)) if regs else None,
                    "spill_store_bytes": int(spill.group(1)) if spill else None})
    return out


def phase_build() -> None:
    """The three kernel libraries (one nvcc each) and the native IO library
    (g++), all at once."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1) as pool:
        host_io = pool.submit(native.library_path)
        _build.build_many(LIBS)
        host_io.result()
    wall = time.perf_counter() - t0
    for name in LIBS:
        ptxas = _build.BUILD_LOG.get(name, "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
        spills = sorted({int(b) for b in re.findall(r"(\d+) bytes spill stores", ptxas)})
        log(phase="build", library=name, nvcc_seconds=_build.BUILD_SECONDS.get(name), kernels=len(regs),
            max_registers=max(regs, default=None), spill_store_bytes=spills)
        log(phase="build", library=name, per_kernel=ptxas_kernels(ptxas))
    log(phase="build", library="rs_native_io", gxx_seconds=_build.BUILD_SECONDS.get("rs_native_io"),
        path=os.path.relpath(native.library_path(), REPO))
    log(phase="build", parallel_wall_seconds=wall)
    cuda_gemm._lib(), cuda_pack2._lib(), cuda_planes._lib()
    native.get_lib()  # raises NativeUnavailable: the card run must not take the fallback


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
            phase_fleet_and_cli(work, SEED + 3, 128 * MiB)
            phase_short_segments(work, SEED + 4, 16 * MiB)
            resilience = phase_resilience(work, SEED + 5, MAIN_FILE_BYTES, device)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        timings = phase_timings(device)
        log_compute_share(main_res, timings)
        tools = phase_tools()
        new_timings = phase_new_timings(device)
        kernels = kernel_entries(k1_err, grids, timings[0],
                                 main_res["pipelined"]["launches"] + resilience["k1_launches"], new_timings,
                                 tools["launches"])
    log(phase="wall", seconds=time.perf_counter() - t_start, quick=args.quick)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
