#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (gpu_rscode_torch) end to end on one GPU.

    python3 chip_smoke.py            # every phase; needs one CUDA card
    python3 chip_smoke.py --quick    # build + kernel-vs-plain grids only

Phases, each fatal on failure:
  1. the card's name and power limit (nvidia-smi); CUDA must be present;
  2. build the three CUDA kernel libraries from the checkout's sources, one
     nvcc each, all at once (timed), with each kernel instance's registers
     and spills (the gf_planes instances listed apart);
  3. K1 against its plain PyTorch version on the card, bit-exact, over a
     grid of shapes at w=4 (bytes with the high nibble set), w=8 and w=16
     in both forms (the folded bit-sliced kernel and the pre-parity
     popcount kernel): ragged and misaligned
     widths (m = 1, 31, 33, 1639, ...; rows that start off 16-byte
     alignment), shapes that need several output tiles and depth chunks,
     p = k decode shapes up to 128, and the update's E·Δ widths (2, 3,
     409-411, 822, 411,007 columns);
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
     host re-solve where a group of 3 reaches the card's routing threshold
     for k=10, else through the host search alone, one archive each, and
     rebuild every chunk byte for byte, then
     decode_fleet must give their SHA-256s; and the archive re-encoded
     without checksums, 64 bytes of one chunk flipped, must be named
     silent_bitrot by scan_file(syndrome=True) and restored by
     locate_decode_file.  Every GEMM runs K1 on the compute stream from
     pinned staging; each operation's wall, GB/s (of the 1 GiB file, or
     of the fleet's bytes) and K1 launches are logged, and the batched
     inversion's device time beside the host loop's;
  5c. the interleaved layout and the in-place updates at the main path's
     setting (k=10, n=14, w=8, --checksum, 64 MiB segments, a seeded 1 GiB
     file): an interleaved encode; its chunk 0 lost, auto_decode_file
     (SHA-256) and repair_file (the saved digests); a copy without CRC
     lines with 64 bytes of chunk 3 flipped, locate_decode_file; a 64 MiB
     append_file, a 64 MiB update_file at 300,000,007 and update_file_many
     of 1,000 seeded 4 KiB edits in one group, which must take ONE stacked
     K1 launch; a 4 MiB update under RS_UPDATE_CRASH=mid_patch, which must
     leave a pending journal that recover_archive rolls back to the pre-op
     digests; on a row archive of another seeded file, a 64 MiB update
     across rows 1 and 2, a 7-byte append past its 6-byte slack refused
     and a 6-byte append taken.  The source file is each archive's host
     mirror, edited alongside: a re-encode of it (same layout) must give
     byte-identical chunks and # crc32 lines, and a decode with chunks 0-3
     lost its SHA-256.  Each operation's wall, GB/s of its payload, K1
     launches (on the compute stream from pinned staging) and phases are
     logged;
  5d. the strategies xor and ring (plain PyTorch XOR chains over packed bit
     planes, no hand-written kernel): phase 4's 1 GiB file encoded under
     each, pipelined, must give chunks and .METADATA byte-identical to the
     cuda archive of phase 4, and decode with chunks 0-3 lost to its
     SHA-256; locate_decode_file under xor on phase 5b's bitrotted archive
     with native 0 lost, then with the bitrot undone, must restore the
     input, and every segment it did not correct must feed its recovery
     GEMM from the syndrome GEMM's pack (the corrected ones re-stage); a
     4 MiB update_file under xor on a copy of phase 5c's interleaved
     archive must equal the same update under cuda on another copy; a
     64 MiB w=16 CLI round trip under each.  Each of these runs with the
     counts reset: K1 must not be launched, the codec's plain GEMMs must
     not be called, and every stream dispatch must be an xor or ring
     pipeline call.  Both are also held bit-exact against K1 on the card
     over K1's grid shapes with k <= 16, p <= 8 (w 8 and 16, ragged and
     misaligned), and timed at the encode and decode segments (pack,
     chain, unpack, the whole dispatch and its host enqueue time, CUDA
     events, best of 3) beside K1 and the bound, with each schedule's XOR
     count, its device ops a dispatch and its build time cold and from a
     warm schedule store;
  5e. the plan layer (gpu_rscode_torch/plan.py: bucketed plans replayed
     from CUDA graphs; tune.py; the native host codec): phase 4's 1 GiB
     file with RS_PLAN=0 (eager, exact widths) serial and pipelined, each
     archive byte-identical to phase 4's (layer on), then the layer on
     again, pipelined and warm, where every encode and decode dispatch must
     be a graph replay; the same file under --strategy cpu (archive equal
     to cuda's, decode to the input, no NumPy-oracle call) and native.gemm
     at the encode segment; after phase 5d's timings, a ragged file (64 MiB
     + 12,345 bytes) under cuda, xor and ring, eager, cold and warm (every
     warm dispatch, the tail's included, a replay; every archive equal to
     the eager cuda one); the dispatch table (cuda, xor, ring at the encode
     and decode segments: device ms and host enqueue ms eager against the
     graph replay, device ops a dispatch, plan counts); and the autotuner
     in measure mode at k=10, p=4, w=8, whose winner a fresh process in
     prior mode must read back from the store.  Every phase logs the plan
     layer's calls, captures and replays; K1 counts eager launches plus the
     launches inside replays (k1_runs);
  5f. the object store (gpu_rscode_torch/store/) at its documented
     defaults, k=4, p=2, w=8, interleaved stripes sealing at 64 MiB,
     through the api's object wrappers with no device given: 2,048
     objects of seeded sizes, log-uniform over 4 KiB-1 MiB (about 0.36
     GiB), PUT in batches of 64, then one batch of 1,000 x 4 KiB; every
     object read back and held against its host mirror (SHA-256); 128
     deleted (gone from the listing, their ranges zero in the archive); a
     forced compaction (every retired archive's files gone, every live
     object read back); one native chunk of a sealed stripe moved away and
     every object of that stripe read through the degraded path (each
     counted in rs_store_range_reads_total{path="degraded"}); a flipped
     byte in an object's range repaired through its CRC, then refused
     with RangeReadError once the chunk's CRC line is forged; a reopen
     through the snapshot ladder and one by full replay
     (RS_STORE_SNAPSHOT_DISABLE=1) that must give the same index; and
     every stripe's parity against GaloisField.matmul of its natives.  It
     runs after phase 5e's last steps (its window widths fill the plan
     cache, whose counts phase 5e reads as deltas), with metrics on and RS_STORE_SNAPSHOT_KEEP unbounded (so
     that full replay stays possible); it logs each operation's wall,
     objects/s, MB/s and K1 launches (K1 must run for PUT, DELETE,
     COMPACT and the degraded GETs and not for the fast GETs), the index
     fsyncs, the snapshots, both open times and the GEMM shapes;
  5g. the serving daemon (gpu_rscode_torch/serve/) on the card: one
     ServeDaemon on 127.0.0.1, port 0, device cuda:0, at its default knobs
     (2 workers, depth 64, a 5 ms window, 16 a batch), with RS_METRICS=1
     and RS_RUNLOG in the work directory, talked to over HTTP only: four
     seeded 256 MiB POST /encode (k=10, n=14, checksum) from tenants alpha
     and beta at once, their POST /decode with the first 4 natives away
     (SHA-256), a flipped parity byte found by /scrub?syndrome=1 and GET
     /health, 64 concurrent 4 KiB /update requests in ONE write group (the
     window and cap raised to 2 s / 64 for that step) and a 1 MiB /append
     on a 64 MiB interleaved archive decoded against a host mirror; 1,024
     seeded objects (log-uniform 4 KiB-1 MiB) at the store's defaults PUT
     from 16 client threads, every GET against its mirror, a hot set of 64
     read twice (cache hits), the hot set read with the ledger on and off
     in turns (on, off, off, on), 128 DELETEs answering 404 after, every
     object of a sealed stripe read degraded with one native chunk away;
     the port's run_open_loop twice (the default mix, 15 s at 8 req/s; an
     object mix, 15 s at 32 req/s), neither with a failure; a second
     daemon (depth 2, one worker) under 32 concurrent 16 MiB encodes, some
     answering 429 with the request id, drained, every admitted archive
     decoded to its source; and one segment of every archive's parity
     against the GF oracle.  The batch-fallback count must be 0, no
     request may fail, and K1 must run (read after both daemons closed);
     each route's wall, MB/s or req/s, p50 and p99 are logged, with the
     batch sizes, the cache hit rate, the stage medians, the ledger
     digest's cost and PLAN_CACHE.stats();
  5h. the fault and maintenance planes (gpu_rscode_torch/resilience/,
     maint/) on cuda:0: rs chaos in-process for every class at seed
     20260807 x 12 and --object at 20260804 x 12, each class's schedule
     and verdict digests equal to the JAX package's (CHAOS_DIGESTS), every
     iteration passing and K1 running in each; a seeded 1 GiB archive
     (k=10, n=14, --checksum, 64 MiB segments) with chunk 0 lost and chunk
     5 rotted, auto-decoded under read:ioerror@p=0.05;read:delay@ms=1,p=0.1
     (SHA-256; rs_retries_total retried and recovered > 0), a torn encode
     under write:torn@after=64KiB (the injected fault, no chunk and no
     .rs_tmp left), the mid-stream swap of a 1 MiB k=3 n=5 archive in
     4 KiB segments under chunk1:ioerror@from=2,scope=read (bytes exact,
     one swap; a plain conf decode names chunk 1) and chunk1's scrub read
     error (state read_error, still decodable); rs maint's dry run (4
     repairs) and --drain over 4 x 256 MiB archives with one rotted chunk
     each (every chunk's SHA-256 restored), then a fifth drained under
     RS_MAINT_CRASH=repair:mid and again (converged); and loadgen's
     run_maint_ab (4 x 64 MiB, k=10, p=4, 10 s at 8 req/s): the ON arm
     converges, the governor pauses, the foreground p99 ratio stays within
     1.25, GET /maint answers enabled, no request fails (each arm's
     queue wait, service, slowest requests and repair times logged from
     its ledger).  Each step's
     wall, GB/s, retries, K1 runs and the plan cache's counts are logged;
  5i. the measurement plane (gpu_rscode_torch/obs/: profiler, perfbase,
     attrib; the CLI's --metrics-json, --trace, --profile-dir, rs perf,
     rs analyze, rs stats, rs history) at the main path's setting (a
     seeded 1 GiB file, k=10, n=14, w=8, 64 MiB segments): (a) encode and
     decode through the CLI with RS_METRICS=1, --metrics-json and --trace:
     17 dispatches an op (segments_dispatched{strategy="cuda"}), each one
     K1 run, rs_codec_bytes_total = k x the chunk size,
     rs_io_write_bytes_total = the 4 parity chunks' bytes on encode (the
     natives are straight file copies, which neither package counts as
     staging IO) and the file's bytes on decode, 17 dispatch spans an op
     in valid Chrome-trace JSON, the output's SHA-256; (b) the encode with
     every plane off, with RS_METRICS=1 and with RS_PROF=1 (walls logged,
     nothing gated), and a profiled decode: one rs_perf event a dispatch,
     each a K1 graph replay timed as its chain stage or a capture timed as
     compile, with the median coverage and stage walls logged; (c) one
     encode and one decode under --profile-dir: one torch.profiler
     session each, whose key_averages() must list gf_bitslice_kernel as
     often as K1 ran, with device time (with RS_PLAN=0 as well if the
     graph replays hide the name; if the trace holds no device event, the
     cudaGraphLaunch calls must equal the replays), and the device-busy
     share of each op's wall (kernels and copies, their union on the
     timeline) logged; (d) rs perf --record then --check (exit 0), and a
     daemon with RS_RUNLOG answering GET /perf with the cuda cells and
     /metrics with the rs_perf_baseline_* gauges; (e) rs analyze over
     cuda, bitplane, xor, ring and native at k=10, p=4, 256 MiB in 64 MiB
     segments, the roofline probed on the card (each row's GB/s and
     verdict logged); (f) rs stats --workload and rs history --op encode,
     each exiting 0.  K1's runs count in the kernels line;
  5j. the mesh (gpu_rscode_torch/parallel/: mesh, sharded, distributed;
     obs/aggregate, obs/doctor): (a) BASELINE config 4, the wide stripe
     (k=128, n=144, w=8) on a seeded 1 GiB file in 64 MiB segments: the
     single-device cuda encode, then the same encode through the library on
     a (4, 1) mesh of cuda:0 with stripe_sharded (chunks and .METADATA of
     equal SHA-256; per segment 4 pre-parity K1 launches and nothing else,
     rs_mesh_collective_bytes_total = p*w*m = 16*8 x the chunk size, one
     mesh plan-cache miss and a call a segment), its decode with the first
     16 chunks lost (SHA-256, 4 pre-parity launches a segment), and the
     encode on a (1, 4) cols mesh (4 folded launches a segment, the same
     archive); (b) the main configuration (k=10, n=14) through the CLI with
     --devices 1: phase 4's seeded file, its archive byte-equal to phase
     4's, a decode with the first 4 chunks lost; (c) two ranks on the one
     card (gloo with CUDA tensors), --devices 2 --stripe 2 on a seeded
     256 MiB file: encode with --metrics-json / --trace parts, a conf
     decode with 4 chunks lost, an --auto decode and a --repair, each a
     collective (outputs' SHA-256, the repaired archive equal to one
     process's run of the same (2, 1) mesh), then rs aggregate: the summed
     staged bytes equal the single process's, each part's collective bytes
     and staged segments equal its, one trace lane a rank; a one-rank NCCL
     group (the backend the rule picks, an int8 sum); (d) rs doctor --json:
     the torch section names the card, the mesh section one CUDA device
     and NCCL, no warning; then K1 timed at the two shard shapes (cols:
     k=128, p=16, a quarter segment, folded; stripe: k=32, p=16, a
     segment, pre-parity) next to its plain version and bound.  Each
     operation's wall, GB/s and K1 runs are logged;
  6. timings: file encode/decode GB/s of phase 4, and K1 at the main path's
     segment shapes, at phase 5b's syndrome (r=4, depth 14) and repair
     (3 targets, k=10) shapes, at phase 5c's E·Δ shapes (the stacked
     group, one 4 KiB window) and at phase 5f's (a 64-object PUT batch's
     E·Δ, the 1,000 x 4 KiB batch's, a degraded GET's window recovery)
     next to its bound, the logic-op estimate of its design and its plain
     version;
  7. K2 (pack2) and K3 (every expand+refold pair, the pinned mode, the copy
     floor) against their plain versions on the card, bit-exact, and the
     dispatch of every expansion name through gf_matmul_cuda; K3's sum
     kernel (gf_planes_sum_kernel, every w=8 expansion) also at depths
     1-33, p = 1-10 and its largest sums; K2 also at
     its depth-slice edges, at the largest accumulator a slice can reach,
     at tiles that are not a multiple of its 128-column step, and with
     operators too large for shared memory; K3 at w=16 (shift, shift_raw,
     sign x sum, dot: the sum and dot kernels) at k 1-33, p 1-10, m
     37-100,003, tiles 256 and 8192, pinned, and at its largest sums (every
     symbol 0xFFFF, the densest element); per instance at p=16 the largest
     k its staged route takes and the next (the route through L1, or the
     ValueError with no launch), the largest k each instance the sum, dot
     and none kernels took over from the retired generic kernel had (w=4
     and w=16's pre-parity form included), and w=16 at k = 16,400 (sums
     past 2^31); the pre-parity form (refold none) of every instance at
     w=4, 8 and 16 (gf_planes_none_kernel), exact int32, with the stripe
     mesh's k=32, p=16; the public dispatch of every JAX name at w=16
     (refold none, sum, dot, autotune) and with fold_parity=False; K3's six
     W=4 instances (shift, shift_raw x sum, dot, none: the sum, dot and
     none kernels) at k 1-33, p 1-17, m 37-100,003, pinned, at their
     largest sums and through the public dispatch (bytes with the high
     nibble set); the dot refold of
     every w=8 expansion (gf_planes_dot_kernel) on the dot pairs' grid, at
     depths 1-33, p 1-16, its largest sums, and the largest k that fits at
     p=16 with the refusal one past it; and nibble on the sum and dot
     kernels (PRMT-table planes) on both grids, at k 52, 53 and 128 (its
     operator in shared memory, then read through L1) at p 1-16, and at
     the largest k at p=16 (908) with the refusal one past it;
  8. the kernel-formulation tools as entry points on the card at their
     default sizes (kernel_sweep 64 MB, expand_probe 320 MB): every result
     a number, and K2, K3's GEMM and K3's copy floor each launched;
  5k. the seven tools of gpu_rscode_torch/tools/ that joined the first two,
     at reduced sizes (the phase's budget is 120 s), each through the same
     check as phase 8 (the capture header first, every number in every row
     finite and positive; each tool holds every timed output against the
     GF oracle before it prints a rate): inverse_bench at k 10 and 128 x
     batch 3 and 256, mesh_bench on 64 MB, mesh_overhead at 1 and 8 MB,
     strategy_bench on a 64 MB stripe, k_sweep on 64 MB, w16_bench on
     64 MB, stream_bench on a 256 MB file; then repair_fleet over three
     small damaged archives at k=10, n=14 and three at k=128, n=144, each
     of which must call the batched inverter once if a group of 3 reaches
     the card's measured threshold for its k
     (api._device_invert_min_batch_cuda, data/inverse_routing_h100.jsonl)
     and not at all otherwise (phase 5b's fleet of 3 follows the same
     rule), every rebuilt chunk equal to its original.  The counts are reset just before; K1's runs join the
     kernels line;
  5l. the last five tools, at reduced sizes (the phase's budget is 120 s),
     through the same check as 5k, every file under the smoke's work dir:
     io_bench's staging calls on a 64 MB file and its sync-drain against
     write-behind A/B (64 MB encode and decode, two archives' fleet repair;
     each row's read / compute / write split), update_bench and
     update_group_ab on 64 MiB archives (64 x 4 KiB edits), xor_ab on a
     20 MiB stripe (xor, xor_noopt, ring, table, cuda) and its locate A/B on
     16 MiB (packed-operand reuse on and off, the pack pass eager so both
     arms' pack sums are timed), warm_ab's cold, seeded and warm child
     processes on 4 MiB.  Each tool holds its outputs (parity against the
     GF oracle, SHA-256, re-encode twins, the warm start's zero builds)
     before it prints a rate.  The counts are reset just before; K1 must
     run, and its runs join the kernels line;
  5m. the RS_PALLAS_* knobs on the main path, the counts reset before each
     step and K1 required not to run: under RS_PALLAS_EXPAND=shift_raw
     RS_PALLAS_REFOLD=autotune a seeded 1 GiB k=10 n=14 encode (archive
     byte-identical to phase 4's K1 archive) and its decode with the first
     4 chunks lost (SHA-256), every dispatch a K3 run and some inside graph
     replays, the calibrated choices, rs_pallas_autotune_total and the
     plans' refolds logged; under RS_PALLAS_EXPAND=shift_raw the same file
     encoded on a (2, 1) stripe mesh of the card (K3's pre-parity form,
     gf_planes_none_kernel alone; the archive equal to phase 4's), and a
     seeded 256 MiB w=16 file the same way (the none kernel at w=16; the
     archive equal to K1's of the same file); under RS_PALLAS_EXPAND=pack2
     its encode through K2 captured into the plans' graphs (equal to phase
     4's); a 256 MiB w=16 CLI round trip under RS_PALLAS_REFOLD=autotune
     (the sum and dot kernels at w=16, inside replays too, and no other K3
     kernel); RSCodec(10, 4, w=4) on the card (encode, decode with the
     first 4 natives lost, an update) on staged 64 MiB segments, three
     times each, under no knob (K1), under RS_PALLAS_EXPAND=shift_raw (K3
     at W=4: the sum kernel) and under it with RS_PALLAS_REFOLD=dot (the
     dot kernel), each against K1's plain version and inside graph
     replays; and a seeded
     256 MiB w=8 file encoded under no knob (K1) and then under
     RS_PALLAS_EXPAND=shift_raw alone (the dot refold: gf_planes_dot_kernel,
     inside replays), the two archives byte-identical, then decoded with
     the first 4 chunks lost (SHA-256); then the same file under
     RS_PALLAS_EXPAND=nibble, encoded through nibble+dot (archive equal to
     K1's) and decoded under RS_PALLAS_REFOLD=sum through nibble+sum, both
     inside replays.  The environment is restored and the plan and
     autotune caches cleared after it;
  9. K2, each K3 pair, the compute-only ceilings (shift_raw+dot and
     nibble+sum pinned) and the copy floor timed at
     the main path's encode segment next to the bound, the plain version
     and, for the copy floor, B[:p].clone() (which moves 2·p·m bytes, not
     the floor's (k + p)·m); K3's w=16 pairs and pre-parity form at the
     w=16 encode segment (m = 3,355,392) and its pre-parity form at the w=8
     segment (bound: B read and the int32 sums written once); K1 in both
     forms and K3's six W=4 instances at w=4 on the same bytes (one symbol
     a byte); K2 and every K3 row beside the instruction estimate of its
     design and the tensor-core bound of its product
     (nibble's k*32 planes: past the bytes bound), each row with the tile
     it ran at.  tools/k3_timings_ab.py runs this phase in a parent tree
     and this one in turns.

Phases run in the order 1-5, 5b-5j, 5m, 6, 8, 5k, 5l, 9.  The last lines are
nvidia-smi's name and power limit, the kernels JSON and the result JSON.
A phase that fails prints one line {"phase": "failed", "at": the phases
running, "last_logged": the last phase and step logged, "error": the
exception's class and message} and the exception propagates (exit 1).
--quick runs phases 1-3, 7 and phase 5d's grid and prints
the same three lines, with the times it did not take as null.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import io
import itertools
import json
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gpu_rscode_torch import api, cli, native, plan, tune
from gpu_rscode_torch.codec import RSCodec
from gpu_rscode_torch.gf_decode import LocateContext
from gpu_rscode_torch.models.vandermonde import vandermonde_matrix
from gpu_rscode_torch.ops import _build, cuda_gemm, cuda_pack2, cuda_planes, ring_gemm, xor_gemm
from gpu_rscode_torch.ops import gemm as gemm_module
from gpu_rscode_torch.ops.gemm import _widen, gf_matmul_bitplane, to_tensor
from gpu_rscode_torch.ops import inverse
from gpu_rscode_torch.ops.gf import get_field
from gpu_rscode_torch.parallel import pipeline
from gpu_rscode_torch.tools import (expand_probe, inverse_bench, io_bench, k_sweep, kernel_sweep, mesh_bench,
                                    mesh_overhead, strategy_bench, stream_bench, update_bench, update_group_ab,
                                    w16_bench, warm_ab, xor_ab)
from gpu_rscode_torch.tools.make_conf import make_conf
from gpu_rscode_torch.utils.env import scoped
from gpu_rscode_torch.utils.fileformat import chunk_file_name
from gpu_rscode_torch.utils.timing import PhaseTimer

REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
INT8_OPS_PER_S = 1.979e15  # H100 SXM dense int8 tensor-core rate (reached by wgmma only)
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


# The phases running, outermost first, and the last phase / step logged: a
# failing run's last lines name where it failed (main).
AT: list[str] = []
LAST_LOGGED: dict = {}


def log(**fields) -> None:
    LAST_LOGGED.update(phase=fields.get("phase"), step=fields.get("step"))
    print(json.dumps(fields), flush=True)


def _named(label: str):
    """Push ``label`` on :data:`AT` while the phase runs; an exception
    leaves it there."""

    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            AT.append(label)
            out = fn(*args, **kwargs)
            AT.pop()
            return out

        return run

    return wrap


def smi_line(fields: str = "name,power.limit") -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def sym_bytes(w: int) -> int:
    """Bytes a GF(2^w) symbol takes in memory: one at w=4 and 8."""
    return 2 if w == 16 else 1


def bound_ms(p: int, k: int, m: int, w: int) -> float:
    """Least time for C = A.B over GF(2^w) at (p, k, m): B read once and C
    written once at the device-memory rate.  The GF(2) product itself needs
    no multiply; what K1's design issues per column on the logic pipe is
    estimated beside it (k1_logic_ops_per_col)."""
    return 1e3 * (k + p) * m * sym_bytes(w) / HBM_BYTES_PER_S


def k1_logic_ops_per_col(p: int, k: int, w: int) -> float:
    """An estimate from the bit-sliced design, not a measurement: per column,
    one LOP3 for each (output plane, input plane) pair of every tile, plus
    five logic or shift ops per masked swap of the transposes (log2(w)
    stages of w/2 swaps) on each input row of each tile and on each output
    row, over the thread's 32 columns.  At w=4 the transposes are w=8's
    (one symbol a byte)."""
    rt, tiles, _ = cuda_gemm.bitslice_plan(p, k, w)
    sw = max(w, 8)
    swaps = 5 * int(math.log2(sw)) * (sw // 2)
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
# instructions it is emulated with; nibble: one PRMT of a table).  The
# pre-parity form's exact planes: shift_raw masks the next byte's bits
# off, nibble ANDs half its chunks' planes to 0/1.
K3_PLANE_OPS = {"shift": 2, "shift_raw": 1, "cmp": 6, "sign": 5, "nibble": 1}
K3_EXACT_PLANE_OPS = {**K3_PLANE_OPS, "shift_raw": 2, "nibble": 1.5}


def _k3_depth(k: int, expand: str, w: int = 8, exact: bool = False) -> tuple[int, int]:
    """A pass's warp instructions over the depth, besides the mma and the
    operator's fragment reads, and its operator chunks.  At w=8, per four
    rows it reads them (4 LDS.64) and transposes them (16 PRMT); the byte
    expansions then make one chunk's 16 plane registers, nibble shifts the
    8 words' high halves (8) and makes 16 a chunk in 2-4 chunks (one a
    symbol, k rounded up to pairs).  At w=16 a chunk is two rows (2
    LDS.128 and 8 PRMT that split the bytes) and 16 plane registers.  At
    w=4 a chunk is 8 rows: per four rows read (none past k) the same 4
    LDS.64 and 16 PRMT and 8 plane registers (plane t alone; the dot
    kernel also makes the zero words' planes past k, not counted).
    ``exact``: the pre-parity form's plane values."""
    ops = (K3_EXACT_PLANE_OPS if exact else K3_PLANE_OPS)[expand]
    if w == 4:
        return -(-k // 4) * (4 + 16 + 8 * ops), -(-k // 8)
    if w == 16:
        chunks = -(-k // 2)
        return chunks * (2 + 8 + 16 * ops), chunks
    blocks = -(-k // 4)
    if expand == "nibble":
        chunks = 2 * -(-k // 2)
        return blocks * (4 + 16 + 8) + chunks * 16 * ops, chunks
    return blocks * (4 + 16 + 16 * ops), blocks


def _k3_copies(k: int, w: int) -> int:
    """A warp step's copies of its k rows into shared memory: a predicated
    16-byte cp.async per 32 / (4 w / 8) rows a lane, about 6 instructions
    each, and about 20 for the commit, wait and loop."""
    return 6 * -(-k // (32 // (4 * w // 8))) + 20


def k3_ops_per_col(p: int, k: int, expand: str, w: int = 8) -> float:
    """An estimate from the design of gf_planes_sum_kernel, not a
    measurement: thread instructions per column besides the mma, for the
    sum refold.  A warp step covers 64 columns as 8 mma column groups.  Per
    step it copies its k rows (_k3_copies).  Per pass over a pair of
    m-tiles (at w=4 the last one may run alone) it zeroes 64 accumulators
    (32) and controls its loop (10), runs the depth (_k3_depth) and reads
    one A fragment per chunk and m-tile.  Per m-tile it refolds 8 groups
    at 10 instructions each (3 PRMT, a mask, 3 shuffles, 3 OR; w=4: 2
    shuffles, 8) and stores: w=4 and 8, 6 PRMT, its address and one 8-byte
    store (10); w=16 (an m-tile a symbol), 4 PRMT, its address and one
    16-byte store (8).  Each instruction runs on 32 threads, over 64
    columns."""
    groups, step = 8, 64
    mt = -(-p * w // 16)
    passes = -(-mt // 2)
    depth, chunks = _k3_depth(k, expand, w)
    warp_instr = (_k3_copies(k, max(w, 8)) + passes * (32 + 10) + passes * depth + chunks * mt
                  + mt * ((8 if w == 4 else 10) * groups + (8 if w == 16 else 10)))
    return warp_instr * 32 / step


def k3_ops_bound_ms(p: int, k: int, m: int, expand: str, w: int = 8) -> float:
    """Least time for the tensor-core work of an expansion's product at the
    card's dense int8 rate: 2 * (p*w) * depth operations a column, the
    depth k*w bit planes or k*32 one-hot nibble planes."""
    return 1e3 * 2 * p * w * k * (32 if expand == "nibble" else w) * m / INT8_OPS_PER_S


def k3_dot_ops_per_col(p: int, k: int, expand: str, w: int = 8) -> float:
    """An estimate from the design of gf_planes_dot_kernel, not a
    measurement: thread instructions per column besides the mma, for the
    dot refold.  The step's copies as k3_ops_per_col counts them.  Per pass
    over 4 n-tiles (32 operator rows) it zeroes 64 accumulators (32) and
    controls its loop (10), runs the depth (_k3_depth) and reads 2
    B-fragment uint4 a chunk.  Per pass it moves the 64
    accumulators into the second product's 16 A registers (3 PRMT and a
    mask each, 64).  Per 8-byte-symbol output tile it zeroes 16 sums (8),
    controls its loop (10) and stores: w=8, 2 symbols with 6 PRMT, an
    address and a test and one 8-byte store each (22); w=16, one symbol
    with 12 PRMT, an address, a test and one 16-byte store (15).  At w=4 a
    pass (8 symbols) is a whole output tile.  Each instruction runs on 32
    threads, over 64 columns."""
    step = 64
    mt = cuda_planes.sum_operator(np.zeros((p, 1), dtype=np.uint16 if w == 16 else np.uint8), w).shape[0] // 16
    passes = mt // 2
    tiles = passes if w == 4 else -(-mt // 4)
    depth, chunks = _k3_depth(k, expand, w)
    warp_instr = (_k3_copies(k, max(w, 8)) + tiles * (8 + 10 + (15 if w == 16 else 22)) + passes * (32 + 10 + 64)
                  + passes * depth + chunks * mt)
    return warp_instr * 32 / step


def k3_none_ops_per_col(p: int, k: int, expand: str, w: int = 8) -> float:
    """An estimate from the design of gf_planes_none_kernel, not a
    measurement: thread instructions per column besides the mma, for the
    pre-parity form.  The sum kernel's copies, passes and depth with the
    exact planes (_k3_depth); per pass, instead of the refold, 16 STS.128
    into the staging rows, two warp barriers, and 16 LDS.128 and 16
    STG.128 with their loop and addresses (about 16).  Each instruction
    runs on 32 threads, over 64 columns."""
    mt = -(-p * w // 16)
    passes = -(-mt // 2)
    depth, chunks = _k3_depth(k, expand, w, exact=True)
    warp_instr = (_k3_copies(k, max(w, 8)) + passes * (32 + 10) + passes * depth + chunks * mt
                  + passes * (16 + 2 + 16 + 16 + 16))
    return warp_instr * 32 / 64


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
    """Seeded symbols; at w=4 whole bytes, so that the kernels must ignore
    the high nibble."""
    dt = np.uint16 if w == 16 else np.uint8
    return to_tensor(rng.integers(0, 1 << max(w, 8), size=shape).astype(dt), device)


@_named("3 K1 grid")
def phase_kernel_grid(device) -> int:
    """K1 vs its plain version on the card, both forms; returns the max abs
    error."""

    shapes = [(2, 4, 256), (4, 10, 5000), (1, 1, 128), (8, 32, 1024), (3, 5, 100)]
    shapes += [(2, 4, m) for m in (64, 2048, 2049, 4097)]
    shapes += [(10, 10, 65537), (4, 10, 1 << 20)]
    # Ragged and misaligned widths (1639: the last segment of a 1 GiB
    # encode), and depth 33.
    shapes += [(p, k, m) for p, k in ((4, 10), (10, 10)) for m in (1, 31, 33, 1639)] + [(4, 33, 1639), (4, 33, 4097)]
    # The in-place update's widths (phase 5c): a one-symbol edit, 4 KiB
    # windows (409-411 columns) alone and stacked, a stacked group.
    shapes += [(4, 10, m) for m in (2, 3, 409, 410, 411, 822, 411_007)]
    # Several output tiles and depth chunks of the bit-sliced kernel.
    wide = {4: [(16, 128, 4097), (17, 100, 3000), (64, 64, 1100), (128, 128, 2049), (16, 50, 70001)],
            8: [(128, 128, 4097), (64, 200, 3000), (16, 50, 1100), (16, 50, 70001)],
            16: [(64, 64, 4097), (128, 128, 2049), (5, 7, 300), (9, 12, 130), (4, 33, 70001)]}
    worst = 0
    cases = 0
    rng = np.random.default_rng(SEED)
    for w in (4, 8, 16):
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


def check_pipeline(what: str, launches: int, io_counts: dict, staged_ahead: bool = False,
                   native_io: bool = True) -> None:
    """K1 ran, each launch in a dispatch on the pipeline's compute stream
    (one launch a dispatch), every dispatched segment was staged from
    pinned memory, and the native IO library served every read and write
    (``native_io=False``: an operation that makes no such call, the
    in-place update's preads and pwrites, but no fallback call either).
    ``staged_ahead``: a run that failed and resumed may have staged
    segments it never dispatched."""
    if launches <= 0:
        raise AssertionError(f"{what}: K1 was not launched")
    if io_counts["stream_dispatches"] != launches:
        raise AssertionError(f"{what}: {launches} K1 launches but {io_counts['stream_dispatches']} on the compute stream")
    if io_counts["pinned_stages"] < launches or (io_counts["pinned_stages"] != launches and not staged_ahead):
        raise AssertionError(f"{what}: {io_counts['pinned_stages']} segments staged from pinned memory for {launches} dispatches")
    if (native_io and io_counts["native_io_calls"] <= 0) or io_counts["fallback_io_calls"]:
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
        plan0 = _plan_counts()
        t0 = time.perf_counter()
        api.encode_file(path, k, n - k, pipeline_depth=depth, timer=enc_timer)
        t_enc = time.perf_counter() - t0
        enc_launches, enc_io, enc_plan = k1_runs(), _io_counts(), _plan_delta(plan0)
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
        plan0 = _plan_counts()
        t0 = time.perf_counter()
        api.decode_file(path, conf, out, pipeline_depth=depth, timer=dec_timer)
        t_dec = time.perf_counter() - t0
        dec_launches, dec_io, dec_plan = k1_runs(), _io_counts(), _plan_delta(plan0)
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
        encode_io=enc_io, decode_io=dec_io, rs_plan=plan.enabled(), encode_plan=enc_plan, decode_plan=dec_plan,
        encode_phases_s=dict(enc_timer.acc), decode_phases_s=dict(dec_timer.acc),
        encode_phase_sum_s=sum(enc_timer.acc.values()), decode_phase_sum_s=sum(dec_timer.acc.values()),
    )
    log(**res)
    for name in [conf, out, path + ".METADATA"] + [chunk_file_name(path, i) for i in range(n - k, n)]:
        os.unlink(name)
    return res, digests


@_named("4 main path")
def phase_main_path(work: str, seed: int, size: int) -> tuple[dict, dict, str, str]:
    """The 1 GiB main path serial, then pipelined; returns both results, the
    cuda archive's digests, and the input file (left for phase 5d) with its
    SHA-256."""
    path = os.path.join(work, "main.bin")
    want_sha = write_seeded(path, seed, size)
    serial, serial_digests = run_main_path(path, want_sha, "serial", 1, "0")
    piped, piped_digests = run_main_path(path, want_sha, "pipelined", 2, None)
    if serial_digests != piped_digests:
        diff = sorted(name for name in serial_digests if serial_digests[name] != piped_digests.get(name))
        raise AssertionError(f"serial and pipelined archives differ: {diff}")
    log(phase="main_path_archives", identical=True, files=len(piped_digests), digests=piped_digests)
    return {"serial": serial, "pipelined": piped}, piped_digests, path, want_sha


STRATEGIES = ("xor", "ring")


# -- phase 5e: the plan layer (bucketed plans replayed from CUDA graphs) ------


def _plan_counts() -> dict:
    st = plan.PLAN_CACHE.stats()
    return {key: st[key] for key in ("hits", "misses", "calls", "captures", "replays")}


def _plan_delta(before: dict) -> dict:
    after = _plan_counts()
    return {key: after[key] - before[key] for key in before}


def _check_graphed(what: str, counts: dict, dispatches: int, warm: bool) -> None:
    """Every dispatch of a run went through a captured graph: a replay, or
    (unless ``warm``) the eager first dispatch of a staging buffer after
    which its graph was captured."""
    if counts["calls"] != dispatches or counts["captures"] + counts["replays"] != dispatches:
        raise AssertionError(f"{what}: {dispatches} stream dispatches, plan counts {counts}")
    if warm and counts["replays"] != dispatches:
        raise AssertionError(f"{what}: a warm run captured again: {counts}")


@_named("5e plan layer")
def phase_plan_main(path: str, want_sha: str, cuda_digests: dict) -> dict:
    """Phase 5e on the 1 GiB main path: ``RS_PLAN=0`` (eager, exact widths)
    serial and pipelined, each archive byte-identical to phase 4's (plan
    layer on); the layer on again, pipelined, now warm: every dispatch a
    graph replay; and ``--strategy cpu`` (the native host codec): the
    archive equal to cuda's and the decode to the input, no oracle call."""
    k, n = 10, 14
    size = os.path.getsize(path)
    rows = {}
    with scoped(RS_PLAN="0"):
        for mode, depth, writers in (("eager serial", 1, "0"), ("eager pipelined", 2, None)):
            res, digests = run_main_path(path, want_sha, mode, depth, writers)
            if digests != cuda_digests:
                raise AssertionError(f"{mode}: the RS_PLAN=0 archive differs from the plan layer's")
            if res["encode_plan"]["calls"] or res["decode_plan"]["calls"]:
                raise AssertionError(f"{mode}: RS_PLAN=0 dispatched through plans: {res['encode_plan']}")
            rows[mode] = res
    res, digests = run_main_path(path, want_sha, "graphs pipelined (warm)", 2, None)
    if digests != cuda_digests:
        raise AssertionError("the warm plan run's archive differs from phase 4's")
    _check_graphed("warm plan encode", res["encode_plan"], res["encode_io"]["stream_dispatches"], warm=True)
    _check_graphed("warm plan decode", res["decode_plan"], res["decode_io"]["stream_dispatches"], warm=True)
    rows["graphs pipelined (warm)"] = res

    # --strategy cpu: the host codec on the same file.
    _reset_counts()
    _reset_io_counts()
    native.GEMM_CALLS = native.GEMM_FALLBACK_CALLS = 0
    t0 = time.perf_counter()
    api.encode_file(path, k, n - k, strategy="cpu")
    t_enc = time.perf_counter() - t0
    if archive_digests(path, n) != cuda_digests:
        raise AssertionError("the --strategy cpu archive differs from the cuda archive")
    enc_calls = native.GEMM_CALLS
    for i in range(n - k):
        os.unlink(chunk_file_name(path, i))
    conf, out = make_conf(n, k, path), path + ".out"
    t0 = time.perf_counter()
    api.decode_file(path, conf, out, strategy="cpu")
    t_dec = time.perf_counter() - t0
    if sha256_file(out) != want_sha:
        raise AssertionError("--strategy cpu: the decoded SHA-256 differs from the input")
    io_counts = _io_counts()
    if (native.GEMM_FALLBACK_CALLS or enc_calls <= 0 or native.GEMM_CALLS <= enc_calls or k1_runs()
            or io_counts["stream_dispatches"] or io_counts["pinned_stages"]):
        raise AssertionError(f"--strategy cpu: native GEMM calls {native.GEMM_CALLS}, fallback calls "
                             f"{native.GEMM_FALLBACK_CALLS}, K1 {k1_runs()}, io {io_counts}")
    rng = np.random.default_rng(SEED + 14)
    A = RSCodec(k, n - k, device="cpu").parity_block
    Bh = rng.integers(0, 256, size=(k, SEGMENT_COLS), dtype=np.uint8)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        native.gemm(A, Bh)
        best = min(best, time.perf_counter() - t0)
    rows["cpu"] = dict(encode_s=t_enc, decode_s=t_dec, encode_gbps=size / t_enc / 1e9, decode_gbps=size / t_dec / 1e9,
                       native_gemm_calls=native.GEMM_CALLS, fallback_calls=native.GEMM_FALLBACK_CALLS,
                       archive_equals_cuda=True, sha256_match=True, native_gemm_segment_s=best,
                       native_gemm_gbps=k * SEGMENT_COLS / best / 1e9, host_cores=os.cpu_count())
    log(phase="plan_cpu_strategy", nvidia_smi=smi_line(), **rows["cpu"])
    for name in [conf, out, path + ".METADATA"] + [chunk_file_name(path, i) for i in range(n - k, n)]:
        os.unlink(name)
    log(phase="plan_main", nvidia_smi=smi_line(),
        gbps={mode: {"encode": r["encode_gbps"], "decode": r["decode_gbps"]} for mode, r in rows.items()},
        plan={mode: {"encode": r.get("encode_plan"), "decode": r.get("decode_plan")} for mode, r in rows.items()})
    return rows


def _ragged_op(what: str, fn, strategy: str, warm: bool) -> dict:
    _reset_counts()
    _reset_io_counts()
    plan0 = _plan_counts()
    t0 = time.perf_counter()
    fn()
    wall = time.perf_counter() - t0
    counts, io_counts = _plan_delta(plan0), _io_counts()
    if strategy == "cuda" and k1_runs() != io_counts["stream_dispatches"]:
        raise AssertionError(f"{what}: {k1_runs()} K1 runs for {io_counts['stream_dispatches']} dispatches")
    if strategy != "cuda" and (k1_runs() or cuda_gemm.CAPTURED):
        raise AssertionError(f"{what}: K1 ran under {strategy}")
    if plan.enabled():
        _check_graphed(what, counts, io_counts["stream_dispatches"], warm)
    return dict(wall_s=wall, plan=counts, dispatches=io_counts["stream_dispatches"])


@_named("5e ragged")
def phase_plan_ragged(work: str, seed: int) -> dict:
    """Phase 5e's ragged file (64 MiB + 12,345 bytes: one full segment and a
    1,337-column tail in the 2,048 bucket) under cuda, xor and ring: encoded
    and decoded (chunks 0-3 lost) with RS_PLAN=0, then twice with the layer
    on; the second run must replay a captured graph at every dispatch, the
    tail's included, and every archive must equal the eager cuda one."""
    k, n = 10, 14
    size = 64 * MiB + 12_345
    path = os.path.join(work, "ragged.bin")
    want_sha = write_seeded(path, seed, size)
    want = None
    rows = {}
    for strategy in ("cuda",) + STRATEGIES:
        for run, rs_plan in (("eager", "0"), ("cold", None), ("warm", None)):
            with scoped(RS_PLAN=rs_plan):
                enc = _ragged_op(f"ragged {strategy} {run} encode",
                                 lambda: api.encode_file(path, k, n - k, strategy=strategy), strategy, run == "warm")
                digests = archive_digests(path, n)
                want = want or digests
                if digests != want:
                    raise AssertionError(f"ragged {strategy} {run}: the archive differs from the eager cuda one")
                for i in range(n - k):
                    os.unlink(chunk_file_name(path, i))
                conf, out = make_conf(n, k, path), path + ".out"
                dec = _ragged_op(f"ragged {strategy} {run} decode",
                                 lambda: api.decode_file(path, conf, out, strategy=strategy), strategy, run == "warm")
                if sha256_file(out) != want_sha:
                    raise AssertionError(f"ragged {strategy} {run}: the decoded SHA-256 differs from the input")
                for name in [conf, out, path + ".METADATA"] + [chunk_file_name(path, i) for i in range(n - k, n)]:
                    os.unlink(name)
            rows[f"{strategy} {run}"] = {"encode": enc, "decode": dec}
    os.unlink(path)
    res = dict(phase="plan_ragged", nvidia_smi=smi_line(), bytes=size, runs=rows, archives_equal=True,
               sha256_match=True)
    log(**res)
    return res


@_named("5e dispatch")
def phase_plan_dispatch(device) -> list[dict]:
    """Phase 5e's dispatch table: cuda, xor and ring at the encode (k=10,
    p=4) and decode (p=k=10) segments, eager (``plan.eager``, what
    ``RS_PLAN=0`` runs) against the plan layer on a staging buffer (a graph
    replay): device ms (CUDA events, best of 3), the host's enqueue ms of
    one dispatch (best of 3, no synchronise inside), the device ops a
    dispatch issues (the ATen ops of the eager call; K1's kernels a replay
    runs) and the plan's counts.  Every graph dispatch must equal
    the eager output."""
    k, m = 10, SEGMENT_COLS
    gf = get_field(8)
    smi = smi_line()
    rng = np.random.default_rng(SEED + 13)
    total = RSCodec(k, 4, device=device).total_matrix
    shapes = [("encode k=10 p=4", total[k:]), ("decode p=k=10", inverse.invert_matrix(total[4:14], gf))]
    B = random_symbols(rng, (k, m), 8, device)
    slot = plan.STAGING.acquire(device, k * m)
    arr = slot.tensor.view(k, m)
    arr.copy_(B)
    staged = plan.StagedSegment(arr, m, m, slot=slot)
    iters = {"cuda": 50, "xor": 10, "ring": 10}
    rows = []

    def enqueue_ms(fn) -> float:
        best = float("inf")
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
        return 1e3 * best

    try:
        for label, A in shapes:
            p = A.shape[0]
            for strategy in ("cuda",) + STRATEGIES:
                def eager():
                    return plan.eager(strategy, A, B, 8)

                def graphed():
                    return plan.dispatch(A, staged, w=8, strategy=strategy)

                want = eager().clone()
                with _DeviceOps() as counted:
                    eager()
                torch.cuda.synchronize()
                eager_ms = time_ms(eager, iters=iters[strategy], reps=3)
                eager_enq = enqueue_ms(eager)
                before, replayed0 = _plan_counts(), cuda_gemm.REPLAYED
                first = graphed().clone()  # the eager first dispatch, then the capture
                replayed = graphed().clone()
                graph_ms = time_ms(graphed, iters=iters[strategy], reps=3)
                graph_enq = enqueue_ms(graphed)
                torch.cuda.synchronize()
                err = max(int((_widen(got) - _widen(want)).abs().max().item()) for got in (first, replayed))
                if err:
                    raise AssertionError(f"{strategy} {label}: the graph replay differs from the eager dispatch")
                counts = _plan_delta(before)
                # The buffer's graph may exist already (the pool hands out
                # the main path's buffers): then every call is a replay.
                if counts["captures"] > 1 or counts["captures"] + counts["replays"] != counts["calls"]:
                    raise AssertionError(f"{strategy} {label}: plan counts {counts}")
                row = dict(phase="plan_dispatch", strategy=strategy, shape=label, p=p, k=k, m=m, nvidia_smi=smi,
                           eager_ms=eager_ms, graph_ms=graph_ms, eager_enqueue_ms=eager_enq,
                           graph_enqueue_ms=graph_enq, device_ops=counted.ops,
                           k1_kernels_per_graph=(cuda_gemm.REPLAYED - replayed0) / counts["replays"], plan=counts,
                           bound_ms=bound_ms(p, k, m, 8), bound_by="bytes", max_abs_err=err)
                log(**row)
                rows.append(row)
    finally:
        done = torch.cuda.Event()
        done.record()
        plan.STAGING.release(slot, done)
    return rows


@_named("5e tune")
def phase_tune(device, work: str) -> dict:
    """Phase 5e's autotuner: RS_STRATEGY_AUTOTUNE=measure at k=10, p=4,
    w=8 on the card times every candidate through the plan layer (the
    graph strategies as replays) and persists the winner in a fresh store;
    a fresh process in prior mode must resolve the same winner from it
    (source "ledger")."""
    store = os.path.join(work, "tune_store.jsonl")
    with scoped(RS_STRATEGY_AUTOTUNE="measure", RS_SCHEDULE_STORE=store):
        tune.clear_decisions()
        t0 = time.perf_counter()
        winner = tune.resolve_auto(10, 4, 8, device=device)
        seconds = time.perf_counter() - t0
        decision = tune.decisions()["cuda|10|4|8"]
    code = ("import json\nfrom gpu_rscode_torch import tune\n"
            "s = tune.resolve_auto(10, 4, 8, device='cuda')\n"
            "print(json.dumps({'strategy': s, 'source': tune.decisions()['cuda|10|4|8']['source']}))\n")
    env = dict(os.environ, RS_STRATEGY_AUTOTUNE="prior", RS_SCHEDULE_STORE=store, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"the fresh prior-mode process failed: {proc.stderr[-2000:]}")
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    if fresh != {"strategy": winner, "source": "ledger"}:
        raise AssertionError(f"measure mode chose {winner}; the fresh process resolved {fresh}")
    tune.clear_decisions()
    res = dict(phase="plan_tune", nvidia_smi=smi_line(), k=10, p=4, w=8, winner=winner, gbps=decision["gbps"],
               measure_seconds=seconds, fresh_process=fresh, stripe_bytes_per_chunk=tune._MEASURE_COLS)
    log(**res)
    return res


def _strategy_calls() -> int:
    """Dispatches of every xor and ring pipeline of this process so far."""
    return sum(d["calls"] for d in xor_gemm.pipeline_stats() + ring_gemm.ring_pipeline_stats())


@contextlib.contextmanager
def _no_plain_gemm():
    """While the strategies run, the codec's plain GEMMs raise: on CUDA, xor
    and ring must reach neither K1 nor the bitplane or table path (the
    codec reaches them through plan.eager, which looks them up in
    ops.gemm at each call)."""
    saved = gemm_module.gf_matmul_bitplane, gemm_module.gf_matmul_table

    def refuse(*args, **kwargs):
        raise AssertionError("a plain GEMM was called under strategy xor or ring")

    gemm_module.gf_matmul_bitplane = gemm_module.gf_matmul_table = refuse
    try:
        yield
    finally:
        gemm_module.gf_matmul_bitplane, gemm_module.gf_matmul_table = saved


def run_strategy(name: str, strategy: str, fn, nbytes: int, smi: str, timer: PhaseTimer | None = None,
                 native_io: bool = True, resident: int = 0):
    """One operation under ``strategy`` with the counts set to 0 just before
    it and read just after: K1 must not move, every stream dispatch must be
    an xor or ring pipeline call, and every dispatch but the ``resident``
    ones (which read planes already on the card) staged from pinned memory.
    Returns the operation's result and its logged row."""
    _reset_counts()
    _reset_io_counts()
    calls0, reuse0, plan0 = _strategy_calls(), dict(xor_gemm.PACK_REUSE), _plan_counts()
    t0 = time.perf_counter()
    with _no_plain_gemm():
        result = fn()
    wall = time.perf_counter() - t0
    plan_counts = _plan_delta(plan0)
    io_counts, calls = _io_counts(), _strategy_calls() - calls0
    reuse = {key: xor_gemm.PACK_REUSE[key] - reuse0[key] for key in reuse0}
    resident = resident(reuse) if callable(resident) else resident
    if k1_runs() or cuda_gemm.CAPTURED:
        raise AssertionError(f"{name}: strategy {strategy} ran K1 {k1_runs()} times ({cuda_gemm.CAPTURED} captured)")
    if calls <= 0 or io_counts["stream_dispatches"] != calls:
        raise AssertionError(f"{name}: {calls} {strategy} dispatches, {io_counts['stream_dispatches']} on the compute "
                             "stream")
    if io_counts["pinned_stages"] != calls - resident:
        raise AssertionError(f"{name}: {io_counts['pinned_stages']} pinned stages for {calls} dispatches, {resident} "
                             "of them on resident planes")
    if (native_io and io_counts["native_io_calls"] <= 0) or io_counts["fallback_io_calls"]:
        raise AssertionError(f"{name}: native IO calls {io_counts['native_io_calls']}, NumPy fallback calls "
                             f"{io_counts['fallback_io_calls']}")
    row = dict(strategy=strategy, wall_s=wall, gbps=nbytes / wall / 1e9, bytes=nbytes, k1_launches=0,
               dispatches=calls, pack_reuse=reuse, io=io_counts, plan=plan_counts)
    if timer is not None:
        row["phases_s"] = dict(timer.acc)
    log(phase="strategies", op=name, nvidia_smi=smi, **row)
    return result, row


@_named("5d xor/ring")
def phase_strategies_main(path: str, want_sha: str, cuda_digests: dict) -> dict:
    """Phase 5d on the main path: ``path`` (phase 4's 1 GiB input) encoded
    pipelined under xor, then ring, each archive byte-identical to phase 4's
    cuda archive, then decoded with chunks 0-3 lost to its SHA-256.
    Deletes ``path`` at the end."""
    k, n = 10, 14
    size = os.path.getsize(path)
    smi = smi_line()
    rows = {}
    for strategy in STRATEGIES:
        enc_timer, dec_timer = PhaseTimer(), PhaseTimer()
        _, enc = run_strategy(f"encode_{strategy}", strategy,
                              lambda: api.encode_file(path, k, n - k, strategy=strategy, timer=enc_timer), size, smi,
                              enc_timer)
        _check_graphed(f"encode_{strategy}", enc["plan"], enc["dispatches"], warm=False)
        digests = archive_digests(path, n)
        if digests != cuda_digests:
            diff = sorted(name for name in digests if digests[name] != cuda_digests.get(name))
            raise AssertionError(f"the {strategy} archive differs from the cuda archive: {diff}")
        for i in range(n - k):
            os.unlink(chunk_file_name(path, i))
        conf, out = make_conf(n, k, path), path + ".out"
        _, dec = run_strategy(f"decode_{strategy}", strategy,
                              lambda: api.decode_file(path, conf, out, strategy=strategy, timer=dec_timer), size, smi,
                              dec_timer)
        _check_graphed(f"decode_{strategy}", dec["plan"], dec["dispatches"], warm=False)
        if sha256_file(out) != want_sha:
            raise AssertionError(f"{strategy}: the decoded SHA-256 differs from the input")
        for name in [conf, out, path + ".METADATA"] + [chunk_file_name(path, i) for i in range(n - k, n)]:
            os.unlink(name)
        rows[strategy] = {"encode": enc, "decode": dec, "archive_equals_cuda": True, "sha256_match": True}
    os.unlink(path)
    return rows


def _locate_under_xor(path: str, want_sha: str, rot_cols) -> dict:
    """Phase 5d's locate decode under xor on phase 5b's archive (64 bytes of
    chunk 3 flipped at ``rot_cols``) with native 0 lost, then again with
    the bitrot undone.  The recovery GEMM of every segment that was not
    corrected reads the syndrome GEMM's pack (a resident dispatch); each
    corrected one re-stages its patched rows."""
    from gpu_rscode_torch import gf_decode

    k = 10
    size = os.path.getsize(path)
    chunk = -(-size // k)
    segments = len(api._segment_spans(chunk, api._segment_cols(chunk, k, api.DEFAULT_SEGMENT_BYTES)))
    os.unlink(chunk_file_name(path, 0))
    real = gf_decode.correct_segment
    corrected = [0]

    def correct_segment(*args, **kwargs):
        corrected[0] += 1
        return real(*args, **kwargs)

    smi = smi_line()
    res = {}
    for label in ("bitrot", "clean"):
        if label == "clean":
            _flip(chunk_file_name(path, 3), rot_cols)  # XOR 0xA5 again: the bitrot undone
        corrected[0] = 0
        gf_decode.correct_segment = correct_segment
        try:
            # Each segment: one pack for the syndrome GEMM (which reads it),
            # and for the recovery GEMM either the planes again (resident)
            # or a re-staged, re-packed segment.
            out, row = run_strategy(f"locate_decode_xor_{label}", "xor",
                                    lambda: api.locate_decode_file(path, path + ".xloc", strategy="xor"), size, smi,
                                    resident=lambda reuse: reuse["reused"] - segments)
        finally:
            gf_decode.correct_segment = real
        if sha256_file(out) != want_sha:
            raise AssertionError(f"locate_decode_file under xor ({label}): the SHA-256 differs from the input")
        os.unlink(out)
        reused = row["pack_reuse"]["reused"] - segments
        restaged = row["pack_reuse"]["packed"] - segments
        if restaged != corrected[0] or reused + restaged != segments or (label == "clean" and restaged):
            raise AssertionError(f"locate under xor ({label}): {segments} segments, {reused} reused their pack, "
                                 f"{restaged} re-staged, {corrected[0]} corrected")
        res[label] = dict(row, segments=segments, segments_reused_pack=reused, segments_restaged=restaged,
                          segments_corrected=corrected[0])
        log(phase="strategies", op=f"locate_xor_{label}_reuse", segments=segments, reused=reused, restaged=restaged,
            corrected=corrected[0])
    return res


def _update_under_xor(path: str, at: int, edit: bytes, device) -> dict:
    """Phase 5d's update: ``edit`` at ``at`` through update_file under xor
    on one copy of the interleaved archive ``path`` and under cuda on
    another; the two archives must be byte-identical."""
    from gpu_rscode_torch.utils.fileformat import metadata_file_name

    n = 14
    copies = {}
    for strategy in ("xor", "cuda"):
        d = os.path.join(os.path.dirname(path), f"update_{strategy}")
        os.makedirs(d)
        copies[strategy] = os.path.join(d, os.path.basename(path))
        for i in range(n):
            shutil.copyfile(chunk_file_name(path, i), chunk_file_name(copies[strategy], i))
        shutil.copyfile(metadata_file_name(path), metadata_file_name(copies[strategy]))
    timer = PhaseTimer()
    summary, row = run_strategy("update_4MiB_xor", "xor",
                                lambda: api.update_file(copies["xor"], at, edit, strategy="xor", device=device,
                                                        timer=timer), len(edit), smi_line(), timer, native_io=False)
    api.update_file(copies["cuda"], at, edit, strategy="cuda", device=device)
    if archive_digests(copies["xor"], n) != archive_digests(copies["cuda"], n):
        raise AssertionError("the 4 MiB update under xor differs from the same update under cuda")
    for p in copies.values():
        shutil.rmtree(os.path.dirname(p))
    return dict(row, summary=summary, equals_cuda=True)


@_named("5 fleets and CLI")
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
    launches, io_counts = k1_runs(), _io_counts()
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
    before = k1_runs()
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
               sha256_match=True, cli_flags=flags, cli_launches=k1_runs() - before, cli_match=True)
    log(**res)
    for name in os.listdir(work):
        os.unlink(os.path.join(work, name))
    return res


@_named("5 w=16 CLI")
def phase_cli_w16(work: str, seed: int, size: int, strategy: str | None = None) -> dict:
    """A w=16 round trip with --checksum through the CLI on the card; with
    ``strategy`` (phase 5d) under --strategy, where K1 must not move and no
    plain GEMM may be called."""
    k, n = 10, 14
    path = os.path.join(work, "wide.bin")
    data = np.random.default_rng(seed).bytes(size)
    with open(path, "wb") as fp:
        fp.write(data)
    flags = ["--device", "cuda"] + (["--strategy", strategy] if strategy else [])
    before, calls0 = k1_runs(), _strategy_calls()
    t0 = time.perf_counter()
    with _no_plain_gemm() if strategy else contextlib.nullcontext():
        rc = cli.main(["-k", str(k), "-n", str(n), "-e", path, "--width", "16", "--checksum", "--quiet", *flags])
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
        rc = cli.main(["-d", "-i", path, "-c", conf, "-o", out, "--quiet", *flags])
        if rc != 0:
            raise AssertionError(f"CLI decode exited {rc}")
    wall = time.perf_counter() - t0
    with open(out, "rb") as fp:
        if fp.read() != data:
            raise AssertionError("w=16 CLI round trip changed the bytes")
    launches = k1_runs() - before
    if strategy and (launches or _strategy_calls() - calls0 <= 0):
        raise AssertionError(f"w=16 CLI under {strategy}: {launches} K1 launches, "
                             f"{_strategy_calls() - calls0} {strategy} dispatches")
    res = dict(phase="strategies" if strategy else "cli_w16", op="cli_w16", strategy=strategy or "auto", bytes=size,
               launches=launches, dispatches=_strategy_calls() - calls0, round_trip_s=wall, match=True)
    log(**res)
    for name in os.listdir(work):
        os.unlink(os.path.join(work, name))
    return res


@_named("6 K1 timings")
def phase_timings(device, group_cols: int, store_shapes: dict | None = None) -> list[dict]:
    """K1 at the main path's shapes vs its bound, its logic-op estimate and
    its plain version: encode and decode (rows 0 and 1, which the compute
    share reads), then the resilience reads' syndrome and repair shapes, the
    update's E·Δ shapes (phase 5c's stacked group of ``group_cols``
    columns, one 4 KiB interleaved window) and the object store's (phase
    5f's median columns of a 64-object PUT batch's E·Δ, of the 1,000 x
    4 KiB batch's and of a degraded GET's window recovery)."""
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
               gf.matmul(total[[0, 5, 12]], inverse.invert_matrix(total[[1, 2, 3, 4, 6, 7, 8, 9, 10, 11]], gf))),
              # E·Δ of the update: the group's stacked windows, one 4 KiB window.
              ("update group stacked k=10 p=4", 8, group_cols, RSCodec(k, 4, device=device).parity_block),
              ("update one 4 KiB window k=10 p=4", 8, 411, RSCodec(k, 4, device=device).parity_block)]
    if store_shapes:
        # The store's defaults: k=4, p=2, w=8; the degraded stripe lost
        # native chunk 1, so the window recovery inverts rows 0, 2, 3, 4.
        E = RSCodec(4, 2, device=device).parity_block
        inv = inverse.invert_matrix(RSCodec(4, 2, device=device).total_matrix[[0, 2, 3, 4]], gf)
        for label, key, A in (("store PUT batch E·Δ k=4 p=2 (64 objects)", "put_64_update", E),
                              ("store PUT 1,000 x 4 KiB E·Δ k=4 p=2", "put_1000_update", E),
                              ("store degraded GET window k=4 (4 rows)", "degraded_window", inv)):
            m = store_shapes[key]["median_cols"]
            if m:
                shapes.append((label, 8, m, A))
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


@_named("5d grid")
def phase_strategies_grid(device) -> dict:
    """Phase 5d's grid: gf_matmul_xor and gf_matmul_ring against K1 on the
    card, bit-exact, over K1's grid shapes with k <= 16 and p <= 8 (ragged
    widths, a misaligned first row, the update's E·Δ widths), at w 8 and
    16; no plain GEMM is called.  Returns the grids by strategy."""
    rng = np.random.default_rng(SEED + 11)
    ragged = (1, 2, 31, 33, 64, 128, 409, 1639, 2049, 4097)
    shapes = {8: [(4, 10, m) for m in ragged + (411, 822, 65537, 411_007, 1 << 20)]
              + [(p, k, m) for p, k in ((1, 1), (2, 4), (3, 5), (8, 16), (6, 12), (7, 3), (1, 16), (8, 1))
                 for m in (100, 1031, 4097)],
              16: [(4, 10, m) for m in (1, 33, 1639, 65537)]
              + [(p, k, m) for p, k in ((1, 1), (3, 5), (8, 16), (2, 7)) for m in (130, 2049)]}
    grids = {strategy: Grid(f"{strategy} (plain PyTorch XOR chains) vs K1") for strategy in STRATEGIES}
    t0 = time.perf_counter()
    with _no_plain_gemm():
        for w, grid in shapes.items():
            coeffs = {}
            for i, (p, k, m) in enumerate(grid):
                A = coeffs.setdefault((p, k), rng.integers(0, 1 << w, size=(p, k)))
                skew = 3 if i == 0 else 0
                B = random_symbols(rng, (skew + k * m,), w, device)[skew:].view(k, m)
                want = cuda_gemm.gf_matmul_cuda(A, B, w)
                grids["xor"].check(xor_gemm.gf_matmul_xor(A, B, w), want, f"w={w} p={p} k={k} m={m} skew={skew}")
                grids["ring"].check(ring_gemm.gf_matmul_ring(A, B, w), want, f"w={w} p={p} k={k} m={m} skew={skew}")
    for strategy, grid in grids.items():
        log(phase="strategies_vs_k1", strategy=strategy, cases=grid.cases, max_abs_err=grid.worst, tolerance=0,
            seconds=time.perf_counter() - t0)
    return grids


class _DeviceOps(TorchDispatchMode):
    """Counts the ATen operations that launch work (no views, no
    allocations) issued inside the mode."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and not func.overloadpacket.__name__.endswith("empty"):
            self.ops += 1
        return func(*args, **(kwargs or {}))


@_named("5d timings")
def phase_strategies_timings(device, work: str) -> list[dict]:
    """Phase 5d's timings at the encode (k=10, p=4) and decode (p=k=10)
    segments: each strategy's whole dispatch, its pack, chain and unpack
    (CUDA events, best of 3), the host's enqueue time of one dispatch (best
    of 3, no synchronise inside), its device ops, the schedule's XOR count
    and its build time cold and from a warm store; K1 and the bound at the
    same shape beside them."""
    k, m = 10, SEGMENT_COLS
    gf = get_field(8)
    smi = smi_line()
    rng = np.random.default_rng(SEED + 12)
    total = RSCodec(k, 4, device=device).total_matrix
    shapes = [("encode k=10 p=4", total[k:]), ("decode p=k=10", inverse.invert_matrix(total[4:14], gf))]
    saved = os.environ.get("RS_SCHEDULE_STORE")
    os.environ["RS_SCHEDULE_STORE"] = os.path.join(work, "schedule_store.jsonl")
    rows = []
    try:
        for label, A in shapes:
            p = A.shape[0]
            B = random_symbols(rng, (k, m), 8, device)
            want = cuda_gemm.gf_matmul_cuda(A, B, 8)
            k1_ms = time_ms(lambda: cuda_gemm.gf_matmul_cuda(A, B, 8), iters=100, reps=3)
            for strategy, build, get, matmul, stats in (
                    ("xor", xor_gemm.build_schedule, xor_gemm.get_pipeline, xor_gemm.gf_matmul_xor,
                     xor_gemm.store_stats),
                    ("ring", ring_gemm.build_ring_schedule, ring_gemm.get_ring_pipeline, ring_gemm.gf_matmul_ring,
                     ring_gemm.ring_store_stats)):
                xor_gemm.clear_pipeline_cache()
                t0 = time.perf_counter()
                sched = build(A, 8)
                cold = time.perf_counter() - t0
                xor_gemm.clear_pipeline_cache()
                built = stats()["built"]
                t0 = time.perf_counter()
                build(A, 8)
                warm = time.perf_counter() - t0
                if stats()["built"] != built:
                    raise AssertionError(f"{strategy} {label}: the warm store rebuilt the schedule")
                with _no_plain_gemm():
                    got = matmul(A, B, 8)
                    torch.cuda.synchronize()
                    err = int((_widen(got) - _widen(want)).abs().max().item())
                    if err:
                        raise AssertionError(f"{strategy} != K1 at the {label} timing shape")
                    pipe = get(A, (k, m), np.uint8, 8, "cuda")
                    planes = xor_gemm._pack(B, 8).unbind(0)
                    outs = torch.empty((p * 8, m // 32), dtype=torch.int32, device=device)
                    pack_ms = time_ms(lambda: xor_gemm._pack(B, 8), iters=5, reps=3)
                    chain_ms = time_ms(lambda: pipe._chain(planes, outs), iters=5, reps=3)
                    unpack_ms = time_ms(lambda: xor_gemm._unpack(outs, 8, p), iters=5, reps=3)
                    ms = time_ms(lambda: matmul(A, B, 8), iters=5, reps=3)
                    enqueue = []
                    for _ in range(3):
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        matmul(A, B, 8)
                        enqueue.append(time.perf_counter() - t0)
                        torch.cuda.synchronize()
                    with _DeviceOps() as counted:
                        matmul(A, B, 8)
                    torch.cuda.synchronize()
                row = dict(phase="strategy_timing", strategy=strategy, shape=label, p=p, k=k, m=m, nvidia_smi=smi,
                           ms=ms, pack_ms=pack_ms, chain_ms=chain_ms, unpack_ms=unpack_ms,
                           host_enqueue_ms=1e3 * min(enqueue), device_ops=counted.ops, xors=sched.xors,
                           terms_naive=sched.terms_naive, terms_cse=sched.terms_cse, build_cold_s=cold,
                           build_warm_s=warm, opt=pipe.describe()["opt"], k1_ms=k1_ms,
                           bound_ms=bound_ms(p, k, m, 8), bound_by="bytes", max_abs_err=err)
                log(**row)
                rows.append(row)
    finally:
        if saved is None:
            os.environ.pop("RS_SCHEDULE_STORE", None)
        else:
            os.environ["RS_SCHEDULE_STORE"] = saved
        xor_gemm.clear_pipeline_cache()
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
        err = int((_widen(got) - _widen(want)).abs().max().item()) if got.numel() else 0
        self.worst = max(self.worst, err)
        self.cases += 1
        if err:
            raise AssertionError(f"{self.name} != plain at {what}: max err {err}")


def k3_grid_name(expand: str, refold: str | None, w: int = 8) -> str:
    """The kernels line's name of the K3 kernel that runs (expand, refold)
    at w (refold None: the dispatch's default)."""
    refold = refold or cuda_gemm._default_refold(w)
    kind = cuda_planes.kind(w, expand, refold)
    return next(name for name, k in K3_KINDS.items() if k == kind)


@_named("7 K2/K3 grids")
def phase_new_kernels_vs_plain(device) -> dict:
    """K2 and K3 against their plain versions on the card; returns the
    grids by kernel."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rng = np.random.default_rng(SEED + 7)
    k2, copy = Grid("K2"), Grid("K3-copy-floor")
    planes_sum, planes_dot = Grid("K3-planes-sum"), Grid("K3-planes-dot")
    wide, pre, narrow = Grid("K3-planes-w16"), Grid("K3-planes-preparity"), Grid("K3-planes-w4")
    pre_w = Grid("K3-planes-preparity-w4-w16")
    by_name = {grid.name: grid for grid in (planes_sum, planes_dot, wide, pre, narrow, pre_w)}
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
        grid = by_name[k3_grid_name(expand, refold)]
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
    # The sum and dot kernels at depths off their 4-symbol chunks (nibble:
    # a last block of 1-3 symbols), p off their m-tile pairs (and the dot
    # kernel's 8-symbol output tiles), m below one warp step and 16-byte
    # rows at the segment's width, and their largest sums: every byte 0xFF,
    # every coefficient the densest element.
    for expand in cuda_planes.SUM_EXPANDS:
        for refold, grid, ps in (("sum", planes_sum, (1, 2, 4, 10)), ("dot", planes_dot, (1, 2, 4, 9, 16))):
            for k in (1, 3, 5, 33):
                for m in (37, 4097, 65536):
                    B = _rand_u8(gen, (k, m), device)
                    for p in ps:
                        A = rng.integers(0, 256, size=(p, k))
                        grid.check(cuda_planes.gf_matmul_planes(A, B, expand, refold),
                                   cuda_planes.gf_matmul_planes_plain(A, B, expand, refold),
                                   f"{expand}+{refold} p={p} k={k} m={m}")
            for k in (4, 33):
                B = torch.full((k, 4096), 0xFF, dtype=torch.uint8, device=device)
                A = np.full((10, k), dense)
                grid.check(cuda_planes.gf_matmul_planes(A, B, expand, refold),
                           cuda_planes.gf_matmul_planes_plain(A, B, expand, refold),
                           f"{expand}+{refold} largest sum: element {dense} k={k} bytes 0xFF")
    # nibble's operator in shared memory at p=16 up to k=52, read through L1
    # past it (53, 128 at p 10 and 16).
    for k in (52, 53, 128):
        B = _rand_u8(gen, (k, 4097), device)
        for p in (1, 4, 10, 16):
            A = rng.integers(0, 256, size=(p, k))
            for refold, grid in (("sum", planes_sum), ("dot", planes_dot)):
                grid.check(cuda_planes.gf_matmul_planes(A, B, "nibble", refold),
                           cuda_planes.gf_matmul_planes_plain(A, B, "nibble", refold), f"nibble+{refold} p={p} k={k}")
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
            grid = k2 if kernel == "pack2" else by_name[k3_grid_name(kernel, refold)]
            grid.check(cuda_gemm.gf_matmul_cuda(A, B, 8, expand=name, refold=refold), want, f"expand={name} refold={refold}")
    _new_instances_vs_plain(device, gen, rng, dense, by_name)
    _w4_instances_vs_plain(device, gen, rng, narrow, pre_w)
    grids = (k2, planes_sum, planes_dot, copy, wide, pre, narrow, pre_w)
    for grid in grids:
        log(phase="kernel_vs_plain", kernel=grid.name, cases=grid.cases, max_abs_err=grid.worst, tolerance=0)
    return {grid.name: grid for grid in grids}


def _rand_u16(gen, shape, device) -> torch.Tensor:
    return torch.randint(-(1 << 15), 1 << 15, shape, dtype=torch.int32, device=device, generator=gen).to(
        torch.int16).view(torch.uint16)


def _rand_w(gen, shape, device, w: int) -> torch.Tensor:
    return (_rand_u16 if w == 16 else _rand_u8)(gen, shape, device)


def _limit_case(grids: dict, rng, gen, device, w: int, expand: str, refold: str, p: int, k: int, m: int,
                what: str) -> str:
    """One launch at (k, p) against the plain version; returns its route."""
    A = rng.integers(0, 1 << w, size=(p, k))
    B = _rand_w(gen, (k, m), device, w)
    grid = grids[k3_grid_name(expand, refold, w)]
    grid.check(cuda_planes.gf_matmul_planes(A, B, expand, refold, w=w),
               cuda_planes.gf_matmul_planes_plain(A, B, expand, refold, w=w),
               f"w={w} {expand}+{refold} p={p} k={k} m={m} ({what})")
    return cuda_planes.route(k, p, expand, refold, w)


# The largest k the retired generic kernel took, at p=16 and p=1, for the
# instances the sum, dot and none kernels took over from it (w=16 sum /
# dot / none, w=8 none, nibble apart, w=4 every refold): every one must
# still run.
_EARLIER_EDGES = {(16, "sum"): {16: 56, 1: 908}, (16, "dot"): {16: 38, 1: 874},
                 (8, "none"): {16: 224, 1: 1816}, (8, "nibble+none"): {16: 56, 1: 454},
                 (16, "none"): {16: 56, 1: 908}, (4, "sum"): {16: 904, 1: 3632}, (4, "dot"): {16: 840, 1: 3496},
                 (4, "none"): {16: 904, 1: 3632}}


def _edge_pairs(w: int, what: str) -> list:
    """The (expand, refold) pairs of an _EARLIER_EDGES entry."""
    if what == "nibble+none":
        return [("nibble", "none")]
    expands = {4: cuda_planes.NARROW_EXPANDS, 16: cuda_planes.WIDE_EXPANDS}.get(
        w, [e for e in cuda_planes.SUM_EXPANDS if e != "nibble"])
    return [(e, what) for e in expands]


def _new_instances_vs_plain(device, gen, rng, dense8: int, grids: dict) -> None:
    """Phase 7's w=16 and pre-parity cases: every w=16 pair at k 1-33, p
    1-10 and m 37-100,003 (tiles 256 and 8192; odd m take the byte-wise
    copies and stores, 4160 the 16-byte ones) and pinned; their
    largest sums (every symbol 0xFFFF, every coefficient the densest
    element); per instance at p=16 the largest k whose staged route fits
    and the first past it (the direct route, or the refusal with no
    launch where the instance has none); the edges the retired generic
    kernel had for every instance the sum, dot and none kernels took over
    from it (w=4 and w=16 included), and w=16 at k=16,400 (sums past 2^31, which the mma adds modulo 2^32); the
    pre-parity form of every instance, exact int32, with the stripe mesh's
    k-slice (k=32, p=16); and the public dispatch of every JAX name at
    w=16 and pre-parity.  ``grids``: phase 7's K3 grids by name."""
    wide = grids["K3-planes-w16"]
    dense16 = int(get_field(16).bitmats.sum(axis=2).max(axis=1).argmax())
    for expand in cuda_planes.WIDE_EXPANDS:
        for refold in ("sum", "dot"):
            for k in (1, 3, 4, 10, 33):
                for m in (37, 4160, 100003):
                    B = _rand_u16(gen, (k, m), device)
                    for p in (1, 4, 10):
                        A = rng.integers(0, 1 << 16, size=(p, k))
                        want = cuda_planes.gf_matmul_planes_plain(A, B, expand, refold, w=16)
                        for tile in (256, 8192):
                            wide.check(cuda_planes.gf_matmul_planes(A, B, expand, refold, tile, w=16), want,
                                       f"w=16 {expand}+{refold} p={p} k={k} m={m} tile={tile}")
            for m in (3 * 8192 + 37, 3 * 8192 + 64):
                A, B = rng.integers(0, 1 << 16, size=(4, 10)), _rand_u16(gen, (10, m), device)
                wide.check(cuda_planes.gf_matmul_planes(A, B, expand, refold, 8192, pinned=True, w=16),
                           cuda_planes.gf_matmul_planes_plain(A, B, expand, refold, 8192, pinned=True, w=16),
                           f"w=16 {expand}+{refold} pinned m={m}")
    # The largest sums at w=16, folded and pre-parity.
    for expand in cuda_planes.WIDE_EXPANDS:
        for k in (4, 33):
            B = torch.full((k, 4096), -1, dtype=torch.int16, device=device).view(torch.uint16)
            A = np.full((10, k), dense16)
            for refold in ("sum", "dot", "none"):
                grid = grids[k3_grid_name(expand, refold, 16)]
                grid.check(cuda_planes.gf_matmul_planes(A, B, expand, refold, w=16),
                           cuda_planes.gf_matmul_planes_plain(A, B, expand, refold, w=16),
                           f"w=16 {expand}+{refold} largest sum: element {dense16} k={k} symbols 0xFFFF")
    # At p=16 the largest k the staged route takes and the next: the direct
    # route, or (no direct route) the refusal, with no launch.
    limits = {}
    for w, expand, refold in cuda_planes.INSTANCES:
        if cuda_planes.is_sum_pair(expand, refold, w) and w == 8 and expand != "nibble":
            continue  # the byte expansions' sum kernel: its edge is the dot kernel's
        k = 1
        while cuda_planes.route(k + 1, 16, expand, refold, w) is not None and (
                cuda_planes.route(k + 1, 16, expand, refold, w) == cuda_planes.route(1, 16, expand, refold, w)):
            k += 1
        staged = _limit_case(grids, rng, gen, device, w, expand, refold, 16, k, 4097, "largest staged k")
        past = cuda_planes.route(k + 1, 16, expand, refold, w)
        limits[f"w={w} {expand}+{refold}"] = {"k": k, "route": staged, "next": past}
        if past is not None:
            _limit_case(grids, rng, gen, device, w, expand, refold, 16, k + 1, 4097, f"route {past}")
            if past != "direct":  # nibble's folded forms: operator through L1 up to the ring's edge
                while cuda_planes.route(k + 1, 16, expand, refold, w) is not None:
                    k += 1
                _limit_case(grids, rng, gen, device, w, expand, refold, 16, k, 257, f"largest k, route {past}")
                limits[f"w={w} {expand}+{refold}"]["l1_k"] = k
            else:
                continue
        A = rng.integers(0, 1 << w, size=(16, k + 1))
        B = _rand_w(gen, (k + 1, 4097), device, w)
        before = dict(cuda_planes.LAUNCHES)
        try:
            cuda_planes.gf_matmul_planes(A, B, expand, refold, w=w)
        except ValueError as e:
            if "the card allows" not in str(e) or cuda_planes.LAUNCHES != before:
                raise AssertionError(f"w={w} {expand}+{refold} k={k + 1}: refusal {e!r}, launches {cuda_planes.LAUNCHES}")
        else:
            raise AssertionError(f"w={w} {expand}+{refold} p=16 k={k + 1}: past shared memory, not refused")
    log(phase="kernel_vs_plain", kernel="K3 shared-memory limits", p=16, largest_k=limits)
    # The generic kernel's edges of the instances the sum, dot and none kernels took over
    # (and one past at p=16), and w=16 past the exact-sum depth.
    routes = {}
    for (w, what), edges in _EARLIER_EDGES.items():
        for expand, refold in _edge_pairs(w, what):
            for p, k in edges.items():
                for kk in ((k, k + 1) if p == 16 else (k,)):
                    routes[f"w={w} {expand}+{refold} p={p} k={kk}"] = _limit_case(
                        grids, rng, gen, device, w, expand, refold, p, kk, 257 if p == 1 else 4097, "the generic kernel's edge")
    # Every symbol 0xFFFF and every coefficient the densest element at k =
    # 16,400: the scaled first-product sums pass 2^31 (the plain version's
    # planes are -1: its sums stay exact in float32).
    k = 16400
    A = np.full((1, k), dense16)
    B = torch.full((k, 64), -1, dtype=torch.int16, device=device).view(torch.uint16)
    top = int((cuda_planes.sum_operator(A[:, :4], 16).astype(np.int64).sum(axis=1) * 255).max()) * k // 4
    for refold in ("sum", "dot"):
        wide.check(cuda_planes.gf_matmul_planes(A, B, "shift_raw", refold, w=16),
                   cuda_planes.gf_matmul_planes_plain(A, B, "shift_raw", refold, w=16),
                   f"w=16 shift_raw+{refold} p=1 k={k} symbols 0xFFFF, largest sum about {top}")
        routes[f"w=16 shift_raw+{refold} p=1 k={k}"] = cuda_planes.route(k, 1, "shift_raw", refold, 16)
    log(phase="kernel_vs_plain", kernel="K3 earlier edges", routes=routes, deep_sum_estimate=top)
    # The pre-parity form of every instance, exact int32.
    for w, expand, refold in cuda_planes.INSTANCES:
        if refold != "none":
            continue
        grid = grids[k3_grid_name(expand, "none", w)]
        for k in (1, 4, 10, 33):
            for m in (37, 4160, 100003):
                B = _rand_w(gen, (k, m), device, w)
                for p in (1, 4, 10):
                    A = rng.integers(0, 1 << w, size=(p, k))
                    want = cuda_planes.gf_matmul_planes_plain(A, B, expand, "none", w=w)
                    for tile in (256, 8192):
                        grid.check(cuda_planes.gf_matmul_planes(A, B, expand, "none", tile, w=w), want,
                                   f"w={w} {expand}+none p={p} k={k} m={m} tile={tile}")
        # The stripe mesh's k-slice of BASELINE config 4, and pinned.
        A, B = rng.integers(0, 1 << w, size=(16, 32)), _rand_w(gen, (32, 65536), device, w)
        grid.check(cuda_planes.gf_matmul_planes(A, B, expand, "none", w=w),
                   cuda_planes.gf_matmul_planes_plain(A, B, expand, "none", w=w), f"w={w} {expand}+none p=16 k=32")
        grid.check(cuda_planes.gf_matmul_planes(A, B, expand, "none", 8192, pinned=True, w=w),
                   cuda_planes.gf_matmul_planes_plain(A, B, expand, "none", 8192, pinned=True, w=w),
                   f"w={w} {expand}+none p=16 k=32 pinned")
    B = torch.full((33, 4096), 0xFF, dtype=torch.uint8, device=device)
    for expand in cuda_planes.EXPANDS:
        A = np.full((10, 33), dense8)
        grids["K3-planes-preparity"].check(cuda_planes.gf_matmul_planes(A, B, expand, "none"),
                                           cuda_planes.gf_matmul_planes_plain(A, B, expand, "none"),
                                           f"w=8 {expand}+none largest sum: element {dense8} k=33 bytes 0xFF")
    # The public dispatch of every JAX name at w=16 (refold None, sum, dot,
    # autotune) and pre-parity (its sums against the kernel expansion's
    # plain version, its parity against K1's).
    for w in (8, 16):
        A = rng.integers(0, 1 << w, size=(4, 10))
        B = _rand_w(gen, (10, 4097), device, w)
        folded, sums = gf_matmul_bitplane(A, B, w), gf_matmul_bitplane(A, B, w, fold_parity=False)
        for name, kernel in cuda_gemm.EXPANSIONS.items():
            if name not in cuda_gemm.JAX_NAMES or kernel == "pack2" or (w == 16 and name in cuda_gemm.BYTE_ONLY):
                continue
            if w == 16:
                for refold in (None, "sum", "dot", "autotune"):
                    got = cuda_gemm.gf_matmul_cuda(A, B, 16, expand=name, refold=refold)
                    wide.check(got, folded, f"dispatch w=16 expand={name} refold={refold}")
            pre = grids[k3_grid_name(kernel, "none", w)]
            got = cuda_gemm.gf_matmul_cuda(A, B, w, expand=name, fold_parity=False)
            pre.check(got, cuda_planes.gf_matmul_planes_plain(A, B, kernel, "none", w=w),
                      f"dispatch w={w} expand={name} fold_parity=False")
            pre.check(got & 1, sums & 1, f"dispatch w={w} expand={name} fold_parity=False, parity against K1's")
    cuda_gemm.clear_autotune_cache()


def _w4_instances_vs_plain(device, gen, rng, narrow: Grid, pre: Grid) -> None:
    """Phase 7's W=4 cases (bytes with the high nibble set): K3's folded
    W=4 instances (the sum and dot kernels) at k 1-33, p 1-17 (p = 8: a
    pair of m-tiles; 1, 3, 4, 10, 17: a lone last one, which the sum and
    none kernels run alone; 17: past one 8-symbol tile), m 37-100,003,
    tiles 256 and 8192, pinned, and at their largest sums (every byte
    0xFF, the densest element), with the pre-parity form (the none kernel)
    beside each; and the public dispatch of shift and shift_raw at w=4
    (refold None, sum, dot, autotune; fold_parity=False) against K1's
    plain version."""
    dense4 = int(get_field(4).bitmats.sum(axis=2).max(axis=1).argmax())
    for expand in cuda_planes.NARROW_EXPANDS:
        for k in (1, 3, 8, 9, 33):
            for m in (37, 4097, 100003):
                B = _rand_u8(gen, (k, m), device)
                for p in (1, 3, 4, 8, 10, 17):
                    A = rng.integers(0, 16, size=(p, k))
                    for refold in ("sum", "dot", "none"):
                        grid = pre if refold == "none" else narrow
                        want = cuda_planes.gf_matmul_planes_plain(A, B, expand, refold, w=4)
                        for tile in (256, 8192):
                            grid.check(cuda_planes.gf_matmul_planes(A, B, expand, refold, tile, w=4), want,
                                       f"w=4 {expand}+{refold} p={p} k={k} m={m} tile={tile}")
        A, B = rng.integers(0, 16, size=(4, 10)), _rand_u8(gen, (10, 3 * 8192 + 37), device)
        for refold in ("sum", "dot"):
            narrow.check(cuda_planes.gf_matmul_planes(A, B, expand, refold, 8192, pinned=True, w=4),
                         cuda_planes.gf_matmul_planes_plain(A, B, expand, refold, 8192, pinned=True, w=4),
                         f"w=4 {expand}+{refold} pinned")
        for k in (4, 33):
            B = torch.full((k, 4096), 0xFF, dtype=torch.uint8, device=device)
            A = np.full((10, k), dense4)
            for refold in ("sum", "dot", "none"):
                grid = pre if refold == "none" else narrow
                grid.check(cuda_planes.gf_matmul_planes(A, B, expand, refold, w=4),
                           cuda_planes.gf_matmul_planes_plain(A, B, expand, refold, w=4),
                           f"w=4 {expand}+{refold} largest sum: element {dense4} k={k} bytes 0xFF")
    A, B = rng.integers(0, 16, size=(4, 10)), _rand_u8(gen, (10, 4097), device)
    folded, sums = gf_matmul_bitplane(A, B, 4), gf_matmul_bitplane(A, B, 4, fold_parity=False)
    for name in cuda_planes.NARROW_EXPANDS:
        for refold in (None, "sum", "dot", "autotune"):
            narrow.check(cuda_gemm.gf_matmul_cuda(A, B, 4, expand=name, refold=refold), folded,
                         f"dispatch w=4 expand={name} refold={refold}")
        got = cuda_gemm.gf_matmul_cuda(A, B, 4, expand=name, fold_parity=False)
        pre.check(got, cuda_planes.gf_matmul_planes_plain(A, B, name, "none", w=4),
                  f"dispatch w=4 expand={name} fold_parity=False")
        pre.check(got & 1, sums & 1, f"dispatch w=4 expand={name} fold_parity=False, parity against K1's")
    cuda_gemm.clear_autotune_cache()


def _reset_counts() -> None:
    cuda_gemm.LAUNCHES = cuda_gemm.CAPTURED = cuda_gemm.REPLAYED = cuda_gemm.PREPARITY = 0
    cuda_pack2.LAUNCHES = cuda_pack2.CAPTURED = cuda_pack2.REPLAYED = 0
    cuda_planes.reset_counts()


def k1_runs() -> int:
    """K1 kernels that ran since the counts were reset: eager launches and
    the launches inside CUDA-graph replays (the plan layer's), one a
    dispatch either way.  Launches recorded into a graph at its capture ran
    nothing then, and count in cuda_gemm.CAPTURED only."""
    return cuda_gemm.LAUNCHES + cuda_gemm.REPLAYED


# Kernel (the kernels line's and the grids' names) -> cuda_planes' count:
# the sum and dot kernels at w=8 ("sum", "dot"), at w=4 ("w4") and at w=16
# ("w16"); the none kernel at w=8 ("preparity") and at w=4 and 16.
K3_KINDS = {"K3-planes-sum": "sum", "K3-planes-dot": "dot", "K3-copy-floor": "copy",
            "K3-planes-w4": "w4", "K3-planes-w16": "w16", "K3-planes-preparity": "preparity",
            "K3-planes-preparity-w4-w16": "preparity_w4_w16"}


def _counts() -> dict:
    """Kernels that ran since the counts were reset, eager and inside graph
    replays, by kernel."""
    out = {"K1": k1_runs(), "K2": cuda_pack2.LAUNCHES + cuda_pack2.REPLAYED}
    out.update({name: cuda_planes.runs(kind) for name, kind in K3_KINDS.items()})
    return out


def _numbers(row: dict) -> list[float]:
    """Every number in a tool's row, nested dictionaries included (labels
    and flags are not numbers)."""
    out = []
    for v in row.values():
        if isinstance(v, dict):
            out += _numbers(v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            out.append(float(v))
    return out


def _run_tool(tool, argv: list[str], any_sign: tuple = ()) -> list[dict]:
    """Run a tool's main in this process: rc 0, the capture header first,
    every number of its rows finite and positive (those under the keys in
    ``any_sign``, finite)."""
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
    values = [v for row in rows for v in _numbers({k: v for k, v in row.items() if k not in any_sign})]
    signed = [v for row in rows for v in _numbers({k: v for k, v in row.items() if k in any_sign})]
    if (not rows or not values or not all(math.isfinite(v) and v > 0 for v in values)
            or not all(math.isfinite(v) for v in signed)):
        raise AssertionError(f"{name}: a result is not a positive number: {rows}")
    log(phase="tool", tool=name, argv=argv, seconds=seconds, header=lines[0], results={k: v for r in rows for k, v in r.items()})
    return rows


@_named("8 tools")
def phase_tools() -> dict:
    """The slice's entry points at their default sizes; returns the sweep's
    results and the launches the two runs made."""
    _reset_counts()
    sweep = _run_tool(kernel_sweep, ["--trials", "1"])
    probe = _run_tool(expand_probe, ["--trials", "1"])
    launches = _counts()
    for name in ("K2", "K3-planes-sum", "K3-planes-dot", "K3-copy-floor"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} was not launched by the tools: {launches}")
    log(phase="tools_launches", **launches)
    return {"sweep": {k: v for r in sweep for k, v in r.items()},
            "probe": {k: v for r in probe for k, v in r.items()}, "launches": launches}


TOOLS_5K = (  # reduced sizes: the phase's budget is 120 s
    (inverse_bench, ["--k", "10", "128", "--batch", "3", "256", "--trials", "1"]),
    (mesh_bench, ["--mb", "64", "--trials", "1"]),
    (mesh_overhead, ["--mb", "1", "8"]),
    (strategy_bench, ["--size", "64"]),
    (k_sweep, ["--mb", "64", "--trials", "1"]),
    (w16_bench, ["--mb", "64", "--trials", "1"]),
    (stream_bench, ["--mb", "256"]),
)


def _fleet_routing(work: str, seed: int, k: int, p: int) -> dict:
    """repair_fleet over three small damaged archives at (k, k + p): the
    batched inverter runs once if a group of 3 reaches the card's threshold
    for k (api._device_invert_min_batch_cuda), else not at all and the
    host search inverts each archive; every rebuilt chunk equals its
    original."""
    n = k + p
    files = [os.path.join(work, f"route{k}_{i}.bin") for i in range(3)]
    for i, f in enumerate(files):
        write_seeded(f, seed + i, MiB + 4097 * i)
    api.encode_fleet(files, k, p, checksums=True)
    saved = {f: archive_digests(f, n) for f in files}
    lost = {files[0]: [0, k + 1], files[1]: [3, 4], files[2]: [k - 1, n - 1]}
    for f, pair in lost.items():
        for i in pair:
            os.unlink(chunk_file_name(f, i))
    calls, real = [], inverse.invert_matrix_torch_batch

    def spy(Ms, w=8, **kw):
        calls.append(list(np.shape(Ms)))
        return real(Ms, w, **kw)

    api.clear_subset_cache()
    inverse.invert_matrix_torch_batch = spy
    try:
        got = api.repair_fleet(files)
    finally:
        inverse.invert_matrix_torch_batch = real
    threshold = api._device_invert_min_batch_cuda(k)
    want = [[3, k, k]] if threshold is not None and 3 >= threshold else []
    if got != lost or calls != want:
        raise AssertionError(f"repair_fleet routing: rebuilt {got}, batched calls {calls}, expected {want} "
                             f"(threshold at k={k}: {threshold})")
    for f in files:
        if archive_digests(f, n) != saved[f]:
            raise AssertionError(f"repair_fleet routing: {f}'s archive differs from the one encoded")
    res = {"k": k, "threshold": threshold, "batched_calls": len(calls), "routed": "device" if calls else "host"}
    log(phase="tools_5k", step="repair_fleet_routing", **res)
    return res


@_named("5k tools")
def phase_tools_5k(work: str, seed: int, device) -> dict:
    """Phase 5k: the seven measurement tools of the JAX package's that came
    last, at reduced sizes, then repair_fleet's routing on the card.  The
    counts are reset just before; K1's runs join the kernels line."""
    t0 = time.perf_counter()
    _reset_counts()
    results = {}
    for tool, argv in TOOLS_5K:
        if tool is stream_bench:
            argv = argv + ["--dir", work]
        results[tool.__name__.rsplit(".", 1)[-1]] = _run_tool(tool, argv)
    # k=10: the main configuration; k=128: the wide stripe, whose threshold
    # is lower on the card's grid.
    routing = [_fleet_routing(work, seed, 10, 4), _fleet_routing(work, seed + 3, 128, 16)]
    launches = _counts()
    if launches["K1"] <= 0:
        raise AssertionError(f"K1 was not launched by the tools: {launches}")
    res = {"tools": results, "routing": routing, "k1_launches": launches["K1"], "seconds": time.perf_counter() - t0}
    log(phase="tools_5k_summary", seconds=res["seconds"], launches=launches, routing=routing)
    return res


# Reduced sizes (the phase's budget is 120 s).  The keys whose numbers may
# be zero or negative: the sync arm's writer count (0), the stage split of
# an extra profiled dispatch (a dispatch may time no stage), the pack
# reduction (a difference), the warm children's schedule builds (0, or
# warm_ab raises).
TOOLS_5L = (
    (io_bench, ["--mb", "64", "--trials", "1"], ()),
    (io_bench, ["--ab", "--mb", "64", "--trials", "1", "--archives", "2"], ("writers",)),
    (update_bench, ["--ab", "--size-mb", "64", "--trials", "1"], ()),
    (update_group_ab, ["--size-mb", "64", "--edits", "64", "--edit-kb", "4", "--trials", "1"], ()),
    (xor_ab, ["--ab", "--size-mb", "20", "--trials", "1", "--strategies", "xor,xor_noopt,ring,table,cuda"],
     ("stages",)),
    (xor_ab, ["--locate-ab", "--size-mb", "16", "--trials", "1"], ("pack_reduction",)),
    (warm_ab, ["--ab", "--size-mb", "4", "--trials", "1"], ("warm_schedule_builds",)),
)


@_named("5l five tools")
def phase_tools_5l(work: str) -> dict:
    """Phase 5l: the last five measurement tools at reduced sizes, every
    file under ``work``.  The counts are reset just before; K1's runs join
    the kernels line."""
    t0 = time.perf_counter()
    _reset_counts()
    results = []
    for tool, argv, any_sign in TOOLS_5L:
        t_tool = time.perf_counter()
        rows = _run_tool(tool, argv + ["--dir", work], any_sign)
        results.append({"tool": tool.__name__.rsplit(".", 1)[-1], "argv": argv, "rows": rows,
                        "seconds": time.perf_counter() - t_tool})
    launches = _counts()
    if launches["K1"] <= 0:
        raise AssertionError(f"K1 was not launched by the five tools: {launches}")
    io_rows = [row for r in results for row in r["rows"] if row.get("metric") in ("staging_io_gbps", "io_ab")]
    res = {"tools": results, "k1_launches": launches["K1"], "seconds": time.perf_counter() - t0}
    log(phase="tools_5l_summary", seconds=res["seconds"], launches=launches, io_bench_rows=io_rows,
        tool_seconds={f"{r['tool']} {' '.join(r['argv'][:1])}": r["seconds"] for r in results}, smi=smi_line())
    return res


def preparity_bound_ms(p: int, k: int, m: int, w: int) -> float:
    """Least time for the pre-parity form: B read once and the (p*w, m)
    int32 sums written once at the device-memory rate."""
    return 1e3 * (k * sym_bytes(w) + 4 * p * w) * m / HBM_BYTES_PER_S


@_named("9 K2/K3 timings")
def phase_new_timings(device) -> dict:
    """K2, each K3 pair, the pinned ceiling and the copy floor at the main
    path's encode segment shape; K3's w=16 instances (the sum, dot and none
    kernels at w=16) at the w=16 encode segment (the same 64 MiB: m =
    3,355,392 symbols) and its w=8 pre-parity form (the none kernel) at the
    w=8 segment; K1 (both forms) and K3's W=4 instances at w=4 on the w=8
    segment's bytes.  Each K3 row carries its design's instruction estimate
    (est_ops_per_col, est_ops_ms) and its tensor floor (ops_bound_ms).  tools/k3_timings_ab.py runs this phase in
    two trees in turns (a parent and a change, on one card)."""
    k, p, m = 10, 4, SEGMENT_COLS
    m16 = SEGMENT_COLS // 2
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    clock_mhz = float(smi_line("clocks.max.sm").split()[0])
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 9)
    A = RSCodec(k, p, device=device).parity_block
    B = _rand_u8(gen, (k, m), device)
    A16 = RSCodec(k, p, w=16, device=device).parity_block
    B16 = _rand_u16(gen, (k, m16), device)
    A4 = RSCodec(k, p, w=4, device=device).parity_block
    seg = (m, 8, bound_ms(p, k, m, 8))
    cases = [("K2", "pack2", lambda: cuda_pack2.gf_matmul_pack2(A, B), lambda: cuda_pack2.gf_matmul_pack2_plain(A, B), None,
              seg)]
    for expand, refold in cuda_planes.PAIRS:
        cases.append((k3_grid_name(expand, refold), f"{expand}+{refold}",
                      functools.partial(cuda_planes.gf_matmul_planes, A, B, expand, refold),
                      functools.partial(cuda_planes.gf_matmul_planes_plain, A, B, expand, refold), None, seg))
    for kernel, expand, refold in (("K3-planes-dot", "shift_raw", "dot"), ("K3-planes-sum", "nibble", "sum")):
        cases.append((kernel, f"{expand}+{refold} pinned (compute-only ceiling)",
                      functools.partial(cuda_planes.gf_matmul_planes, A, B, expand, refold, pinned=True),
                      functools.partial(cuda_planes.gf_matmul_planes_plain, A, B, expand, refold, pinned=True), None,
                      seg))
    cases.append(("K3-copy-floor", "copy_floor", lambda: cuda_planes.copy_floor(B, p), lambda: cuda_planes.copy_floor_plain(B, p),
                  lambda: B[:p].clone(), seg))
    for expand in cuda_planes.WIDE_EXPANDS:
        for refold in ("sum", "dot"):
            cases.append(("K3-planes-w16", f"w16 {expand}+{refold}",
                          functools.partial(cuda_planes.gf_matmul_planes, A16, B16, expand, refold, w=16),
                          functools.partial(cuda_planes.gf_matmul_planes_plain, A16, B16, expand, refold, w=16), None,
                          (m16, 16, bound_ms(p, k, m16, 16))))
    for expand in cuda_planes.WIDE_EXPANDS:
        cases.append((k3_grid_name(expand, "none", 16), f"w16 {expand}+none",
                      functools.partial(cuda_planes.gf_matmul_planes, A16, B16, expand, "none", w=16),
                      functools.partial(cuda_planes.gf_matmul_planes_plain, A16, B16, expand, "none", w=16), None,
                      (m16, 16, preparity_bound_ms(p, k, m16, 16))))
    for expand in cuda_planes.EXPANDS:
        cases.append(("K3-planes-preparity", f"{expand}+none",
                      functools.partial(cuda_planes.gf_matmul_planes, A, B, expand, "none"),
                      functools.partial(cuda_planes.gf_matmul_planes_plain, A, B, expand, "none"), None,
                      (m, 8, preparity_bound_ms(p, k, m, 8))))
    # w=4 on the same bytes: one symbol a byte, the high nibble ignored.
    for fold, label, bound in ((True, "K1 w4", bound_ms(p, k, m, 4)),
                               (False, "K1 w4 pre-parity", preparity_bound_ms(p, k, m, 4))):
        cases.append(("K1", label, functools.partial(cuda_gemm.gf_matmul_cuda, A4, B, 4, fold_parity=fold),
                      functools.partial(gf_matmul_bitplane, A4, B, 4, fold_parity=fold), None, (m, 4, bound)))
    for expand in cuda_planes.NARROW_EXPANDS:
        for refold in ("sum", "dot", "none"):
            bound = preparity_bound_ms(p, k, m, 4) if refold == "none" else bound_ms(p, k, m, 4)
            cases.append((k3_grid_name(expand, refold, 4), f"w4 {expand}+{refold}",
                          functools.partial(cuda_planes.gf_matmul_planes, A4, B, expand, refold, w=4),
                          functools.partial(cuda_planes.gf_matmul_planes_plain, A4, B, expand, refold, w=4), None,
                          (m, 4, bound)))
    rows = {}
    for kernel, label, fn, plain, library, (cols, w, bound) in cases:
        err = int((_widen(fn()) - _widen(plain())).abs().max().item())
        if err:
            raise AssertionError(f"{kernel} {label} != plain at the timing shape")
        ms = time_ms(fn, iters=100, reps=3)
        row = dict(phase="kernel_timing", kernel=kernel, shape=f"encode k={k} p={p} m={cols} w={w} ({label})", ms=ms,
                   plain_ms=time_ms(plain, iters=3, warmup=1), bound_ms=bound, bound_by="bytes",
                   library_ms=time_ms(library, iters=20) if library else None, max_abs_err=err,
                   data_gbps=k * cols * sym_bytes(w) / (ms * 1e-3) / 1e9,
                   traffic_gbps=(k + p) * cols * sym_bytes(w) / (ms * 1e-3) / 1e9,
                   nvidia_smi=smi_line())
        ops = k2_ops_per_col(p, k) if kernel == "K2" else None
        expand, refold = (label.split(" ")[label.startswith(("w16 ", "w4 "))].split("+") + [None])[:2]
        row.update(tile=cuda_pack2.DEFAULT_TILE if kernel == "K2" else None if kernel == "K1" else
                   cuda_planes.tile_cols(None, cols) if refold is None else
                   cuda_planes.block_cols(None, cols))
        if kernel.startswith("K3-planes"):
            if refold == "none":
                ops = k3_none_ops_per_col(p, k, expand, w)
            else:
                ops = (k3_ops_per_col if refold == "sum" else k3_dot_ops_per_col)(p, k, expand, w)
            # The floor of this formulation's tensor work, beside the bytes
            # bound: nibble's k*32 planes outlast its bytes, yet K1 computes
            # the same product in less, so bound_ms stays the bytes.
            row.update(ops_bound_ms=k3_ops_bound_ms(p, k, cols, expand, w))
        if label == "K1 w4":
            ops = k1_logic_ops_per_col(p, k, 4)
        if ops is not None:
            row.update(est_ops_per_col=ops, sms=sms, max_sm_clock_mhz=clock_mhz,
                       est_ops_ms=1e3 * ops * cols / (sms * LOGIC_OPS_PER_SM_CLOCK * clock_mhz * 1e6))
        log(**row)
        rows[label] = row
    return rows


@_named("5 short segments")
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
                    launches = k1_runs()
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
    """Each operation of a phase with the counts set to 0 just before it and
    read just after: its wall, GB/s over ``nbytes``, K1 launches and, given
    a ``timer``, its phases.  An operation with a GEMM must launch K1 only
    on the pipeline's compute stream from pinned staging
    (``check_pipeline``); one without must launch nothing."""

    def __init__(self, smi: str, label: str = "resilience_op"):
        self.smi, self.label, self.rows = smi, label, {}

    def run(self, name: str, fn, nbytes: int, gemm: bool = True, staged_ahead: bool = False, native_io: bool = True,
            timer: PhaseTimer | None = None):
        _reset_counts()
        _reset_io_counts()
        plan0 = _plan_counts()
        t0 = time.perf_counter()
        result = fn()
        wall = time.perf_counter() - t0
        launches, io_counts = k1_runs(), _io_counts()
        if gemm:
            check_pipeline(name, launches, io_counts, staged_ahead, native_io)
        elif launches or io_counts["stream_dispatches"]:
            raise AssertionError(f"{name}: {launches} K1 launches where no GEMM belongs")
        self.rows[name] = dict(wall_s=wall, gbps=nbytes / wall / 1e9, bytes=nbytes, k1_launches=launches,
                               io=io_counts, plan=_plan_delta(plan0))
        if timer is not None:
            self.rows[name]["phases_s"] = dict(timer.acc)
        log(phase=self.label, op=name, nvidia_smi=self.smi, **self.rows[name])
        return result

    def timed(self, name: str, fn, nbytes: int, **kw):
        """:meth:`run` of ``fn(timer)`` with a fresh PhaseTimer, its phases
        logged beside the wall."""
        timer = PhaseTimer()
        return self.run(name, lambda: fn(timer), nbytes, timer=timer, **kw)

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
    # The card's routing (api._device_invert_min_batch_cuda): a group of 3
    # below the threshold for k=10 takes the host search, one archive each.
    threshold = api._device_invert_min_batch_cuda(k)
    if threshold is not None and 3 >= threshold:
        if (len(batches) != 1 or batches[0]["shape"] != [3, k, k] or batches[0]["pivot"] is not False
                or batches[0]["device"] != str(device) or not all(batches[0]["ok"]) or host_solves):
            raise AssertionError(f"repair_fleet: batched inversions {batches}, host re-solves {host_solves}")
    elif batches or sorted(host_solves) != sorted(files):
        raise AssertionError(f"repair_fleet below the card's threshold ({threshold}): batched inversions {batches}, "
                             f"host searches {host_solves}")
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
    return dict(batched_inversions=batches, host_resolves=len(host_solves), routing_threshold_k10=threshold,
                invert_batch_device_ms=device_ms,
                invert_host_loop_ms=host_ms, fleet_bytes=len(files) * size, sha256_match=True)


@_named("5b resilience")
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
    os.unlink(out)
    t_xor = time.perf_counter()
    locate_xor = _locate_under_xor(path, want_sha, cols)  # phase 5d, on this archive

    res = dict(phase="resilience", nvidia_smi=smi, bytes=size, k=k, n=n, ops=ops.rows, midstream=swap, fleet=fleets,
               silent_bitrot=syn, k1_launches=ops.launches, locate_xor=locate_xor,
               seconds=time.perf_counter() - t0, locate_xor_seconds=time.perf_counter() - t_xor)
    log(**res)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    return res


def _pwrite_file(path: str, data: bytes, off: int) -> None:
    """The host mirror's edit: ``data`` at byte ``off`` of ``path``."""
    fd = os.open(path, os.O_WRONLY)
    try:
        if os.pwrite(fd, data, off) != len(data):
            raise AssertionError(f"short pwrite into the mirror {path}")
    finally:
        os.close(fd)


def _crc_lines(path: str) -> list[str]:
    with open(path + ".METADATA") as fp:
        return [ln for ln in fp.read().splitlines() if ln.startswith("# crc32")]


def _prove(path: str, layout: str, work: str, device, segment_bytes: int, ops: Ops) -> dict:
    """``path`` is the archive and, edited alongside it, its host mirror:
    a from-scratch encode of the mirror (same layout) in a second directory
    must give byte-identical chunk files and ``# crc32`` lines, and a decode
    of the archive with chunks 0-3 lost must give the mirror's SHA-256."""
    k, n = 10, 14
    proof_dir = os.path.join(work, f"proof_{layout}")
    os.makedirs(proof_dir)
    twin = os.path.join(proof_dir, os.path.basename(path))
    os.link(path, twin)  # the mirror's bytes, under the archive's name
    size = os.path.getsize(path)
    ops.timed(f"proof_reencode_{layout}", lambda t: api.encode_file(twin, k, n - k, checksums=True, layout=layout,
                                                                     device=device, segment_bytes=segment_bytes,
                                                                     timer=t), size)
    got, want = archive_digests(path, n), archive_digests(twin, n)  # keyed by base name, the same in both
    diff = [name for name in got if not name.endswith(".METADATA") and got[name] != want[name]]
    if diff or _crc_lines(path) != _crc_lines(twin):
        raise AssertionError(f"{layout}: the updated archive differs from a re-encode of the mirror: {diff}")
    mirror_sha = sha256_file(path)
    for i in range(4):
        os.unlink(chunk_file_name(path, i))
    out = path + ".proof.out"
    ops.timed(f"proof_decode_{layout}", lambda t: api.decode_file(path, make_conf(n, k, path), out, device=device,
                                                                  segment_bytes=segment_bytes, timer=t), size)
    if sha256_file(out) != mirror_sha:
        raise AssertionError(f"{layout}: the decode with chunks 0-3 lost differs from the mirror")
    return dict(chunks_equal_reencode=True, crc_lines_equal=True, decode_sha256_equals_mirror=True,
                mirror_sha256=mirror_sha)


@_named("5c updates")
def phase_updates(work: str, seed: int, size: int, device, segment_bytes: int = api.DEFAULT_SEGMENT_BYTES) -> dict:
    """The interleaved layout and the in-place updates at k=10, n=14, w=8
    with checksums on ``size`` seeded bytes: the interleaved encode, its
    reads (auto-decode, repair, locate), an append, an update, a group of
    1,000 4 KiB edits (one stacked K1 launch), a torn update rolled back,
    and on a row archive an update across the row-1/row-2 boundary and the
    appends on either side of its tail slack; each archive then proven
    against a re-encode of its host mirror.  Returns the logged result."""
    from gpu_rscode_torch.update import SimulatedCrash, UpdateError
    from gpu_rscode_torch.update.group import _merge_windows
    from gpu_rscode_torch.update.layout import touched_windows
    from gpu_rscode_torch.utils.fileformat import chunk_size_for_layout, metadata_file_name, rewrite_metadata_lines

    t0 = time.perf_counter()
    k, n = 10, 14
    smi = smi_line()
    ops = Ops(smi, label="update_op")
    rng = np.random.default_rng(seed + 1)
    path = os.path.join(work, "upd.bin")  # the archive's input, then its host mirror
    want_sha = write_seeded(path, seed, size)
    chunk = chunk_size_for_layout(size, k, 1, "interleaved")
    kw = dict(device=device, segment_bytes=segment_bytes)

    ops.timed("encode_interleaved", lambda t: api.encode_file(path, k, n - k, checksums=True, layout="interleaved",
                                                               timer=t, **kw), size)
    saved = archive_digests(path, n)

    # The reads of an interleaved archive.
    os.unlink(chunk_file_name(path, 0))
    out = ops.timed("auto_decode_interleaved", lambda t: api.auto_decode_file(path, path + ".auto.out", timer=t,
                                                                               **kw), size)
    if sha256_file(out) != want_sha:
        raise AssertionError("interleaved auto_decode_file: the SHA-256 differs from the input")
    os.unlink(out)
    rebuilt = ops.timed("repair_interleaved", lambda t: api.repair_file(path, timer=t, **kw), size)
    if rebuilt != [0] or archive_digests(path, n) != saved:
        raise AssertionError(f"interleaved repair_file rebuilt {rebuilt} or changed the archive")
    # A copy without CRC lines (chunks linked, chunk 3 copied), 64 bytes of
    # chunk 3 flipped at scattered columns, for the error-locating decode.
    loc_dir = os.path.join(work, "locate")
    os.makedirs(loc_dir)
    loc = os.path.join(loc_dir, "upd.bin")
    for i in range(n):
        (shutil.copyfile if i == 3 else os.link)(chunk_file_name(path, i), chunk_file_name(loc, i))
    shutil.copyfile(metadata_file_name(path), metadata_file_name(loc))
    rewrite_metadata_lines(metadata_file_name(loc), crcs={})
    _flip(chunk_file_name(loc, 3), np.sort(np.random.default_rng(seed + 20).choice(chunk, size=64, replace=False)))
    out = ops.timed("locate_decode_interleaved", lambda t: api.locate_decode_file(loc, loc + ".out", timer=t, **kw),
                    size)
    if sha256_file(out) != want_sha:
        raise AssertionError("interleaved locate_decode_file: the SHA-256 differs from the input")
    shutil.rmtree(loc_dir)

    # Append, update, group update: each applied to the mirror too.
    big = min(64 * MiB, size // 16)  # 64 MiB at 1 GiB; smaller in a dry run at a small size
    tail = rng.bytes(big)
    res_append = ops.timed("append_64MiB", lambda t: api.append_file(path, tail, timer=t, **kw), len(tail),
                           native_io=False)
    with open(path, "ab") as fp:
        fp.write(tail)
    at = min(300_000_007, size // 3 + 7)
    edit = rng.bytes(big)
    res_update = ops.timed("update_64MiB", lambda t: api.update_file(path, at, edit, timer=t, **kw), len(edit),
                           native_io=False)
    _pwrite_file(path, edit, at)
    total = os.path.getsize(path)
    slots = np.sort(rng.choice(total // 8192, size=1000, replace=False))
    edits = [{"op": "update", "at": int(slot) * 8192 + int(rng.integers(0, 4096)), "data": rng.bytes(4096)}
             for slot in slots]
    res_group = ops.timed("group_1000x4KiB", lambda t: api.update_file_many(path, edits, group_edits=len(edits),
                                                                            timer=t, **kw),
                          4096 * len(edits), native_io=False)
    if ops.rows["group_1000x4KiB"]["k1_launches"] != 1 or res_group["groups"] != 1:
        raise AssertionError(f"the group of 1,000 edits took {ops.rows['group_1000x4KiB']['k1_launches']} K1 "
                             f"launches in {res_group['groups']} group(s), not one stacked launch")
    # The one launch's width: the group's merged column windows, stacked.
    windows = _merge_windows([win for e in edits for win in touched_windows("interleaved", e["at"], 4096, k, 1,
                                                                            chunk_size_for_layout(total, k, 1,
                                                                                                  "interleaved"))])
    group_cols = sum(hi - lo for lo, hi in windows)
    for e in edits:
        _pwrite_file(path, e["data"], e["at"])

    # A torn 4 MiB update: natives patched, parity not; recover rolls back.
    pre = archive_digests(path, n)
    os.environ["RS_UPDATE_CRASH"] = "mid_patch"
    try:
        api.update_file(path, min(123_456_789, size // 5 + 9), rng.bytes(big // 16), **kw)
        raise AssertionError("RS_UPDATE_CRASH=mid_patch did not raise SimulatedCrash")
    except SimulatedCrash:
        pass
    finally:
        del os.environ["RS_UPDATE_CRASH"]
    pending = api.scan_file(path, device=device)["pending_journal"]
    verdict = api.recover_archive(path)
    after = archive_digests(path, n)
    if not pending or verdict != "rolled_back" or after != pre:
        raise AssertionError(f"torn update: pending_journal {pending}, recover {verdict!r}, "
                             f"archive restored {after == pre}")
    torn = dict(simulated_crash=True, pending_journal=pending, recovered=verdict, digests_equal_pre_op=True)
    t_xor = time.perf_counter()
    update_xor = _update_under_xor(path, min(555_555_555, size // 2 + 5), rng.bytes(big // 16), device)  # phase 5d
    update_xor["seconds"] = time.perf_counter() - t_xor
    proof_interleaved = _prove(path, "interleaved", work, device, segment_bytes, ops)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)

    # The row layout: an update across the row-1/row-2 boundary, then the
    # appends on either side of the tail slack (6 bytes for 1 GiB, k=10).
    row = os.path.join(work, "row.bin")
    write_seeded(row, seed + 2, size)
    ops.timed("encode_row", lambda t: api.encode_file(row, k, n - k, checksums=True, timer=t, **kw), size)
    row_chunk = chunk_size_for_layout(size, k, 1, "row")
    row_at = 2 * row_chunk - big // 2
    edit = rng.bytes(big)
    res_row = ops.timed("update_64MiB_row_boundary", lambda t: api.update_file(row, row_at, edit, timer=t, **kw),
                        len(edit), native_io=False)
    _pwrite_file(row, edit, row_at)
    slack = k * row_chunk - size
    pre = archive_digests(row, n)
    try:
        api.append_file(row, rng.bytes(slack + 1), **kw)
        raise AssertionError(f"a {slack + 1}-byte append past the row archive's {slack}-byte slack was taken")
    except UpdateError as e:
        refused = str(e)
    if archive_digests(row, n) != pre:
        raise AssertionError("the refused row append changed the archive")
    fit = rng.bytes(slack)
    res_fit = ops.timed(f"append_{slack}B_row", lambda t: api.append_file(row, fit, timer=t, **kw), slack,
                        native_io=False)
    with open(row, "ab") as fp:
        fp.write(fit)
    proof_row = _prove(row, "row", work, device, segment_bytes, ops)

    res = dict(phase="updates", nvidia_smi=smi, bytes=size, k=k, n=n, ops=ops.rows,
               summaries={"append": res_append, "update": res_update, "group": res_group, "row_update": res_row,
                          "row_append": res_fit},
               group_stacked_cols=group_cols, torn_update=torn, update_xor=update_xor, row_slack=slack,
               row_refused=refused,
               proof={"interleaved": proof_interleaved, "row": proof_row},
               k1_launches=ops.launches, seconds=time.perf_counter() - t0)
    log(**res)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    return res


# -- phase 5f: the object store ------------------------------------------------

STORE_OBJECTS = 2048  # seeded sizes, log-uniform over 4 KiB - 1 MiB
STORE_BATCH = 64
STORE_SMALL = 1000  # x 4 KiB: the write-combining batch
STORE_DELETES = 128
STORE_STRIPE = 64 * MiB  # the seal threshold's default


class _GemmLog:
    """Records the codec's encode / update / decode GEMMs while active, as
    (operation tag, method, rows, depth, columns): the store's K1 shapes
    for phase 6."""

    def __init__(self):
        self.calls: list[tuple[str, str, int, int, int]] = []
        self.tag = ""

    @contextlib.contextmanager
    def active(self):
        real = {name: getattr(RSCodec, name) for name in ("encode", "update", "decode")}

        def wrap(name):
            def logged(codec, *args):
                A = codec.parity_block if name == "encode" else args[0]
                B = args[-1]
                cols = B.cols if isinstance(B, plan.StagedSegment) else B.shape[1]
                self.calls.append((self.tag, name, int(np.shape(A)[0]), int(np.shape(A)[1]), int(cols)))
                return real[name](codec, *args)
            return logged

        for name in real:
            setattr(RSCodec, name, wrap(name))
        try:
            yield self
        finally:
            for name, fn in real.items():
                setattr(RSCodec, name, fn)


def _store_mirror_check(what: str, keys, mirror: dict, get) -> int:
    """GET every key and hold it against the host mirror's SHA-256; returns
    the bytes read."""
    nbytes = 0
    for key in keys:
        data = get(key)
        if hashlib.sha256(data).digest() != mirror[key]:
            raise AssertionError(f"{what}: object {key!r} differs from its host mirror")
        nbytes += len(data)
    return nbytes


def _store_parity_proof(bucket_dir: str, arcs: list[str], k: int, p: int) -> int:
    """Every stripe's parity chunks against ``GaloisField.matmul`` of its
    native chunks (the host oracle), in 1 Mi-column slices on every core.
    Returns the columns proven."""
    from gpu_rscode_torch.utils.fileformat import metadata_file_name, read_archive_meta

    gf = get_field(8)
    slices = []
    for arc in arcs:
        base = os.path.join(bucket_dir, arc)
        meta = read_archive_meta(metadata_file_name(base))
        E = meta.total_mat[k:]
        mms = [np.memmap(chunk_file_name(base, i), dtype=np.uint8, mode="r") for i in range(k + p)]
        if any(mm.shape[0] != meta.chunk for mm in mms):
            raise AssertionError(f"stripe {arc}: a chunk is not {meta.chunk} bytes")
        slices += [(arc, E, mms, lo, min(lo + MiB, meta.chunk)) for lo in range(0, meta.chunk, MiB)]

    def prove(item):
        arc, E, mms, lo, hi = item
        natives = np.stack([mm[lo:hi] for mm in mms[:k]])
        if not np.array_equal(gf.matmul(E, natives), np.stack([mm[lo:hi] for mm in mms[k:]])):
            raise AssertionError(f"stripe {arc}: parity columns [{lo}, {hi}) differ from the GF oracle")
        return hi - lo

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        return sum(pool.map(prove, slices))


@_named("5f store")
def phase_store(work: str, seed: int) -> dict:
    """The object store at its documented defaults (k=4, p=2, w=8,
    interleaved stripes sealing at 64 MiB), through the api's object
    wrappers with no device given (CUDA): PUT of STORE_OBJECTS seeded
    objects in batches of 64 and one batch of 1,000 x 4 KiB, GET of every
    object against its host mirror, DELETE of 256 (gone from the listing,
    their ranges zero in the archive), a forced compaction (retired files
    gone, every live object read back), degraded GETs of every object of a
    sealed stripe with one native chunk moved away (counted as degraded),
    an object's flipped byte caught by its CRC (repaired, then with the
    chunk's CRC line forged: RangeReadError), reopen through the snapshot
    ladder and by full replay (same index), and every stripe's parity
    against the GF oracle.  K1 launches are counted per operation."""
    from gpu_rscode_torch import store
    from gpu_rscode_torch.obs import metrics
    from gpu_rscode_torch.store import index as store_index
    from gpu_rscode_torch.utils.fileformat import metadata_file_name, read_archive_meta, rewrite_checksums

    t0 = time.perf_counter()
    smi = smi_line()
    root = os.path.join(work, "store")
    name = "photos"
    bdir = os.path.join(root, name)
    rng = np.random.default_rng(seed)
    sizes = np.exp(rng.uniform(np.log(4096), np.log(1 << 20), STORE_OBJECTS)).astype(np.int64)
    blob = rng.bytes(int(sizes.sum()) + STORE_SMALL * 4096)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    objects = [(f"img/{i:05d}", memoryview(blob)[offs[i]:offs[i + 1]]) for i in range(STORE_OBJECTS)]
    base = int(offs[-1])
    small = [(f"tiny/{i:04d}", memoryview(blob)[base + 4096 * i:base + 4096 * (i + 1)]) for i in range(STORE_SMALL)]
    mirror = {key: hashlib.sha256(data).digest() for key, data in objects + small}
    index_appends = [0]
    real_append = store_index.append_records

    def counted_append(path, records, *, sync=True):
        index_appends[0] += bool(records) and sync
        return real_append(path, records, sync=sync)

    rows: dict[str, dict] = {}
    gemms = _GemmLog()

    def run(op: str, fn, size, *, k1: bool):
        """``fn()`` with the counts set to 0 just before it; ``size(out)``
        gives the objects and bytes it moved."""
        gemms.tag = op
        _reset_counts()
        t = time.perf_counter()
        out = fn()
        wall = time.perf_counter() - t
        launches = k1_runs()
        if k1 and not launches:
            raise AssertionError(f"store {op}: K1 was not launched")
        if not k1 and launches:
            raise AssertionError(f"store {op}: {launches} K1 launches where no GEMM belongs")
        n_objects, nbytes = size(out)
        rows[op] = dict(wall_s=wall, objects=n_objects, objects_per_s=n_objects / wall, bytes=nbytes,
                        mb_per_s=nbytes / wall / 1e6, k1_launches=launches)
        log(phase="store_op", op=op, nvidia_smi=smi, **rows[op])
        return out

    metrics.force_enable()
    metrics.REGISTRY.reset()
    store_index.append_records = counted_append
    try:
        with scoped(RS_STORE_SNAPSHOT_KEEP=str(1 << 30), RS_STORE_SNAPSHOT_DISABLE=None), gemms.active():
            # PUT: the 64-object batches, then the write-combining batch.
            def put_all():
                for i in range(0, STORE_OBJECTS, STORE_BATCH):
                    api.put_objects(root, name, [(k_, bytes(d)) for k_, d in objects[i:i + STORE_BATCH]])

            run("put_64", put_all, lambda _: (STORE_OBJECTS, base), k1=True)
            run("put_1000x4KiB", lambda: api.put_objects(root, name, [(k_, bytes(d)) for k_, d in small]),
                lambda _: (STORE_SMALL, STORE_SMALL * 4096), k1=True)
            bucket = store.open_bucket(root, name)
            if (bucket.k, bucket.p, bucket.w, bucket.stripe_bytes) != (4, 2, 8, STORE_STRIPE):
                raise AssertionError(f"store defaults moved: {bucket.stats()['config']}")
            stripes = sorted(bucket.stats()["archives"])

            # GET every object (fast path: no GEMM).
            keys = [k_ for k_, _ in objects + small]
            got = run("get_fast", lambda: _store_mirror_check("get", keys, mirror,
                                                              lambda k_: api.get_object(root, name, k_)),
                      lambda n: (len(keys), n), k1=False)

            # DELETE: tombstone, then the range zeroed through E·Δ.
            doomed = sorted(rng.choice(STORE_OBJECTS, STORE_DELETES, replace=False).tolist())
            doomed = [objects[i][0] for i in doomed]
            entries = {k_: api.stat_object(root, name, k_) for k_ in doomed}
            run("delete", lambda: [api.delete_object(root, name, k_) for k_ in doomed],
                lambda out: (len(out), sum(d["bytes"] for d in out)), k1=True)
            listed = {o["key"] for o in api.list_objects(root, name)}
            if listed & set(doomed) or len(listed) != len(keys) - STORE_DELETES:
                raise AssertionError("deleted objects still listed, or live ones missing")
            for k_, e in entries.items():
                raw = store.read_range(os.path.join(bdir, e["arc"]), e["at"], e["bytes"])
                if any(raw):
                    raise AssertionError(f"deleted {k_!r}: its range is not zero in {e['arc']}")
            live = sorted(listed)

            # COMPACT: every sealed archive with dead bytes is rewritten.
            res = run("compact", lambda: api.compact_bucket(root, name, force=True),
                      lambda out: (out["objects_moved"], out["bytes_moved"]), k1=True)
            if not res["archives_retired"]:
                raise AssertionError("the forced compaction retired nothing")
            for arc in res["archives_retired"]:
                left = [f for f in os.listdir(bdir) if f == f"{arc}.METADATA" or f.endswith(f"_{arc}")
                        or f.startswith(arc)]
                if left:
                    raise AssertionError(f"retired {arc}: files left {left}")
            run("get_after_compact", lambda: _store_mirror_check(
                "get after compaction", live, mirror, lambda k_: api.get_object(root, name, k_)),
                lambda n: (len(live), n), k1=False)

            # Degraded GET: one native chunk of a sealed stripe moved away.
            # Each degraded read scans the whole archive's CRCs, so the
            # sealed stripe with the fewest objects keeps the phase short.
            st = bucket.stats()["archives"]
            sealed = [a for a, v in st.items() if v["sealed"]]
            by_arc = {}
            for o in bucket.list_objects():
                by_arc.setdefault(o["arc"], []).append(o["key"])
            victim = min(sealed, key=lambda a: len(by_arc.get(a, ())))
            in_victim = by_arc[victim]
            chunk1 = chunk_file_name(os.path.join(bdir, victim), 1)
            os.rename(chunk1, chunk1 + ".away")
            reads = metrics.counter("rs_store_range_reads_total").labels(path="degraded")
            before = reads.value
            run("get_degraded", lambda: _store_mirror_check(
                "degraded get", in_victim, mirror, lambda k_: api.get_object(root, name, k_)),
                lambda n: (len(in_victim), n), k1=True)
            if reads.value - before != len(in_victim):
                raise AssertionError(f"{reads.value - before} degraded reads counted for {len(in_victim)} GETs")
            os.rename(chunk1 + ".away", chunk1)

            # Bitrot in an object's range: the object CRC catches it; the
            # degraded pass repairs it, and with the chunk's CRC line forged
            # (the scan then trusts the rotted chunk) the read refuses.
            key = by_arc[next(a for a in sealed if a != victim)][0]
            e = api.stat_object(root, name, key)
            arcbase = os.path.join(bdir, e["arc"])
            row_i, col = e["at"] % 4, e["at"] // 4
            path = chunk_file_name(arcbase, row_i)
            meta_path = metadata_file_name(arcbase)
            crcs = dict(read_archive_meta(meta_path).crcs)
            _flip(path, [col])
            degraded0 = reads.value
            if hashlib.sha256(api.get_object(root, name, key)).digest() != mirror[key]:
                raise AssertionError("bitrot: the degraded pass did not repair the object")
            with open(path, "rb") as fp:
                rewrite_checksums(meta_path, {**crcs, row_i: zlib.crc32(fp.read())})
            # The survivor subset the repair pinned would route round the
            # rot; from a cold cache the natives come first.
            api.clear_subset_cache()
            try:
                api.get_object(root, name, key)
                raise AssertionError("bitrot with a forged chunk CRC: the object CRC did not refuse the read")
            except store.RangeReadError as err:
                bitrot_error = str(err)
            _flip(path, [col])
            rewrite_checksums(meta_path, crcs)
            if reads.value - degraded0 != 1:
                raise AssertionError("bitrot: the repaired read was not counted as degraded")

            # Reopen: snapshot ladder, then full replay; the same index.
            store.drop_cached()
            t = time.perf_counter()
            b1 = store.open_bucket(root, name)
            report_snap = b1.open_report
            open_snap_s = time.perf_counter() - t
            state_snap = dict(b1._state.entries)
            with scoped(RS_STORE_SNAPSHOT_DISABLE="1"):
                store.drop_cached()
                t = time.perf_counter()
                b2 = store.open_bucket(root, name)
                report_full = b2.open_report
                open_full_s = time.perf_counter() - t
                state_full = dict(b2._state.entries)
            store.drop_cached()
            if report_snap["source"] != "snapshot" or report_full["source"] != "log" or state_snap != state_full:
                raise AssertionError(f"reopen: ladder {report_snap} vs full replay {report_full}")
            if set(state_snap) != set(live):
                raise AssertionError("reopen: the index lost or gained objects")

            # Parity proof of every stripe left against the host oracle.
            t = time.perf_counter()
            arcs = sorted(store.open_bucket(root, name).stats()["archives"])
            proven = _store_parity_proof(bdir, arcs, 4, 2)
            proof_s = time.perf_counter() - t
        snap = metrics.REGISTRY.snapshot()
    finally:
        store_index.append_records = real_append
        metrics.force_enable(False)
        metrics.REGISTRY.reset()
        store.drop_cached()

    def counter(name_, label=""):
        return snap.get(name_, {}).get("values", {}).get(label, 0)

    res = dict(phase="store", nvidia_smi=smi, k=4, p=2, w=8, stripe_bytes=STORE_STRIPE, objects=STORE_OBJECTS + STORE_SMALL,
               put_bytes=base + STORE_SMALL * 4096, stripes_after_put=len(stripes), ops=rows,
               k1_launches=sum(r["k1_launches"] for r in rows.values()),
               index_fsyncs=index_appends[0],
               snapshots=counter("rs_store_snapshots_total"),
               snapshot_files=len(store.list_snapshots(bdir)), segment_files=len(store.list_segments(bdir)),
               group_fsyncs={lab: counter("rs_update_group_fsyncs_total", lab)
                             for lab in ('{stage="chunks"}', '{stage="journal"}', '{stage="metadata"}')},
               range_reads={lab: counter("rs_store_range_reads_total", lab)
                            for lab in ('{path="fast"}', '{path="degraded"}', '{path="failed"}')},
               archives_retired=len(res["archives_retired"]), degraded_stripe=victim,
               degraded_objects=len(in_victim), bitrot_error=bitrot_error, open_snapshot_s=open_snap_s,
               open_full_replay_s=open_full_s, open_report_snapshot=report_snap, open_report_full=report_full,
               parity_proof_stripes=len(arcs), parity_proof_cols=proven, parity_proof_s=proof_s,
               get_bytes=got, seconds=time.perf_counter() - t0, gemm_shapes=_store_shapes(gemms.calls))
    log(**res)
    shutil.rmtree(root, ignore_errors=True)
    return res


SERVE_FILES = 4  # x SERVE_FILE_BYTES, from tenants alpha and beta
SERVE_FILE_BYTES = 256 * MiB
SERVE_UPDATE_BYTES = 64 * MiB
SERVE_EDITS = 64  # x 4 KiB, concurrent: one write group
SERVE_OBJECTS = 1024  # seeded sizes, log-uniform over 4 KiB - 1 MiB (2,048 ran over the phase's budget)
SERVE_CLIENTS = 16
SERVE_HOT = 64
SERVE_DELETES = 128
SERVE_ADMISSION = 32  # x 16 MiB against depth 2, one worker
SERVE_STRIPE = 64 * MiB  # the store's default stripe


def _http(port: int, method: str, path: str, body: bytes = b"", tenant: str = "default", headers=None,
          digest: bool = False, timeout: float = 600.0):
    """One request to a daemon on 127.0.0.1: (status, body or its SHA-256,
    headers, seconds)."""
    import http.client

    t0 = time.perf_counter()
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    try:
        conn.request(method, path, body=body,
                     headers={"X-RS-Tenant": tenant, "Content-Length": str(len(body)), **(headers or {})})
        resp = conn.getresponse()
        if digest:
            h = hashlib.sha256()
            while chunk := resp.read(MiB):
                h.update(chunk)
            payload = h.hexdigest()
        else:
            payload = resp.read()
        return resp.status, payload, dict(resp.getheaders()), time.perf_counter() - t0
    finally:
        conn.close()


def _fan_out(fn, items, workers: int) -> tuple[list, float]:
    """``fn`` over ``items`` on ``workers`` client threads: the results in
    order and the wall seconds."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=workers) as pool:
        out = list(pool.map(fn, items))
    return out, time.perf_counter() - t0


def _latency(seconds: list[float]) -> dict:
    return {"n": len(seconds), "p50_ms": 1e3 * float(np.percentile(seconds, 50)),
            "p99_ms": 1e3 * float(np.percentile(seconds, 99))}


def _stage_p50_ms(op: str) -> dict:
    """Median of each stage duration (ms) over the wide events of ``op`` in
    the lifecycle ring."""
    from gpu_rscode_torch.obs import reqtrace

    durations: dict = {}
    for ev in reqtrace.recent(reqtrace.ring_capacity()):
        if ev["op"] != op:
            continue
        present = [(s, ev["stages"][s]) for s in reqtrace.STAGES if s in ev["stages"]]
        for (_, a), (stage, b) in zip(present, present[1:]):
            durations.setdefault(stage, []).append(1e3 * (b - a))
    return {stage: float(np.median(v)) for stage, v in durations.items()}


def _metric(snap: dict, name: str, labels: str = "") -> float:
    return snap.get(name, {}).get("values", {}).get(labels, 0)


def _serve_parity_proof(roots: list[str]) -> int:
    """For every archive under ``roots``: the first segment (up to 1 Mi
    columns) of its parity chunks against ``GaloisField.matmul`` of its
    natives, on every core.  Returns the archives proven."""
    from gpu_rscode_torch.utils.fileformat import read_archive_meta

    metas = [os.path.join(d, f) for root in roots for d, _, files in os.walk(root)
             for f in files if f.endswith(".METADATA")]

    def prove(meta_path):
        base = meta_path[: -len(".METADATA")]
        meta = read_archive_meta(meta_path)
        k, p, sym = meta.native_num, meta.parity_num, meta.w // 8
        gf = get_field(meta.w)
        cols = min(meta.chunk // sym, MiB)
        dt = np.uint8 if sym == 1 else np.uint16
        rows = [np.fromfile(chunk_file_name(base, i), dtype=dt, count=cols) for i in range(k + p)]
        if not np.array_equal(gf.matmul(meta.total_mat[k:].astype(dt), np.stack(rows[:k])), np.stack(rows[k:])):
            raise AssertionError(f"{base}: parity differs from the GF oracle in its first {cols} columns")
        return 1

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        return sum(pool.map(prove, metas))


@_named("5g serve")
def phase_serve(work: str, seed: int, device) -> dict:
    """The serving daemon on the card (gpu_rscode_torch/serve/): one
    ServeDaemon on 127.0.0.1, port 0, device cuda:0, default knobs, talked
    to over HTTP only.  Files at the reference's shape (k=10, n=14,
    --checksum): four seeded 256 MiB uploads from two tenants at once,
    decoded with their first 4 natives away (SHA-256); a parity byte
    flipped and found by /scrub?syndrome=1 and GET /health; 64 concurrent
    4 KiB /update requests in one write group and a 1 MiB /append on a
    64 MiB interleaved archive, decoded against a host mirror; 2,048
    seeded objects (log-uniform 4 KiB-1 MiB) PUT from 16 client threads at
    the store's defaults, every GET against its mirror, a hot set read
    twice for cache hits, 128 DELETEs answering 404 after, every object of
    a sealed stripe read degraded with one native chunk away; two
    open-loop runs of the port's loadgen; a second daemon (depth 2, one
    worker) under 32 concurrent 16 MiB encodes (429s with the request id),
    drained, every admitted archive decoded to its source; and one
    segment of every archive's parity against the GF oracle.  The
    batch-fallback count must be 0, no request may fail but the 429s, and
    K1 must run (counted after every executor thread joined)."""
    from gpu_rscode_torch import store
    from gpu_rscode_torch.obs import metrics
    from gpu_rscode_torch.serve import loadgen
    from gpu_rscode_torch.serve.daemon import ServeDaemon

    res: dict = {"routes": {}}
    root = os.path.join(work, "serve_root")
    rng = np.random.default_rng(seed)
    forced = metrics.forced()
    t_phase = time.perf_counter()
    _reset_counts()
    with scoped(RS_METRICS="1", RS_RUNLOG=os.path.join(work, "serve_ledger.jsonl"), RS_SERVE_WORKERS=None,
              RS_SERVE_DEPTH=None, RS_SERVE_BATCH_MS=None, RS_SERVE_MAX_BATCH=None, RS_OBJ_CACHE_BYTES=None):
        daemon = ServeDaemon(root, port=0, addr="127.0.0.1", device=device).start()
        port = daemon.port
        knobs = {"workers": daemon.workers, "depth": daemon.queue.max_depth, "batch_ms": daemon.batcher.batch_ms,
                 "max_batch": daemon.batcher.max_batch}
        if knobs != {"workers": 2, "depth": 64, "batch_ms": 5.0, "max_batch": 16}:
            raise AssertionError(f"serve: the daemon's default knobs are {knobs}")
        try:
            res["warm"] = daemon.warm(10, 4, file_bytes=SERVE_FILE_BYTES)

            # -- files at the reference's shape ------------------------------
            files = [(f"f{i}.bin", ("alpha", "beta")[i % 2], rng.bytes(SERVE_FILE_BYTES)) for i in range(SERVE_FILES)]
            shas = {name: hashlib.sha256(data).hexdigest() for name, _, data in files}

            def encode(item):
                name, tenant, data = item
                return _http(port, "POST", f"/encode?name={name}&k=10&n=14&checksum=1", data, tenant)

            out, wall = _fan_out(encode, files, len(files))
            if any(st != 200 for st, *_ in out):
                raise AssertionError(f"serve encode: {[(st, body[:200]) for st, body, *_ in out]}")
            batch_sizes = metrics.REGISTRY.snapshot()["rs_serve_batch_size"]["values"][""]
            res["routes"]["encode"] = {"bytes": SERVE_FILES * SERVE_FILE_BYTES, "wall_s": wall,
                                       "MBps": SERVE_FILES * SERVE_FILE_BYTES / wall / 1e6,
                                       "batch_sizes": batch_sizes["buckets"], **_latency([o[3] for o in out])}
            log(phase="serve", route="encode", **res["routes"]["encode"])
            del out

            aside = os.path.join(work, "serve_aside")
            os.makedirs(aside, exist_ok=True)
            for name, tenant, _ in files:
                for i in range(4):
                    src = chunk_file_name(os.path.join(root, tenant, name), i)
                    os.rename(src, os.path.join(aside, os.path.basename(src) + tenant))

            def decode(item):
                name, tenant, _ = item
                return _http(port, "POST", f"/decode?name={name}", b"", tenant, digest=True)

            out, wall = _fan_out(decode, files, len(files))
            for (name, _, _), (st, digest, hdrs, _) in zip(files, out):
                if st != 200 or digest != shas[name]:
                    raise AssertionError(f"serve decode {name}: status {st}, sha256 {digest} != {shas[name]}")
            res["routes"]["decode"] = {"bytes": SERVE_FILES * SERVE_FILE_BYTES, "wall_s": wall,
                                       "MBps": SERVE_FILES * SERVE_FILE_BYTES / wall / 1e6,
                                       "batch": [int(o[2].get("X-RS-Batch", 0)) for o in out],
                                       **_latency([o[3] for o in out])}
            log(phase="serve", route="decode", **res["routes"]["decode"])
            for name, tenant, _ in files:  # the natives back, for the parity proof
                for i in range(4):
                    dst = chunk_file_name(os.path.join(root, tenant, name), i)
                    os.rename(os.path.join(aside, os.path.basename(dst) + tenant), dst)
            del files

            # -- scrub: a flipped parity byte --------------------------------
            victim = os.path.join(root, "alpha", "f0.bin")
            flipped = [SERVE_FILE_BYTES // 10 - 7]
            _flip(chunk_file_name(victim, 12), flipped)
            st, body, _, secs = _http(port, "POST", "/scrub?name=f0.bin&syndrome=1", b"", "alpha")
            report = json.loads(body)["report"] if st == 200 else {}
            if st != 200 or report.get("corrupt") != [12]:
                raise AssertionError(f"serve scrub: status {st}, report {report}")
            st, body, _, _ = _http(port, "GET", "/health")
            fleet = json.loads(body)
            row = next((a for a in fleet.get("archives", []) if a["archive"] == victim), None)
            if st != 200 or row is None or row["chunks"] != {"12": "crc_mismatch"}:
                raise AssertionError(f"serve health: status {st}, row {row}")
            _flip(chunk_file_name(victim, 12), flipped)  # undone, for the parity proof
            res["routes"]["scrub"] = {"seconds": secs, "GBps": 14 * SERVE_FILE_BYTES / 10 / secs / 1e9,
                                      "health_bucket": row["bucket"], "syndrome": report.get("syndrome")}
            log(phase="serve", route="scrub", **res["routes"]["scrub"])

            # -- updates: one write group of 64 edits, then an append ---------
            mirror = bytearray(rng.bytes(SERVE_UPDATE_BYTES))
            st, body, _, secs = _http(port, "POST", "/encode?name=u.bin&k=10&n=14&checksum=1&layout=interleaved",
                                      bytes(mirror), "alpha")
            if st != 200:
                raise AssertionError(f"serve interleaved encode: {st} {body[:200]}")
            res["routes"]["encode_interleaved"] = {"seconds": secs, "MBps": SERVE_UPDATE_BYTES / secs / 1e6}
            offsets = sorted(int(x) for x in rng.choice(SERVE_UPDATE_BYTES // 4096, SERVE_EDITS, replace=False) * 4096)
            edits = [(at, rng.bytes(4096)) for at in offsets]
            # The default window (5 ms) and cap (16) cannot hold 64 requests
            # in one harvest: the group needs a window that closes at 64.
            daemon.batcher.batch_ms, daemon.batcher.max_batch = 2000.0, SERVE_EDITS

            def update(item):
                at, data = item
                return _http(port, "POST", f"/update?name=u.bin&at={at}", data, "alpha")

            out, wall = _fan_out(update, edits, SERVE_EDITS)
            daemon.batcher.batch_ms, daemon.batcher.max_batch = knobs["batch_ms"], knobs["max_batch"]
            docs = [json.loads(body) for _, body, _, _ in out]
            groups = {d.get("update", {}).get("group_id") for d in docs}
            if any(st != 200 for st, *_ in out) or len(groups) != 1 or None in groups:
                raise AssertionError(f"serve update: statuses {[o[0] for o in out]}, groups {groups}")
            for at, data in edits:
                mirror[at:at + len(data)] = data
            tail = rng.bytes(MiB)
            st, body, _, secs = _http(port, "POST", "/append?name=u.bin", tail, "alpha")
            if st != 200:
                raise AssertionError(f"serve append: {st} {body[:200]}")
            mirror += tail
            st, digest, _, dsecs = _http(port, "POST", "/decode?name=u.bin", b"", "alpha", digest=True)
            if st != 200 or digest != hashlib.sha256(mirror).hexdigest():
                raise AssertionError(f"serve update decode: status {st}, sha256 differs from the host mirror")
            res["routes"]["update"] = {"edits": SERVE_EDITS, "wall_s": wall, "req_per_s": SERVE_EDITS / wall,
                                       "group_id": groups.pop(), "grouped": docs[0]["update"]["grouped"],
                                       **_latency([o[3] for o in out])}
            res["routes"]["append"] = {"bytes": MiB, "seconds": secs}
            log(phase="serve", route="update", **res["routes"]["update"])
            log(phase="serve", route="append", **res["routes"]["append"], decode_seconds=dsecs)
            del mirror

            # -- objects at the store's defaults -----------------------------
            sizes = np.exp(rng.uniform(np.log(4096), np.log(MiB), SERVE_OBJECTS)).astype(np.int64)
            objs = {f"o{i:05d}": rng.bytes(int(s)) for i, s in enumerate(sizes)}
            osha = {key: hashlib.sha256(data).hexdigest() for key, data in objs.items()}
            obytes = int(sizes.sum())
            keys = list(objs)

            def put(key):
                return _http(port, "PUT", f"/o/bkt/{key}", objs[key], "gamma")

            out, wall = _fan_out(put, keys, SERVE_CLIENTS)
            if any(st != 200 for st, *_ in out):
                raise AssertionError(f"serve PUT: {sorted({o[0] for o in out})}")
            grouped = [json.loads(o[1])["object"].get("grouped", 1) for o in out]
            res["routes"]["object_put"] = {"objects": SERVE_OBJECTS, "bytes": obytes, "wall_s": wall,
                                           "stage_p50_ms": _stage_p50_ms("object_put"),
                                           "objects_per_s": SERVE_OBJECTS / wall, "MBps": obytes / wall / 1e6,
                                           "max_grouped": max(grouped), **_latency([o[3] for o in out])}
            log(phase="serve", route="object_put", **res["routes"]["object_put"])
            del objs
            bucket = store.cached_bucket(os.path.join(root, "gamma"), "bkt")
            cfg = bucket.stats()["config"]
            if (cfg["k"], cfg["p"], cfg["w"], cfg["stripe_bytes"]) != (4, 2, 8, SERVE_STRIPE):
                raise AssertionError(f"serve bucket: not at the store's defaults: {cfg}")

            def get(key):
                return _http(port, "GET", f"/o/bkt/{key}", b"", "gamma", digest=True)

            out, wall = _fan_out(get, keys, SERVE_CLIENTS)
            bad = [key for key, o in zip(keys, out) if o[0] != 200 or o[1] != osha[key]]
            if bad:
                raise AssertionError(f"serve GET: {len(bad)} objects differ from their mirror, first {bad[0]}")
            res["routes"]["object_get"] = {"objects": SERVE_OBJECTS, "wall_s": wall,
                                           "objects_per_s": SERVE_OBJECTS / wall, "MBps": obytes / wall / 1e6,
                                           "stage_p50_ms": _stage_p50_ms("object_get"),
                                           **_latency([o[3] for o in out])}
            log(phase="serve", route="object_get", **res["routes"]["object_get"])
            cache0 = json.loads(_http(port, "GET", "/stats")[1])["objcache"]
            hot = keys[:SERVE_HOT]
            out, wall = _fan_out(get, hot + hot, SERVE_CLIENTS)
            if any(o[0] != 200 or o[1] != osha[key] for key, o in zip(hot + hot, out)):
                raise AssertionError("serve hot GET: an object differs from its mirror")
            cache1 = json.loads(_http(port, "GET", "/stats")[1])["objcache"]
            hits = cache1["hits"] - cache0["hits"]
            if hits <= 0:
                raise AssertionError(f"serve hot GET: no cache hits ({cache0} -> {cache1})")
            res["routes"]["object_get_hot"] = {"gets": 2 * SERVE_HOT, "hits": hits,
                                               "hit_rate": hits / (2 * SERVE_HOT), "objcache": cache1,
                                               "verdicts": sorted({o[2].get("X-RS-Cache") for o in out})}
            log(phase="serve", route="object_get_hot", **res["routes"]["object_get_hot"])

            # What the per-request ledger record costs: the hot set read
            # (cache hits, no read lane) with RS_RUNLOG on and off, in turns.
            ledger, rates = os.environ["RS_RUNLOG"], {"on": [], "off": []}
            for arm in ("on", "off", "off", "on"):
                if arm == "on":
                    os.environ["RS_RUNLOG"] = ledger
                else:
                    os.environ.pop("RS_RUNLOG", None)
                out, wall = _fan_out(get, hot * 4, SERVE_CLIENTS)
                if any(o[0] != 200 or o[1] != osha[key] for key, o in zip(hot * 4, out)):
                    raise AssertionError(f"serve ledger A/B ({arm}): an object differs from its mirror")
                rates[arm].append(len(out) / wall)
            os.environ["RS_RUNLOG"] = ledger
            res["routes"]["ledger_ab"] = {"gets": 4 * SERVE_HOT, "gets_per_s_ledger_on": rates["on"],
                                          "gets_per_s_ledger_off": rates["off"]}
            log(phase="serve", route="ledger_ab", **res["routes"]["ledger_ab"])

            doomed = keys[-SERVE_DELETES:]
            out, wall = _fan_out(lambda key: _http(port, "DELETE", f"/o/bkt/{key}", b"", "gamma"), doomed,
                                 SERVE_CLIENTS)
            gone, _ = _fan_out(get, doomed, SERVE_CLIENTS)
            if any(o[0] != 200 for o in out) or any(o[0] != 404 for o in gone):
                raise AssertionError("serve DELETE: a delete failed or a deleted object still answers")
            res["routes"]["object_delete"] = {"objects": SERVE_DELETES, "wall_s": wall,
                                              "objects_per_s": SERVE_DELETES / wall, **_latency([o[3] for o in out])}
            log(phase="serve", route="object_delete", **res["routes"]["object_delete"])
            live = keys[:-SERVE_DELETES]

            # Degraded GET: one native chunk of a sealed stripe away; the
            # bucket's cache entries dropped so every GET takes the read lane.
            st_arcs = bucket.stats()["archives"]
            by_arc: dict = {}
            for o in bucket.list_objects():
                by_arc.setdefault(o["arc"], []).append(o["key"])
            sealed = [a for a, v in st_arcs.items() if v["sealed"] and by_arc.get(a)]
            arc = min(sealed, key=lambda a: len(by_arc[a]))
            chunk1 = chunk_file_name(os.path.join(root, "gamma", "bkt", arc), 1)
            os.rename(chunk1, chunk1 + ".away")
            daemon.objcache.invalidate("gamma", "bkt")
            snap0 = metrics.REGISTRY.snapshot()
            out, wall = _fan_out(get, by_arc[arc], SERVE_CLIENTS)
            os.rename(chunk1 + ".away", chunk1)
            snap1 = metrics.REGISTRY.snapshot()
            degraded = (_metric(snap1, "rs_store_range_reads_total", '{path="degraded"}')
                        - _metric(snap0, "rs_store_range_reads_total", '{path="degraded"}'))
            if any(o[0] != 200 or o[1] != osha[key] for key, o in zip(by_arc[arc], out)):
                raise AssertionError("serve degraded GET: an object differs from its mirror")
            if degraded != len(by_arc[arc]) or {o[2].get("X-RS-Read-Path") for o in out} != {"degraded"}:
                raise AssertionError(f"serve degraded GET: {degraded} degraded reads for {len(by_arc[arc])} GETs")
            res["routes"]["object_get_degraded"] = {"stripe": arc, "objects": len(by_arc[arc]), "wall_s": wall,
                                                    "objects_per_s": len(by_arc[arc]) / wall,
                                                    **_latency([o[3] for o in out])}
            log(phase="serve", route="object_get_degraded", **res["routes"]["object_get_degraded"])
            res["objects_live"] = len(live)

            # -- open-loop traffic -------------------------------------------
            base = f"http://127.0.0.1:{port}"
            mixes = {
                "default": dict(duration_s=15.0, rate=8.0, tenants=[("alpha", 3.0), ("beta", 1.0)],
                                size_bytes=64 * 1024, k=4, p=2, decode_frac=0.3, seed=seed),
                "objects": dict(duration_s=15.0, rate=32.0, tenants=[("alpha", 3.0), ("beta", 1.0)],
                                size_bytes=64 * 1024, k=4, p=2, decode_frac=0.3, object_frac=0.6,
                                object_bytes=4096, object_keys=256, object_zipf=1.1, update_frac=0.1,
                                edit_burst=8, seed=seed + 1),
            }
            res["open_loop"] = {}
            for mix, kw in mixes.items():
                rep = loadgen.run_open_loop(base, quiet=True, **kw)
                summ = rep["summary"]
                if summ["failed"]:
                    raise AssertionError(f"serve open loop {mix}: {summ['failed']} failed of {summ['sent']}")
                cells = {f"{r['tenant']}/{r['op']}": {"ok": r["ok"], "rejected": r["rejected"],
                                                       "p50_ms": 1e3 * (r["latency_s"].get("0.5") or 0),
                                                       "p99_ms": 1e3 * (r["latency_s"].get("0.99") or 0)}
                         for r in rep["tenants"]}
                res["open_loop"][mix] = {"offered_rps": summ["offered_rps"], "achieved_rps": summ["achieved_rps"],
                                         "sent": summ["sent"], "ok": summ["ok"], "rejected": summ["rejected"],
                                         "cells": cells}
                log(phase="serve", route=f"open_loop_{mix}", **res["open_loop"][mix])
        finally:
            daemon.close(drain=True, timeout=300)
        stats = {"requests_done": daemon.requests_done, "requests_failed": daemon.requests_failed,
                 "rejected": daemon.queue.rejected}

        # -- admission and drain: depth 2, one worker ------------------------
        root2 = os.path.join(work, "serve_root_admission")
        small = daemon2 = None
        daemon2 = ServeDaemon(root2, port=0, addr="127.0.0.1", device=device, depth=2, workers=1).start()
        try:
            small = [rng.bytes(16 * MiB) for _ in range(SERVE_ADMISSION)]

            def admit(i):
                return _http(daemon2.port, "POST", f"/encode?name=a{i}.bin&k=10&n=14&checksum=1", small[i],
                             "alpha", {"X-RS-Request-Id": f"adm-{i}"})

            out, wall = _fan_out(admit, range(SERVE_ADMISSION), SERVE_ADMISSION)
            statuses = [o[0] for o in out]
            if set(statuses) - {200, 429} or 429 not in statuses:
                raise AssertionError(f"serve admission: statuses {statuses}")
            if any(o[2].get("X-RS-Request-Id") != f"adm-{i}" for i, o in enumerate(out)):
                raise AssertionError("serve admission: a response did not echo its request id")
            if not daemon2.drain(timeout=300):
                raise AssertionError("serve admission: the drain did not finish")
        finally:
            daemon2.close(drain=True, timeout=300)
        admitted = [i for i, st in enumerate(statuses) if st == 200]
        if daemon2.requests_done != len(admitted) or daemon2.requests_failed:
            raise AssertionError(f"serve admission: {daemon2.requests_done} done, {daemon2.requests_failed} failed "
                                 f"for {len(admitted)} admitted")
        for i in admitted:
            path = os.path.join(root2, "alpha", f"a{i}.bin")
            out_path = api.auto_decode_file(path, path + ".out", device=device)
            if sha256_file(out_path) != hashlib.sha256(small[i]).hexdigest():
                raise AssertionError(f"serve admission: archive a{i}.bin does not decode to its source")
            os.unlink(out_path)
        res["admission"] = {"requests": SERVE_ADMISSION, "admitted": len(admitted),
                            "rejected_429": statuses.count(429), "wall_s": wall}
        log(phase="serve", route="admission", **res["admission"])
        del small

        snap = metrics.REGISTRY.snapshot()
        fallbacks = sum(snap.get("rs_serve_batch_fallbacks_total", {}).get("values", {}).values())
        # What each wide event's ledger record costs the handler: the
        # envelope's metrics digest serializes the whole registry.
        from gpu_rscode_torch.obs import runlog

        t0 = time.perf_counter()
        for _ in range(20):
            runlog.metrics_digest()
        res["ledger_digest_ms"] = (time.perf_counter() - t0) / 20 * 1e3
        res["registry_json_bytes"] = len(json.dumps(snap, sort_keys=True))
        proven = _serve_parity_proof([root, root2])
    k1 = k1_runs()  # every executor thread has joined (both daemons closed)
    if not forced:
        metrics.force_enable(False)
    if fallbacks:
        raise AssertionError(f"serve: {fallbacks} batches fell back to per-request execution")
    if stats["requests_failed"]:
        raise AssertionError(f"serve: {stats['requests_failed']} requests failed")
    if k1 <= 0:
        raise AssertionError("serve: K1 was not launched")
    res.update(k1_launches=k1, fallbacks=fallbacks, archives_proven=proven, daemon=stats,
               seconds=time.perf_counter() - t_phase)
    log(phase="serve_summary", k1_launches=k1, batch_fallbacks=fallbacks, archives_proven=proven,
        ledger_digest_ms=res["ledger_digest_ms"], registry_json_bytes=res["registry_json_bytes"],
        seconds=res["seconds"], plan_cache={key: val for key, val in plan.PLAN_CACHE.stats().items() if key != "plans"},
        nvidia_smi=smi_line(), **stats)
    return res


# -- phase 5h: the fault and maintenance planes ------------------------------

# Chaos digests of the JAX package's `rs chaos` (gpu_rscode_tpu, CPU):
#   python -m gpu_rscode_tpu chaos --seed SEED --iters 12 [CLASS FLAGS]
# verdict rows hold only ints, strings and bools, so the digests do not
# depend on the device.  (flags, seed) -> (schedule_digest, verdict_digest).
CHAOS_DIGESTS = {
    ((), 20260807): ("b86f6c9ee791480b", "bfe3af78af05dab0"),
    (("--silent",), 20260807): ("75b940ee34e45dd3", "0ecf6ac98bf48690"),
    (("--update",), 20260807): ("e76445964bacb726", "b5ceb4fc204221a5"),
    (("--update", "--group"), 20260807): ("fab92abf50f3fdce", "08ed725aadd79ca3"),
    (("--object",), 20260807): ("108d038636fdf6bb", "3562cb13c256af60"),
    (("--health",), 20260807): ("c076fae7fa943e0b", "e9887a0f3e933141"),
    (("--maint",), 20260807): ("203248547cd29ea6", "dc5cbd2607c3bed9"),
    (("--object",), 20260804): ("2d57717ff72642a9", "cdf0d7ede52bdc31"),
}
CHAOS_ITERS = 12
FAULT_FILE_BYTES = 1024 * MiB  # the main path's file, k=10, n=14
SWAP_FILE_BYTES = 1 * MiB  # the mid-stream swap's archive, k=3, n=5, 4 KiB segments
MAINT_ARCHIVES = 4
MAINT_FILE_BYTES = 256 * MiB
MAINT_AB_BYTES = 64 * MiB
# 10 s: the monkey's 6 s SLO window ages out within the load, so the
# governor resumes and the repairs run beside the foreground.
MAINT_AB_SECONDS = 10.0
MAINT_AB_RATE = 8.0


def _metric_delta(before: dict, name: str, labels: str) -> float:
    from gpu_rscode_torch.obs import metrics

    return _metric(metrics.REGISTRY.snapshot(), name, labels) - _metric(before, name, labels)


def _chaos_class(flags: tuple, seed: int, work: str, device) -> dict:
    """One `rs chaos` class in-process on ``device``; its digests must be the
    JAX package's and every iteration must pass."""
    from gpu_rscode_torch.resilience import chaos

    d = tempfile.mkdtemp(dir=work)
    _reset_counts()
    before = plan.PLAN_CACHE.stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = chaos.main(["--seed", str(seed), "--iters", str(CHAOS_ITERS), "--device", str(device), "--dir", d,
                         "--no-shrink", *flags])
    wall = time.perf_counter() - t0
    shutil.rmtree(d, ignore_errors=True)
    lines = buf.getvalue().splitlines()
    out = json.loads(lines[-1]) if rc == 0 and lines else {}
    want_schedule, want_verdict = CHAOS_DIGESTS[(flags, seed)]
    got = (out.get("schedule_digest"), out.get("verdict_digest"))
    if rc != 0 or out.get("passed") != CHAOS_ITERS or out.get("failed") != 0 or got != (want_schedule, want_verdict):
        repro = [line for line in lines if line.startswith("REPRODUCE: ")]
        if repro:
            # The failing iteration once more, for its traceback.
            try:
                chaos.run_iteration(json.loads(repro[0][len("REPRODUCE: "):]), tempfile.mkdtemp(dir=work),
                                    device=device)
                log(phase="faults_maint", step="chaos_rerun", passed=True)
            except chaos.ChaosFailure as e:
                import traceback

                traceback.print_exception(e.__cause__ or e)
        raise AssertionError(f"chaos {' '.join(flags) or 'classic'} seed {seed}: rc {rc}, {lines[-3:]}; "
                             f"want digests {(want_schedule, want_verdict)}")
    runs = k1_runs()
    if runs <= 0:
        raise AssertionError(f"chaos {' '.join(flags) or 'classic'}: K1 never ran")
    after = plan.PLAN_CACHE.stats()
    row = {"class": " ".join(flags) or "classic", "seed": seed, "iters": CHAOS_ITERS, "wall_s": wall,
           "k1_runs": runs, "schedule_digest": got[0], "verdict_digest": got[1],
           "plan_cache": {key: after[key] - before[key] for key in ("hits", "misses", "evictions")}}
    log(phase="faults_maint", step="chaos", **row)
    return row


def _litter(directory: str, stem: str) -> list[str]:
    return sorted(f for f in os.listdir(directory) if f.endswith(".rs_tmp") or (f.startswith("_") and stem in f))


def _fault_plane(work: str, seed: int) -> dict:
    """The fault plane at the main path's setting, then the mid-stream swap
    and the scrub read error on a small archive."""
    from gpu_rscode_torch.obs import metrics
    from gpu_rscode_torch.resilience import faults

    res: dict = {}
    d = os.path.join(work, "faults")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "faulted.bin")
    want = write_seeded(path, seed, FAULT_FILE_BYTES)
    api.encode_file(path, 10, 4, checksums=True)
    os.unlink(chunk_file_name(path, 0))
    _flip(chunk_file_name(path, 5), [FAULT_FILE_BYTES // 20])
    spec = "read:ioerror@p=0.05;read:delay@ms=1,p=0.1"
    fault_plan = faults.parse_plan(spec, seed=seed)
    before = metrics.REGISTRY.snapshot()
    _reset_counts()
    t0 = time.perf_counter()
    with faults.activate(fault_plan):
        out = api.auto_decode_file(path, path + ".dec")
    wall = time.perf_counter() - t0
    retried = _metric_delta(before, "rs_retries_total", '{outcome="retried"}')
    recovered = _metric_delta(before, "rs_retries_total", '{outcome="recovered"}')
    got = sha256_file(out)
    if got != want or retried <= 0 or recovered <= 0:
        raise AssertionError(f"faulted decode: sha256 {got} != {want} or retries {retried}/{recovered}")
    res["faulted_decode"] = {"wall_s": wall, "GBps": FAULT_FILE_BYTES / wall / 1e9, "k1_runs": k1_runs(),
                             "retried": retried, "recovered": recovered,
                             "exhausted": _metric_delta(before, "rs_retries_total", '{outcome="exhausted"}'),
                             "midstream_swaps": _metric_delta(before, "rs_degraded_decodes_total",
                                                             '{stage="midstream"}'),
                             "injected": {f"{k}:{s}": n for (k, s), n in fault_plan.injected.items()}}
    log(phase="faults_maint", step="faulted_decode", spec=spec, **res["faulted_decode"])
    os.unlink(out)
    launches = res["faulted_decode"]["k1_runs"]

    # A torn encode: the first drain over 64 KiB dies, and nothing of the
    # archive may be left beside the input.
    torn_dir = os.path.join(d, "torn")
    os.makedirs(torn_dir)
    torn = os.path.join(torn_dir, "torn.bin")
    os.link(path, torn)
    err = None
    _reset_counts()
    t0 = time.perf_counter()
    with faults.activate(faults.parse_plan("write:torn@after=64KiB", seed=seed)):
        try:
            api.encode_file(torn, 10, 4, checksums=True)
        except faults.InjectedWriteError as e:
            err = e
    litter = _litter(torn_dir, "torn.bin")
    if err is None or "injected torn fault" not in str(err) or litter:
        raise AssertionError(f"torn encode: error {err!r}, litter {litter}")
    res["torn_encode"] = {"seconds": time.perf_counter() - t0, "error": str(err), "k1_runs": k1_runs()}
    log(phase="faults_maint", step="torn_encode", **res["torn_encode"])
    launches += k1_runs()
    shutil.rmtree(torn_dir)
    os.unlink(path)
    for i in range(14):
        if os.path.exists(chunk_file_name(path, i)):
            os.unlink(chunk_file_name(path, i))

    # The mid-stream swap (k=3, n=5, 4 KiB segments, native 0 lost).
    small = os.path.join(d, "swap.bin")
    want = write_seeded(small, seed + 1, SWAP_FILE_BYTES)
    api.encode_file(small, 3, 2, checksums=True, segment_bytes=4096)
    os.unlink(chunk_file_name(small, 0))
    before = metrics.REGISTRY.snapshot()
    _reset_counts()
    swap_plan = faults.parse_plan("chunk1:ioerror@from=2,scope=read", seed=seed)
    t0 = time.perf_counter()
    with faults.activate(swap_plan):
        out = api.auto_decode_file(small, small + ".dec", segment_bytes=4096)
    swaps = _metric_delta(before, "rs_degraded_decodes_total", '{stage="midstream"}')
    if sha256_file(out) != want or swaps != 1:
        raise AssertionError(f"mid-stream swap: sha256 {sha256_file(out)} != {want} or swaps {swaps} != 1")
    res["midstream_swap"] = {"seconds": time.perf_counter() - t0, "k1_runs": k1_runs(), "swaps": swaps,
                             "calls": {f"{s}:{n}": c for (s, n), c in swap_plan._calls.items()}}
    log(phase="faults_maint", step="midstream_swap", **res["midstream_swap"])
    launches += k1_runs()
    conf = os.path.join(d, "swap.conf")
    with open(conf, "w") as fp:
        fp.write("".join(os.path.basename(chunk_file_name(small, i)) + "\n" for i in (1, 2, 3)))
    err = None
    _reset_counts()
    with faults.activate(faults.parse_plan("chunk1:ioerror@from=2,scope=read", seed=seed)):
        try:
            api.decode_file(small, conf, small + ".dec2", segment_bytes=4096)
        except api.ChunkIntegrityError as e:
            err = e
    if err is None or set(err.bad_chunks) != {1} or os.path.exists(small + ".dec2"):
        raise AssertionError(f"plain decode under the chunk-1 fault: {err!r}")
    res["plain_decode_error"] = str(err)
    launches += k1_runs()
    log(phase="faults_maint", step="plain_decode_names_chunk1", error=str(err))

    # The scrub read error: chunk 1 unreadable at the scrub boundary.
    before = metrics.REGISTRY.snapshot()
    with faults.activate(faults.parse_plan("chunk1:ioerror@scope=scrub", seed=seed)):
        report = api.scan_file(small, segment_bytes=4096)
    read_errors = _metric_delta(before, "rs_scrub_chunks_total", '{state="read_error"}')
    if report["corrupt"] != [1] or report["decodable"] is not True or read_errors != 1:
        raise AssertionError(f"scrub read error: {report}, read_error states {read_errors}")
    res["scrub_read_error"] = {"corrupt": report["corrupt"], "missing": report["missing"],
                               "decodable": report["decodable"]}
    log(phase="faults_maint", step="scrub_read_error", **res["scrub_read_error"])
    shutil.rmtree(d)
    res["k1_launches"] = launches
    return res


def _chunk_digests(path: str) -> dict:
    """SHA-256 of each of a k=10, n=14 archive's chunks (a repair rewrites
    .METADATA's CRC lines in its own order, so the metadata is left out)."""
    digests = archive_digests(path, 14)
    digests.pop(os.path.basename(path) + ".METADATA")
    return digests


def _maint_cli(argv: list[str]) -> tuple[int, dict]:
    from gpu_rscode_torch.maint import controller

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = controller.main(argv)
    return rc, json.loads(buf.getvalue().splitlines()[-1])


def _maint_drain(work: str, seed: int, device) -> dict:
    """`rs maint --drain` on the card over damaged archives, then a drain
    killed mid-repair and its restart."""
    d = os.path.join(work, "maint")
    os.makedirs(d, exist_ok=True)
    ledger = os.path.join(d, "ledger.jsonl")
    argv = ["--ledger", ledger, "--device", str(device), "--json", "--owner", "chip_smoke",
            "--bytes-per-s", str(1 << 40)]
    res: dict = {}
    with scoped(RS_RUNLOG=ledger, RS_RUNLOG_MAX_BYTES=None, RS_MAINT_CRASH=None, RS_HEALTH_SCRUB_MAX_AGE_S=None):
        archives = []
        for a in range(MAINT_ARCHIVES + 1):
            path = os.path.join(d, f"maint_{a}.bin")
            write_seeded(path, seed + a, MAINT_FILE_BYTES)
            api.encode_file(path, 10, 4, checksums=True)
            os.unlink(path)  # the chunks are the data now
            archives.append(path)
        crash_victim = archives.pop()
        digests = {path: _chunk_digests(path) for path in archives + [crash_victim]}
        for a, path in enumerate(archives):
            _flip(chunk_file_name(path, 1 + a), [4096 * (a + 1)])
            api.scan_file(path)
        rc, doc = _maint_cli(argv)
        repairs = [job for job in doc["jobs"] if job["kind"] == "repair"]
        if rc != 0 or len(repairs) != MAINT_ARCHIVES:
            raise AssertionError(f"maint dry run: rc {rc}, {doc}")
        _reset_counts()
        t0 = time.perf_counter()
        rc, doc = _maint_cli([*argv, "--drain"])
        wall = time.perf_counter() - t0
        restored = all(_chunk_digests(path) == digests[path] for path in archives)
        if rc != 0 or doc["remaining"] != 0 or not restored:
            raise AssertionError(f"maint drain: rc {rc}, remaining {doc.get('remaining')}, restored {restored}")
        res["drain"] = {"wall_s": wall, "GBps": MAINT_ARCHIVES * MAINT_FILE_BYTES / wall / 1e9, "jobs": doc["jobs"],
                        "passes": doc["passes"], "k1_runs": k1_runs(), "job_walls": [
                            j["wall_s"] for j in doc["stats"]["last_jobs"]]}
        log(phase="faults_maint", step="maint_drain", **res["drain"])
        launches = k1_runs()

        # A drain killed mid-repair (after repair_file, before its rescan),
        # then the restart: it must converge and the chunks come back.
        from gpu_rscode_torch.maint import controller

        _flip(chunk_file_name(crash_victim, 7), [12345])
        api.scan_file(crash_victim)
        _reset_counts()
        with scoped(RS_MAINT_CRASH="repair:mid"):
            try:
                _maint_cli([*argv, "--drain"])
                crashed = False
            except controller.MaintCrash:
                crashed = True
        rc, doc = _maint_cli([*argv, "--drain"])
        restored = _chunk_digests(crash_victim) == digests[crash_victim]
        if not crashed or rc != 0 or doc["remaining"] != 0 or not restored:
            raise AssertionError(f"maint crash restart: crashed {crashed}, rc {rc}, {doc.get('remaining')}, "
                                 f"restored {restored}")
        res["crash_restart"] = {"stage": "repair:mid", "jobs_after_restart": doc["jobs"], "k1_runs": k1_runs()}
        log(phase="faults_maint", step="maint_crash_restart", **res["crash_restart"])
        launches += k1_runs()
    shutil.rmtree(d)
    res["k1_launches"] = launches
    return res


def _quantiles(values) -> dict:
    values = sorted(values)
    if not values:
        return {"n": 0}
    return {"n": len(values), "p50": values[len(values) // 2], "p99": values[min(len(values) - 1,
                                                                                  int(0.99 * len(values)))],
            "max": values[-1], "sum": round(sum(values), 6)}


def _stage_gaps(recs: list) -> dict:
    """Quantiles of the time from each daemon stage of a request to the
    next (admit, dequeue, batch_formed, dispatch, device_done,
    drain_done, ack), keyed by the later stage."""
    out = {}
    for prev, stage in itertools.pairwise(("admit", "dequeue", "batch_formed", "dispatch", "device_done",
                                           "drain_done", "ack")):
        gaps = [round(r["stages"][stage] - r["stages"][prev], 6) for r in recs
                if stage in r["stages"] and prev in r["stages"]]
        if gaps:
            out[stage] = {k: v for k, v in _quantiles(gaps).items() if k in ("p50", "p99", "sum")}
    return out


def _ab_arm_breakdown(ledger: str, report: dict) -> dict:
    """Where an A/B arm's foreground time went, from the arm's own ledger
    (the daemon's wide events and the api's rs_run records) and the
    client's per-request rows: queue wait, service, the client's share
    (upload and response outside the daemon's admit..ack), batch sizes,
    the file ops' phase sums, and when the maint jobs ran against the
    load (seconds after the first foreground admission) with the number
    of foreground requests that overlapped one."""
    from gpu_rscode_torch.obs import runlog

    recs = runlog.read_records(ledger)
    fg = [r for r in recs if r.get("kind") == "rs_request" and r.get("tenant") in ("alpha", "beta")
          and r.get("op") in ("encode", "decode") and r.get("outcome") == "ok"]
    t0 = min((r["ts"] - r["wall_s"] for r in fg), default=0.0)
    out = {"queue_wait_s": _quantiles([r["stages"].get("dequeue", 0.0) for r in fg]),
           "service_s": _quantiles([r["service_s"] for r in fg]),
           "server_wall_s": _quantiles([r["wall_s"] for r in fg]),
           "batches": _quantiles([r.get("batch") or 0 for r in fg]),
           "stage_gaps_s": _stage_gaps(fg),
           "last_fg_ack_s": round(max((r["ts"] - t0 for r in fg), default=0.0), 3)}
    rows = [r for r in report.get("requests", []) if r.get("tenant") in ("alpha", "beta")
            and r.get("op") in ("encode", "decode") and r.get("status") == 200 and r.get("stages")]
    out["client_outside_s"] = _quantiles([r["wall_s"] - max(r["stages"].values()) for r in rows])
    ops: dict = {}
    for r in recs:
        if r.get("kind") != "rs_run" or r.get("op") == "chaos_iter":
            continue
        cell = ops.setdefault(r["op"], {"n": 0, "wall_s": 0.0, "phases": {}, "ran_at_s": []})
        cell["n"] += 1
        cell["wall_s"] = round(cell["wall_s"] + r["wall_s"], 6)
        for name, v in (r.get("phases") or {}).items():
            cell["phases"][name] = round(cell["phases"].get(name, 0.0) + v, 6)
        if r["op"] in ("repair", "scan"):
            cell["ran_at_s"].append(round(r["ts"] - r["wall_s"] - t0, 3))
    out["file_ops"] = ops
    jobs = [(r["ts"] - r["wall_s"], r["ts"]) for r in recs
            if r.get("kind") == "rs_run" and r.get("op") in ("repair", "scan") and r["ts"] - r["wall_s"] > t0]
    out["slowest"] = [{"op": r["op"], "tenant": r["tenant"], "admit_s": round(r["ts"] - r["wall_s"] - t0, 3),
                       "wall_s": r["wall_s"], "queue_wait_s": r["stages"].get("dequeue"), "service_s": r["service_s"],
                       "batch": r.get("batch"),
                       "beside_maint": any(a < r["ts"] and b > r["ts"] - r["wall_s"] for a, b in jobs)}
                      for r in sorted(fg, key=lambda r: -r["wall_s"])[:4]]
    out["fg_beside_maint"] = sum(any(a < r["ts"] and b > r["ts"] - r["wall_s"] for a, b in jobs) for r in fg)
    return out


def _maint_ab(work: str, device) -> dict:
    """The daemon with --maint against the same traffic without it
    (loadgen.run_maint_ab)."""
    from gpu_rscode_torch.serve import loadgen

    d = os.path.join(work, "maint_ab")
    os.makedirs(d)
    _reset_counts()
    t0 = time.perf_counter()
    reports, windows = [], []
    open_loop = loadgen.run_open_loop

    def keep_report(*args, **kwargs):
        # This process's CPU seconds over the open loop's wall (client and
        # daemon share it).
        cpu, wall = time.process_time(), time.perf_counter()
        reports.append(open_loop(*args, **kwargs))
        windows.append({"cpu_s": round(time.process_time() - cpu, 3), "wall_s": round(time.perf_counter() - wall, 3)})
        return reports[-1]

    loadgen.run_open_loop = keep_report
    try:
        with scoped(RS_METRICS=None, RS_SLO=None, RS_MAINT=None, RS_SERVE_BATCH_MS=None):
            off, on, margin = loadgen.run_maint_ab(archives=MAINT_ARCHIVES, size_bytes=MAINT_AB_BYTES, k=10, p=4,
                                                   duration_s=MAINT_AB_SECONDS, rate=MAINT_AB_RATE,
                                                   p99_ratio_max=1.25, workdir=d, quiet=True, device=device)
    finally:
        loadgen.run_open_loop = open_loop
        for arm, report, process in zip(("maint_off", "maint_on"), reports, windows):
            log(phase="faults_maint", step="maint_ab_breakdown", arm=arm, process=process,
                **_ab_arm_breakdown(os.path.join(d, arm, "ledger.jsonl"), report))
    failed = {arm["arm"]: arm["summary"]["failed"] for arm in (off, on)}
    if not on["maint_enabled"] or off["maint_enabled"] or any(failed.values()):
        raise AssertionError(f"maint A/B: enabled {on['maint_enabled']}/{off['maint_enabled']}, failed {failed}")
    res = {"wall_s": time.perf_counter() - t0, "k1_runs": k1_runs(), "p99_ratio": margin["p99_ratio"],
           "converge_wait_s": on["converge_wait_s"], "pause_events": on["pause_events"],
           "resume_events": on["resume_events"], "maint_jobs": on["maint_jobs"],
           "arms": {arm["arm"]: {"fg_p50_s": arm["fg_p50_s"], "fg_p99_s": arm["fg_p99_s"],
                                 "settle_s": arm["settle_s"],
                                 "ok": arm["summary"]["ok"], "failed": arm["summary"]["failed"],
                                 "rejected": arm["summary"]["rejected"],
                                 "offered_rps": arm["summary"]["offered_rps"],
                                 "achieved_rps": arm["summary"]["achieved_rps"]} for arm in (off, on)}}
    log(phase="faults_maint", step="maint_ab", bytes=MAINT_AB_BYTES, seconds=MAINT_AB_SECONDS, rate=MAINT_AB_RATE,
        **res)
    shutil.rmtree(d)
    res["k1_launches"] = res["k1_runs"]
    return res


@_named("5h faults and maint")
def phase_faults_maint(work: str, seed: int, device) -> dict:
    """Phase 5h: the fault and maintenance planes on the card (see the
    module doc)."""
    t_phase = time.perf_counter()
    res: dict = {"chaos": []}
    with scoped(RS_METRICS="1", RS_FAULTS=None, RS_FAULTS_SEED=None, RS_RUNLOG=None, RS_MAINT=None):
        for flags, chaos_seed in CHAOS_DIGESTS:
            res["chaos"].append(_chaos_class(flags, chaos_seed, work, device))
        res["faults"] = _fault_plane(work, seed)
        res["maint"] = _maint_drain(work, seed + 100, device)
        res["maint_ab"] = _maint_ab(work, device)
    res["k1_launches"] = (sum(row["k1_runs"] for row in res["chaos"]) + res["faults"]["k1_launches"]
                          + res["maint"]["k1_launches"] + res["maint_ab"]["k1_launches"])
    res["seconds"] = time.perf_counter() - t_phase
    log(phase="faults_maint_summary", seconds=res["seconds"], k1_launches=res["k1_launches"],
        chaos_seconds=sum(row["wall_s"] for row in res["chaos"]), plan_cache=plan.PLAN_CACHE.stats())
    return res


# -- phase 5i: the measurement plane ------------------------------------------------

MEASURE_FILE_BYTES = 1024 * MiB  # the main path's file, k=10, n=14, 64 MiB segments
MEASURE_SEGMENT_BYTES = api.DEFAULT_SEGMENT_BYTES


def _cli_quiet(argv: list[str]) -> tuple[int, str]:
    """``rs ARGV`` in this process: (exit code, standard output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def _trace_spans(path: str, name: str) -> list[dict]:
    with open(path) as fp:
        doc = json.load(fp)
    return [e for e in doc["traceEvents"] if e.get("name") == name and e.get("ph") == "X"]


def _observed_op(what: str, argv: list[str], work: str, segments: int, size: int, chunk: int) -> dict:
    """One CLI operation with --metrics-json and --trace: its snapshot and
    trace checked (17 dispatches of the op through K1, the codec's true
    bytes, the staging IO's writes, one dispatch span a segment)."""
    from gpu_rscode_torch.obs import metrics

    op = argv[0]
    mpath, tpath = os.path.join(work, f"5i_{what}.metrics.json"), os.path.join(work, f"5i_{what}.trace.json")
    metrics.REGISTRY.reset()
    k1_before = k1_runs()
    t0 = time.perf_counter()
    rc, _ = _cli_quiet([*argv[1:], "--segment-bytes", str(MEASURE_SEGMENT_BYTES), "--metrics-json", mpath,
                        "--trace", tpath, "--quiet"])
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"5i {what}: rs exited {rc}")
    with open(mpath) as fp:
        snap = json.load(fp)["metrics"]
    series = f'{{op="{op}",strategy="cuda",w="8"}}'
    got = {"segments": _metric(snap, "segments_dispatched", series),
           "codec_bytes": _metric(snap, "rs_codec_bytes_total", series),
           "io_write": snap.get("rs_io_write_bytes_total", {}).get("values", {}),
           "dispatch_spans": sum(e["args"].get("op") == op for e in _trace_spans(tpath, "dispatch")),
           "k1_runs": k1_runs() - k1_before}
    want_write = {'{call="scatter_write"}': 4 * chunk} if op == "encode" else {'{call="stream_write"}': size}
    if (got["segments"], got["codec_bytes"], got["dispatch_spans"], got["k1_runs"]) != (
            segments, 10 * chunk, segments, segments) or got["io_write"] != want_write:
        raise AssertionError(f"5i {what}: {got}, want {segments} segments of {10 * chunk} codec bytes, "
                             f"writes {want_write}")
    log(phase="measure", step=what, wall_s=wall, gbps=size / wall / 1e9, **got)
    return {"wall_s": wall, "k1_runs": got["k1_runs"]}


def _prof_events(ledger: str) -> list[dict]:
    from gpu_rscode_torch.obs import runlog

    return [r for r in runlog.read_records(ledger) if r.get("kind") == "rs_perf"]


PLANES_ROUNDS = 3  # rounds of the three arms in (b), each round in another order


def _planes_cost(path: str, conf: str, out: str, ledger: str, size: int) -> dict:
    """(b): the 1 GiB encode with every plane off, with RS_METRICS=1, with
    RS_PROF=1 (one rs_perf event a dispatch into ``ledger``): PLANES_ROUNDS
    rounds, the arms rotated each round, their walls' medians and spread;
    a profiled decode too.  The profiled dispatches' chain stages are K1's
    graph replays."""
    from gpu_rscode_torch.obs import metrics

    arms = (("off", {}), ("metrics", {"RS_METRICS": "1"}), ("prof", {"RS_PROF": "1", "RS_RUNLOG": ledger}))
    walls: dict = {arm: [] for arm, _ in arms}
    replays = captures = eager = 0
    for r in range(PLANES_ROUNDS):
        for arm, env in arms[r % len(arms):] + arms[:r % len(arms)]:
            with scoped(RS_METRICS=None, RS_PROF=None, RS_RUNLOG=None), scoped(**env):
                metrics.REGISTRY.reset()
                before = (cuda_gemm.REPLAYED, cuda_gemm.CAPTURED, cuda_gemm.LAUNCHES)
                t0 = time.perf_counter()
                api.encode_file(path, 10, 4, segment_bytes=MEASURE_SEGMENT_BYTES)
                walls[arm].append(time.perf_counter() - t0)
                if arm == "prof":
                    replays += cuda_gemm.REPLAYED - before[0]
                    captured = cuda_gemm.CAPTURED - before[1]
                    captures += captured
                    eager += cuda_gemm.LAUNCHES - before[2] - captured  # a capture's first dispatch runs eagerly
    with scoped(RS_PROF="1", RS_RUNLOG=ledger):
        api.decode_file(path, conf, out, segment_bytes=MEASURE_SEGMENT_BYTES)
    events = _prof_events(ledger)
    enc = [e for e in events if e["op"] == "encode"]
    dec = [e for e in events if e["op"] == "decode"]
    chained = [e for e in enc if "chain" in e["stages"]]
    if not enc or not dec or any(e["strategy"] != "cuda" for e in events):
        raise AssertionError(f"5i prof: {len(enc)} encode and {len(dec)} decode rs_perf events")
    # A replay (or an eager dispatch) is one chain stage; a capture's
    # dispatch is timed whole as compile.
    if len(chained) != replays + eager or len(enc) - len(chained) != captures:
        raise AssertionError(f"5i prof: {len(enc)} events, {len(chained)} with a chain stage, "
                             f"{replays} K1 replays, {eager} eager launches, {captures} captures")

    def med(rows, key):
        vals = [r["stages"][key] for r in rows if key in r["stages"]]
        return float(np.median(vals)) if vals else None

    spread = {arm: {"median": float(np.median(v)), "min": min(v), "max": max(v)} for arm, v in walls.items()}
    log(phase="measure", step="planes_cost", encode_wall_s=walls, encode_wall_spread_s=spread, smi=smi_line(),
        prof_events={"encode": len(enc), "decode": len(dec)}, k1_replays=replays, captures=captures, eager=eager,
        median_coverage={"encode": float(np.median([e["coverage"] for e in enc])),
                         "decode": float(np.median([e["coverage"] for e in dec]))},
        median_stage_ms={op: {s: 1e3 * med(rows, s) for s in ("chain", "compile") if med(rows, s) is not None}
                         for op, rows in (("encode", enc), ("decode", dec))},
        median_wall_ms={"encode": 1e3 * float(np.median([e["wall_s"] for e in enc])),
                        "decode": 1e3 * float(np.median([e["wall_s"] for e in dec]))},
        median_staging_ms=1e3 * float(np.median([e.get("staging_s", 0.0) for e in enc])))
    return {"walls": {arm: row["median"] for arm, row in spread.items()}, "events": len(events)}


def _trace_events(trace: str) -> list[dict]:
    """The complete ("X") events of a Chrome trace that carry a duration."""
    with open(trace) as fp:
        return [e for e in json.load(fp)["traceEvents"] if e.get("ph") == "X" and "dur" in e]


def _busy_union_us(events: list[dict]) -> dict:
    """The device's busy time in a trace's events: kernels and copies, each
    summed, their union on the timeline (streams overlap), and the trace's
    own window (first event to last: the op without the profiler's
    start-up, which the first session of a process pays)."""
    window = max(float(e["ts"]) + float(e["dur"]) for e in events) - min(float(e["ts"]) for e in events)
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in device)
    union, end = 0.0, -math.inf
    for lo, hi in spans:
        if hi > end:
            union += hi - max(lo, end)
            end = hi
    return {"device_events": len(device),
            "kernel_us": sum(float(e["dur"]) for e in device if e["cat"] == "kernel"),
            "copy_us": sum(float(e["dur"]) for e in device if e["cat"] != "kernel"),
            "busy_union_us": union, "trace_window_us": window}


def _profiled_op(what: str, fn, prof_dir: str, plan_on: bool) -> dict:
    """(c): ``fn`` under --profile-dir's session, which must write one
    Chrome trace into ``prof_dir`` (nested ops join the outer session).
    The trace's kernel events must list K1 (gf_bitslice_kernel) as often
    as K1 ran, with device time, unless the trace holds no device event at
    all (then the CPU side is checked: the graph launches equal the
    replays)."""
    before = (k1_runs(), cuda_gemm.REPLAYED)
    with scoped(RS_PLAN=None if plan_on else "0"):
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    runs, replays = k1_runs() - before[0], cuda_gemm.REPLAYED - before[1]
    traces = sorted(os.listdir(prof_dir)) if os.path.isdir(prof_dir) else []
    if len(traces) != 1:
        raise AssertionError(f"5i {what}: {len(traces)} traces in {prof_dir}, want 1 (nested ops join)")
    events = _trace_events(os.path.join(prof_dir, traces[0]))
    k1 = [e for e in events if e.get("cat") == "kernel" and "gf_bitslice_kernel" in e.get("name", "")]
    k1_calls = len(k1)
    k1_device_ms = sum(float(e["dur"]) for e in k1) / 1e3
    graph_launches = sum(e.get("name") == "cudaGraphLaunch" for e in events)
    busy = _busy_union_us(events)
    row = {"wall_s": wall, "k1_runs": runs, "k1_replays": replays, "plan": plan_on, "k1_in_trace": k1_calls,
           "k1_device_ms": k1_device_ms, "cuda_graph_launches": graph_launches, "trace": traces[0],
           **busy, "device_busy_share": busy["busy_union_us"] / (wall * 1e6),
           "device_busy_share_of_trace": busy["busy_union_us"] / busy["trace_window_us"]}
    log(phase="measure", step=what, smi=smi_line(), **row)
    if busy["device_events"] == 0:
        # CUPTI gave no device activity: check what the trace does hold.
        if graph_launches != replays:
            raise AssertionError(f"5i {what}: no device events, and {graph_launches} cudaGraphLaunch for "
                                 f"{replays} replays")
    elif k1_calls and (k1_calls != runs or k1_device_ms <= 0):
        raise AssertionError(f"5i {what}: the trace lists K1 {k1_calls} times ({k1_device_ms} ms), K1 ran {runs}")
    return row


def _profiles(path: str, conf: str, out: str, work: str) -> dict:
    """(c): one encode and one decode through the CLI's --profile-dir; if
    the graph replays hide K1's name from a trace that has device events,
    once more with RS_PLAN=0 (eager launches)."""
    rows = {}
    for plan_on in (True, False):
        for op in ("encode", "decode"):
            prof_dir = os.path.join(work, f"5i_prof_{op}_{int(plan_on)}")
            argv = (["-k", "10", "-n", "14", "-e", path] if op == "encode"
                    else ["-d", "-i", path, "-c", conf, "-o", out])
            rows[(op, plan_on)] = _profiled_op(
                f"profile_{op}" + ("" if plan_on else "_eager"),
                lambda argv=argv, prof_dir=prof_dir: _cli_quiet([
                    *argv, "--segment-bytes", str(MEASURE_SEGMENT_BYTES), "--profile-dir", prof_dir, "--quiet"]),
                prof_dir, plan_on)
        hidden = [r for (op, on), r in rows.items() if on == plan_on and r["device_events"] and not r["k1_in_trace"]]
        if not hidden:
            break
        if not plan_on:
            raise AssertionError(f"5i: K1 missing from the eager traces too: {hidden}")
        log(phase="measure", step="profile", note="graph replays hid K1's name; profiling again with RS_PLAN=0")
    return {f"{op}{'' if on else '_eager'}": r for (op, on), r in rows.items()}


def _xor_pack_timing(path: str) -> dict:
    """The 1 GiB encode under xor with RS_METRICS=1 and RS_XOR_PACK_TIMING=1
    from an empty plan cache, so its first dispatches capture graphs: the
    pack timing synchronises only eager packs (a capture's warm-up), never
    inside a capture, so rs_xor_pack_seconds counts the dispatches that
    were not replays; rs_xor_pack_reuse_total counts every dispatch's pack
    (replays included, captures not); the archive equals the cuda one."""
    from gpu_rscode_torch.obs import metrics

    want = archive_digests(path, 14)
    plan.PLAN_CACHE.clear()
    with scoped(RS_METRICS="1", RS_XOR_PACK_TIMING="1", RS_PROF=None, RS_RUNLOG=None):
        metrics.REGISTRY.reset()
        calls0, counts0 = _strategy_calls(), _plan_counts()
        t0 = time.perf_counter()
        api.encode_file(path, 10, 4, strategy="xor", segment_bytes=MEASURE_SEGMENT_BYTES)
        wall = time.perf_counter() - t0
        counts, calls = _plan_delta(counts0), _strategy_calls() - calls0
        snap = metrics.REGISTRY.snapshot()
        timed = sum(v["count"] for v in snap.get("rs_xor_pack_seconds", {}).get("values", {}).values())
        packed = _metric(snap, "rs_xor_pack_reuse_total", '{outcome="packed"}')
    _check_graphed("5i xor pack timing", counts, calls, warm=False)
    if not counts["captures"] or timed != calls - counts["replays"] or packed != calls:
        raise AssertionError(f"5i xor pack timing: {timed} timed packs and {packed} counted for {calls} dispatches, "
                             f"plan counts {counts}")
    if archive_digests(path, 14) != want:
        raise AssertionError("5i xor pack timing: the xor archive differs from the cuda archive")
    log(phase="measure", step="xor_pack_timing", wall_s=wall, dispatches=calls, timed_packs=timed,
        packs_counted=packed, plan=counts)
    return {"wall_s": wall, "timed_packs": timed}


def _baselines_and_daemon(ledger: str, work: str, device) -> dict:
    """(d): rs perf --record then --check on the same evidence (exit 0), a
    daemon with RS_RUNLOG answering GET /perf with the cuda cells, and its
    /metrics carrying the rs_perf_baseline_* gauges."""
    from gpu_rscode_torch.serve.daemon import ServeDaemon

    with scoped(RS_RUNLOG=ledger, RS_METRICS="1"):
        for argv in (["perf", "--record"], ["perf", "--check"]):
            rc, out = _cli_quiet(argv)
            if rc != 0:
                raise AssertionError(f"5i: rs {' '.join(argv)} exited {rc}: {out}")
        daemon = ServeDaemon(os.path.join(work, "5i_serve"), port=0, addr="127.0.0.1", device=device).start()
        try:
            st, body, _, _ = _http(daemon.port, "GET", "/perf")
            report = json.loads(body)
            st_m, metrics_text, _, _ = _http(daemon.port, "GET", "/metrics")
        finally:
            daemon.close()
    cells = [row["cell"] for row in report.get("rows", []) if row["strategy"] == "cuda"]
    if st != 200 or not report.get("baseline") or not cells or report.get("breach"):
        raise AssertionError(f"5i: GET /perf answered {st}: {report}")
    if st_m != 200 or b"rs_perf_baseline_gbps" not in metrics_text or b"rs_perf_baseline_ratio" not in metrics_text:
        raise AssertionError(f"5i: /metrics answered {st_m} without the rs_perf_baseline_* gauges")
    log(phase="measure", step="perf", backend=report["backend"], cells=cells,
        rows=[{k: row[k] for k in ("cell", "base_gbps", "cur_gbps", "n", "status")} for row in report["rows"]])
    return {"cells": cells}


def _analyze(device) -> dict:
    """(e): rs analyze at the main path's shape on the card, the roofline
    probed there."""
    t0 = time.perf_counter()
    with scoped(RS_RUNLOG=None):
        rc, out = _cli_quiet(["analyze", "--json", "--strategies", "cuda,bitplane,xor,ring,native", "--k", "10",
                              "--p", "4", "--size-kb", "262144", "--segment-kb", "65536"])
    if rc != 0:
        raise AssertionError(f"5i: rs analyze exited {rc}")
    report = json.loads(out.splitlines()[-1])
    roof = report["roofline"]
    rows = report["strategies"]
    if roof.get("device") != torch.cuda.get_device_name(device) or roof["source"] != "probe" or len(rows) != 10:
        raise AssertionError(f"5i: rs analyze roofline {roof}, {len(rows)} rows")
    log(phase="measure", step="analyze", seconds=time.perf_counter() - t0, smi=smi_line(),
        roofline={k: roof[k] for k in ("triad_gbps", "gemm_gflops", "device")},
        rows=[{k: r[k] for k in ("strategy", "op", "dispatches", "end_to_end_gbps", "achieved_gbps",
                                 "achieved_gflops", "pct_of_peak_bw", "bound")} for r in rows])
    return {"rows": len(rows)}


@_named("5i measurement plane")
def phase_measurement(work: str, seed: int, device, size: int = MEASURE_FILE_BYTES) -> dict:
    """Phase 5i: the measurement plane on the card (see the module doc)."""
    from gpu_rscode_torch.obs import metrics, profiler

    t_phase = time.perf_counter()
    forced = metrics.forced()
    _reset_counts()
    path = os.path.join(work, "measure.bin")
    want = write_seeded(path, seed, size)
    chunk = -(-size // 10)
    segments = len(api._segment_spans(chunk, api._segment_cols(chunk, 10, MEASURE_SEGMENT_BYTES)))
    out = os.path.join(work, "measure.out")
    ledger = os.path.join(work, "measure_ledger.jsonl")
    res: dict = {}
    with scoped(RS_METRICS="1", RS_PROF=None, RS_RUNLOG=None, RS_TRACE=None, RS_PROFILE=None, RS_PLAN=None):
        res["encode"] = _observed_op("encode", ["encode", "-k", "10", "-n", "14", "-e", path], work, segments,
                                     size, chunk)
        for i in range(4):
            os.unlink(chunk_file_name(path, i))
        conf = make_conf(14, 10, path)
        res["decode"] = _observed_op("decode", ["decode", "-d", "-i", path, "-c", conf, "-o", out], work,
                                     segments, size, chunk)
        if sha256_file(out) != want:
            raise AssertionError("5i: the decoded file differs from the input")
        metrics.force_enable(False)  # --metrics-json latched it; the "off" arm needs it off
        res["planes"] = _planes_cost(path, conf, out, ledger, size)
        res["profiles"] = _profiles(path, conf, out, work)
        if sha256_file(out) != want:
            raise AssertionError("5i: the profiled decode's output differs from the input")
        res["xor_pack_timing"] = _xor_pack_timing(path)
        res["perf"] = _baselines_and_daemon(ledger, work, device)
        res["analyze"] = _analyze(device)
        with scoped(RS_RUNLOG=ledger):
            for argv in (["stats", "--workload"], ["history", "--op", "encode"]):
                rc, text = _cli_quiet(argv)
                if rc != 0:
                    raise AssertionError(f"5i: rs {' '.join(argv)} exited {rc}")
                log(phase="measure", step=argv[0], stdout_bytes=len(text))
    metrics.force_enable(forced)
    profiler.reset()
    res["k1_launches"] = k1_runs()
    res["seconds"] = time.perf_counter() - t_phase
    log(phase="measure_summary", seconds=res["seconds"], k1_launches=res["k1_launches"],
        encode_wall_s=res["planes"]["walls"], smi=smi_line())
    return res


MESH_FILE_BYTES = 1024 * MiB  # BASELINE config 4's wide stripe: k=128, n=144, w=8
MESH_K, MESH_P, MESH_SHARDS = 128, 16, 4
MESH_MP_BYTES = 256 * MiB  # the two-process job's file, k=10, n=14


def _mesh_op(what: str, fn, nbytes: int) -> dict:
    """One mesh file operation with the counts reset just before: its wall,
    GB/s and the K1 runs it made (both forms, and the pre-parity ones)."""
    _reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    wall = time.perf_counter() - t0
    res = dict(phase="mesh", op=what, wall_s=wall, gbps=nbytes / wall / 1e9, k1_runs=k1_runs(),
               preparity=cuda_gemm.PREPARITY, captured=cuda_gemm.CAPTURED)
    log(**res)
    return res


def _mesh_metric(name: str) -> dict:
    from gpu_rscode_torch.obs import metrics

    return metrics.REGISTRY.snapshot().get(name, {}).get("values", {})


def _wide_stripe(work: str, seed: int, device) -> dict:
    """(a) BASELINE config 4 on a mesh of cuda:0 listed four times."""
    from gpu_rscode_torch.obs import metrics
    from gpu_rscode_torch.parallel.mesh import Mesh

    k, p, shards = MESH_K, MESH_P, MESH_SHARDS
    dirs = {name: os.path.join(work, f"mesh_{name}") for name in ("ref", "stripe", "cols")}
    for d in dirs.values():
        os.makedirs(d)
    path = {name: os.path.join(d, "wide.bin") for name, d in dirs.items()}
    want = write_seeded(path["ref"], seed, MESH_FILE_BYTES)
    for name in ("stripe", "cols"):
        os.link(path["ref"], path[name])
    chunk = -(-MESH_FILE_BYTES // k)
    segments = len(api._segment_spans(chunk, api._segment_cols(chunk, k, api.DEFAULT_SEGMENT_BYTES)))
    res = {"segments": segments}
    res["ref"] = _mesh_op("encode k=128 n=144 single device (cuda)",
                          lambda: api.encode_file(path["ref"], k, p, device=device), MESH_FILE_BYTES)
    ref = archive_digests(path["ref"], k + p)
    stripe_mesh = Mesh([[device]] * shards)
    forced = metrics.forced()
    metrics.force_enable()
    metrics.REGISTRY.reset()
    plan.MESH_PLAN_CACHE.clear()
    res["stripe_encode"] = _mesh_op("encode k=128 n=144 stripe mesh (4, 1) of cuda:0",
                                    lambda: api.encode_file(path["stripe"], k, p, device=device, mesh=stripe_mesh,
                                                            stripe_sharded=True), MESH_FILE_BYTES)
    mesh_stats = plan.MESH_PLAN_CACHE.stats()
    collective = _mesh_metric("rs_mesh_collective_bytes_total")
    staged = _mesh_metric("rs_mesh_staged_bytes_total")
    metrics.force_enable(forced)
    if archive_digests(path["stripe"], k + p) != ref:
        raise AssertionError("5j: the stripe-mode archive differs from the single-device one")
    enc = res["stripe_encode"]
    if enc["k1_runs"] != shards * segments or enc["preparity"] != shards * segments or enc["captured"]:
        raise AssertionError(f"5j: stripe encode ran K1 {enc['k1_runs']} times ({enc['preparity']} pre-parity, "
                             f"{enc['captured']} captured); want {shards} pre-parity launches x {segments} segments")
    if collective != {'{op="psum_stripe"}': p * 8 * chunk}:
        raise AssertionError(f"5j: rs_mesh_collective_bytes_total {collective}, want p*w*m = {p * 8 * chunk}")
    if staged != {'{stripe="True"}': k * chunk} or mesh_stats["calls"] != segments or mesh_stats["misses"] != 1:
        raise AssertionError(f"5j: staged {staged}, mesh plan cache {mesh_stats['calls']} calls, "
                             f"{mesh_stats['misses']} misses")
    log(phase="mesh", step="stripe_counts", segments=segments, collective_bytes=collective, staged_bytes=staged,
        mesh_plan_calls=mesh_stats["calls"], mesh_plan_hits=mesh_stats["hits"], mesh_plan_misses=mesh_stats["misses"])
    # Decode with 16 chunks lost: the first 16 natives, all through the
    # stripe-mode recovery GEMM.
    for i in range(p):
        os.unlink(chunk_file_name(path["stripe"], i))
    conf = make_conf(k + p, k, path["stripe"])
    out = path["stripe"] + ".out"
    res["stripe_decode"] = _mesh_op("decode 16 lost stripe mesh (4, 1)",
                                    lambda: api.decode_file(path["stripe"], conf, out, device=device, mesh=stripe_mesh,
                                                            stripe_sharded=True), MESH_FILE_BYTES)
    if sha256_file(out) != want:
        raise AssertionError("5j: the stripe-mode decode differs from the input")
    dec = res["stripe_decode"]
    if dec["k1_runs"] != shards * segments or dec["preparity"] != shards * segments:
        raise AssertionError(f"5j: stripe decode ran K1 {dec['k1_runs']} times ({dec['preparity']} pre-parity)")
    os.unlink(out)
    cols_mesh = Mesh([[device] * shards])
    res["cols_encode"] = _mesh_op("encode k=128 n=144 cols mesh (1, 4) of cuda:0",
                                  lambda: api.encode_file(path["cols"], k, p, device=device, mesh=cols_mesh),
                                  MESH_FILE_BYTES)
    if archive_digests(path["cols"], k + p) != ref:
        raise AssertionError("5j: the cols-mode archive differs from the single-device one")
    enc = res["cols_encode"]
    if enc["k1_runs"] != shards * segments or enc["preparity"]:
        raise AssertionError(f"5j: cols encode ran K1 {enc['k1_runs']} times ({enc['preparity']} pre-parity)")
    res["k1_launches"] = sum(res[key]["k1_runs"] for key in ("ref", "stripe_encode", "stripe_decode", "cols_encode"))
    res["peak_device_gib"] = torch.cuda.max_memory_allocated(device) / (1 << 30)
    for d in dirs.values():
        shutil.rmtree(d)
    return res


def _mesh_shard_timings(device) -> list[dict]:
    """K1 at the wide stripe's shard shapes on the card: cols mode (k=128,
    p=16, a quarter of a 64 MiB segment's columns, folded) and stripe mode
    (k=32, p=16, a whole segment's columns, the pre-parity int32 sums),
    next to the plain version and the bytes bound (B read once, the output
    written once: p symbols, or p*w int32 sums, a column)."""
    rng = np.random.default_rng(17)
    seg_cols = api._segment_cols(-(-MESH_FILE_BYTES // MESH_K), MESH_K, api.DEFAULT_SEGMENT_BYTES)
    A = RSCodec(MESH_K, MESH_P, device=device).parity_block
    rows = []
    for label, a, m, fold in (("mesh cols shard k=128 p=16 (folded)", A, seg_cols // MESH_SHARDS, True),
                              ("mesh stripe shard k=32 p=16 (pre-parity)", np.ascontiguousarray(A[:, :32]), seg_cols,
                               False)):
        p, depth = a.shape
        B = random_symbols(rng, (depth, m), 8, device)
        got = cuda_gemm.gf_matmul_cuda(a, B, 8, fold_parity=fold)
        want = gf_matmul_bitplane(a, B, 8, fold_parity=fold)
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max().item())
        if err:
            raise AssertionError(f"kernel != plain at the {label} timing shape")
        ms = time_ms(lambda: cuda_gemm.gf_matmul_cuda(a, B, 8, fold_parity=fold), iters=50, reps=3)
        plain = time_ms(lambda: gf_matmul_bitplane(a, B, 8, fold_parity=fold), iters=2, warmup=1)
        out_bytes = p * m if fold else p * 8 * m * 4
        row = dict(phase="kernel_timing", shape=label, w=8, p=p, k=depth, m=m, ms=ms, plain_ms=plain,
                   bound_ms=1e3 * (depth * m + out_bytes) / HBM_BYTES_PER_S, bound_by="bytes", library_ms=None,
                   max_abs_err=err, launches_per_gib_op=MESH_SHARDS * 16, smi=smi_line())
        if fold:
            row["est_logic_ops_per_col"] = k1_logic_ops_per_col(p, depth, 8)
        log(**row)
        rows.append(row)
    return rows


def _cli_devices_one(work: str, cuda_digests: dict) -> dict:
    """(b) The main configuration through the CLI with --devices 1: phase
    4's seeded file again, archive byte-equal to phase 4's, then a decode
    with the first 4 chunks lost."""
    d = os.path.join(work, "mesh_cli")
    os.makedirs(d)
    path = os.path.join(d, "main.bin")
    want = write_seeded(path, SEED, MAIN_FILE_BYTES)
    res = _mesh_op("CLI encode k=10 n=14 --devices 1", lambda: _cli_ok(
        ["-k", "10", "-n", "14", "-e", path, "--devices", "1", "--quiet"]), MAIN_FILE_BYTES)
    if archive_digests(path, 14) != cuda_digests:
        raise AssertionError("5j: the --devices 1 archive differs from phase 4's")
    for i in range(4):
        os.unlink(chunk_file_name(path, i))
    conf = make_conf(14, 10, path)
    dec = _mesh_op("CLI decode 4 lost --devices 1", lambda: _cli_ok(
        ["-d", "-i", path, "-c", conf, "-o", path + ".out", "--devices", "1", "--quiet"]), MAIN_FILE_BYTES)
    if sha256_file(path + ".out") != want:
        raise AssertionError("5j: the --devices 1 decode differs from the input")
    if res["k1_runs"] <= 0 or dec["k1_runs"] <= 0 or res["preparity"] or dec["preparity"]:
        raise AssertionError(f"5j: --devices 1 K1 runs {res['k1_runs']} / {dec['k1_runs']}, folded form only")
    shutil.rmtree(d)
    return {"encode": res, "decode": dec, "k1_launches": res["k1_runs"] + dec["k1_runs"]}


def _cli_ok(argv: list[str]) -> None:
    rc = cli.main(argv)
    if rc != 0:
        raise AssertionError(f"5j: rs {' '.join(argv)} exited {rc}")


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# The two ranks' program: each step an `rs` argv run in this process (the
# first joins the job; the others reuse its group), with this rank's K1
# counts set to 0 just before it and printed just after; or "lose": the
# lead moves the first 4 chunks of the archive away and writes the conf of
# the rest, behind a barrier on each side.
_RANK_STEPS = """
import json, os, sys
from gpu_rscode_torch import cli
from gpu_rscode_torch.ops import cuda_gemm
from gpu_rscode_torch.parallel import distributed
from gpu_rscode_torch.tools.make_conf import make_conf
from gpu_rscode_torch.utils.env import scoped
from gpu_rscode_torch.utils.fileformat import chunk_file_name
for i, step in enumerate(json.loads(sys.argv[1])):
    if step[0] == "lose":
        distributed.barrier("rs_smoke_lose")
        if distributed.rank() == 0:
            for j in range(4):
                os.rename(chunk_file_name(step[1], j), f"lost_{j}")
            make_conf(14, 10, step[1])
        distributed.barrier("rs_smoke_lost")
        continue
    cuda_gemm.LAUNCHES = cuda_gemm.CAPTURED = cuda_gemm.REPLAYED = cuda_gemm.PREPARITY = 0
    rc = cli.main(step)
    counts = dict(step=i, launches=cuda_gemm.LAUNCHES, replayed=cuda_gemm.REPLAYED, captured=cuda_gemm.CAPTURED,
                  preparity=cuda_gemm.PREPARITY)
    print("STEP", step[0], step[1], rc, flush=True)
    print("K1COUNTS " + json.dumps(counts), flush=True)
    if rc:
        sys.exit(rc)
"""


def _two_processes(steps: list, cwd: str, device) -> tuple[float, list[dict]]:
    """``steps`` (see _RANK_STEPS) in two processes of one job on this card
    (torchrun's variables; gloo, since two ranks share one card); both must
    exit 0.  Returns the wall and, for each rank, its K1 counts by step
    index.  Kills both on a failure or a timeout."""
    port = _free_port()
    steps = [step if step[0] == "lose" else [*step, "--device", device.type, "--quiet"] for step in steps]
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(2):
            env = dict(os.environ, WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port), PYTHONPATH=REPO)
            procs.append(subprocess.Popen([sys.executable, "-c", _RANK_STEPS, json.dumps(steps)], env=env, cwd=cwd,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"5j: rank {rank} of the two-process job exited {p.returncode}:\n{out[-3000:]}")
    counts = [{c["step"]: c for c in (json.loads(line.split(" ", 1)[1]) for line in out.splitlines()
                                      if line.startswith("K1COUNTS "))} for out in outs]
    log(phase="mesh", step="two_processes", steps=[step[:2] for step in steps], wall_s=wall, k1_counts=counts)
    return wall, counts


def _two_process_job(work: str, seed: int, device) -> dict:
    """(c) Two ranks on the one card (gloo with CUDA tensors), --devices 2
    --stripe 2 on a seeded 256 MiB file at k=10, n=14, each step a
    collective: an encode with --metrics-json / --trace parts, a conf decode
    with the first 4 chunks lost, an --auto decode and a --repair; then
    `rs aggregate` of the parts against one process running the same (2, 1)
    mesh, whose archive the repaired one must equal."""
    from gpu_rscode_torch.obs import metrics
    from gpu_rscode_torch.parallel.mesh import Mesh

    d = os.path.join(work, "mesh_mp")
    s = os.path.join(work, "mesh_single")
    os.makedirs(d)
    os.makedirs(s)
    path, single = os.path.join(d, "mp.bin"), os.path.join(s, "mp.bin")
    want = write_seeded(path, seed, MESH_MP_BYTES)
    os.link(path, single)
    flags = ["--devices", "2", "--stripe", "2"]
    ops = {"encode": 0, "conf_decode": 2, "auto_decode": 3, "repair": 4}  # step indices
    wall, counts = _two_processes([
        ["-k", "10", "-n", "14", "-e", "mp.bin", "--checksum", *flags, "--metrics-json", "m.json", "--trace", "t.json"],
        ["lose", "mp.bin"],
        ["-d", "-i", "mp.bin", "-c", "conf-14-10-mp.bin", "-o", "out.bin", *flags],
        ["-d", "-i", "mp.bin", "--auto", "-o", "auto.bin", *flags],
        ["--repair", "-i", "mp.bin", *flags]], d, device)
    for name in ("out.bin", "auto.bin"):
        if sha256_file(os.path.join(d, name)) != want:
            raise AssertionError(f"5j: the two-process {name} differs from the input")
    # Each rank holds one stripe position of the (2, 1) mesh, so each op runs
    # K1's pre-parity form once a segment on each rank, and nothing else.
    chunk = -(-MESH_MP_BYTES // 10)
    segments = len(api._segment_spans(chunk, api._segment_cols(chunk, 10, api.DEFAULT_SEGMENT_BYTES)))
    per_rank = [{op: rank_counts[i] for op, i in ops.items()} for rank_counts in counts]
    for rank, rank_ops in enumerate(per_rank):
        for op, c in rank_ops.items():
            if c["launches"] != segments or c["preparity"] != segments or c["replayed"] or c["captured"]:
                raise AssertionError(f"5j: rank {rank}'s two-process {op} ran K1 {c}; want {segments} pre-parity "
                                     f"launches (one a segment) and no folded or graph launch")
    res = {"job_s": wall, "segments": segments, "rank_k1": per_rank,
           "rank_k1_launches": sum(c["launches"] for rank_ops in per_rank for c in rank_ops.values())}
    forced = metrics.forced()
    metrics.force_enable()
    metrics.REGISTRY.reset()
    _reset_counts()
    api.encode_file(single, 10, 4, device=device, mesh=Mesh([[device], [device]]), stripe_sharded=True,
                    checksums=True)
    single_snap = metrics.REGISTRY.snapshot()
    metrics.force_enable(forced)
    if k1_runs() != 2 * segments or cuda_gemm.PREPARITY != 2 * segments:
        raise AssertionError(f"5j: the single-process (2, 1) encode ran K1 {k1_runs()} times ({cuda_gemm.PREPARITY} "
                             f"pre-parity); want 2 x {segments} pre-parity launches")
    if archive_digests(path, 14) != archive_digests(single, 14):
        raise AssertionError("5j: the two-process archive (encoded, 4 chunks lost, repaired) differs from the "
                             "single-process one")
    rc, _ = _cli_quiet(["aggregate", os.path.join(d, "m.json"), "--snapshot-out", os.path.join(d, "merged.json")])
    if rc != 0:
        raise AssertionError(f"5j: rs aggregate exited {rc}")
    with open(os.path.join(d, "merged.json")) as fp:
        merged = json.load(fp)["metrics"]
    parts = []
    for i in range(2):
        with open(os.path.join(d, f"m.json.p{i}")) as fp:
            parts.append(json.load(fp)["metrics"])
    staged = "rs_mesh_staged_bytes_total"
    if merged[staged]["values"] != single_snap[staged]["values"]:
        raise AssertionError(f"5j: merged staged bytes {merged[staged]['values']} != single "
                             f"{single_snap[staged]['values']}")
    # Each process reduces p*w*m bytes a segment and stages every segment:
    # its part's counts equal the single-process run's.
    for part in parts:
        counts = [list(snap[name]["values"].values()) for snap in (part, single_snap)
                  for name in ("rs_mesh_collective_bytes_total", "rs_mesh_segments_staged_total")]
        if counts[:2] != counts[2:]:
            raise AssertionError(f"5j: a part's collective bytes and staged segments {counts[:2]} != the single "
                                 f"process's {counts[2:]}")
    rc, _ = _cli_quiet(["aggregate", os.path.join(d, "t.json"), "--trace-out", os.path.join(d, "fused.json")])
    with open(os.path.join(d, "fused.json")) as fp:
        lanes = {e["pid"] for e in json.load(fp)["traceEvents"] if e.get("ph") == "X"}
    if rc != 0 or lanes != {1, 2}:
        raise AssertionError(f"5j: trace aggregate exited {rc} with lanes {lanes}")
    log(phase="mesh", step="aggregate", staged_bytes=merged[staged]["values"],
        collective_bytes_per_part=[part["rs_mesh_collective_bytes_total"]["values"] for part in parts])
    shutil.rmtree(d)
    shutil.rmtree(s)
    return res


def _nccl_one_rank() -> dict:
    """A one-rank NCCL group (the NCCL path; NCCL refuses two ranks on one
    card): the backend the rule picks, and an int8 sum through it."""
    from gpu_rscode_torch.parallel import distributed

    port = _free_port()
    distributed.initialize(init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    try:
        backend = distributed.backend()
        t = torch.full((1024,), 100, dtype=torch.int8, device="cuda")
        torch.distributed.all_reduce(t)
        ok = backend == "nccl" and int(t[0]) == 100
    finally:
        torch.distributed.destroy_process_group()
    if not ok:
        raise AssertionError(f"5j: one-rank group took backend {backend}")
    return {"backend": backend}


def _doctor(kind: str) -> dict:
    """(d) rs doctor --json on the card."""
    rc, text = _cli_quiet(["doctor", "--json", "--no-probe"])
    doc = json.loads(text)
    t, m = doc["torch"], doc["mesh"]
    problems = [doc["warnings"], t["error"], doc["native"]["error"]]
    if (rc != 0 or any(problems) or t["device_name"] != kind or not t["nvcc"] or m["local_device_count"] != 1
            or not m["nccl_available"]):
        raise AssertionError(f"5j: rs doctor rc {rc}: torch {t}, mesh {m}, problems {problems}")
    log(phase="mesh", step="doctor", device=t["device_name"], capability=t["capability"], nvcc=t["nvcc"],
        mesh=m)
    return {"device": t["device_name"], "capability": t["capability"]}


@_named("5j mesh")
def phase_mesh(work: str, seed: int, device, cuda_digests: dict) -> dict:
    """Phase 5j: the mesh on the card (see the module doc)."""
    t_phase = time.perf_counter()
    res = {"wide": _wide_stripe(work, seed, device)}
    res["cli"] = _cli_devices_one(work, cuda_digests)
    res["two_process"] = _two_process_job(work, seed + 1, device)
    res["nccl"] = _nccl_one_rank()
    res["doctor"] = _doctor(torch.cuda.get_device_name(0))
    res["timings"] = _mesh_shard_timings(device)
    res["k1_launches"] = (res["wide"]["k1_launches"] + res["cli"]["k1_launches"]
                          + res["two_process"]["rank_k1_launches"])
    res["seconds"] = time.perf_counter() - t_phase
    log(phase="mesh_summary", seconds=res["seconds"], k1_launches=res["k1_launches"],
        wide_walls={key: res["wide"][key]["wall_s"] for key in ("ref", "stripe_encode", "stripe_decode", "cols_encode")},
        two_process_walls=res["two_process"], peak_device_gib=res["wide"]["peak_device_gib"], smi=smi_line())
    return res


# -- phase 5m: the RS_PALLAS_* knobs on the main path ---------------------------

KNOBS_W16_BYTES = 256 * MiB
KNOBS_DOT_BYTES = 256 * MiB


def _knob_step(what: str, fn, nbytes: int) -> dict:
    """Run one step of phase 5m with the counts reset: its wall, GB/s, the
    kernels that ran (K1 must not), the plan counts and the stream
    dispatches."""
    _reset_counts()
    _reset_io_counts()
    plan0 = _plan_counts()
    t0 = time.perf_counter()
    fn()
    wall = time.perf_counter() - t0
    runs = _counts()
    res = dict(op=what, wall_s=wall, gbps=nbytes / wall / 1e9, runs=runs, plan=_plan_delta(plan0),
               k3_replayed=dict(cuda_planes.REPLAYED), k2_replayed=cuda_pack2.REPLAYED,
               stream_dispatches=pipeline.STREAM_DISPATCHES)
    if runs["K1"]:
        raise AssertionError(f"5m {what}: K1 ran {runs['K1']} times under the RS_PALLAS_* knobs")
    return res


def _codec_w4_step(what: str, device, seed: int, kernel: str) -> dict:
    """RSCodec(10, 4, w=4) on the card, strategy auto: a seeded 64 MiB
    stripe (symbols < 16, one a byte) staged as the segment loops stage it
    and encoded three times, decoded three times with the first 4 natives
    lost, and one update; every result against K1's plain version (or the
    data).  ``kernel`` (K1 or K3-planes-w4) must run every dispatch, some
    inside graph replays, and no other GEMM kernel may run."""
    _reset_counts()
    plan0 = _plan_counts()
    t0 = time.perf_counter()
    codec = RSCodec(10, 4, w=4, device=device)
    cols = SEGMENT_COLS
    data = np.random.default_rng(seed).integers(0, 16, size=(10, cols), dtype=np.uint8)
    want = gf_matmul_bitplane(codec.parity_block, to_tensor(data, device), 4)

    def dispatch(fn, host):
        staged = plan.stage_segment(host, cols, device)
        out = fn(staged)[:, :cols].cpu()
        plan.release(staged)
        return out.numpy()

    dispatches = 0
    for _ in range(3):
        parity = dispatch(codec.encode, data)
        dispatches += 1
        if not np.array_equal(parity, want.cpu().numpy()):
            raise AssertionError(f"5m {what}: the parity differs from K1's plain version")
    rows = list(range(4, 14))
    dec = codec.decode_matrix(rows)
    chunks = np.concatenate([data, parity])[rows]
    for _ in range(3):
        dispatches += 1
        if not np.array_equal(dispatch(lambda st: codec.decode(dec, st), chunks), data):
            raise AssertionError(f"5m {what}: the decode with the first 4 natives lost differs from the data")
    delta = data ^ np.roll(data, 1, axis=1)
    dispatches += 1
    if not np.array_equal(dispatch(lambda st: codec.update(codec.parity_block, st), delta),
                          gf_matmul_bitplane(codec.parity_block, to_tensor(delta, device), 4).cpu().numpy()):
        raise AssertionError(f"5m {what}: the update differs from K1's plain version")
    wall = time.perf_counter() - t0
    runs = _counts()
    replayed = cuda_gemm.REPLAYED if kernel == "K1" else cuda_planes.REPLAYED["w4"]
    others = {name: n for name, n in runs.items() if name != kernel and n}
    if codec.strategy != "cuda" or runs[kernel] < dispatches or replayed <= 0 or others:
        raise AssertionError(f"5m {what}: strategy {codec.strategy}, runs {runs}, {replayed} inside replays, "
                             f"{dispatches} dispatches")
    res = dict(op=what, wall_s=wall, dispatches=dispatches, runs=runs, replayed=replayed, plan=_plan_delta(plan0),
               strategy=codec.strategy, cols=cols)
    log(phase="knobs", step=what, **res)
    return res


def _knob_archive(path: str, what: str, cuda_digests: dict, res: dict) -> None:
    if archive_digests(path, 14) != cuda_digests:
        raise AssertionError(f"5m {what}: the archive differs from phase 4's K1 archive")
    res["archive_equals_k1"] = True


def _clean_archive(path: str, n: int = 14) -> None:
    """Remove an archive of ``path``, its conf and its decoded output."""
    d, base = os.path.split(path)
    names = [chunk_file_name(path, i) for i in range(n)] + [path + ".METADATA", path + ".out",
                                                            os.path.join(d, f"conf-{n}-{n - 4}-{base}")]
    for name in names:
        if os.path.exists(name):
            os.unlink(name)


def _cli_w16_cuda(d: str, seed: int, size: int) -> None:
    """A w=16 round trip with --checksum through the CLI under --strategy
    cuda: encode, the first 4 chunks lost, decode, the bytes compared."""
    path = os.path.join(d, "wide.bin")
    data = np.random.default_rng(seed).bytes(size)
    with open(path, "wb") as fp:
        fp.write(data)
    flags = ["--device", "cuda", "--strategy", "cuda", "--quiet"]
    if cli.main(["-k", "10", "-n", "14", "-e", path, "--width", "16", "--checksum", *flags]) != 0:
        raise AssertionError("5m: the w=16 CLI encode failed")
    for i in range(4):
        os.unlink(chunk_file_name(path, i))
    if cli.main(["-d", "-i", path, "-c", make_conf(14, 10, path), "-o", path + ".out", *flags]) != 0:
        raise AssertionError("5m: the w=16 CLI decode failed")
    with open(path + ".out", "rb") as fp:
        if fp.read() != data:
            raise AssertionError("5m: the w=16 CLI round trip changed the bytes")


@_named("5m pallas knobs")
def phase_knobs(work: str, device, cuda_digests: dict) -> dict:
    """Phase 5m: the RS_PALLAS_* knobs on the main path (see the module
    doc).  The environment is restored and the plan and autotune caches
    cleared after it, so that later phases run K1 as before."""
    from gpu_rscode_torch.obs import metrics

    t_phase = time.perf_counter()
    k, n = 10, 14
    d = os.path.join(work, "knobs")
    os.makedirs(d)
    path = os.path.join(d, "main.bin")
    want = write_seeded(path, SEED, MAIN_FILE_BYTES)
    saved = {var: os.environ.pop(var, None) for var in cuda_gemm.KNOBS}
    forced = metrics.forced()
    res = {}
    try:
        plan.PLAN_CACHE.clear()
        metrics.force_enable()
        metrics.REGISTRY.reset()
        # (a) encode and decode under shift_raw + autotune (K3 at w=8, graphs).
        os.environ.update(RS_PALLAS_EXPAND="shift_raw", RS_PALLAS_REFOLD="autotune")
        enc = _knob_step("encode k=10 n=14 shift_raw+autotune",
                         lambda: api.encode_file(path, k, n - k, strategy="cuda", device=device), MAIN_FILE_BYTES)
        _knob_archive(path, "shift_raw+autotune encode", cuda_digests, enc)
        for i in range(n - k):
            os.unlink(chunk_file_name(path, i))
        conf = make_conf(n, k, path)
        dec = _knob_step("decode 4 lost shift_raw+autotune",
                         lambda: api.decode_file(path, conf, path + ".out", strategy="cuda", device=device), MAIN_FILE_BYTES)
        if sha256_file(path + ".out") != want:
            raise AssertionError("5m: the shift_raw+autotune decode differs from the input")
        plans = [p for p in plan.PLAN_CACHE.stats()["plans"] if p["strategy"] == "cuda"]
        decisions = cuda_gemm.autotune_decisions()
        snap = metrics.REGISTRY.snapshot()
        for step in (enc, dec):
            k3 = step["runs"]["K3-planes-dot"] + step["runs"]["K3-planes-sum"]
            replayed = step["k3_replayed"]["dot"] + step["k3_replayed"]["sum"]
            if k3 < step["stream_dispatches"] or replayed <= 0 or step["plan"]["replays"] <= 0:
                raise AssertionError(f"5m {step['op']}: K3 runs {k3}, inside replays {replayed}, "
                                     f"{step['stream_dispatches']} dispatches, plan {step['plan']}")
        pinned = [p for p in plans if p["captures"] or p["calls"] > 1]
        if not decisions or not pinned or any(p["refold"] not in ("sum", "dot") for p in pinned):
            raise AssertionError(f"5m: autotune decisions {decisions}, plans' refolds {[p['refold'] for p in plans]}")
        res["w8"] = dict(encode=enc, decode=dec, decisions={repr(key): v for key, v in decisions.items()},
                         plans_refold=sorted({p["refold"] for p in plans}),
                         autotune_total=snap.get("rs_pallas_autotune_total", {}).get("values"),
                         refold_total=snap.get("rs_pallas_refold_total", {}).get("values"))
        log(phase="knobs", step="w8 shift_raw+autotune", sha256_match=True, **res["w8"])
        _clean_archive(path)

        # (b) the stripe mesh under shift_raw: K3's pre-parity form.  A plan
        # pins its formulation when it is built: each step starts from an
        # empty plan cache.
        os.environ.pop("RS_PALLAS_REFOLD")
        plan.PLAN_CACHE.clear()
        from gpu_rscode_torch.parallel.mesh import Mesh

        stripe_mesh = Mesh([[device]] * 2)
        stripe = _knob_step("stripe encode (2, 1) mesh shift_raw",
                            lambda: api.encode_file(path, k, n - k, strategy="cuda", device=device, mesh=stripe_mesh,
                                                    stripe_sharded=True), MAIN_FILE_BYTES)
        _knob_archive(path, "stripe encode", cuda_digests, stripe)
        if stripe["runs"]["K3-planes-preparity"] <= 0 or stripe["runs"]["K3-planes-preparity-w4-w16"]:
            raise AssertionError(f"5m stripe encode: gf_planes_none_kernel did not run alone: {stripe['runs']}")
        res["stripe"] = stripe
        log(phase="knobs", step="stripe shift_raw pre-parity", **stripe)
        _clean_archive(path)

        # (b') a w=16 file on the same mesh under shift_raw: the none
        # kernel at w=16, its archive against K1's of the same file.
        os.environ.pop("RS_PALLAS_EXPAND")
        plan.PLAN_CACHE.clear()
        wide = os.path.join(d, "wide16.bin")
        write_seeded(wide, SEED + 18, KNOBS_W16_BYTES)
        api.encode_file(wide, k, n - k, strategy="cuda", device=device, w=16)
        k1_wide = archive_digests(wide, n)
        _clean_archive(wide)
        os.environ["RS_PALLAS_EXPAND"] = "shift_raw"
        plan.PLAN_CACHE.clear()
        stripe16 = _knob_step("stripe encode (2, 1) mesh w=16 shift_raw",
                              lambda: api.encode_file(wide, k, n - k, strategy="cuda", device=device, mesh=stripe_mesh,
                                                      stripe_sharded=True, w=16), KNOBS_W16_BYTES)
        if archive_digests(wide, n) != k1_wide:
            raise AssertionError("5m: the w=16 stripe archive under shift_raw differs from K1's archive of the same file")
        stripe16["archive_equals_k1"] = True
        if stripe16["runs"]["K3-planes-preparity-w4-w16"] <= 0 or stripe16["runs"]["K3-planes-preparity"]:
            raise AssertionError(f"5m w=16 stripe encode: the none kernel at w=16 did not run alone: {stripe16['runs']}")
        res["stripe16"] = stripe16
        log(phase="knobs", step="stripe w=16 shift_raw pre-parity", **stripe16)
        _clean_archive(wide)
        os.unlink(wide)

        # (c) pack2: K2 captured into the plans' graphs.
        os.environ["RS_PALLAS_EXPAND"] = "pack2"
        plan.PLAN_CACHE.clear()
        pack2 = _knob_step("encode k=10 n=14 pack2",
                           lambda: api.encode_file(path, k, n - k, strategy="cuda", device=device), MAIN_FILE_BYTES)
        _knob_archive(path, "pack2 encode", cuda_digests, pack2)
        if pack2["runs"]["K2"] < pack2["stream_dispatches"] or pack2["k2_replayed"] <= 0:
            raise AssertionError(f"5m pack2 encode: K2 runs {pack2['runs']['K2']}, inside replays "
                                 f"{pack2['k2_replayed']}, {pack2['stream_dispatches']} dispatches")
        res["pack2"] = pack2
        log(phase="knobs", step="pack2", **pack2)
        shutil.rmtree(d)
        os.environ.pop("RS_PALLAS_EXPAND")

        # (d) a w=16 CLI round trip under autotune alone.
        os.environ["RS_PALLAS_REFOLD"] = "autotune"
        plan.PLAN_CACHE.clear()
        os.makedirs(d)
        w16 = _knob_step("CLI w=16 round trip autotune", lambda: _cli_w16_cuda(d, SEED + 15, KNOBS_W16_BYTES),
                         2 * KNOBS_W16_BYTES)
        if (w16["runs"]["K3-planes-w16"] <= 0 or w16["k3_replayed"]["w16"] <= 0
                or w16["runs"]["K3-planes-preparity-w4-w16"] or w16["runs"]["K3-planes-w4"]):
            raise AssertionError(f"5m w=16: the sum and dot kernels at w=16 ran {w16['runs']['K3-planes-w16']} times, "
                                 f"{w16['k3_replayed']['w16']} inside replays; every kernel's runs {w16['runs']}")
        w16["decisions"] = sorted(set(cuda_gemm.autotune_decisions().values()))
        w16["plans_refold"] = sorted({str(p["refold"]) for p in plan.PLAN_CACHE.stats()["plans"] if p["w"] == 16})
        res["w16"] = w16
        log(phase="knobs", step="w16 autotune", **w16)
        os.environ.pop("RS_PALLAS_REFOLD")

        # (e) RSCodec at w=4 on staged segments: K1, then K3 at W=4.
        plan.PLAN_CACHE.clear()
        res["w4_k1"] = _codec_w4_step("RSCodec w=4 round trip (K1)", device, SEED + 16, "K1")
        os.environ["RS_PALLAS_EXPAND"] = "shift_raw"
        plan.PLAN_CACHE.clear()
        res["w4_k3"] = _codec_w4_step("RSCodec w=4 round trip shift_raw (K3 W=4 sum)", device, SEED + 16,
                                      "K3-planes-w4")
        # ... and under RS_PALLAS_REFOLD=dot: the dot kernel at W=4.
        os.environ["RS_PALLAS_REFOLD"] = "dot"
        plan.PLAN_CACHE.clear()
        res["w4_k3_dot"] = _codec_w4_step("RSCodec w=4 round trip shift_raw+dot (K3 W=4 dot)", device, SEED + 16,
                                          "K3-planes-w4")
        w4_refolds = sorted({str(p["refold"]) for p in plan.PLAN_CACHE.stats()["plans"]
                             if p["w"] == 4 and (p["captures"] or p["calls"] > 1)})  # pinned plans
        if w4_refolds != ["dot"]:
            raise AssertionError(f"5m w=4 under RS_PALLAS_REFOLD=dot: the plans' refolds {w4_refolds}")
        res["w4_k3_dot"]["plans_refold"] = w4_refolds
        os.environ.pop("RS_PALLAS_REFOLD")

        # (f) 256 MiB at w=8 under shift_raw alone: the dot refold's kernel,
        # against K1's archive of the same file.
        os.environ.pop("RS_PALLAS_EXPAND")
        plan.PLAN_CACHE.clear()
        path = os.path.join(d, "dot.bin")
        want = write_seeded(path, SEED + 17, KNOBS_DOT_BYTES)
        api.encode_file(path, k, n - k, strategy="cuda", device=device)
        k1_digests = archive_digests(path, n)
        _clean_archive(path)
        os.environ["RS_PALLAS_EXPAND"] = "shift_raw"
        plan.PLAN_CACHE.clear()
        dot_enc = _knob_step("encode 256 MiB k=10 n=14 shift_raw (dot)",
                             lambda: api.encode_file(path, k, n - k, strategy="cuda", device=device), KNOBS_DOT_BYTES)
        if archive_digests(path, n) != k1_digests:
            raise AssertionError("5m: the shift_raw+dot archive differs from K1's archive of the same file")
        dot_enc["archive_equals_k1"] = True
        for i in range(n - k):
            os.unlink(chunk_file_name(path, i))
        conf = make_conf(n, k, path)
        dot_dec = _knob_step("decode 256 MiB 4 lost shift_raw (dot)",
                             lambda: api.decode_file(path, conf, path + ".out", strategy="cuda", device=device),
                             KNOBS_DOT_BYTES)
        if sha256_file(path + ".out") != want:
            raise AssertionError("5m: the shift_raw+dot decode differs from the input")
        for step in (dot_enc, dot_dec):
            if step["runs"]["K3-planes-dot"] < step["stream_dispatches"] or step["k3_replayed"]["dot"] <= 0:
                raise AssertionError(f"5m {step['op']}: the dot kernel ran {step['runs']['K3-planes-dot']} times, "
                                     f"{step['k3_replayed']['dot']} inside replays, {step['stream_dispatches']} "
                                     "dispatches")
        res["dot"] = dict(encode=dot_enc, decode=dot_dec)
        log(phase="knobs", step="w8 shift_raw dot", sha256_match=True, **res["dot"])

        # (g) the same file under RS_PALLAS_EXPAND=nibble: the encode through
        # nibble+dot (w=8's default refold), the decode under
        # RS_PALLAS_REFOLD=sum through nibble+sum.
        _clean_archive(path)
        os.environ["RS_PALLAS_EXPAND"] = "nibble"
        plan.PLAN_CACHE.clear()
        nib_enc = _knob_step("encode 256 MiB k=10 n=14 nibble (dot)",
                             lambda: api.encode_file(path, k, n - k, strategy="cuda", device=device), KNOBS_DOT_BYTES)
        if archive_digests(path, n) != k1_digests:
            raise AssertionError("5m: the nibble+dot archive differs from K1's archive of the same file")
        nib_enc["archive_equals_k1"] = True
        for i in range(n - k):
            os.unlink(chunk_file_name(path, i))
        conf = make_conf(n, k, path)
        os.environ["RS_PALLAS_REFOLD"] = "sum"
        plan.PLAN_CACHE.clear()
        nib_dec = _knob_step("decode 256 MiB 4 lost nibble+sum",
                             lambda: api.decode_file(path, conf, path + ".out", strategy="cuda", device=device),
                             KNOBS_DOT_BYTES)
        if sha256_file(path + ".out") != want:
            raise AssertionError("5m: the nibble+sum decode differs from the input")
        for step, name, kind in ((nib_enc, "K3-planes-dot", "dot"), (nib_dec, "K3-planes-sum", "sum")):
            if step["runs"][name] < step["stream_dispatches"] or step["k3_replayed"][kind] <= 0:
                raise AssertionError(f"5m {step['op']}: {name} ran {step['runs'][name]} times, "
                                     f"{step['k3_replayed'][kind]} inside replays, {step['stream_dispatches']} "
                                     "dispatches")
        res["nibble"] = dict(encode=nib_enc, decode=nib_dec)
        log(phase="knobs", step="w8 nibble dot / sum", sha256_match=True, **res["nibble"])
    finally:
        for var, val in saved.items():
            os.environ.pop(var, None)
            if val is not None:
                os.environ[var] = val
        plan.PLAN_CACHE.clear()
        metrics.force_enable(forced)
        metrics.REGISTRY.reset()
        if os.path.isdir(d):
            shutil.rmtree(d)
    steps = (res["w8"]["encode"], res["w8"]["decode"], res["stripe"], res["stripe16"], res["pack2"], res["w16"],
             res["w4_k1"], res["w4_k3"], res["w4_k3_dot"], res["dot"]["encode"], res["dot"]["decode"],
             res["nibble"]["encode"], res["nibble"]["decode"])
    res["launches"] = {name: sum(step["runs"][name] for step in steps) for name in ("K1", "K2", *K3_KINDS)}
    res["walls"] = {step["op"]: step["wall_s"] for step in steps}
    res["seconds"] = time.perf_counter() - t_phase
    log(phase="knobs_summary", seconds=res["seconds"], launches=res["launches"], walls=res["walls"], smi=smi_line())
    return res


def _store_shapes(calls) -> dict:
    """The store's K1 shapes from the GEMM log: the 64-object batches' E·Δ
    (appends to an open stripe), the 1,000 x 4 KiB batch's E·Δ, the
    degraded GETs' window recoveries and the fresh stripes' encodes, each
    with its count and its columns (median, least, most)."""
    out = {}
    for label, tag, method in (("put_64_update", "put_64", "update"), ("put_1000_update", "put_1000x4KiB", "update"),
                               ("degraded_window", "get_degraded", "decode"), ("put_64_encode", "put_64", "encode"),
                               ("compact_update", "compact", "update"), ("compact_encode", "compact", "encode"),
                               ("delete_update", "delete", "update")):
        hits = [(r, d, c) for t, m, r, d, c in calls if t == tag and m == method]
        cols = sorted(c for _, _, c in hits)
        out[label] = {"count": len(hits), "rows": hits[0][0] if hits else None, "depth": hits[0][1] if hits else None,
                      "median_cols": cols[len(cols) // 2] if cols else None,
                      "min_cols": cols[0] if cols else None, "max_cols": cols[-1] if cols else None}
    return out


def log_store_share(store_res: dict, timings: list[dict]) -> None:
    """K1's share of phase 5f's wall at the three store shapes phase 6
    timed: launches at each shape times its time there, over the phase's
    seconds (the stripe encodes, DELETE's and compaction's E·Δ are not
    timed at their own shapes and are left out)."""
    ms = {row["shape"]: row["ms"] for row in timings}
    shapes = store_res["gemm_shapes"]
    parts = {key: shapes[key]["count"] * ms[label] * 1e-3 for key, label in (
        ("put_64_update", "store PUT batch E·Δ k=4 p=2 (64 objects)"),
        ("put_1000_update", "store PUT 1,000 x 4 KiB E·Δ k=4 p=2"),
        ("degraded_window", "store degraded GET window k=4 (4 rows)")) if label in ms}
    log(phase="store_compute_share", k1_seconds=parts, phase_seconds=store_res["seconds"],
        share=sum(parts.values()) / store_res["seconds"])


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
        entry("K1 gf_gemm (bit-sliced GF(2^w) GEMM, w=4, 8, 16; pre-parity: popcount)",
              "gpu_rscode_torch/ops/csrc/gf_gemm.cu", "gpu_rscode_tpu/ops/pallas_gemm.py:307", main_launches, k1_err,
              k1_timing),
        entry("K2 gf_pack2 (packed two-column GF(2^8) GEMM)", "gpu_rscode_torch/ops/csrc/gf_pack2.cu",
              "gpu_rscode_tpu/ops/pallas_gemm.py:256", tl.get("K2"), grids["K2"].worst, t.get("pack2")),
        entry("K3 gf_planes_sum (bit-plane GEMM, sum refold of every w=8 expansion, scaled u8 mma, nibble's "
              "planes from PRMT tables; timed: shift+sum)",
              "gpu_rscode_torch/ops/csrc/gf_planes.cu", "gpu_rscode_tpu/tools/kernel_sweep.py:39",
              tl.get("K3-planes-sum"), grids["K3-planes-sum"].worst, t.get("shift+sum")),
        entry("K3 gf_planes_dot (bit-plane GEMM, dot refold of every w=8 expansion: planes x scaled operator, then "
              "the masked bits x 0/1 F, both u8 mma; timed: shift_raw+dot)",
              "gpu_rscode_torch/ops/csrc/gf_planes.cu", "gpu_rscode_tpu/tools/kernel_sweep.py:122",
              tl.get("K3-planes-dot"), grids["K3-planes-dot"].worst, t.get("shift_raw+dot")),
        entry("K3 copy_floor (the copy floor, K1's traffic)", "gpu_rscode_torch/ops/csrc/gf_planes.cu",
              "gpu_rscode_tpu/tools/kernel_sweep.py:73", tl.get("K3-copy-floor"), grids["K3-copy-floor"].worst,
              t.get("copy_floor")),
        entry("K3 gf_planes_sum_kernel and gf_planes_dot_kernel at w=16 (shift, shift_raw, sign x sum, dot: a symbol "
              "as two byte-symbols, w=8's plane words and refolds; timed: shift_raw+sum)",
              "gpu_rscode_torch/ops/csrc/gf_planes.cu", "gpu_rscode_tpu/ops/pallas_gemm.py:307", tl.get("K3-planes-w16"),
              grids["K3-planes-w16"].worst, t.get("w16 shift_raw+sum")),
        entry("K3 gf_planes_none_kernel (the pre-parity form at w=8, every expansion: exact planes, int32 sums "
              "staged through shared memory; timed: shift_raw+none)",
              "gpu_rscode_torch/ops/csrc/gf_planes.cu", "gpu_rscode_tpu/ops/pallas_gemm.py:307",
              tl.get("K3-planes-preparity"), grids["K3-planes-preparity"].worst, t.get("shift_raw+none")),
        entry("K3 gf_planes_sum_kernel and gf_planes_dot_kernel at w=4 (shift, shift_raw x sum, dot: 8 symbols a "
              "32-deep chunk, the last m-tile alone where it has no pair; timed: w4 shift_raw+sum)",
              "gpu_rscode_torch/ops/csrc/gf_planes.cu", "gpu_rscode_tpu/ops/pallas_gemm.py:307", tl.get("K3-planes-w4"),
              grids["K3-planes-w4"].worst, t.get("w4 shift_raw+sum")),
        entry("K3 gf_planes_none_kernel at w=4 and w=16 (the pre-parity form: shift, shift_raw at w=4; shift, "
              "shift_raw, sign at w=16, two byte-symbols a symbol; timed: w16 shift_raw+none)",
              "gpu_rscode_torch/ops/csrc/gf_planes.cu", "gpu_rscode_tpu/ops/pallas_gemm.py:307",
              tl.get("K3-planes-preparity-w4-w16"), grids["K3-planes-preparity-w4-w16"].worst,
              t.get("w16 shift_raw+none")),
    ]


def ptxas_kernels(ptxas: str) -> list[dict]:
    """Registers and spilled bytes of each kernel instance in ``-Xptxas=-v``
    output, named ``gf_bitslice_kernel<w,rt>`` / ``gf_popcount_kernel<w,nw,cpt>`` /
    ``gf_pack2_kernel<1>`` (1: operator in shared memory, 0: read from device
    memory) / ``gf_planes_sum_kernel<w,expand,src>`` (and the dot and none
    kernels')."""
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


@_named("2 build")
def phase_build() -> None:
    """The three kernel libraries (one nvcc each) and the native IO and GEMM
    libraries (g++), all at once."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        host_io = pool.submit(native.library_path)
        host_gemm = pool.submit(native.gemm_library_path)
        _build.build_many(LIBS)
        host_io.result()
        host_gemm.result()
    wall = time.perf_counter() - t0
    for name in LIBS:
        ptxas = _build.BUILD_LOG.get(name, "")
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", ptxas)]
        spills = sorted({int(b) for b in re.findall(r"(\d+) bytes spill stores", ptxas)})
        log(phase="build", library=name, nvcc_seconds=_build.BUILD_SECONDS.get(name), kernels=len(regs),
            max_registers=max(regs, default=None), spill_store_bytes=spills)
        per_kernel = ptxas_kernels(ptxas)
        log(phase="build", library=name, per_kernel=per_kernel)
        if name == "gf_planes":
            # gf_planes_sum_kernel, gf_planes_dot_kernel and
            # gf_planes_none_kernel<w, expand, src>, with their spills.
            new = [row for row in per_kernel if re.search(r"gf_planes_(dot|sum|none)_kernel", row["kernel"])]
            log(phase="build", library=name, new_instances=new,
                spilling=[row["kernel"] for row in new if row["spill_store_bytes"]])
    for name, lib_path in (("rs_native_io", native.library_path), ("rs_native_gemm", native.gemm_library_path)):
        log(phase="build", library=name, gxx_seconds=_build.BUILD_SECONDS.get(name),
            path=os.path.relpath(lib_path(), REPO))
    log(phase="build", parallel_wall_seconds=wall)
    cuda_gemm._lib(), cuda_pack2._lib(), cuda_planes._lib()
    native.get_lib()  # raises NativeUnavailable: the card run must not take the fallback
    native.get_gemm_lib()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--quick", action="store_true", help="build and kernel-vs-plain grids only")
    args = ap.parse_args()
    try:
        return run(args)
    except BaseException as e:
        log(phase="failed", at=" > ".join(AT) or None, last_logged=dict(LAST_LOGGED),
            error=f"{type(e).__name__}: {e}")
        raise


def run(args) -> int:
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
    phase_strategies_grid(device)
    if args.quick:
        kernels = kernel_entries(k1_err, grids)
    else:
        work_root = os.path.join(REPO, "build", "chip_smoke")
        os.makedirs(work_root, exist_ok=True)
        work = tempfile.mkdtemp(dir=work_root)
        try:
            main_res, cuda_digests, main_file, main_sha = phase_main_path(work, SEED, MAIN_FILE_BYTES)
            t_5e = time.perf_counter()
            plan_res = {"main": phase_plan_main(main_file, main_sha, cuda_digests)}
            plan_res["seconds"] = time.perf_counter() - t_5e
            t_5d = time.perf_counter()
            strategies = phase_strategies_main(main_file, main_sha, cuda_digests)
            for strategy in STRATEGIES:
                strategies[f"cli_w16_{strategy}"] = phase_cli_w16(work, SEED + 1, 64 * MiB, strategy)
            strategies["seconds"] = time.perf_counter() - t_5d
            phase_cli_w16(work, SEED + 1, 64 * MiB)
            phase_fleet_and_cli(work, SEED + 3, 128 * MiB)
            phase_short_segments(work, SEED + 4, 16 * MiB)
            resilience = phase_resilience(work, SEED + 5, MAIN_FILE_BYTES, device)
            updates = phase_updates(work, SEED + 6, MAIN_FILE_BYTES, device)
            t_5d = time.perf_counter()
            strategies["timings"] = phase_strategies_timings(device, work)
            strategies["timings_seconds"] = time.perf_counter() - t_5d
            t_5e = time.perf_counter()
            plan_res["ragged"] = phase_plan_ragged(work, SEED + 7)
            plan_res["dispatch"] = phase_plan_dispatch(device)
            plan_res["tune"] = phase_tune(device, work)
            plan_res["seconds"] += time.perf_counter() - t_5e
            # After the plan phases: the store's many window widths fill the
            # plan cache, and phase 5e reads its counts as deltas.
            t_5f = time.perf_counter()
            store_res = phase_store(work, SEED + 8)
            store_res["seconds"] = time.perf_counter() - t_5f
            serve_res = phase_serve(work, SEED + 9, device)
            faults_res = phase_faults_maint(work, SEED + 10, device)
            measure_res = phase_measurement(work, SEED + 11, device)
            mesh_res = phase_mesh(work, SEED + 12, device, cuda_digests)
            knobs_res = phase_knobs(work, device, cuda_digests)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        log(phase="strategies_summary", main_and_cli_seconds=strategies["seconds"],
            timings_seconds=strategies["timings_seconds"], locate_xor_seconds=resilience["locate_xor_seconds"],
            update_xor_seconds=updates["update_xor"]["seconds"])
        log(phase="plan_summary", seconds=plan_res["seconds"], cache=plan.PLAN_CACHE.stats()["staging"],
            plans=plan.PLAN_CACHE.stats()["executables"], tune_winner=plan_res["tune"]["winner"],
            peak_device_gib=torch.cuda.max_memory_allocated(device) / (1 << 30))
        log(phase="store_summary", seconds=store_res["seconds"], k1_launches=store_res["k1_launches"],
            shapes=store_res["gemm_shapes"])
        timings = phase_timings(device, updates["group_stacked_cols"], store_res["gemm_shapes"])
        log_compute_share(main_res, timings)
        log_store_share(store_res, timings)
        tools = phase_tools()
        work = tempfile.mkdtemp(dir=work_root)
        try:
            tools_5k = phase_tools_5k(work, SEED + 13, device)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        work = tempfile.mkdtemp(dir=work_root)
        try:
            tools_5l = phase_tools_5l(work)
        finally:
            shutil.rmtree(work, ignore_errors=True)
        new_timings = phase_new_timings(device)
        path_launches = {name: tools["launches"].get(name, 0) + knobs_res["launches"].get(name, 0)
                         for name in ("K2", *K3_KINDS)}
        idle = sorted(name for name, n in path_launches.items() if n <= 0)
        if idle:
            raise AssertionError(f"kernels the path never launched: {idle} ({path_launches})")
        kernels = kernel_entries(k1_err, grids, timings[0],
                                 main_res["pipelined"]["launches"] + resilience["k1_launches"]
                                 + updates["k1_launches"] + store_res["k1_launches"] + serve_res["k1_launches"]
                                 + faults_res["k1_launches"] + measure_res["k1_launches"]
                                 + mesh_res["k1_launches"] + tools_5k["k1_launches"]
                                 + tools_5l["k1_launches"] + knobs_res["launches"]["K1"],
                                 new_timings,
                                 path_launches)
    log(phase="wall", seconds=time.perf_counter() - t_start, quick=args.quick)
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
