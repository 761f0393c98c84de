"""End-to-end file encode and decode: the counterpart of the JAX package's
``tools/stream_bench.py`` (the reference's total-time study,
design.tex:477-500, BASELINE.md).

Writes a seeded ``--mb`` MB file, encodes it with ``api.encode_file``
(k, p, ``--strategy``, ``--seg-mb`` segments, ``--depth`` segments in
flight: the reference's ``-s``), erases the first p chunks (the worst
case: every stripe needs real recovery), decodes it with
``api.decode_file`` and reports file GB/s each way with the ``PhaseTimer``
split.  Before any rate is printed, the parity chunks are checked against
the GF oracle (``GaloisField.matmul`` of the natives) on columns spread
over every segment, and the decoded file's SHA-256 against the input's; a
mismatch ends the tool.

After the capture header, one JSON line with the JAX tool's keys
(``metric``, ``unit``, ``file_mb``, ``depth``, ``strategy``,
``encode_gbps``, ``decode_gbps``, ``bit_exact``) and each op's phase
seconds (``encode_phases_s``, ``decode_phases_s``); the phase tables go to
stderr.  ``--strategy`` defaults to ``cuda`` (the JAX tool's ``pallas``).

Usage: python -m gpu_rscode_torch.tools.stream_bench [--mb 256] [--k 10]
       [--p 4] [--depth 2] [--strategy cuda] [--seg-mb 64] [--dir D]
       [--device cuda]
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

from ..api import decode_file, encode_file
from ..obs.runlog import capture_header
from ..ops.gf import get_field
from ..utils.backend import resolve_device
from ..utils.fileformat import chunk_file_name, read_archive_meta, write_conf
from ..utils.timing import PhaseTimer
from ._check import sample_columns


def _digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as fp:
        while block := fp.read(1 << 24):
            h.update(block)
    return h.hexdigest()


def check_parity(path: str, seg_cols: int) -> int:
    """Raise unless the archive's parity chunks equal the GF oracle's
    product of its natives on the first and last column of every segment
    and random columns; returns the columns checked."""
    meta = read_archive_meta(path + ".METADATA")
    k, p = meta.native_num, meta.parity_num
    rows = [np.memmap(chunk_file_name(path, i), dtype=np.uint8, mode="r") for i in range(k + p)]
    cols = sample_columns(meta.chunk, [seg_cols])
    natives = np.stack([r[cols] for r in rows[:k]])
    want = get_field(8).matmul(meta.total_mat[k:].astype(np.uint8), natives)
    if not np.array_equal(np.stack([r[cols] for r in rows[k:]]), want):
        raise AssertionError(f"{path}: parity differs from the GF oracle on the checked columns")
    return len(cols)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mb", type=int, default=256, help="file size MB")
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--depth", type=int, default=2, help="pipeline depth (-s)")
    ap.add_argument("--strategy", default="cuda")
    ap.add_argument("--seg-mb", type=int, default=64, help="segment MB")
    ap.add_argument("--dir", default=None, help="work dir (default: tmpdir)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(json.dumps(capture_header("stream_bench")), flush=True)
    k, p = args.k, args.p
    size = args.mb * 1024 * 1024
    segment_bytes = args.seg_mb * 1024 * 1024
    common = dict(strategy=args.strategy, device=device, segment_bytes=segment_bytes, pipeline_depth=args.depth)
    with tempfile.TemporaryDirectory(dir=args.dir) as td:
        path = os.path.join(td, "payload.bin")
        rng = np.random.default_rng(7)
        with open(path, "wb") as fp:
            left = size
            while left:
                step = min(left, 64 * 1024 * 1024)
                fp.write(rng.integers(0, 256, step, dtype=np.uint8).tobytes())
                left -= step
        digest_src = _digest(path)

        enc_timer = PhaseTimer()
        t0 = time.perf_counter()
        encode_file(path, k, p, timer=enc_timer, **common)
        enc_wall = time.perf_counter() - t0
        print(f"encode ({args.mb} MB, k={k}, p={p}, depth={args.depth}):\n{enc_timer.summary(size)}",
              file=sys.stderr, flush=True)
        check_parity(path, max(1, segment_bytes // k))

        # Worst-case erasure: drop the first p chunks (the reference's
        # unit-test.sh pattern) so every stripe needs real recovery.
        conf = os.path.join(td, "conf")
        write_conf(conf, [chunk_file_name(path, i) for i in range(p, p + k)])
        for i in range(p):
            os.remove(chunk_file_name(path, i))
        out = os.path.join(td, "recovered.bin")
        dec_timer = PhaseTimer()
        t0 = time.perf_counter()
        decode_file(path, conf, out, timer=dec_timer, **common)
        dec_wall = time.perf_counter() - t0
        print(f"decode (worst-case {p}-erasure):\n{dec_timer.summary(size)}", file=sys.stderr, flush=True)
        if _digest(out) != digest_src:
            raise AssertionError("stream_bench: the decoded file's SHA-256 differs from the input's")

    print(json.dumps({
        "metric": f"stream_file_k{k}_n{k + p}_{device.type}",
        "unit": "GB/s",
        "file_mb": args.mb,
        "depth": args.depth,
        "strategy": args.strategy,
        "encode_gbps": size / enc_wall / 1e9,
        "decode_gbps": size / dec_wall / 1e9,
        "bit_exact": True,
        "encode_phases_s": dict(enc_timer.acc),
        "decode_phases_s": dict(dec_timer.acc),
    }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
