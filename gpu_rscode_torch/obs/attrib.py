"""Roofline attribution per strategy: ``rs analyze``.

The counterpart of the JAX package's ``obs/attrib.py``: the same report
schema, cost model and verdicts.

* **Cost**: :func:`analytic_cost`, the textbook GF-GEMM cost of one
  dispatch (one multiply and one XOR a term, operands read once, output
  written once).  The JAX package reads XLA's cost analysis off its AOT
  executables where one exists; the port's plans are CUDA graphs and
  eager calls with no such analysis, so every row's ``cost_source`` is
  ``analytic``, as the JAX package's is on a backend without one.
* **Machine roofline**: :func:`get_roofline` calibrates the device the
  workload runs on: for a CPU caller the JAX package's NumPy triad and
  512 x 512 GEMM; on the card a device triad over three arrays far past
  the 50 MB L2 (256 MiB each) and an fp32 ``torch.matmul`` at 4096 x 4096,
  both timed with CUDA events, best of ``reps``.  The probe is cached in
  the run ledger as ``kind: "rs_roofline"`` with the host and the device
  it probed (``RS_ROOFLINE_MAX_AGE_S``, default 7 days); a record of
  another device is never reused.
* **Attribution**: :func:`build_report` folds measured walls, dispatch
  counts and the per-dispatch cost into achieved GB/s, GFLOP/s and
  arithmetic intensity per (strategy, op) and classifies each row against
  the roofline: ``memory``, ``compute`` or ``dispatch`` (neither roof is
  approached).  One report has one roofline: on the card the ``native``
  row (the host codec) is classified against the card's roofline too.
* **Memory hooks**: :func:`sample_device_memory` samples the card's
  allocator into ``rs_device_mem_bytes{kind,device}`` at segment
  boundaries (``api._dispatch_span``).

Import cost: the standard library; numpy, torch and the api load inside
the functions that need them.
"""

from __future__ import annotations

import json
import os
import socket
import sys
import time

from . import metrics as _metrics, runlog as _runlog

SCHEMA_VERSION = 1

_DEFAULT_ROOFLINE_MAX_AGE_S = 7 * 86400.0

# A row "approaches a roof" at this fraction of the calibrated peak; below
# it on both roofs the time went to per-dispatch overhead.
BOUND_THRESHOLD = 0.33

# The card's triad arrays: each well past the H100's 50 MB L2, so the
# probe reads and writes HBM.
_DEVICE_TRIAD_BYTES = 256 << 20
_DEVICE_GEMM_DIM = 4096


def analytic_cost(rows_out: int, k: int, cols: int, sym: int = 1) -> dict:
    """Textbook GF-GEMM cost of one (rows_out, k) x (k, cols) dispatch: one
    multiply and one XOR a term, operands read once, output written once."""
    return {
        "flops": 2.0 * rows_out * k * cols,
        "bytes_accessed": float((k * cols + rows_out * cols + rows_out * k) * sym),
    }


# -- machine roofline --------------------------------------------------------


def device_name(device) -> str:
    """The name a roofline record keeps for the device it probed:
    ``torch.cuda.get_device_name`` on the card, ``"cpu"`` for the host."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return device.type


def _measure_host(reps: int) -> tuple[float, float]:
    """The JAX package's host probe: NumPy triad and 512 x 512 GEMM."""
    import numpy as np

    n = 2_000_000  # 16 MB per float64 array
    b = np.random.default_rng(0).random(n)
    c = np.random.default_rng(1).random(n)
    t = np.empty_like(b)
    a = np.empty_like(b)
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        # NumPy cannot fuse the triad: multiply reads c and writes t (2
        # passes), add reads b and t and writes a (3), so 5 passes move.
        np.multiply(c, 0.5, out=t)
        np.add(b, t, out=a)
        best = min(best, time.perf_counter() - t0)
    triad_gbps = 5 * 8 * n / best / 1e9

    dim = 512
    x = np.random.default_rng(2).random((dim, dim), dtype=np.float32)
    y = np.random.default_rng(3).random((dim, dim), dtype=np.float32)
    x @ y  # warm the BLAS path once
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        x @ y
        best = min(best, time.perf_counter() - t0)
    return triad_gbps, 2.0 * dim**3 / best / 1e9


def _event_best(fn, reps: int) -> float:
    """Best device seconds of ``fn()`` over ``reps`` CUDA-event-timed runs
    on the current stream, after one warm-up run."""
    import torch

    fn()
    best = float("inf")
    for _ in range(max(1, reps)):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / 1e3)
    return best


def _measure_card(device, reps: int) -> tuple[float, float]:
    """The card's probe: a fused triad ``a = b + 0.5 c`` over three fp32
    arrays of 256 MiB (reads b and c, writes a: 3 passes) and an fp32
    4096 x 4096 ``torch.matmul``."""
    import torch

    n = _DEVICE_TRIAD_BYTES // 4
    g = torch.Generator(device=device).manual_seed(0)
    b = torch.rand(n, device=device, generator=g)
    c = torch.rand(n, device=device, generator=g)
    a = torch.empty_like(b)
    triad_s = _event_best(lambda: torch.add(b, c, alpha=0.5, out=a), reps)
    del a, b, c
    dim = _DEVICE_GEMM_DIM
    x = torch.rand((dim, dim), device=device, generator=g)
    y = torch.rand((dim, dim), device=device, generator=g)
    gemm_s = _event_best(lambda: torch.matmul(x, y), reps)
    return 3 * _DEVICE_TRIAD_BYTES / triad_s / 1e9, 2.0 * dim**3 / gemm_s / 1e9


def measure_roofline(reps: int = 3, device="cpu") -> dict:
    """Calibrate ``device``: triad GB/s and GEMM GFLOP/s, best of ``reps``."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            triad_gbps, gemm_gflops = _measure_card(device, reps)
    else:
        triad_gbps, gemm_gflops = _measure_host(reps)
    return {
        "triad_gbps": round(triad_gbps, 3),
        "gemm_gflops": round(gemm_gflops, 3),
        "ts": time.time(),
        "host": socket.gethostname(),
        "device": device_name(device),
    }


def roofline_max_age_s() -> float:
    try:
        return float(os.environ.get("RS_ROOFLINE_MAX_AGE_S", _DEFAULT_ROOFLINE_MAX_AGE_S))
    except ValueError:
        return _DEFAULT_ROOFLINE_MAX_AGE_S


def load_cached_roofline(ledger: str | None = None, device="cpu") -> dict | None:
    """The newest ``rs_roofline`` record of THIS host and of ``device``
    (a shared ledger carries every host's, and one host may probe its card
    and its CPU)."""
    p = ledger or _runlog.path()
    if not p or not (os.path.exists(p) or os.path.exists(p + ".1")):
        return None
    host, name = socket.gethostname(), device_name(device)
    for rec in reversed(_runlog.read_records(p)):
        if rec.get("kind") == "rs_roofline" and rec.get("host") == host and rec.get("device") == name:
            return rec
    return None


def get_roofline(ledger: str | None = None, refresh: bool = False, device="cpu") -> dict:
    """The roofline of ``device``: ledger-cached when fresh, else probed
    (and the probe recorded in the ledger when one is configured)."""
    if not refresh:
        cached = load_cached_roofline(ledger, device)
        if cached is not None:
            age = time.time() - float(cached.get("ts") or 0)
            if 0 <= age < roofline_max_age_s() and cached.get("triad_gbps") and cached.get("gemm_gflops"):
                return dict(cached, source="ledger", age_s=round(age, 1))
    probe = measure_roofline(device=device)
    p = ledger or _runlog.path()
    if p:
        _runlog.append(dict(probe, kind="rs_roofline", schema=SCHEMA_VERSION, backend=_runlog.backend_name()),
                       ledger_path=p)
    return dict(probe, source="probe", age_s=0.0)


# -- device memory hooks -----------------------------------------------------

# The JAX package's four memory_stats() kinds.
_MEM_KINDS = ("bytes_in_use", "peak_bytes_in_use", "bytes_limit", "largest_free_block_bytes")

# 1-in-N sampling at segment boundaries: the sampler runs inside the
# dispatch loop, and its cost would land in the walls `rs analyze` reads.
_SAMPLE_EVERY = 8
_sample_tick = [0]


def _card_memory(index: int) -> dict:
    """The four kinds of card ``index``: the caching allocator's current and
    peak allocated bytes, and the driver's total and free bytes."""
    import torch

    stats = torch.cuda.memory_stats(index)
    free, total = torch.cuda.mem_get_info(index)
    return {
        "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
        "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        "bytes_limit": total,
        "largest_free_block_bytes": free,
    }


def sample_device_memory(force: bool = False) -> None:
    """Sample each card's memory into ``rs_device_mem_bytes{kind,device}``
    at a segment boundary.  Throttled to 1 call in ``_SAMPLE_EVERY``
    (``force=True`` bypasses); a no-op unless RS_METRICS is on and this
    process already uses CUDA (it never initialises a device itself)."""
    if not _metrics.enabled():
        return
    if not force:
        _sample_tick[0] = (_sample_tick[0] + 1) % _SAMPLE_EVERY
        if _sample_tick[0] != 1:
            return
    torch = sys.modules.get("torch")
    if torch is None or not torch.cuda.is_initialized():
        return
    gauge = _metrics.gauge("rs_device_mem_bytes", "device memory_stats() sampled at segment boundaries")
    for index in range(torch.cuda.device_count()):
        for kind, v in _card_memory(index).items():
            gauge.labels(kind=kind, device=index).set(int(v))


# -- attribution workload ----------------------------------------------------

# The JAX package's default strategy set ("native" is the analyze
# surface's name for the host codec, strategy="cpu").  ``cuda`` (K1) is
# analyzable where the JAX package has ``pallas``.
DEFAULT_STRATEGIES = ("table", "bitplane", "xor", "ring", "native")

_STRATEGY_ALIASES = {"native": "cpu"}
_ANALYZABLE = ("table", "bitplane", "cuda", "xor", "ring", "cpu")


def _counter_value(snapshot: dict, name: str, **labels) -> float:
    """Sum of a snapshot counter family's series matching ``labels``."""
    fam = snapshot.get(name) or {}
    want = {k: str(v) for k, v in labels.items()}
    total = 0.0
    for label_str, v in (fam.get("values") or {}).items():
        if not isinstance(v, (int, float)):
            continue
        inner = label_str[1:-1] if label_str else ""
        have = {}
        for part in inner.split(","):
            if "=" in part:
                kk, vv = part.split("=", 1)
                have[kk] = vv.strip('"')
        if all(have.get(k) == val for k, val in want.items()):
            total += v
    return total


def run_workload(strategies=DEFAULT_STRATEGIES, k: int = 4, p: int = 2, w: int = 8, size: int = 1 << 20,
                 segment_bytes: int = 256 * 1024, device=None) -> list[dict]:
    """Per-strategy encode and decode of one synthetic file through the
    file API on ``device`` (None: the card), warm-measured: one warm-up
    pass per op, then one measured pass with a fresh PhaseTimer.  The
    ``native`` host codec runs on the host whatever ``device`` is.

    Returns one row per (strategy, op): wall seconds, the dispatch and
    compute phases, payload bytes and the dispatch count (the
    ``segments_dispatched`` delta).  Metrics are force-enabled for the run
    and the latch is restored after it."""
    prev_forced = _metrics.forced()
    _metrics.force_enable()
    try:
        return _run_workload_enabled(strategies, k, p, w, size, segment_bytes, device)
    finally:
        _metrics.force_enable(prev_forced)


def _run_workload_enabled(strategies, k: int, p: int, w: int, size: int, segment_bytes: int, device) -> list[dict]:
    import tempfile

    import numpy as np

    from .. import api
    from ..tools.make_conf import make_conf
    from ..utils.timing import PhaseTimer

    rows: list[dict] = []
    rng = np.random.default_rng(20260804)
    for name in strategies:
        strategy = _STRATEGY_ALIASES.get(name, name)
        with tempfile.TemporaryDirectory(prefix="rs_analyze_") as d:
            path = os.path.join(d, "payload.bin")
            with open(path, "wb") as fp:
                fp.write(rng.integers(0, 256, size=size, dtype=np.uint8).tobytes())
            # decode reads w from .METADATA; only encode takes it.
            common = dict(strategy=strategy, segment_bytes=segment_bytes,
                          device=None if strategy == "cpu" else device)
            enc = dict(common, w=w)

            def measure(op: str, fn, rows_out: int) -> dict:
                before = _metrics.REGISTRY.snapshot()
                timer = PhaseTimer(enabled=True)
                t0 = time.perf_counter()
                fn(timer)
                wall = time.perf_counter() - t0
                after = _metrics.REGISTRY.snapshot()
                dispatches = (_counter_value(after, "segments_dispatched", op=op, strategy=strategy, w=w)
                              - _counter_value(before, "segments_dispatched", op=op, strategy=strategy, w=w))
                phases = timer.phase_report()
                return {
                    "strategy": name,
                    "codec_strategy": strategy,
                    "op": op,
                    "rows_out": rows_out,
                    "wall_s": round(wall, 6),
                    "dispatch_s": round(phases.get(f"{op} dispatch", 0.0), 6),
                    "compute_s": round(phases.get(f"{op} compute", 0.0), 6),
                    "dispatches": int(dispatches),
                    "bytes": size,
                    "phases": phases,
                }

            # Encode: warm-up, then the measured pass (p parity rows out).
            api.encode_file(path, k, p, **enc)
            rows.append(measure("encode", lambda t: api.encode_file(path, k, p, timer=t, **enc), rows_out=p))
            # Decode with the first n-k chunks lost (a real inversion); the
            # recovery GEMM computes only the min(p, k) missing natives.
            conf = make_conf(k + p, k, path)
            out = path + ".dec"
            api.decode_file(path, conf, out, **common)
            rows.append(measure("decode", lambda t: api.decode_file(path, conf, out, timer=t, **common),
                                rows_out=min(p, k)))
    return rows


# -- report ------------------------------------------------------------------


def classify_bound(bw_util: float, flop_util: float,
                   threshold: float = BOUND_THRESHOLD) -> str:
    """memory / compute / dispatch verdict from roof utilizations."""
    if max(bw_util, flop_util) < threshold:
        return "dispatch"
    return "memory" if bw_util >= flop_util else "compute"


def build_report(
    rows: list[dict],
    roofline: dict,
    *,
    k: int,
    p: int,
    w: int,
    snapshot: dict | None = None,
) -> dict:
    """Fold measured rows, the per-dispatch cost and the roofline into the
    attribution report (the ``rs analyze --json`` payload)."""
    sym = w // 8
    peak_bw = float(roofline.get("triad_gbps") or 0) or None
    peak_fl = float(roofline.get("gemm_gflops") or 0) or None

    out_rows = []
    for r in rows:
        op, strategy = r["op"], r["codec_strategy"]
        # The dispatch's true output-row count, recorded by the workload
        # (encode: p parity rows; decode: only the MISSING natives are
        # recovered — NOT k).  Legacy rows without it fall back to the
        # op-shaped default.
        rows_out = r.get("rows_out") or (p if op == "encode" else min(p, k))
        dispatches = max(1, r.get("dispatches") or 0)
        # Per-dispatch column count in symbols: the payload divided over
        # the measured dispatches.
        chunk_syms = max(1, r["bytes"] // max(1, k) // sym)
        cols = max(1, chunk_syms // dispatches)
        # No plan carries a cost analysis on the card: the analytic model.
        cost_source = "analytic"
        ac = analytic_cost(rows_out, k, cols, sym)
        flops_d, bytes_d = ac["flops"], ac["bytes_accessed"]
        # Attribute against the *device-facing* wall: dispatch enqueue +
        # the D2H block that hides device compute (host view).  Falls
        # back to total wall when the phase split is empty (host codec
        # runs inline: its dispatch phase IS the compute).
        active_s = (r["dispatch_s"] + r["compute_s"]) or r["wall_s"]
        flops_total = flops_d * dispatches
        bytes_total = bytes_d * dispatches
        gflops = flops_total / active_s / 1e9 if active_s > 0 else 0.0
        gbps = bytes_total / active_s / 1e9 if active_s > 0 else 0.0
        ai = flops_d / bytes_d if bytes_d else 0.0
        bw_util = gbps / peak_bw if peak_bw else 0.0
        flop_util = gflops / peak_fl if peak_fl else 0.0
        out_rows.append({
            "strategy": r["strategy"],
            "codec_strategy": strategy,
            "op": op,
            "k": k,
            "n": k + p,
            "w": w,
            "bytes": r["bytes"],
            "wall_s": r["wall_s"],
            "active_s": round(active_s, 6),
            "dispatches": dispatches,
            "end_to_end_gbps": round(
                r["bytes"] / r["wall_s"] / 1e9, 6
            ) if r["wall_s"] > 0 else None,
            "achieved_gbps": round(gbps, 6),
            "achieved_gflops": round(gflops, 6),
            "arithmetic_intensity": round(ai, 6),
            "cost_source": cost_source,
            "flops_per_dispatch": flops_d,
            "bytes_per_dispatch": bytes_d,
            "pct_of_peak_bw": round(100 * bw_util, 3),
            "pct_of_peak_flops": round(100 * flop_util, 3),
            "bound": classify_bound(bw_util, flop_util),
        })

    if snapshot is None:
        snapshot = _metrics.REGISTRY.snapshot()
    latency = {}
    for metric in ("rs_dispatch_wall_seconds", "rs_file_op_wall_seconds"):
        fam = snapshot.get(metric)
        if fam:
            latency[metric] = {
                label: {
                    "count": v.get("count"),
                    "max": v.get("max"),
                    **(v.get("quantiles") or {}),
                }
                for label, v in fam.get("values", {}).items()
                if isinstance(v, dict)
            }
    return {
        "kind": "rs_analyze",
        "schema": SCHEMA_VERSION,
        "ts": time.time(),
        "host": socket.gethostname(),
        "backend": _runlog.backend_name(),
        "config": {"k": k, "n": k + p, "w": w},
        "roofline": roofline,
        "strategies": out_rows,
        "latency": latency,
    }


def render_report(report: dict) -> str:
    """Human-readable `rs analyze` table."""
    rl = report.get("roofline") or {}
    cfg = report.get("config") or {}
    lines = [
        f"host {report.get('host')}  backend {report.get('backend')}  "
        f"k={cfg.get('k')} n={cfg.get('n')} w={cfg.get('w')}",
        f"roofline: {rl.get('triad_gbps')} GB/s triad, "
        f"{rl.get('gemm_gflops')} GFLOP/s gemm "
        f"({rl.get('source', '?')}, age {rl.get('age_s', '?')}s)",
        "",
        f"{'strategy':<10} {'op':<7} {'GB/s':>8} {'GFLOP/s':>9} "
        f"{'AI':>7} {'%bw':>6} {'%flop':>6}  {'bound':<9} cost",
    ]
    for r in report.get("strategies", []):
        lines.append(
            f"{r['strategy']:<10} {r['op']:<7} "
            f"{r['achieved_gbps']:>8.3f} {r['achieved_gflops']:>9.3f} "
            f"{r['arithmetic_intensity']:>7.3f} "
            f"{r['pct_of_peak_bw']:>6.1f} {r['pct_of_peak_flops']:>6.1f}  "
            f"{r['bound']:<9} {r['cost_source']}"
        )
    lat = report.get("latency") or {}
    for metric, series in sorted(lat.items()):
        for label, q in sorted(series.items()):
            p50, p99 = q.get("0.5"), q.get("0.99")
            if p50 is None:
                continue
            lines.append(
                f"{metric}{label}: p50 {p50 * 1e3:.3f} ms  "
                f"p99 {(p99 or 0) * 1e3:.3f} ms  "
                f"max {(q.get('max') or 0) * 1e3:.3f} ms  "
                f"(n={q.get('count')})"
            )
    return "\n".join(lines)


def main(argv=None) -> int:
    """The ``rs analyze`` subcommand."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="rs analyze",
        description="Roofline attribution: run a small per-strategy encode/decode workload and report achieved "
        "GB/s, GFLOP/s, arithmetic intensity and a memory/compute/dispatch bound verdict against the "
        "calibrated roofline of the device it ran on.",
    )
    ap.add_argument("--json", action="store_true", help="emit the report as one JSON document")
    ap.add_argument("--workload", action="store_true",
                    help="run the synthetic workload (the default; kept for symmetry with `rs stats --workload`)")
    ap.add_argument("--strategies", default=",".join(DEFAULT_STRATEGIES),
                    help="comma-separated strategy list (default table,bitplane,xor,ring,native; 'native' is the "
                    "host codec, 'cuda' the card's kernel)")
    ap.add_argument("--k", type=int, default=4)
    ap.add_argument("--p", type=int, default=2)
    ap.add_argument("--w", type=int, default=8, choices=(8, 16))
    ap.add_argument("--size-kb", type=int, default=1024, help="workload payload size in KiB (default 1024)")
    ap.add_argument("--segment-kb", type=int, default=256, help="segment size in KiB (default 256)")
    ap.add_argument("--runlog", default=None, help="ledger for the roofline cache (default $RS_RUNLOG)")
    ap.add_argument("--refresh-roofline", action="store_true",
                    help="re-probe the roofline even when a fresh ledger calibration exists")
    ap.add_argument("--device", default=None, help="where the workload runs (default: the CUDA device)")
    try:
        args = ap.parse_args(argv)
    except SystemExit as e:
        return int(e.code or 0)
    strategies = [s for s in args.strategies.split(",") if s]
    bad = [s for s in strategies if _STRATEGY_ALIASES.get(s, s) not in _ANALYZABLE]
    if bad:
        print(f"rs analyze: unknown strategies {bad}", file=sys.stderr)
        return 2
    if args.w != 8 and any(_STRATEGY_ALIASES.get(s, s) == "cpu" for s in strategies):
        print("rs analyze: the native host codec is w=8 only; drop it from --strategies for --w 16", file=sys.stderr)
        return 2
    from ..utils.backend import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        print(f"rs analyze: {e}", file=sys.stderr)
        return 1
    roofline = get_roofline(args.runlog, refresh=args.refresh_roofline, device=device)
    rows = run_workload(strategies, k=args.k, p=args.p, w=args.w, size=args.size_kb * 1024,
                        segment_bytes=args.segment_kb * 1024, device=device)
    report = build_report(rows, roofline, k=args.k, p=args.p, w=args.w)
    if args.json:
        print(json.dumps(report))
    else:
        print(render_report(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
