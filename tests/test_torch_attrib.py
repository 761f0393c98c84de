"""The port's roofline attribution (gpu_rscode_torch/obs/attrib.py) and
``rs analyze``, against the JAX package's on the CPU: the report's schema
(the keys tests/test_attrib.py checks), the analytic cost, the verdicts and
``build_report`` from fixed walls are equal; a roofline record of another
device is never reused; the card's memory sampler fills the JAX package's
four kinds; the disabled path registers nothing.
"""

import contextlib
import io
import json
import socket
import time

import numpy as np
import pytest
import torch

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch.obs import attrib as t_attrib
from gpu_rscode_torch.obs import metrics as t_metrics
from gpu_rscode_torch.obs import runlog as t_runlog
from gpu_rscode_tpu import cli as j_cli
from gpu_rscode_tpu.obs import attrib as j_attrib
from gpu_rscode_tpu.obs import metrics as j_metrics

CARD = "NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("RS_METRICS", "RS_RUNLOG", "RS_PROFILE", "RS_ROOFLINE_MAX_AGE_S"):
        monkeypatch.delenv(var, raising=False)
    yield
    for m in (t_metrics, j_metrics):
        m.force_enable(False)
        m.REGISTRY.reset()


def _analyze(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(["analyze", "--json", *argv])
    return rc, json.loads(buf.getvalue())


@pytest.fixture(scope="module")
def reports():
    """One `rs analyze --json` run of each package at the JAX test's small
    size (64 KiB, 16 KiB segments), every default strategy."""
    argv = ["--size-kb", "64", "--segment-kb", "16"]
    t_rc, t_rep = _analyze(t_cli.main, [*argv, "--device", "cpu"])
    j_rc, j_rep = _analyze(j_cli.main, argv)
    for m in (t_metrics, j_metrics):
        m.force_enable(False)
        m.REGISTRY.reset()
    assert t_rc == j_rc == 0
    return t_rep, j_rep


def test_analyze_json_schema_equals_jax(reports):
    t_rep, j_rep = reports
    assert t_rep["kind"] == "rs_analyze" and t_rep["schema"] == 1
    assert set(t_rep) == set(j_rep)
    assert {"roofline", "strategies", "latency", "config", "backend"} <= set(t_rep)
    assert t_rep["config"] == j_rep["config"] and t_rep["backend"] == "cpu"
    # The roofline record names the device it probed (the JAX package's
    # has no device field).
    assert set(t_rep["roofline"]) == set(j_rep["roofline"]) | {"device"}
    assert t_rep["roofline"]["device"] == "cpu" and t_rep["roofline"]["source"] == "probe"
    rows = {(r["strategy"], r["op"]): r for r in t_rep["strategies"]}
    j_rows = {(r["strategy"], r["op"]): r for r in j_rep["strategies"]}
    assert set(rows) == set(j_rows) == {(s, op) for s in t_attrib.DEFAULT_STRATEGIES for op in ("encode", "decode")}
    for key, r in rows.items():
        assert set(r) == set(j_rows[key])
        # The same payload in the same segments: the same dispatch count.
        for field in ("codec_strategy", "k", "n", "w", "bytes", "dispatches"):
            assert r[field] == j_rows[key][field], (key, field)
        assert r["achieved_gbps"] > 0 and r["bound"] in ("memory", "compute", "dispatch")
        # A kept difference: the JAX package reads XLA's cost analysis off
        # its plan executables where the backend has one; the port's plans
        # have none, so every row takes the analytic model (the one JAX's
        # rows without a cost analysis take, the native host codec's).
        assert r["cost_source"] == "analytic"
        if j_rows[key]["cost_source"] == "analytic":
            for field in ("flops_per_dispatch", "bytes_per_dispatch", "arithmetic_intensity"):
                assert r[field] == j_rows[key][field], (key, field)
    assert set(t_rep["latency"]) == set(j_rep["latency"]) == {"rs_dispatch_wall_seconds", "rs_file_op_wall_seconds"}
    series = next(iter(t_rep["latency"]["rs_dispatch_wall_seconds"].values()))
    assert series["count"] > 0 and series["max"] >= series["0.5"]


def test_analyze_usage_errors_equal_jax(capsys):
    for argv in (["--strategies", "warp"], ["--strategies", "native", "--w", "16"]):
        assert t_cli.main(["analyze", *argv, "--device", "cpu"]) == j_cli.main(["analyze", *argv]) == 2
    assert "unknown strategies" in capsys.readouterr().err
    # `cuda` is analyzable where the JAX package has `pallas`.
    assert "cuda" in t_attrib._ANALYZABLE and "pallas" not in t_attrib._ANALYZABLE


def test_analyze_without_a_card_needs_the_cpu_asked_for(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert t_cli.main(["analyze", "--strategies", "bitplane"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.parametrize("args", [(2, 4, 1000, 1), (4, 10, 65536, 2), (1, 1, 1, 1), (10, 10, 6710784, 1)])
def test_analytic_cost_equals_jax(args):
    assert t_attrib.analytic_cost(*args) == j_attrib.analytic_cost(*args)


@pytest.mark.parametrize("bw", [0.0, 0.05, 0.33, 0.8])
@pytest.mark.parametrize("fl", [0.0, 0.08, 0.33, 0.9])
def test_classify_bound_equals_jax(bw, fl):
    assert t_attrib.classify_bound(bw, fl) == j_attrib.classify_bound(bw, fl)


def test_build_report_from_fixed_walls_equals_jax():
    rng = np.random.default_rng(3)
    rows = []
    for strategy, codec in (("bitplane", "bitplane"), ("native", "cpu"), ("xor", "xor")):
        for op, rows_out in (("encode", 4), ("decode", 4)):
            wall = float(rng.uniform(0.01, 1.0))
            rows.append({"strategy": strategy, "codec_strategy": codec, "op": op, "rows_out": rows_out,
                         "wall_s": wall, "dispatch_s": wall * 0.3, "compute_s": wall * 0.5 if op == "encode" else 0.0,
                         "dispatches": int(rng.integers(1, 20)), "bytes": 256 << 20, "phases": {}})
    rows.append(dict(rows[0], dispatch_s=0.0, compute_s=0.0, dispatches=0))  # the whole wall is active
    roofline = {"triad_gbps": 2500.0, "gemm_gflops": 50000.0, "source": "probe", "age_s": 0.0}
    snapshot = {"rs_dispatch_wall_seconds": {"values": {'{op="encode"}': {
        "count": 3, "max": 0.2, "quantiles": {"0.5": 0.1, "0.99": 0.2}}}}}
    t_rep = t_attrib.build_report(rows, roofline, k=10, p=4, w=8, snapshot=snapshot)
    j_rep = j_attrib.build_report(rows, roofline, k=10, p=4, w=8, plan_stats={"plans": []}, snapshot=snapshot)
    t_rep.pop("ts"), j_rep.pop("ts")
    assert t_rep == j_rep
    assert t_attrib.render_report(dict(t_rep, ts=0)) == j_attrib.render_report(dict(j_rep, ts=0))


def _probe(triad, device="cpu"):
    return lambda reps=3, device=device: {"triad_gbps": triad, "gemm_gflops": 99.0, "ts": time.time(),
                                          "host": socket.gethostname(), "device": t_attrib.device_name(device)}


def test_roofline_cache_is_per_device(tmp_path, monkeypatch):
    """A fresh record of this host's CPU is reused; one of another device
    (the card's, or the JAX package's record with no device) is not."""
    ledger = str(tmp_path / "ledger.jsonl")
    host = socket.gethostname()
    t_runlog.append({"kind": "rs_roofline", "host": host, "ts": time.time(), "triad_gbps": 3000.0,
                     "gemm_gflops": 5e4, "device": CARD}, ledger)
    t_runlog.append({"kind": "rs_roofline", "host": host, "ts": time.time(), "triad_gbps": 7.0,
                     "gemm_gflops": 70.0}, ledger)
    monkeypatch.setattr(t_attrib, "measure_roofline", _probe(12.5))
    first = t_attrib.get_roofline(ledger, device="cpu")
    assert first["source"] == "probe" and first["triad_gbps"] == 12.5 and first["device"] == "cpu"
    monkeypatch.setattr(t_attrib, "measure_roofline", lambda **kw: pytest.fail("re-probed a fresh calibration"))
    second = t_attrib.get_roofline(ledger, device="cpu")
    assert second["source"] == "ledger" and second["triad_gbps"] == 12.5
    monkeypatch.setattr(t_attrib, "device_name", lambda device: CARD if str(device).startswith("cuda") else "cpu")
    card = t_attrib.get_roofline(ledger, device="cuda:0")
    assert card["source"] == "ledger" and card["triad_gbps"] == 3000.0
    # Stale: re-probed.
    monkeypatch.setenv("RS_ROOFLINE_MAX_AGE_S", "0")
    monkeypatch.setattr(t_attrib, "measure_roofline", _probe(1.0))
    assert t_attrib.get_roofline(ledger, device="cpu")["source"] == "probe"
    recs = t_runlog.read_records(ledger)
    assert t_runlog.filter_records(recs) == []  # calibrations are not runs


def test_card_memory_fills_the_four_kinds(monkeypatch):
    stats = {"allocated_bytes.all.current": 1 << 20, "allocated_bytes.all.peak": 3 << 20}
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda index: stats)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda index: (70 << 30, 80 << 30))
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    t_attrib.sample_device_memory(force=True)
    assert "rs_device_mem_bytes" not in t_metrics.REGISTRY.names()  # metrics off: nothing
    t_metrics.force_enable(True)
    t_attrib.sample_device_memory(force=True)
    values = t_metrics.REGISTRY.snapshot()["rs_device_mem_bytes"]["values"]
    assert values == {
        '{device="0",kind="bytes_in_use"}': 1 << 20,
        '{device="0",kind="peak_bytes_in_use"}': 3 << 20,
        '{device="0",kind="bytes_limit"}': 80 << 30,
        '{device="0",kind="largest_free_block_bytes"}': 70 << 30,
    }
    assert set(t_attrib._MEM_KINDS) == set(j_attrib._MEM_KINDS)


def test_disabled_attribution_path_registers_nothing(tmp_path):
    src = tmp_path / "f.bin"
    src.write_bytes(np.random.default_rng(7).integers(0, 256, size=40_000, dtype=np.uint8).tobytes())
    t_api.encode_file(str(src), 4, 2, segment_bytes=8192, device="cpu")
    assert t_metrics.REGISTRY.snapshot() == {}
    t_attrib.sample_device_memory(force=True)
    assert t_metrics.REGISTRY.snapshot() == {}
