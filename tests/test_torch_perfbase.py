"""The port's perf baselines and drift gate (gpu_rscode_torch/obs/perfbase.py)
and the history surface of its run ledger (``filter_records``,
``throughput_gbps``), against the JAX package's on the same records: the
samples, cells, blessed record and digest, comparison, report, rendering,
gauges and ``rs perf`` exit codes are equal, and a baseline written by one
package is read by the other.
"""

import json
import socket

import numpy as np
import pytest

from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch.obs import metrics as t_metrics
from gpu_rscode_torch.obs import perfbase as t_perf
from gpu_rscode_torch.obs import runlog as t_runlog
from gpu_rscode_tpu import cli as j_cli
from gpu_rscode_tpu.obs import metrics as j_metrics
from gpu_rscode_tpu.obs import perfbase as j_perf
from gpu_rscode_tpu.obs import runlog as j_runlog

HOST = socket.gethostname()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("RS_PERF_DRIFT_FRAC", raising=False)
    monkeypatch.delenv("RS_RUNLOG", raising=False)
    yield
    for m in (t_metrics, j_metrics):
        m.force_enable(False)
        m.REGISTRY.reset()


def _evidence(seed: int, scale: float = 1.0) -> list[dict]:
    """Seeded ledger and capture records of every kind perfbase and the
    history filter read: rs_perf events (a cold one among them), rs_run
    records (a failed one, one without a strategy), a capture header with
    xor_ab rows, and records the trend view must drop."""
    rng = np.random.default_rng(seed)
    recs: list[dict] = []
    ts = 1000.0
    for strategy in ("xor", "ring", "bitplane"):
        for op in ("encode", "decode"):
            for _ in range(int(rng.integers(3, 9))):
                nbytes = int(rng.choice([4096, 1 << 20, 16 << 20, 20 << 20]))
                gbps = float(rng.uniform(0.5, 3.0)) * scale
                wall = nbytes / (gbps * 1e9)
                stages = {"pack": wall * 0.2, "chain": wall * 0.5}
                if rng.random() < 0.15:
                    stages["compile"] = wall * 0.5  # a cold dispatch: left out
                ts += 1
                recs.append({"kind": "rs_perf", "op": op, "strategy": strategy, "bytes": nbytes, "wall_s": wall,
                             "stages": stages, "host": HOST, "backend": "cpu", "ts": ts})
    for i in range(12):
        ts += 1
        nbytes = int(rng.integers(1, 64)) << 20
        recs.append({"kind": "rs_run", "op": ["encode", "decode"][i % 2],
                     "config": {"k": 4, "n": 6 + (i % 3 == 0) * 2, "w": 8,
                                "strategy": ["bitplane", "xor", "cuda"][i % 3]},
                     "bytes": nbytes, "wall_s": nbytes / (float(rng.uniform(0.2, 2.0)) * scale * 1e9),
                     "outcome": "error" if i == 5 else "ok", "host": HOST if i != 7 else "other", "backend": "cpu",
                     "ts": ts})
    recs.append({"kind": "rs_run", "op": "scrub", "config": {}, "bytes": 1 << 20, "wall_s": 0.01, "outcome": "ok",
                 "host": HOST, "backend": "cpu", "ts": ts + 1})
    recs.append({"kind": "capture_header", "tool": "xor_ab", "host": HOST, "backend": "cpu", "ts": ts + 2})
    recs.append({"kind": "xor_ab", "op": "encode", "bytes": 20 << 20,
                 "gbps": {"xor": 0.75 * scale, "table": 0.15 * scale, "bad": None}})
    for kind in ("rs_roofline", "rs_xor_schedule", "rs_request", "rs_damage", "rs_health_snapshot"):
        recs.append({"kind": kind, "host": HOST, "backend": "cpu", "ts": ts + 3})
    return recs


def _ledger(path, recs):
    with open(path, "w") as fp:
        for r in recs:
            fp.write(json.dumps(r) + "\n")
    return str(path)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_samples_cells_compare_and_report_equal_jax(seed):
    recs = _evidence(seed)
    t_s, j_s = t_perf.collect_samples(recs), j_perf.collect_samples(recs)
    assert t_s == j_s and len(t_s) > 10
    for window in (1, 4, 32):
        assert t_perf.current_cells(t_s, HOST, "cpu", window) == j_perf.current_cells(j_s, HOST, "cpu", window)
    cur = t_perf.current_cells(t_s, HOST, "cpu")
    base = {"kind": "rs_perf_baseline", "cells": t_perf.current_cells(_samples_scaled(seed, 1.1), HOST, "cpu")}
    for frac in (None, 0.5, 0.85, 0.99):
        assert t_perf.compare(base, cur, frac) == j_perf.compare(base, cur, frac)
    assert t_perf.compare(None, cur) == j_perf.compare(None, cur)
    t_rep = t_perf.report(recs, host=HOST, backend="cpu")
    j_rep = j_perf.report(recs, host=HOST, backend="cpu")
    assert t_rep == j_rep
    assert t_perf.render(t_rep) == j_perf.render(j_rep)
    assert t_perf.payload_digest(cur) == j_perf.payload_digest(cur)
    assert t_perf.bucket_label(4097) == j_perf.bucket_label(4097) == "8KiB"


def _samples_scaled(seed, scale):
    return t_perf.collect_samples(_evidence(seed, scale))


@pytest.mark.parametrize("seed", [4, 5])
def test_history_filter_and_throughput_equal_jax(seed):
    recs = _evidence(seed)
    for kw in ({}, {"op": "encode"}, {"op": "xor_ab"}, {"k": 4}, {"n": 8}, {"w": 8}, {"strategy": "xor"},
               {"host": "other"}, {"cls": "damage"}, {"cls": "request", "host": HOST}):
        assert t_runlog.filter_records(recs, **kw) == j_runlog.filter_records(recs, **kw), kw
    assert [t_runlog.throughput_gbps(r) for r in recs] == [j_runlog.throughput_gbps(r) for r in recs]


def test_bless_writes_the_same_record_and_each_package_reads_the_others(tmp_path):
    """bless() returns the same record (payload digest included) in both
    packages; the record one package appends passes the other's
    validation and loads as its baseline, prior cells carried forward."""
    recs = _evidence(7)
    t_led = _ledger(tmp_path / "t.jsonl", recs)
    j_led = _ledger(tmp_path / "j.jsonl", recs)
    t_rec = t_perf.bless(t_led, t_runlog.read_records(t_led), HOST, "cpu")
    j_rec = j_perf.bless(j_led, j_runlog.read_records(j_led), HOST, "cpu")
    assert t_rec == j_rec and t_rec["payload_digest"] == t_perf.payload_digest(t_rec["cells"])
    t_written = t_runlog.read_records(t_led)[-1]
    j_written = j_runlog.read_records(j_led)[-1]
    assert j_perf.valid_baseline(t_written) and t_perf.valid_baseline(j_written)
    assert j_perf.load_baseline(j_runlog.read_records(t_led), HOST, "cpu")["cells"] == t_rec["cells"]
    assert t_perf.load_baseline(t_runlog.read_records(j_led), HOST, "cpu")["cells"] == j_rec["cells"]
    # A tampered record is ignored by both, never trusted, never fatal.
    bad = dict(t_written, cells={**t_written["cells"], "x|y|1B": {"gbps": 9.0}})
    assert not t_perf.valid_baseline(bad) and not j_perf.valid_baseline(bad)
    assert not t_perf.valid_baseline(dict(t_written, algo_version=2))
    # A re-bless over new evidence keeps the cells it did not observe.
    more = [r for r in _evidence(8) if r.get("kind") == "rs_perf" and r["strategy"] == "xor"]
    t_rec2 = t_perf.bless(t_led, t_runlog.read_records(t_led) + more, HOST, "cpu")
    j_rec2 = j_perf.bless(j_led, j_runlog.read_records(j_led) + more, HOST, "cpu")
    assert t_rec2 == j_rec2 and set(t_rec["cells"]) <= set(t_rec2["cells"])


def test_export_gauges_equal_jax():
    recs = _evidence(9)
    rep = t_perf.report(recs, host=HOST, backend="cpu")
    t_metrics.force_enable(True)
    j_metrics.force_enable(True)
    t_perf.export_gauges(rep)
    j_perf.export_gauges(rep)
    t_snap, j_snap = t_metrics.REGISTRY.snapshot(), j_metrics.REGISTRY.snapshot()
    assert {k: v["values"] for k, v in t_snap.items()} == {k: v["values"] for k, v in j_snap.items()}
    assert set(t_snap) == {"rs_perf_baseline_gbps", "rs_perf_baseline_current_gbps", "rs_perf_baseline_ratio",
                           "rs_perf_baseline_cells", "rs_perf_baseline_breach"}


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_rs_perf_exit_codes_and_output_equal_jax(tmp_path, capsys):
    """The lifecycle through both CLIs on twin ledgers: no ledger (2), a
    missing ledger (1), --check with no baseline (2), --record then
    --check on the same evidence (0), a slower run drifting below the gate
    (4), no overlapping evidence (2), --json and a usage error."""
    recs = _evidence(11)
    ledgers = {name: _ledger(tmp_path / f"{name}.jsonl", recs) for name in "tj"}
    mains = {"t": t_cli.main, "j": j_cli.main}

    def both(*argv, rc):
        outs = {}
        for name in "tj":
            args = [a.replace("LEDGER", ledgers[name]) for a in argv]
            got, out, err = _run(mains[name], ["perf", *args], capsys)
            assert got == rc, (name, argv, err)
            if out.startswith("{"):
                doc = json.loads(out)
                doc.pop("baseline_ts")  # the time each package blessed at
                out = json.dumps(doc)
            outs[name] = (out, err.replace(ledgers[name], "LEDGER"))
        assert outs["t"] == outs["j"], argv
        return outs["t"]

    both(rc=2)
    both("--runlog", str(tmp_path / "none.jsonl"), rc=1)
    both("--runlog", "LEDGER", rc=0)
    both("--runlog", "LEDGER", "--check", rc=2)
    both("--runlog", "LEDGER", "--record", "--host", HOST, "--backend", "cpu", rc=0)
    both("--runlog", "LEDGER", "--check", "--host", HOST, "--backend", "cpu", rc=0)
    out, _ = both("--runlog", "LEDGER", "--json", "--host", HOST, "--backend", "cpu", rc=0)
    assert json.loads(out)["kind"] == "rs_perf_report"
    for name in "tj":
        with open(ledgers[name], "a") as fp:
            for r in _evidence(11, scale=0.5):
                if r.get("kind") == "rs_perf":
                    fp.write(json.dumps(dict(r, ts=r["ts"] + 1e6)) + "\n")
    _, err = both("--runlog", "LEDGER", "--check", "--host", HOST, "--backend", "cpu", "--window", "4", rc=4)
    assert "DRIFT BREACH" in err
    both("--runlog", "LEDGER", "--check", "--host", HOST, "--backend", "cpu", "--window", "4",
         "--drift-frac", "0.1", rc=0)
    both("--runlog", "LEDGER", "--check", "--host", "nowhere", "--backend", "cpu", rc=2)
    both("--bogus", rc=2)
