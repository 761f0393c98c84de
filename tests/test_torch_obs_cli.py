"""The port's measurement plane through its CLI, against the JAX package's
on the CPU: the ``--metrics-json`` snapshots of the same seeded encode,
decode, ``--scrub``, ``--scrub --syndrome`` and ``--repair`` carry the same
metric families and label sets, with equal event counts; ``rs stats``,
``--trace``, the metrics file's fail-fast and failed-run contracts; ``rs
history``'s filters and ``--regress`` exit codes; and every metric name the
JAX package registers is registered by the port, but for a listed few.
"""

import json
import os
import pathlib
import re
import time

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch import plan as t_plan
from gpu_rscode_torch.obs import metrics as t_metrics
from gpu_rscode_torch.parallel import pipeline as t_pipeline
from gpu_rscode_torch.tools.make_conf import make_conf
from gpu_rscode_tpu import cli as j_cli
from gpu_rscode_tpu import plan as j_plan
from gpu_rscode_tpu.obs import metrics as j_metrics
from gpu_rscode_tpu.parallel import pipeline as j_pipeline

ROOT = pathlib.Path(__file__).resolve().parent.parent

# The counter families that count events (not seconds): equal series by
# series after the same operations.
EVENT_COUNTERS = ("segments_dispatched", "rs_codec_bytes_total", "rs_io_write_bytes_total", "rs_io_read_bytes_total",
                  "rs_io_h2d_bytes_total", "rs_scrub_chunks_total", "rs_scrub_archives_scanned_total",
                  "rs_scrub_verdicts_total", "rs_syndrome_checks_total", "rs_repair_outcomes_total",
                  "rs_repair_chunks_rebuilt_total", "rs_file_ops_total", "rs_segments_staged_total",
                  "rs_plan_dispatch_total", "rs_plan_cache_events_total", "rs_autotune_source_total")

# Top-level snapshot keys only the JAX package has: none (the refold
# autotune decisions are in both).
JAX_ONLY_SNAPSHOT_KEYS = set()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("RS_METRICS", "RS_RUNLOG", "RS_TRACE", "RS_PROF", "RS_PROFILE"):
        monkeypatch.delenv(var, raising=False)
    # Both packages start from the same process-wide staging-ring high
    # watermark: the gauge rs_staging_ring_occupancy_peak registers only
    # when a ring climbs above it, and a test file run earlier in this
    # process may have raised one package's mark and not the other's.
    monkeypatch.setattr(t_pipeline, "_RING_PEAK", [0])
    monkeypatch.setattr(j_pipeline, "_RING_PEAK", [0])
    yield
    for m in (t_metrics, j_metrics):
        m.force_enable(False)
        m.REGISTRY.reset()


def _run_both(tmp_path, argv_of, capsys):
    """Run the same CLI argv in each package, each on its own copy of the
    seeded file; returns {name: (rc, snapshot)} per step."""
    data = np.random.default_rng(20260807).integers(0, 256, size=200_003, dtype=np.uint8).tobytes()
    out = {}
    for name, main, extra, metrics, plan in (("t", t_cli.main, ["--device", "cpu"], t_metrics, t_plan),
                                             ("j", j_cli.main, [], j_metrics, j_plan)):
        d = tmp_path / name
        d.mkdir()
        f = d / "f.bin"
        f.write_bytes(data)
        plan.PLAN_CACHE.clear()
        steps = []
        for i, (argv, before) in enumerate(argv_of(str(f))):
            if before is not None:
                before(str(f))
            mj = d / f"m{i}.json"
            metrics.REGISTRY.reset()
            rc = main([*argv, "--strategy", "bitplane", "--quiet", "--segment-bytes", "65536", "--metrics-json",
                       str(mj), *extra])
            metrics.force_enable(False)
            steps.append((rc, json.loads(mj.read_text())))
        out[name] = steps
    capsys.readouterr()
    return out


def _steps(f):
    conf = lambda f: make_conf(6, 4, f)  # noqa: E731
    return [
        (["-k", "4", "-n", "6", "-e", f, "--checksum"], None),
        (["-d", "-i", f, "-c", f"{os.path.dirname(f)}/conf-6-4-f.bin", "-o", f + ".out"], conf),
        (["--scrub", "-i", f], None),
        (["--scrub", "--syndrome", "-i", f], None),
        (["--repair", "-i", f], lambda f: os.unlink(os.path.join(os.path.dirname(f), "_1_f.bin"))),
        (["--scrub", "-i", f], lambda f: os.unlink(os.path.join(os.path.dirname(f), "_4_f.bin"))),
    ]


def test_metrics_json_families_and_event_counts_equal_jax(tmp_path, capsys):
    runs = _run_both(tmp_path, _steps, capsys)
    for (t_rc, t_snap), (j_rc, j_snap) in zip(runs["t"], runs["j"]):
        assert t_rc == j_rc == 0
        assert set(j_snap) - set(t_snap) == JAX_ONLY_SNAPSHOT_KEYS and set(t_snap) <= set(j_snap)
        assert t_snap["metrics_enabled"] is j_snap["metrics_enabled"] is True
        tm, jm = t_snap["metrics"], j_snap["metrics"]
        assert set(tm) == set(jm)
        for fam in tm:
            assert tm[fam]["type"] == jm[fam]["type"], fam
            assert set(tm[fam]["values"]) == set(jm[fam]["values"]), fam
        for fam in EVENT_COUNTERS:
            if fam in jm:
                assert tm[fam]["values"] == jm[fam]["values"], fam
    encode, decode, scrub, syndrome, repair, damaged = (snap["metrics"] for _, snap in runs["t"])
    assert encode["segments_dispatched"]["values"] == {'{op="encode",strategy="bitplane",w="8"}': 4}
    assert encode["rs_codec_bytes_total"]["values"] == {'{op="encode",strategy="bitplane",w="8"}': 200_004}
    # The parity chunks' bytes (the natives are straight file copies that
    # neither package counts as staging IO) and the decoded file's.
    assert encode["rs_io_write_bytes_total"]["values"] == {'{call="scatter_write"}': 2 * 50_001}
    assert decode["rs_io_write_bytes_total"]["values"] == {'{call="stream_write"}': 200_003}
    assert scrub["rs_scrub_verdicts_total"]["values"] == {'{decodable="True"}': 1}
    assert syndrome["rs_syndrome_checks_total"]["values"] == {'{verdict="clean"}': 4}  # one a segment
    assert repair["rs_repair_outcomes_total"]["values"] == {'{outcome="rebuilt"}': 1}
    assert damaged["rs_scrub_archives_scanned_total"]["values"] == {'{outcome="damaged"}': 1}


def test_cli_metrics_json_roundtrip_and_stats(tmp_path, capsys):
    """As tests/test_obs.py holds the JAX package's: --metrics-json
    force-enables collection and its snapshot's segment counts match the
    run; `rs stats` in the same process agrees; --text is the Prometheus
    exposition; a usage error returns 2."""
    t_plan.PLAN_CACHE.clear()
    chunk = 2 * 1024 + 700
    path = tmp_path / "f.bin"
    path.write_bytes(np.random.default_rng(7).integers(0, 256, size=4 * chunk, dtype=np.uint8).tobytes())
    mpath = tmp_path / "m.json"
    assert t_cli.main(["-k", "4", "-n", "6", "-e", str(path), "--quiet", "--segment-bytes", "4096", "--metrics-json",
                       str(mpath), "--device", "cpu"]) == 0
    snap = json.loads(mpath.read_text())
    n_segments = len(t_api._segment_spans(chunk, 1024))
    seg_values = snap["metrics"]["segments_dispatched"]["values"]
    assert snap["metrics_enabled"] is True and sum(seg_values.values()) == n_segments
    assert snap["metrics"]["rs_segments_staged_total"]["values"][""] == n_segments
    assert snap["plan_cache"]["misses"] >= 1 and snap["plan_cache"]["hits"] + snap["plan_cache"]["misses"] >= n_segments
    capsys.readouterr()
    assert t_cli.main(["stats"]) == 0
    stats = json.loads(capsys.readouterr().out.strip())
    assert stats["metrics"]["segments_dispatched"]["values"] == seg_values
    assert t_cli.main(["stats", "--text"]) == 0
    text = capsys.readouterr().out
    assert "# TYPE segments_dispatched counter" in text and "rs_codec_bytes_total{" in text
    assert t_cli.main(["stats", "--bogus"]) == j_cli.main(["stats", "--bogus"]) == 2
    capsys.readouterr()


def test_stats_workload_equals_jax_plan_counts(capsys):
    """`rs stats --workload`: the multi-tail encode through the plan
    ladder gives the JAX package's plan-cache counts."""
    assert t_cli.main(["stats", "--workload", "--device", "cpu"]) == 0
    t_snap = json.loads(capsys.readouterr().out.strip())
    assert j_cli.main(["stats", "--workload"]) == 0
    j_snap = json.loads(capsys.readouterr().out.strip())
    for key in ("hits", "misses", "evictions", "executables"):
        assert t_snap["plan_cache"][key] == j_snap["plan_cache"][key], key
    assert t_snap["metrics"]["segments_dispatched"]["values"] == j_snap["metrics"]["segments_dispatched"]["values"]
    from gpu_rscode_torch.tools import plan_stats as t_ps
    from gpu_rscode_tpu.tools import plan_stats as j_ps

    assert t_ps._ladder_bound(t_ps._seg_cols(4, 4096, 8)) == j_ps._ladder_bound(j_ps._seg_cols(4, 4096, 8))


def test_cli_trace_flag_one_dispatch_span_a_segment(tmp_path, capsys):
    path = tmp_path / "f.bin"
    chunk = 2 * 1024 + 700
    path.write_bytes(np.random.default_rng(8).integers(0, 256, size=4 * chunk, dtype=np.uint8).tobytes())
    for op_argv, op in ((["-k", "4", "-n", "6", "-e", str(path)], "encode"),
                        (["-d", "-i", str(path), "-c", make_conf(6, 4, str(path)), "-o", str(tmp_path / "o")],
                         "decode")):
        tpath = tmp_path / f"{op}.json"
        assert t_cli.main([*op_argv, "--quiet", "--segment-bytes", "4096", "--trace", str(tpath), "--device",
                           "cpu"]) == 0
        events = json.loads(tpath.read_text())["traceEvents"]
        disp = [e for e in events if e["name"] == "dispatch" and e["ph"] == "X"]
        assert len(disp) == len(t_api._segment_spans(chunk, 1024))
        assert all(e["args"]["op"] == op for e in disp)
        assert sum(e["name"] == "h2d_stage" for e in events) == len(disp)
    # --scrub rides the same surface: its scan span lands in the trace.
    tpath = tmp_path / "scrub.json"
    assert t_cli.main(["--scrub", "-i", str(path), "--trace", str(tpath), "--device", "cpu"]) == 0
    assert any(e["name"] == "scan_chunks" for e in json.loads(tpath.read_text())["traceEvents"])
    capsys.readouterr()


def test_cli_metrics_json_unwritable_path_fails_fast(tmp_path, capsys):
    path = tmp_path / "f.bin"
    path.write_bytes(b"x" * 1000)
    argv = ["-k", "4", "-n", "6", "-e", str(path), "--quiet", "--metrics-json", str(tmp_path / "no_dir" / "m.json")]
    assert t_cli.main([*argv, "--device", "cpu"]) == j_cli.main(argv) == 2
    # A pure usage error (validated before the probe) creates no file.
    upath = tmp_path / "u.json"
    assert t_cli.main(["-k", "4", "-n", "6", "-e", str(path), "--quiet", "--width", "12", "--metrics-json",
                       str(upath), "--device", "cpu"]) == 2
    assert not upath.exists()
    assert not list(tmp_path.glob("_*_f.bin"))
    capsys.readouterr()


def test_cli_metrics_json_written_on_failed_run(tmp_path, capsys):
    for name, main, extra in (("t", t_cli.main, ["--device", "cpu"]), ("j", j_cli.main, [])):
        mpath = tmp_path / f"{name}_fail.json"
        assert main(["-k", "4", "-n", "6", "-e", str(tmp_path / "missing.bin"), "--quiet", "--metrics-json",
                     str(mpath), *extra]) == 1
        assert json.loads(mpath.read_text())["metrics_enabled"] is True
        mpath2 = tmp_path / f"{name}_usage.json"
        assert main(["-k", "4", "-e", str(tmp_path / "x.bin"), "--quiet", "--metrics-json", str(mpath2), *extra]) == 2
        assert json.loads(mpath2.read_text())["metrics_enabled"] is True
    capsys.readouterr()


# -- rs history ---------------------------------------------------------------------------


def _seed_history(ledger, wall, count, ts0):
    with open(ledger, "a") as fp:
        for i in range(count):
            fp.write(json.dumps({"kind": "rs_run", "op": "encode", "config": {"k": 4, "n": 6, "w": 8,
                                                                             "strategy": "bitplane"},
                                 "bytes": 1_000_000_000, "wall_s": wall, "outcome": "ok", "host": "h",
                                 "ts": ts0 + i}) + "\n")


def test_history_filters_and_regress_exit_codes_equal_jax(tmp_path, capsys, monkeypatch):
    """The JAX package's history scenarios through both CLIs on twin
    ledgers: listing and --json, the missing-ledger codes, a saved
    baseline, a 2x regression (exit 3), an unknown baseline (exit 1), and
    a capture file trended by its header's tool."""
    ledgers = {name: str(tmp_path / f"{name}.jsonl") for name in "tj"}
    mains = {"t": t_cli.main, "j": j_cli.main}

    def both(*argv, rc):
        outs = {}
        for name in "tj":
            got = mains[name](["history", *[a.replace("LEDGER", ledgers[name]) for a in argv]])
            cap = capsys.readouterr()
            assert got == rc, (name, argv, cap.err)
            outs[name] = (cap.out, cap.err.replace(ledgers[name], "LEDGER"))
        assert outs["t"] == outs["j"], argv
        return outs["t"]

    monkeypatch.delenv("RS_RUNLOG", raising=False)
    both(rc=2)
    both("--runlog", str(tmp_path / "missing.jsonl"), rc=1)
    for name in "tj":
        _seed_history(ledgers[name], 0.5, 10, 1e9)
    out, err = both("--runlog", "LEDGER", "--op", "encode", rc=0)
    assert out.count("2.000GB/s") == 10 and "mean 2.000 GB/s" in err
    out, _ = both("--runlog", "LEDGER", "--json", "--last", "2", "--strategy", "bitplane", "--k", "4", rc=0)
    assert len(out.strip().splitlines()) == 2
    both("--runlog", "LEDGER", "--op", "decode", rc=0)
    both("--runlog", "LEDGER", "--op", "encode", "--save-baseline", "v1", rc=0)
    assert json.loads(open(ledgers["t"] + ".baselines.json").read())["v1"]["gbps_mean"] == 2.0
    both("--runlog", "LEDGER", "--op", "encode", "--regress", "v1", rc=0)
    for name in "tj":
        _seed_history(ledgers[name], 1.0, 10, 2e9)
    _, err = both("--runlog", "LEDGER", "--op", "encode", "--window", "10", "--regress", "v1", rc=3)
    assert "REGRESSION" in err
    both("--runlog", "LEDGER", "--op", "encode", "--window", "10", "--regress", "v1", "--threshold", "0.6", rc=0)
    both("--runlog", "LEDGER", "--regress", "nope", rc=1)
    both("--runlog", "LEDGER", "--op", "decode", "--regress", "v1", rc=1)  # nothing in the window
    both("--bogus", rc=2)
    from gpu_rscode_torch.obs import runlog as t_runlog

    cap = tmp_path / "io_cap.jsonl"
    with open(cap, "w") as fp:
        fp.write(json.dumps(dict(t_runlog.capture_header("io_bench"), ts=time.time())) + "\n")
        for mode, gbps in (("sync", 2.0), ("writebehind", 4.0)):
            fp.write(json.dumps({"metric": "io_ab", "op": "encode", "mode": mode, "wall_s": 0.5, "gbps": gbps}) + "\n")
    ledgers = {"t": str(cap), "j": str(cap)}
    _, err = both("--runlog", "LEDGER", "--op", "io_bench", rc=0)
    assert "best 4.000 GB/s" in err


def test_cli_run_lands_in_ledger_and_trends(tmp_path, capsys, monkeypatch):
    ledger = tmp_path / "l.jsonl"
    monkeypatch.setenv("RS_RUNLOG", str(ledger))
    path = tmp_path / "f.bin"
    path.write_bytes(b"\x01" * 40_000)
    assert t_cli.main(["-k", "4", "-n", "6", "-e", str(path), "--quiet", "--device", "cpu"]) == 0
    capsys.readouterr()
    assert t_cli.main(["history", "--op", "encode", "--json"]) == 0
    recs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert len(recs) == 1 and recs[0]["config"]["k"] == 4 and recs[0]["backend"] == "cpu"


# -- metric names ---------------------------------------------------------------------------


_REGISTERED = re.compile(r'\b(?:counter|gauge|histogram|quantile)\(\s*[fr]?"([a-z_][a-z0-9_]*)"')

# Names the JAX package registers that the port does not, each with its
# reason.  Later slices shrink this list.
NOT_IN_PORT = {
    # The TPU compiler's counters: Pallas kernel calls and demotion; the
    # port's kernels are CUDA and never demote.
    "rs_pallas_demotions_total": "Pallas demotion guard (the port never demotes)",
    "rs_pallas_gemm_calls_total": "Pallas kernel calls (the port counts K1 launches itself)",
    # XLA buffer donation: a plan of the port owns its static buffers.
    "rs_donation_host_copy_bytes_total": "XLA buffer donation",
    "rs_donation_restages_total": "XLA buffer donation",
}


def _names(package: str) -> set[str]:
    out = set()
    for p in (ROOT / package).rglob("*.py"):
        out.update(_REGISTERED.findall(p.read_text()))
    return out


def test_every_jax_metric_name_is_registered_by_the_port():
    jax_names, port_names = _names("gpu_rscode_tpu"), _names("gpu_rscode_torch")
    assert jax_names - port_names == set(NOT_IN_PORT)
    # Each listed name is still one the JAX package registers.
    assert set(NOT_IN_PORT) <= jax_names
