"""The port's load generator (``gpu_rscode_torch.serve.loadgen``, ``rs
loadgen``) against the JAX package's, on the CPU.

The arrival plan, the zipf weights, the tenant parsing, the per-request
detail and the recorder's rows must equal the JAX package's for the same
seed and inputs (tolerance 0).  A short ``rs loadgen --spawn --device cpu``
run writes a capture with the JAX run's row kinds and keys; every capture
goes to a temporary path, none into the repo's ``bench_captures/``."""

import json
import os
import pathlib

import pytest

from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch.obs import metrics as t_metrics
from gpu_rscode_torch.serve import loadgen as t_lg
from gpu_rscode_tpu import cli as j_cli
from gpu_rscode_tpu.obs import metrics as j_metrics
from gpu_rscode_tpu.serve import loadgen as j_lg

REPO = pathlib.Path(__file__).resolve().parents[1]
CAPTURES = REPO / "bench_captures"


@pytest.fixture(autouse=True)
def _clean_metrics():
    yield
    for m in (j_metrics, t_metrics):
        m.force_enable(False)
        m.REGISTRY.reset()


MIXES = [
    dict(duration_s=15.0, rate=8.0, tenants=[("alpha", 3.0), ("beta", 1.0)], decode_frac=0.3, seed=0),
    dict(duration_s=15.0, rate=32.0, tenants=[("alpha", 1.0)], decode_frac=0.0, seed=7, update_frac=0.1,
         object_frac=0.6),
    dict(duration_s=60.0, rate=20.0, tenants=[("a", 1.0), ("b", 2.0), ("c", 0.5)], decode_frac=0.3, seed=5,
         update_frac=0.4),
]


@pytest.mark.parametrize("mix", range(len(MIXES)))
def test_schedule_is_the_same_arrival_plan_as_jax(mix):
    kw = MIXES[mix]
    plan = t_lg._schedule(kw["duration_s"], kw["rate"], kw["tenants"], kw["decode_frac"], kw["seed"],
                          kw.get("update_frac", 0.0), kw.get("object_frac", 0.0))
    assert plan == j_lg._schedule(kw["duration_s"], kw["rate"], kw["tenants"], kw["decode_frac"], kw["seed"],
                                  kw.get("update_frac", 0.0), kw.get("object_frac", 0.0))
    assert len(plan) > 50


@pytest.mark.parametrize("keys,s", [(256, 1.1), (10, 0.0), (1000, 2.0)])
def test_zipf_weights_equal_jax(keys, s):
    assert t_lg._zipf_weights(keys, s) == j_lg._zipf_weights(keys, s)


@pytest.mark.parametrize("spec", ["alpha:3,beta:1", "a,b:2.5", ":1", "x:0", "x:-1"])
def test_tenant_parsing_equal_jax(spec):
    def run(mod):
        try:
            return ("ok", mod._parse_tenants(spec))
        except ValueError as e:
            return ("error", str(e))

    assert run(t_lg) == run(j_lg)


DETAILS = [
    (b'{"req_id": "r1", "stages_ms": {"admit": 0.0, "ack": 12.5}, "update": {"group_id": "wg-1"}}', {}, True),
    (b'{"req_id": "r2", "object": {"group_id": "og-2"}}', {"X-RS-Request-Id": "h2"}, True),
    (b"not json", {"X-RS-Request-Id": "h3"}, True),
    (b"bytes", {"X-RS-Request-Id": "h4", "X-RS-Cache": "hit", "X-RS-Read-Path": "cached",
                "X-RS-Stages": '{"admit": 0.0, "ack": 0.001}'}, False),
]


@pytest.mark.parametrize("case", range(len(DETAILS)))
def test_request_detail_equal_jax(case):
    payload, headers, json_body = DETAILS[case]
    assert t_lg._request_detail(payload, headers, json_body) == j_lg._request_detail(payload, headers, json_body)


def test_recorder_rows_and_totals_equal_jax():
    recs = [t_lg._Recorder(), j_lg._Recorder()]
    stream = [("alpha", "encode", 200, 0.01 * i, 1000 + i) for i in range(30)]
    stream += [("beta", "decode", 429, 0.001, 0), ("beta", "decode", None, 0.5, 0), ("alpha", "update", 500, 0.2, 0)]
    for rec in recs:
        for tenant, op, status, wall, nbytes in stream:
            rec.record(tenant, op, status, wall, nbytes, detail={"req_id": f"{op}-{wall}"})
    assert recs[0].rows() == recs[1].rows()
    assert recs[0].totals() == recs[1].totals()
    assert recs[0].requests == recs[1].requests


def _loadgen(main, tmp_path, tag, extra=()):
    capture = str(tmp_path / f"{tag}.jsonl")
    rc = main(["loadgen", "--spawn", "--duration", "2", "--rate", "10", "--size-kb", "16", "--tenants", "a:2,b:1",
               "--seed", "3", "--root", str(tmp_path / f"{tag}_root"), "--capture", capture, "--json", *extra])
    assert rc == 0
    return [json.loads(line) for line in open(capture)]


def _schema(rows):
    """Each row kind with the union of its keys (the capture's schema)."""
    out: dict[str, set] = {}
    for r in rows:
        out.setdefault(r["kind"], set()).update(r)
    return out


def test_spawned_open_loop_capture_has_the_jax_schema(tmp_path, capsys):
    before = sorted(os.listdir(CAPTURES)) if CAPTURES.is_dir() else []
    t_rows = _loadgen(t_cli.main, tmp_path, "t", ("--device", "cpu"))
    j_rows = _loadgen(j_cli.main, tmp_path, "j")
    assert (sorted(os.listdir(CAPTURES)) if CAPTURES.is_dir() else []) == before  # nothing written there
    assert _schema(t_rows) == _schema(j_rows)
    assert t_rows[0]["kind"] == "capture_header" and t_rows[0]["tool"] == "serve_loadgen"
    assert t_rows[0]["backend"] == "cpu"
    t_sum, j_sum = (next(r for r in rows if r["kind"] == "serve_summary") for rows in (t_rows, j_rows))
    assert t_sum["config"] == j_sum["config"]
    assert t_sum["sent"] == j_sum["sent"] == t_sum["ok"] > 0  # the same plan, every request served
    assert t_sum["failed"] == t_sum["rejected"] == 0


def test_object_cache_ab_runs_on_the_port(tmp_path):
    """The cache A/B's three daemons run on the given device; every GET is
    byte-verified inside, and the small-cap arm must evict."""
    rows = t_lg.run_object_cache_ab(objects=8, object_bytes=2048, gets=40, k=4, p=2, trials=1,
                                    workdir=str(tmp_path), quiet=True, device="cpu")
    on, off, small, margin = rows
    assert on["verdicts"]["hit"] > 0 and off["verdicts"] == {"hit": 0, "miss": 0, "bypass": 40}
    assert small["objcache"]["evictions"] > 0 and margin["kind"] == "object_cache_ab_margin"


def test_residency_ab_runs_both_arms_on_the_port(tmp_path):
    """--ab: the resident daemon and one ``python -m gpu_rscode_torch``
    process per file, both with ``--device cpu``."""
    rows = t_lg.run_ab(files=2, size_bytes=4096, k=4, p=2, workdir=str(tmp_path), quiet=True, device="cpu")
    assert [r["kind"] for r in rows] == ["serve_ab", "serve_ab", "serve_ab_margin"]
    assert [r["arm"] for r in rows[:2]] == ["resident", "subprocess"]
    assert os.path.exists(tmp_path / "ab_0.bin.METADATA")  # the subprocess arm's archive


def test_refusals_and_the_device_rule(tmp_path, capsys):
    """--faults with --spawn and --maint-ab now run (they were refused
    before the fault and maintenance planes were ported); the device rule
    stands."""
    args = ["loadgen", "--spawn", "--duration", "1", "--capture", "-"]
    assert t_cli.main([*args, "--device", "cpu", "--faults", "read:delay@ms=1", "--json"]) == 0
    summary = json.loads(capsys.readouterr().out)["rows"][0]
    assert summary["config"]["faults"] == "read:delay@ms=1" and summary["failed"] == 0
    assert t_cli.main(["loadgen", "--url", "http://127.0.0.1:9", "--faults", "read:delay@ms=1",
                       "--capture", "-"]) == 2
    assert "--faults needs --spawn" in capsys.readouterr().err
    assert t_cli.main([*args, "--device", "cpu", "--faults", "read:melt"]) == 2
    assert "bad --faults spec" in capsys.readouterr().err
    assert t_cli.main(["loadgen", "--maint-ab", "--device", "cpu", "--maint-archives", "1", "--size-kb", "16",
                       "--duration", "2", "--rate", "4", "--maint-p99-max", "1000", "--capture", "-",
                       "--json"]) == 0
    rows = json.loads(capsys.readouterr().out)["rows"]
    assert [r["kind"] for r in rows] == ["maint_ab", "maint_ab", "maint_ab_margin"]
    off, on, margin = rows
    assert (off["repairs_left"], on["repairs_left"]) == (1, 0) and on["chunks_restored"]
    assert on["maint_enabled"] and not off["maint_enabled"] and margin["pause_events"] >= 1
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_lg.run_maint_ab(archives=1, size_bytes=1024, k=4, p=2, workdir=str(tmp_path))
    assert t_cli.main([*args, "--root", str(tmp_path / "r")]) == 2  # no GPU here, no --device
    assert "no CUDA device" in capsys.readouterr().err
