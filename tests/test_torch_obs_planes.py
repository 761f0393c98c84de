"""The port's observability planes against the JAX package's, on the CPU:
``obs/tracing``, ``obs/reqtrace``, ``obs/slo``, ``obs/health``, ``obs/serve``
and the api's damage hooks.

For the same event streams both packages must give equal results
(tolerance 0): trace session files (on one stepped clock; only the
``process_name`` metadata names the package), reqtrace wide events, ring
contents and ledger rows, SLO reports, gauges and the ``rs slo`` replay,
health replays, fleet reports, payload digests and the ``rs health``
output.  The same api calls with ``RS_RUNLOG`` set write equal ``rs_damage``
records; the record envelope (ts, run id, host, git sha, backend, metrics
digest) and the archive's root are left out of that comparison.  The
metrics endpoints answer alike."""

import itertools
import json
import os
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch.obs import health as t_health
from gpu_rscode_torch.obs import metrics as t_metrics
from gpu_rscode_torch.obs import reqtrace as t_reqtrace
from gpu_rscode_torch.obs import runlog as t_runlog
from gpu_rscode_torch.obs import serve as t_oserve
from gpu_rscode_torch.obs import slo as t_slo
from gpu_rscode_torch.obs import tracing as t_tracing
from gpu_rscode_torch.serve import queue as t_queue
from gpu_rscode_torch.utils.fileformat import chunk_file_name
from gpu_rscode_tpu import api as j_api
from gpu_rscode_tpu import cli as j_cli
from gpu_rscode_tpu.obs import health as j_health
from gpu_rscode_tpu.obs import metrics as j_metrics
from gpu_rscode_tpu.obs import reqtrace as j_reqtrace
from gpu_rscode_tpu.obs import serve as j_oserve
from gpu_rscode_tpu.obs import slo as j_slo
from gpu_rscode_tpu.obs import tracing as j_tracing
from gpu_rscode_tpu.serve import queue as j_queue

ENVELOPE = {"ts", "run", "host", "git_sha", "backend", "metrics_digest", "proc"}
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("RS_RUNLOG", "RS_SLO", "RS_SLO_WINDOWS", "RS_TRACE", "RS_REQTRACE_RING", "RS_METRICS",
                "RS_HEALTH_SCRUB_MAX_AGE_S", "RS_HEALTH_AT_RISK", "RS_RUNLOG_MAX_BYTES", "RS_METRICS_PORT"):
        monkeypatch.delenv(var, raising=False)
    yield
    for m in (j_metrics, t_metrics):
        m.force_enable(False)
        m.REGISTRY.reset()
    for r in (j_reqtrace, t_reqtrace):
        r.reset()


class _Clock:
    """A stepped clock for ``time.perf_counter`` / ``time.monotonic`` /
    ``time.time``: each read advances it by 1 ms."""

    def __init__(self, monkeypatch):
        self.monkeypatch = monkeypatch
        self.reset()
        for name in ("perf_counter", "monotonic", "time"):
            monkeypatch.setattr(time, name, self.read)

    def reset(self):
        self._it = itertools.count(1)

    def read(self):
        return 1_000.0 + next(self._it) * 1e-3


# -- tracing ------------------------------------------------------------------


def _trace_session(tr, path):
    with tr.session(path):
        with tr.span("encode", lane="dispatch", k=4, seg=np.int64(3)):
            tr.instant("swap", lane="host", chunk=2)
            with tr.span("inner"):
                tr.counter("staging", free=3, busy=1)
        tr.complete("queue_wait", "req:queue_wait", 1_000.0, 1_000.25, req_id="r1")

        @tr.traced("decorated", lane="write")
        def work(x):
            return x + 1

        assert work(1) == 2
        with pytest.warns(UserWarning, match="already active"), tr.session(path + ".inner"):
            tr.instant("nested")  # joins the outer session
    with open(path) as fp:
        return json.load(fp)


def test_trace_session_files_equal_jax(tmp_path, monkeypatch):
    clock = _Clock(monkeypatch)
    j_doc = _trace_session(j_tracing, str(tmp_path / "j.json"))
    clock.reset()
    t_doc = _trace_session(t_tracing, str(tmp_path / "t.json"))
    names = [e for e in t_doc["traceEvents"] if e["name"] == "process_name"]
    assert names == [{"name": "process_name", "ph": "M", "pid": 1, "args": {"name": "gpu_rscode_torch"}}]
    names[0]["args"]["name"] = "gpu_rscode_tpu"
    assert t_doc == j_doc
    assert not os.path.exists(tmp_path / "t.json.inner")


def test_mark_epoch_rides_the_export_like_jax(tmp_path, monkeypatch):
    clock = _Clock(monkeypatch)
    docs = []
    for tr, tag in ((j_tracing, "j"), (t_tracing, "t")):
        clock.reset()
        monkeypatch.setattr(tr, "_EPOCH", None)
        monkeypatch.setattr(tr, "_PROCESS_INDEX", None)
        tr.mark_epoch(process_index=3, epoch=12.5)
        t = tr.Tracer(str(tmp_path / f"{tag}.json"))
        with open(t.export()) as fp:
            docs.append(json.load(fp)["otherData"])
    assert docs[0] == docs[1]
    assert docs[1]["rs_epoch"] == 12.5 and docs[1]["rs_process_index"] == 3


def test_tracing_off_is_a_no_op_like_jax():
    for tr in (j_tracing, t_tracing):
        assert tr.active() is None
        with tr.span("x") as got:
            assert got is None
        tr.instant("x")
        tr.counter("x", v=1)
        tr.complete("x", "lane", 0.0, 1.0)


# -- reqtrace -----------------------------------------------------------------


@pytest.mark.parametrize("text", ["cid-1", "a.b_c-D", "x" * 64, "x" * 65, "bad id", "", None, "ü"])
def test_request_ids_accepted_or_minted_like_jax(text):
    t, j = t_reqtrace.accept_request_id(text), j_reqtrace.accept_request_id(text)
    if text and j == text:
        assert t == text
    else:
        assert len(t) == len(j) == 16 and int(t, 16) >= 0 and t != text


def _wide_events(rt, qmod, ledger, monkeypatch):
    monkeypatch.setenv("RS_RUNLOG", ledger)
    monkeypatch.setenv("RS_REQTRACE_RING", "3")
    rt.reset()
    out = []
    specs = [("encode", 200, "ok", None), ("decode", 200, "ok", None), ("object_get", 200, "ok", "hit"),
             ("encode", 429, None, None), ("update", 500, "error", None), ("scrub", None, "ok", None)]
    for i, (op, status, outcome, cache) in enumerate(specs):
        req = qmod.Request(op, ["alpha", "beta"][i % 2], f"n{i}", "/x", cost=1000 * (i + 1), req_id=f"r{i}")
        req.arrival = 100.0 + i
        rt.begin(req)
        for j, stage in enumerate(rt.STAGES[1:][: 2 + i]):
            rt.mark(req, stage, req.arrival + 0.01 * (j + 1) * (i + 1))
        req.outcome, req.batch_id, req.batch_size, req.service_s = outcome, i, 1 + i % 2, 0.003 * i
        req.group_id = "wg-1" if op == "update" else None
        req.error = ValueError("x") if outcome == "error" else None
        req.cache, req.path = (cache, "cached") if cache else (None, None)
        out.append(rt.emit(req, status=status))
    return out, rt.recent(10), rt.recent(0)


def test_wide_events_ring_and_ledger_rows_equal_jax(tmp_path, monkeypatch):
    for m in (j_metrics, t_metrics):
        m.force_enable()
    j_out = _wide_events(j_reqtrace, j_queue, str(tmp_path / "j.jsonl"), monkeypatch)
    t_out = _wide_events(t_reqtrace, t_queue, str(tmp_path / "t.jsonl"), monkeypatch)
    assert t_out == j_out
    assert len(t_out[1]) == 3 and t_out[2] == []
    rows = [[{k: v for k, v in r.items() if k not in ENVELOPE} for r in t_runlog.read_records(str(tmp_path / f))]
            for f in ("j.jsonl", "t.jsonl")]
    assert rows[0] == rows[1] and len(rows[1]) == 6
    snaps = [m.REGISTRY.snapshot()["rs_serve_stage_seconds"] for m in (j_metrics, t_metrics)]
    assert snaps[0] == snaps[1]


def test_disabled_lifecycle_plane_allocates_nothing_like_jax():
    for rt, qmod in ((j_reqtrace, j_queue), (t_reqtrace, t_queue)):
        assert not rt.enabled()
        req = qmod.Request("encode", "a", "n", "/x")
        rt.begin(req)
        rt.mark(req, "dequeue")
        assert req.stages is None and rt.emit(req, status=200) is None


# -- SLO ----------------------------------------------------------------------

SPECS = ["default:encode:p99=250ms,avail=99.9;*:decode:p99=1s", "*:*:p50=10,p90=0.5s", "a:*:avail=50;*:x:p99=2ms",
         "", "nope", "a:b:p99=fast", "a:b:avail=100", "a:b:zz=1", "a:b:", "a:b:p99", "a:b:avail=x"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_slo_equal_jax(spec):
    def run(mod):
        try:
            return ("ok", [o.describe() for o in mod.parse_slo(spec)])
        except mod.SLOSpecError as e:
            return ("error", str(e))

    assert run(t_slo) == run(j_slo)


def _slo_run(mod, metrics):
    metrics.force_enable()
    eng = mod.SLOEngine(spec="alpha:encode:p99=100ms,avail=90;*:decode:p50=1s;beta:*:avail=99",
                        window_lengths=(60.0, 300.0))
    rng = np.random.default_rng(11)
    for i in range(400):
        tenant = ["alpha", "beta", "gamma"][int(rng.integers(0, 3))]
        op = ["encode", "decode", "scrub"][int(rng.integers(0, 3))]
        eng.observe(tenant, op, float(rng.exponential(0.08)), ok=bool(rng.random() < 0.93), t=float(i))
    rep = eng.export_gauges(now=400.0)
    snap = metrics.REGISTRY.snapshot()
    return (rep, mod.breaches(rep), mod.render(rep),
            {k: snap[k] for k in ("rs_slo_attainment", "rs_slo_burn_rate", "rs_slo_requests_total")})


def test_slo_engine_reports_gauges_and_render_equal_jax():
    t, j = _slo_run(t_slo, t_metrics), _slo_run(j_slo, j_metrics)
    assert t == j
    assert t[1] and "[!!]" in t[2]


def test_rs_slo_replay_equal_jax(tmp_path, capsys):
    ledger = tmp_path / "l.jsonl"
    rng = np.random.default_rng(12)
    with open(ledger, "w") as fp:
        for i in range(120):
            fp.write(json.dumps({"kind": "rs_request", "ts": 5000.0 + i, "tenant": ["a", "b"][i % 2],
                                 "op": ["encode", "decode"][i % 3 == 0], "wall_s": float(rng.exponential(0.2)),
                                 "outcome": "ok" if rng.random() < 0.9 else "error"}) + "\n")
        fp.write("torn {\n")
    outs = []
    for main in (j_cli.main, t_cli.main):
        res = []
        for args in (["--json"], [], ["--check"]):
            rc = main(["slo", "--runlog", str(ledger), "--slo", "*:encode:p99=300ms;a:decode:avail=95", *args])
            cap = capsys.readouterr()
            res.append((rc, cap.out, cap.err))
        rc = main(["slo", "--runlog", str(ledger), "--slo", "a:b:zz=1"])
        res.append((rc, capsys.readouterr().err))
        outs.append(res)
    assert outs[0] == outs[1]
    assert outs[1][2][0] == 4


# -- health -------------------------------------------------------------------


def _damage_stream(seed: int):
    rng = np.random.default_rng(seed)
    recs = []
    archives = [f"/fleet/a{i}.bin" for i in range(6)]
    for i in range(150):
        a = archives[int(rng.integers(0, len(archives)))]
        ev = ["scan", "syndrome", "decode_failure", "repair", "repair_failed", "update", "claim", "release",
              "future_kind"][int(rng.integers(0, 9))]
        rec = {"kind": "rs_damage", "cls": "damage", "event": ev, "archive": a, "ts": 1000.0 + 10 * i,
               "k": 4, "p": int(rng.integers(1, 4)), "w": 8}
        if ev == "scan":
            rec["states"] = {str(c): ["crc_mismatch", "missing", "truncated", "silent_bitrot"][int(rng.integers(0, 4))]
                             for c in rng.choice(6, size=int(rng.integers(0, 3)), replace=False)}
            rec["generation"] = int(rng.integers(0, 3))
        elif ev in ("syndrome", "decode_failure", "repair"):
            rec["chunks"] = sorted(int(c) for c in rng.choice(6, size=int(rng.integers(0, 3)), replace=False))
        elif ev in ("claim", "release"):
            rec["owner"] = ["m1", "m2"][int(rng.integers(0, 2))]
            rec["lease_s"] = 300.0
        recs.append(rec)
        if i == 75:
            recs.append({"kind": "rs_health_snapshot", "algo_version": 1, "snap_id": "s1",
                         "archives": {"/fleet/x.bin": {"k": 4, "p": 2}}, "payload_digest": "bad", "ts": 1.0})
    return recs


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_health_replay_reports_and_digests_equal_jax(seed, monkeypatch):
    recs = _damage_stream(seed)
    out = []
    for h, m in ((j_health, j_metrics), (t_health, t_metrics)):
        m.force_enable()
        state = h.replay(recs)
        pure = h.replay(recs, use_snapshots=False)
        rep = h.fleet_report(state, now=3000.0)
        h.export_metrics(rep)
        snap = h.snapshot_record(state)
        snap["snap_id"] = "fixed"
        again = h.replay(recs + [{**snap, "ts": 2999.0}])
        out.append((h.canonical(state), h.canonical(pure), rep, h.work_queue(state, now=3000.0),
                    h.payload_digest(state["archives"]), h.render_table(rep, top=3), h.canonical(again),
                    {k: v for k, v in m.REGISTRY.snapshot().items() if k.startswith("rs_durability")}))
    assert out[0] == out[1]
    assert out[1][0] == out[1][6]  # a checkpoint replays to the state it froze
    assert out[1][2]["total"] > 0 and out[1][2]["snapshots_corrupt"] == 1


def test_rs_health_output_equal_jax(tmp_path, monkeypatch, capsys):
    ledger = tmp_path / "l.jsonl"
    with open(ledger, "w") as fp:
        for rec in _damage_stream(4):
            fp.write(json.dumps(rec) + "\n")
    monkeypatch.setattr(time, "time", lambda: 4000.0)
    outs = []
    for main in (j_cli.main, t_cli.main):
        res = []
        for args in (["--json"], ["--top", "2"], []):
            rc = main(["health", "--ledger", str(ledger), *args])
            res.append((rc, capsys.readouterr().out))
        outs.append(res)
    assert outs[0] == outs[1]
    assert t_cli.main(["health"]) == 2
    assert "no ledger configured" in capsys.readouterr().err


def _archive(root, name, size, seed, api, **kw):
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, name)
    with open(path, "wb") as fp:
        fp.write(np.random.default_rng(seed).integers(0, 256, size=size, dtype=np.uint8).tobytes())
    api.encode_file(path, 4, 2, **kw)
    os.unlink(path)
    return path


def _flip(path, index, offset):
    with open(chunk_file_name(path, index), "r+b") as fp:
        fp.seek(offset)
        b = fp.read(1)
        fp.seek(offset)
        fp.write(bytes([b[0] ^ 0x77]))


def _api_scenario(api, root, ledger, monkeypatch, kw):
    monkeypatch.setenv("RS_RUNLOG", ledger)
    a = _archive(root, "a.bin", 9000, 1, api, checksums=True, **kw)
    b = _archive(root, "b.bin", 7000, 2, api, checksums=False, **kw)
    c = _archive(root, "c.bin", 5000, 3, api, checksums=True, layout="interleaved", **kw)
    os.unlink(chunk_file_name(a, 1))
    _flip(a, 4, 10)
    api.scan_file(a, **kw)  # missing + crc_mismatch
    assert api.repair_file(a, **kw) == [1, 4]  # repair
    api.scan_file(a, **kw)  # clean: clears the map
    _flip(b, 2, 33)
    api.scan_file(b, syndrome=True, **kw)  # syndrome
    for i in range(3):
        os.unlink(chunk_file_name(b, i))
    with pytest.raises(ValueError):
        api.repair_file(b, **kw)  # repair_failed
    with pytest.raises(ValueError):
        api.repair_fleet([b], **kw)  # repair_failed, the fleet's
    api.update_file(c, 100, b"z" * 300, **kw)
    api.append_file(c, b"y" * 1000, **kw)
    api.update_file_many(c, [{"op": "update", "at": 0, "data": b"q" * 10}, {"op": "append", "data": b"r" * 7}], **kw)
    # A survivor that fails after the scan chose it: decode_failure, then
    # the reselection decodes.
    real = api.decode_file
    calls = []

    def flaky(in_file, conf, *a, **k):
        calls.append(1)
        if len(calls) == 1:
            raise api.ChunkIntegrityError({0: chunk_file_name(in_file, 0)})
        return real(in_file, conf, *a, **k)

    monkeypatch.setattr(api, "decode_file", flaky)
    api.auto_decode_file(c, os.path.join(root, "c.out"), **kw)
    monkeypatch.setattr(api, "decode_file", real)
    # The damage records only: the JAX package also writes an rs_run record
    # per file operation (its _observed_file_op, not ported yet).
    return [{k: (v.replace(root, "<root>") if isinstance(v, str) else v) for k, v in r.items() if k not in ENVELOPE}
            for r in t_runlog.read_records(ledger) if r.get("kind") == "rs_damage"]


def test_api_damage_hooks_write_the_records_jax_writes(tmp_path, monkeypatch):
    j_rows = _api_scenario(j_api, str(tmp_path / "j"), str(tmp_path / "j.jsonl"), monkeypatch, {})
    t_rows = _api_scenario(t_api, str(tmp_path / "t"), str(tmp_path / "t.jsonl"), monkeypatch, CPU)
    assert t_rows == j_rows
    events = [r["event"] for r in t_rows]
    for ev in ("scan", "repair", "syndrome", "repair_failed", "update", "decode_failure"):
        assert ev in events, ev
    assert events.count("repair_failed") == 2 and events.count("update") == 3


def test_hooks_write_nothing_without_a_ledger(tmp_path):
    a = _archive(str(tmp_path), "a.bin", 3000, 1, t_api, checksums=True, **CPU)
    t_api.scan_file(a, **CPU)
    t_api.update_file(a, 0, b"x", **CPU)
    assert sorted(os.listdir(tmp_path)) == sorted(
        [f"_{i}_a.bin" for i in range(6)] + ["a.bin.METADATA"])


# -- the metrics endpoint -----------------------------------------------------


def _get(port, path):
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=10) as resp:
            return resp.status, resp.read(), resp.headers.get("Content-Type")
    except urllib.error.HTTPError as e:
        body = e.read()
        e.close()
        return e.code, body, e.headers.get("Content-Type")


def test_metrics_endpoints_answer_alike(tmp_path):
    ledger = tmp_path / "l.jsonl"
    with open(ledger, "w") as fp:
        for i in range(5):
            fp.write(json.dumps({"kind": "rs_run", "i": i}) + "\n")
    servers = []
    try:
        for osrv, m in ((j_oserve, j_metrics), (t_oserve, t_metrics)):
            srv = osrv.start(0, str(ledger), "127.0.0.1")
            servers.append((osrv, srv))
            m.counter("rs_demo_total", "a demo series").labels(op="encode").inc(3)
            m.gauge("rs_demo_depth", "a demo gauge").set(7)
        answers = []
        for _, srv in servers:
            port = srv.server_address[1]
            health = json.loads(_get(port, "/healthz")[1])
            answers.append((_get(port, "/metrics"), _get(port, "/runs?n=2"), _get(port, "/runs?n=0"),
                            _get(port, "/nope"), sorted(health), health["ok"], health["metrics_enabled"]))
        assert answers[0] == answers[1]
        assert b"rs_demo_total" in answers[1][0][1] and len(json.loads(answers[1][1][1])) == 2
    finally:
        for osrv, srv in servers:
            osrv.stop(srv)


def test_metrics_port_env_starts_one_server(monkeypatch):
    monkeypatch.setenv("RS_METRICS_PORT", "0")
    monkeypatch.setenv("RS_METRICS_ADDR", "127.0.0.1")
    srv = t_oserve.maybe_start_from_env()
    try:
        assert srv is not None and t_oserve.maybe_start_from_env() is srv
        assert t_metrics.enabled()
        assert _get(srv.server_address[1], "/runs")[0] == 404  # no ledger configured
    finally:
        t_oserve.stop(srv)
    assert t_oserve._ENV_SERVER is None
