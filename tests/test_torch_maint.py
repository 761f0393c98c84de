"""The port's maintenance plane (``maint/``, ``rs maint``, the daemon's
``--maint``) against the JAX package's, on the CPU: the token bucket and
the burn-rate governor step for step, the knobs, discovery order over one
damage ledger and store root, leases, crash convergence, the damage-ledger
records one ``rs maint --drain`` leaves (byte-equal apart from the clock,
the run identity and the archives' directory), and ``GET /maint`` with the
plane on.  Tolerance 0."""

import contextlib
import io
import json
import os
import shutil
import time
import urllib.request

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch import store as t_store
from gpu_rscode_torch.maint import controller as t_maint
from gpu_rscode_torch.obs import health as t_health
from gpu_rscode_torch.serve import daemon as t_daemon
from gpu_rscode_torch.utils.fileformat import chunk_file_name
from gpu_rscode_tpu import store as j_store
from gpu_rscode_tpu.maint import controller as j_maint
from gpu_rscode_tpu.serve import daemon as j_daemon

CPU = {"device": "cpu"}
KNOBS = ("RS_MAINT", "RS_MAINT_TENANT", "RS_MAINT_BYTES_PER_S", "RS_MAINT_BURN_PAUSE", "RS_MAINT_RESUME",
         "RS_MAINT_LEASE_S", "RS_MAINT_INTERVAL_S", "RS_MAINT_CRASH", "RS_HEALTH_SCRUB_MAX_AGE_S",
         "RS_RUNLOG_MAX_BYTES", "RS_STORE_COMPACT_DEAD_FRAC")
# Record fields that name the run, the clock or the process, not the data.
VOLATILE = ("ts", "run", "host", "git_sha", "backend", "proc", "metrics_digest", "owner", "schema")


@pytest.fixture(autouse=True)
def _clean_knobs(monkeypatch):
    for name in KNOBS:
        monkeypatch.delenv(name, raising=False)
    monkeypatch.delenv("RS_RUNLOG", raising=False)


class _Clock:
    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_token_bucket_matches_jax():
    clocks = (_Clock(), _Clock())
    buckets = (t_maint.TokenBucket(1000.0, clock=clocks[0]), j_maint.TokenBucket(1000.0, clock=clocks[1]))
    for step, (dt, n) in enumerate([(0, 500), (0, 1800), (0.5, 100), (3, 4000), (0.1, 0), (10, 1)]):
        for clock in clocks:
            clock.t += dt
        got = [b.take(n) for b in buckets]
        assert got[0] == got[1], step
        assert buckets[0].taken == buckets[1].taken
    assert t_maint.TokenBucket(0).rate == j_maint.TokenBucket(0).rate == 1.0


def _report(burns, tenant="alpha"):
    return {"cells": [{"tenant": tenant, "op": "encode",
                       "windows": {"60": {"objectives": {"p99": {"burn_rate": b}}}}} for b in burns]}


def test_burn_governor_hysteresis_matches_jax():
    govs = (t_maint.BurnGovernor(pause_at=1.0, resume_at=0.5), j_maint.BurnGovernor(pause_at=1.0, resume_at=0.5))
    seq = [None, _report([0.2]), _report([1.0]), _report([0.7]), _report([0.49]), _report([3.0], tenant="maint"),
           _report([0.1, 2.5]), {"cells": [{"tenant": "beta", "op": "decode", "windows": {"5": {}}}]},
           _report([0.0])]
    for rep in seq:
        assert govs[0].observe(rep) == govs[1].observe(rep)
        assert (govs[0].paused, govs[0].pause_events, govs[0].resume_events, govs[0].last_burn,
                govs[0].worst_cell) == (govs[1].paused, govs[1].pause_events, govs[1].resume_events,
                                        govs[1].last_burn, govs[1].worst_cell)
    assert list(govs[0].events) == list(govs[1].events) and govs[0].pause_events == 2
    assert t_maint.BurnGovernor(pause_at=1.0, resume_at=5.0).resume_at == 1.0


@pytest.mark.parametrize("env", [{}, {"RS_MAINT": "1", "RS_MAINT_TENANT": "bg", "RS_MAINT_BURN_PAUSE": "2",
                                      "RS_MAINT_RESUME": "x", "RS_MAINT_BYTES_PER_S": "1e6",
                                      "RS_MAINT_INTERVAL_S": "0.5"}, {"RS_MAINT": "off"}])
def test_knobs_match_jax(monkeypatch, env):
    for key, val in env.items():
        monkeypatch.setenv(key, val)
    for name in ("enabled", "tenant_env", "burn_pause_env", "burn_resume_env", "bytes_per_s_env", "interval_env"):
        assert getattr(t_maint, name)() == getattr(j_maint, name)(), name
    assert t_maint.MAINT_COST_WEIGHT == j_maint.MAINT_COST_WEIGHT and t_maint.MAX_ATTEMPTS == j_maint.MAX_ATTEMPTS


@pytest.mark.parametrize("spec", ["", "repair", "repair:claimed", "repair:mid", "scrub:claimed", "compact:done"])
def test_crash_points_match_jax(monkeypatch, spec):
    monkeypatch.setenv("RS_MAINT_CRASH", spec)
    for kind, stage in (("repair", "claimed"), ("repair", "mid"), ("scrub", "claimed"), ("compact", "done")):
        t_out = _outcome(lambda: t_maint._crash_point(kind, stage))
        j_out = _outcome(lambda: j_maint._crash_point(kind, stage))
        assert t_out == j_out


def _outcome(fn):
    try:
        fn()
        return "ok"
    except Exception as e:  # noqa: BLE001 - the class and message are the outcome
        return (type(e).__name__, str(e))


def _fleet(d, ledger, n=3, damaged=(0, 2), size=20_000):
    """``n`` checksummed archives (k=3, p=2), scanned clean into ``ledger``,
    then archive a of ``damaged`` gets a + 1 chunks rotted and is rescanned
    (more lost chunks rank first)."""
    os.makedirs(d, exist_ok=True)
    paths = []
    for a in range(n):
        path = os.path.join(str(d), f"arc{a}.bin")
        with open(path, "wb") as fp:
            fp.write(np.random.default_rng(a).integers(0, 256, size, dtype=np.uint8).tobytes())
        t_api.encode_file(path, 3, 2, checksums=True, segment_bytes=4096, **CPU)
        paths.append(path)
    os.environ["RS_RUNLOG"] = str(ledger)
    try:
        for path in paths:
            t_api.scan_file(path, **CPU)
        for a in damaged:
            for c in range(min(a + 1, 2)):
                with open(chunk_file_name(paths[a], c), "r+b") as fp:
                    fp.seek(10 + c)
                    fp.write(b"\xee\x11")
            t_api.scan_file(paths[a], **CPU)
    finally:
        del os.environ["RS_RUNLOG"]
    return paths


def _dead_heavy_bucket(root):
    b = t_store.open_bucket(str(root), "bkt", create=True, k=2, p=1, stripe_bytes=4096, **CPU)
    for j in range(6):
        b.put(f"o{j}", bytes([j]) * 1500)
    for j in range(5):
        b.delete(f"o{j}")
    t_store.drop_cached()
    j_store.drop_cached()


def test_discover_order_and_leases_match_jax(tmp_path):
    ledger = tmp_path / "ledger.jsonl"
    _fleet(tmp_path / "fleet", ledger)
    _dead_heavy_bucket(tmp_path / "root")
    kw = dict(ledger_path=str(ledger), store_roots=[str(tmp_path / "root")], owner="me")
    t_ctl, j_ctl = t_maint.MaintController(**kw, **CPU), j_maint.MaintController(**kw)
    now = time.time()
    got, want = t_ctl.discover(now=now), j_ctl.discover(now=now)
    assert got == want
    assert [j["kind"] for j in got["jobs"]] == ["repair", "repair", "compact"]
    # A foreign live lease hides its archive from both; an expired one does not.
    target = got["jobs"][0]["target"]
    t_health.record_claim(target, "someone-else", lease_s=60, ledger_path=str(ledger))
    got, want = t_ctl.discover(now=now + 1), j_ctl.discover(now=now + 1)
    assert got == want and got["skipped_claimed"] == 1 and target not in [j["target"] for j in got["jobs"]]
    assert t_ctl.discover(now=now + 3600) == j_ctl.discover(now=now + 3600)
    assert t_ctl.discover(now=now + 3600)["skipped_claimed"] == 0
    # The job byte estimates agree too.
    for job in got["jobs"]:
        assert t_ctl._job_bytes(job) == j_ctl._job_bytes(job)
    t_store.drop_cached()
    j_store.drop_cached()


def _records(ledger, root):
    out = []
    for line in open(ledger):
        rec = json.loads(line)
        if rec.get("kind") != "rs_damage":
            continue
        rec = {k: v for k, v in rec.items() if k not in VOLATILE}
        if "archive" in rec:
            rec["archive"] = os.path.relpath(rec["archive"], root)
        out.append(rec)
    return out


def _maint_main(main, argv, ledger):
    """``rs maint`` of one package with the damage ledger as ``RS_RUNLOG``:
    the jobs' own records (a repair, its rescan) must land in the ledger
    the controller replays, or a drain never sees its work done."""
    buf = io.StringIO()
    saved = os.environ.get("RS_RUNLOG")
    os.environ["RS_RUNLOG"] = str(ledger)
    try:
        with contextlib.redirect_stdout(buf):
            rc = main(argv)
    finally:
        os.environ.pop("RS_RUNLOG")
        if saved is not None:
            os.environ["RS_RUNLOG"] = saved
    return rc, json.loads(buf.getvalue().splitlines()[-1])


def test_drain_ledger_records_and_bytes_match_jax(tmp_path):
    """One `rs maint --drain` in each package over identical damaged
    fleets: equal outcomes, equal restored chunks, and damage-ledger
    records equal apart from the clock, the run and the directory."""
    ledgers, fleets = {}, {}
    for who in ("t", "j"):
        ledgers[who] = tmp_path / who / "ledger.jsonl"
        fleets[who] = _fleet(tmp_path / who, ledgers[who])
    pristine = {c: open(chunk_file_name(fleets["t"][1], c), "rb").read() for c in range(5)}
    base = ["--drain", "--json", "--owner", "cli", "--bytes-per-s", "1e12"]
    t_rc, t_doc = _maint_main(t_maint.main, ["--device", "cpu", *base], ledgers["t"])
    j_rc, j_doc = _maint_main(j_maint.main, base, ledgers["j"])
    assert t_rc == j_rc == 0
    for doc in (t_doc, j_doc):
        doc["stats"].pop("last_jobs")
        doc["stats"].pop("owner")
    assert t_doc == j_doc and t_doc["jobs"] == 2 and t_doc["remaining"] == 0
    for a in (0, 2):
        for c in range(5):
            assert open(chunk_file_name(fleets["t"][a], c), "rb").read() == \
                open(chunk_file_name(fleets["j"][a], c), "rb").read()
    assert all(open(chunk_file_name(fleets["t"][1], c), "rb").read() == pristine[c] for c in range(5))
    assert _records(ledgers["t"], tmp_path / "t") == _records(ledgers["j"], tmp_path / "j")


@pytest.mark.parametrize("stage", ["repair:claimed", "repair:mid"])
def test_crash_then_same_owner_restart_converges_like_jax(tmp_path, monkeypatch, stage):
    results = []
    for who, maint, kw in (("t", t_maint, CPU), ("j", j_maint, {})):
        ledger = tmp_path / who / "ledger.jsonl"
        paths = _fleet(tmp_path / who, ledger, n=2, damaged=(1,))
        monkeypatch.setenv("RS_RUNLOG", str(ledger))
        monkeypatch.setenv("RS_MAINT_CRASH", stage)
        ctl = maint.MaintController(ledger_path=str(ledger), owner="o", bytes_per_s=1e12, interval_s=0.01, **kw)
        with pytest.raises(maint.MaintCrash, match=f"injected crash at {stage}"):
            ctl.drain()
        monkeypatch.delenv("RS_MAINT_CRASH")
        state = t_health.load(str(ledger))
        claim = state["archives"][os.path.abspath(paths[1])].get("claim")
        # A live own claim after the claim stage; the repair's record
        # cleared it after the mid stage.
        results.append(bool(claim) and claim.get("owner") == "o")
        out = maint.MaintController(ledger_path=str(ledger), owner="o", bytes_per_s=1e12, interval_s=0.01,
                                    **kw).drain()
        assert out["remaining"] == 0 and out["skipped_claimed"] == 0
        assert t_api.scan_file(paths[1], **CPU)["corrupt"] == []
        results.append((out, _records(ledger, tmp_path / who)))
    assert results[0] == results[2] and results[1] == results[3]
    assert results[0] is (stage == "repair:claimed")


def test_rs_maint_cli_surface(tmp_path, capsys, monkeypatch):
    assert t_cli.main(["maint", "--device", "cpu"]) == 2
    assert "no work sources" in capsys.readouterr().err
    ledger = tmp_path / "ledger.jsonl"
    _fleet(tmp_path / "fleet", ledger, n=2, damaged=(0,))
    assert t_cli.main(["maint", "--ledger", str(ledger)]) == 1  # no GPU here and no --device
    assert "no CUDA device" in capsys.readouterr().err
    monkeypatch.setenv("RS_RUNLOG", str(ledger))
    assert t_cli.main(["maint", "--device", "cpu"]) == 0
    assert "maint queue: 1 job(s)" in capsys.readouterr().out
    assert t_cli.main(["maint", "--device", "cpu", "--watch", "0.1", "--count", "1", "--json",
                       "--bytes-per-s", "1e12"]) == 0
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row["kind"] == "rs_maint_pass" and row["ran"] == 1 and row["jobs"] == {"repair": {"ok": 1}}
    assert t_cli.main(["maint", "--device", "cpu", "--drain", "--json"]) == 0
    assert json.loads(capsys.readouterr().out)["remaining"] == 0


def _get(port, path):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=60) as resp:
        return json.loads(resp.read())


def test_get_maint_with_the_plane_on_heals_like_jax(tmp_path, monkeypatch):
    """`rs serve --maint` (maint=True) on both packages over copies of one
    damaged root: GET /maint reports the plane with the same keys, and
    each daemon's maint tenant repairs its copy in the background."""
    monkeypatch.setenv("RS_MAINT_INTERVAL_S", "0.1")
    monkeypatch.setenv("RS_MAINT_BYTES_PER_S", "1e12")
    answers = {}
    for who, mod, kw in (("t", t_daemon, CPU), ("j", j_daemon, {})):
        root = tmp_path / who / "root"
        ledger = tmp_path / who / "ledger.jsonl"
        paths = _fleet(root / "alpha", ledger, n=1, damaged=(0,))
        monkeypatch.setenv("RS_RUNLOG", str(ledger))
        d = mod.ServeDaemon(str(root), port=0, maint=True, **kw).start()
        try:
            deadline = time.time() + 60
            while time.time() < deadline:
                doc = _get(d.port, "/maint")
                if doc["jobs"].get("repair", {}).get("ok") and not doc["queue"]["repair"]:
                    break
                time.sleep(0.1)
            assert d.stats()["maint"]["enabled"] is True
        finally:
            d.close()
        assert doc["kind"] == "rs_maint" and doc["enabled"] is True and doc["running"] is True
        assert doc["owner"].endswith(f":serve:{root}") and doc["tenant"] == "maint"
        assert t_api.scan_file(paths[0], **CPU)["corrupt"] == []
        answers[who] = {k: v for k, v in doc.items() if k not in ("owner", "last_jobs", "passes", "governor_events")}
        monkeypatch.delenv("RS_RUNLOG")
    assert set(answers["t"]) == set(answers["j"])
    assert answers["t"]["jobs"]["repair"] == answers["j"]["jobs"]["repair"] == {"ok": 1}
    assert answers["t"]["queue"] == answers["j"]["queue"]
    shutil.rmtree(tmp_path / "t")


def test_a_maint_job_runs_on_its_own_lane_beside_the_foreground(tmp_path):
    """A maint job admitted by the DRR queue runs on the daemon's maint
    lane under its target's foreground lock: while it runs, the single
    foreground worker still serves an encode, and a job on the same
    archive name waits for the lock."""
    import threading

    d = t_daemon.ServeDaemon(str(tmp_path / "root"), port=0, maint=True, workers=1, **CPU).start()
    release, started, ran_on = threading.Event(), threading.Event(), []

    def job():
        ran_on.append(threading.current_thread().name)
        started.set()
        release.wait(60)
        return {"held": True}

    target = str(tmp_path / "root" / "alpha" / "a.bin")
    maint = threading.Thread(target=lambda: ran_on.append(d._submit_maint_job(job, name=target, cost=1)))
    try:
        maint.start()
        assert started.wait(60)
        body = bytes(range(256)) * 40
        req = urllib.request.Request(f"http://127.0.0.1:{d.port}/encode?name=b.bin&k=4&n=6", data=body,
                                     method="POST", headers={"X-RS-Tenant": "alpha"})
        with urllib.request.urlopen(req, timeout=60) as resp:
            assert resp.status == 200 and json.loads(resp.read())["ok"] is True
        assert d._maint_lock_key(target) == ("alpha", "a.bin")
        assert d._name_lock(("alpha", "a.bin")).locked()
    finally:
        release.set()
        maint.join(60)
        d.close()
    assert ran_on[0].startswith("rs-serve-maint") and ran_on[1] == {"held": True}
