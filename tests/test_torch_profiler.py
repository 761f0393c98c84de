"""The port's stage profiler (gpu_rscode_torch/obs/profiler.py) and its
``RS_PROFILE`` / ``--profile-dir`` session, against the JAX package's on
the CPU: the disabled path registers nothing, and for the same seeded
bitplane / xor / ring dispatches and file operations the wide events carry
the same keys, op, strategy, width, bucket, bytes, stage names and cache
keys (the walls differ).
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import plan as t_plan
from gpu_rscode_torch.obs import metrics as t_metrics
from gpu_rscode_torch.obs import profiler as t_prof
from gpu_rscode_torch.obs import runlog as t_runlog
from gpu_rscode_torch.ops import xor_gemm as t_xor
from gpu_rscode_torch.ops.gemm import to_numpy, to_tensor
from gpu_rscode_torch.tools.make_conf import make_conf
from gpu_rscode_tpu import api as j_api
from gpu_rscode_tpu import plan as j_plan
from gpu_rscode_tpu.models.vandermonde import vandermonde_matrix
from gpu_rscode_tpu.obs import metrics as j_metrics
from gpu_rscode_tpu.obs import profiler as j_prof
from gpu_rscode_tpu.obs import runlog as j_runlog
from gpu_rscode_tpu.ops import xor_gemm as j_xor
from gpu_rscode_tpu.ops.gf import get_field

# What a wide event says about its dispatch, walls left out.
_SAME = ("kind", "op", "strategy", "w", "bucket", "bytes", "bytes_out")


@pytest.fixture(autouse=True)
def _clean_plane(monkeypatch):
    for var in ("RS_PROF", "RS_PROF_SAMPLE", "RS_METRICS", "RS_RUNLOG", "RS_PROFILE", "RS_SCHEDULE_STORE"):
        monkeypatch.delenv(var, raising=False)
    for prof in (t_prof, j_prof):
        prof.force_enable(False)
        prof.reset()
    yield
    for prof, metrics in ((t_prof, t_metrics), (j_prof, j_metrics)):
        prof.force_enable(False)
        prof.reset()
        metrics.force_enable(False)
        metrics.REGISTRY.reset()
    t_api.profile_dir_override(None)


def _stripe(w, m=4096, k=5, p=3, seed=20260804):
    gf = get_field(w)
    A = vandermonde_matrix(p, k, gf)
    rng = np.random.default_rng(seed)
    return A, rng.integers(0, gf.size, size=(k, m)).astype(gf.dtype)


def _t_dispatch(strategy, w=8, m=4096):
    A, B = _stripe(w, m)
    return to_numpy(t_plan.dispatch(A, to_tensor(B), w=w, strategy=strategy))


def _j_dispatch(strategy, w=8, m=4096):
    A, B = _stripe(w, m)
    return np.asarray(j_plan.dispatch(A, jax.device_put(B), w=w, strategy=strategy))


def _shape(ev: dict) -> dict:
    """An event without its walls: the fields both packages must agree on,
    the stage names and the cache keys."""
    out = {key: ev.get(key) for key in _SAME}
    out["keys"] = sorted(ev)
    out["stages"] = sorted(ev["stages"])
    out["cache"] = sorted(ev["cache"])
    out["plan_bucket"] = ev["cache"].get("plan_bucket")
    return out


def _fresh_caches():
    t_plan.PLAN_CACHE.clear()
    j_plan.PLAN_CACHE.clear()
    t_xor.clear_pipeline_cache()
    j_xor.clear_pipeline_cache()


# -- the disabled path ----------------------------------------------------------


def test_disabled_plane_allocates_nothing_and_registers_nothing():
    """As tests/test_profiler.py holds the JAX package's: with RS_PROF
    unset begin() returns None, the pipelines take their unprofiled
    branches, no profile rides the thread and nothing registers."""
    assert not t_prof.enabled()
    assert t_prof.begin(strategy="xor") is None
    _t_dispatch("xor")
    _t_dispatch("ring")
    _t_dispatch("bitplane")
    assert t_prof.active() is None
    assert t_prof.last_event() is None
    assert "rs_prof_stage_seconds" not in t_metrics.REGISTRY.names()
    t_prof.note_op("encode")
    t_prof.note_staging(0.1, 100)
    t_prof.attr(pack="reused")
    t_prof.add_compile(0.5)
    assert t_prof.finish(None) is None
    assert t_prof.active() is None


@pytest.mark.parametrize("strategy", ["xor", "ring"])
@pytest.mark.parametrize("w", [8, 16])
def test_profiled_output_byte_identical(strategy, w):
    """The split stage execution (the ring's three programs untiled) gives
    the unprofiled dispatch's bytes, and the JAX package's."""
    off = _t_dispatch(strategy, w=w)
    t_prof.force_enable(True)
    on = _t_dispatch(strategy, w=w)
    assert np.array_equal(on, off) and np.array_equal(on, _j_dispatch(strategy, w=w))
    assert t_prof.last_event()["strategy"] == strategy


# -- the wide event against the JAX package's -----------------------------------------


@pytest.mark.parametrize("strategy", ["bitplane", "xor", "ring"])
def test_dispatch_events_match_jax(strategy):
    """A cold and a warm dispatch of the same stripe in both packages: the
    same event fields, stage names and cache keys, in the same order."""
    _fresh_caches()
    t_prof.force_enable(True)
    j_prof.force_enable(True)
    t_events, j_events = [], []
    for op in ("encode", None):
        for prof, dispatch, events in ((t_prof, _t_dispatch, t_events), (j_prof, _j_dispatch, j_events)):
            if op:
                prof.note_op(op)
            dispatch(strategy)
            events.append(prof.last_event())
    assert [_shape(e) for e in t_events] == [_shape(e) for e in j_events]
    assert t_events[0]["op"] == "encode" and t_events[1]["op"] == "matmul"
    assert t_events[0]["stages"].get("compile", 0) > 0 and "compile" not in t_events[1]["stages"]
    for ev in t_events:
        assert set(ev["stages"]) <= set(t_prof.STAGES)
        assert 0 < ev["coverage"] <= 1.0
        assert abs(sum(ev["stages"].values()) / ev["wall_s"] - ev["coverage"]) < 1e-3


@pytest.mark.parametrize("strategy", ["bitplane", "xor", "ring"])
def test_file_op_events_match_jax(tmp_path, monkeypatch, strategy):
    """The same seeded encode and decode through both file APIs with
    RS_PROF=1 and a ledger each: the kind=rs_perf records agree event for
    event (op, strategy, width, bucket, bytes, stages, cache keys, the
    staging fields), and `rs history`'s filter drops them in both."""
    _fresh_caches()
    rng = np.random.default_rng(20260807)
    data = rng.integers(0, 256, size=150_001, dtype=np.uint8).tobytes()
    monkeypatch.setenv("RS_PROF", "1")
    records = {}
    for name, api, runlog in (("t", t_api, t_runlog), ("j", j_api, j_runlog)):
        d = tmp_path / name
        d.mkdir()
        src = d / "f.bin"
        src.write_bytes(data)
        ledger = d / "ledger.jsonl"
        monkeypatch.setenv("RS_RUNLOG", str(ledger))
        kw = {"device": "cpu"} if name == "t" else {}
        api.encode_file(str(src), 4, 2, strategy=strategy, segment_bytes=1 << 15, **kw)
        conf = make_conf(6, 4, str(src))
        api.decode_file(str(src), conf, str(d / "out.bin"), strategy=strategy, segment_bytes=1 << 15, **kw)
        assert (d / "out.bin").read_bytes() == data
        recs = runlog.read_records(str(ledger))
        records[name] = [r for r in recs if r.get("kind") == "rs_perf"]
        assert [r["kind"] for r in runlog.filter_records(recs)] == ["rs_run", "rs_run"]

    def shape(r):
        return {**_shape(r), "staging": "staging_s" in r, "staging_bytes": r.get("staging_bytes")}

    assert len(records["t"]) == len(records["j"]) > 4
    assert [shape(r) for r in records["t"]] == [shape(r) for r in records["j"]]
    assert {r["op"] for r in records["t"]} == {"encode", "decode"}


def test_sampling_profiles_one_in_n(tmp_path, monkeypatch):
    ledger = tmp_path / "ledger.jsonl"
    monkeypatch.setenv("RS_RUNLOG", str(ledger))
    monkeypatch.setenv("RS_PROF", "1")
    monkeypatch.setenv("RS_PROF_SAMPLE", "1/3")
    assert t_prof.sample_every() == 3
    for _ in range(6):
        _t_dispatch("table", m=2048)
    recs = t_runlog.read_records(str(ledger))
    perf = [r for r in recs if r.get("kind") == "rs_perf"]
    assert len(perf) == 2  # dispatches 1 and 4 of 6, as in the JAX package
    assert perf[0]["run"] == t_runlog.run_id() and perf[0]["host"]
    assert t_runlog.filter_records(recs) == []
    monkeypatch.setenv("RS_PROF_SAMPLE", "nope")
    assert t_prof.sample_every() == 1


def test_error_dispatch_discards_the_profile(monkeypatch):
    t_prof.force_enable(True)

    def boom(*args):
        raise RuntimeError("injected dispatch failure")

    monkeypatch.setattr(t_plan, "eager", boom)
    t_plan.PLAN_CACHE.clear()
    with pytest.raises(RuntimeError, match="injected"):
        _t_dispatch("table", m=2048)
    assert t_prof.active() is None


def test_a_stage_refuses_to_time_inside_a_capture(monkeypatch):
    """No synchronise inside a CUDA graph capture: run_stage raises there,
    and the plan layer's capture runs with the profile suspended."""
    t_prof.force_enable(True)
    prof = t_prof.begin(strategy="cuda")
    monkeypatch.setattr(t_prof, "_capturing", lambda: True)
    with pytest.raises(RuntimeError, match="capture"):
        t_prof.run_stage("chain", lambda: None)
    with t_prof.suspended() as held:
        assert held is prof and t_prof.active() is None
        assert t_prof.run_stage("chain", lambda: 7) == 7  # forwarded, untimed
    assert t_prof.active() is prof
    t_prof.discard(prof)


def test_pack_timing_never_synchronises_inside_a_capture(monkeypatch):
    """RS_XOR_PACK_TIMING times the xor pack stage by synchronising on its
    planes; inside a graph capture (the profile suspended) it packs
    untimed, and only an eager pack observes rs_xor_pack_seconds."""
    t_metrics.force_enable(True)
    monkeypatch.setenv("RS_XOR_PACK_TIMING", "1")
    synced = []
    real_sync = t_prof.sync
    monkeypatch.setattr(t_prof, "sync", lambda out: synced.append(1) or real_sync(out))
    _, B = _stripe(8, m=1024)
    Bt = to_tensor(B, torch.device("cpu"))
    want = t_xor._pack(Bt, 8)

    def pack_seconds_count():
        fam = t_metrics.REGISTRY.snapshot().get("rs_xor_pack_seconds", {})
        return sum(v["count"] for v in fam.get("values", {}).values())

    monkeypatch.setattr(t_prof, "_capturing", lambda: True)
    with t_prof.suspended():
        got = t_xor._observed_pack(Bt, 8)
    assert not synced and pack_seconds_count() == 0
    assert torch.equal(got, want)
    monkeypatch.setattr(t_prof, "_capturing", lambda: False)
    t_xor._observed_pack(Bt, 8)
    assert synced == [1] and pack_seconds_count() == 1


def test_pack_reuse_counter_counts_replays_not_captures(monkeypatch):
    """rs_xor_pack_reuse_total follows the PACK_REUSE tallies: a pack
    inside a graph capture ran nothing and is not counted, and each replay
    adds what its captured dispatch packed."""
    t_metrics.force_enable(True)

    def reuse_counter():
        fam = t_metrics.REGISTRY.snapshot().get("rs_xor_pack_reuse_total", {})
        return fam.get("values", {})

    before = dict(t_xor.PACK_REUSE)
    monkeypatch.setattr(t_prof, "_capturing", lambda: True)
    t_xor._count_pack_reuse("packed")
    assert reuse_counter() == {}
    monkeypatch.setattr(t_prof, "_capturing", lambda: False)
    t_xor._count_pack_reuse("packed")  # the capture's eager warm-up

    class _Replayable:
        def replay(self):
            pass

    graph = t_plan._Graph(_Replayable(), None, (), {"packed": 1})
    graph.replay(None)
    graph.replay(None)
    assert reuse_counter() == {'{outcome="packed"}': 3}
    assert t_xor.PACK_REUSE["packed"] - before["packed"] == 4  # the plan layer takes the capture's back


# -- RS_PROFILE / --profile-dir ---------------------------------------------------------


def _traces(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


def test_profile_dir_writes_one_trace_per_outermost_op(tmp_path, monkeypatch):
    """RS_PROFILE=<dir> wraps the outermost observed operation in a
    torch.profiler session (CPU activity for a CPU caller) that writes one
    Chrome trace; auto_decode's nested decode joins it."""
    src = tmp_path / "f.bin"
    src.write_bytes(np.random.default_rng(5).integers(0, 256, size=40_000, dtype=np.uint8).tobytes())
    prof_dir = tmp_path / "prof"
    monkeypatch.setenv("RS_PROFILE", str(prof_dir))
    t_api.encode_file(str(src), 4, 2, device="cpu", checksums=True)
    assert len(_traces(prof_dir)) == 1
    t_api.auto_decode_file(str(src), str(tmp_path / "out.bin"), device="cpu")
    names = _traces(prof_dir)
    assert len(names) == 2 and any(n.startswith("rs-auto_decode-") for n in names)
    assert not any(n.startswith("rs-decode-") for n in names)  # the nested decode joined
    for name in names:
        doc = json.loads((prof_dir / name).read_text())
        assert doc["traceEvents"]
    monkeypatch.delenv("RS_PROFILE")
    # The CLI's --profile-dir latches the same override for one run only.
    from gpu_rscode_torch import cli as t_cli

    cli_dir = tmp_path / "cli_prof"
    assert t_cli.main(["-k", "4", "-n", "6", "-e", str(src), "--device", "cpu", "--quiet",
                       "--profile-dir", str(cli_dir)]) == 0
    assert len(_traces(cli_dir)) == 1
    t_api.encode_file(str(src), 4, 2, device="cpu")
    assert len(_traces(cli_dir)) == 1 and t_api._PROFILE_DIR_OVERRIDE is None


def test_profile_activities_follow_the_caller(monkeypatch):
    from torch.profiler import ProfilerActivity

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    fn = t_api.encode_file.__wrapped__
    assert t_api._profile_activities(fn, ("f", 4, 2), {"device": "cpu"}) == [ProfilerActivity.CPU]
    assert t_api._profile_activities(fn, ("f", 4, 2), {"strategy": "cpu"}) == [ProfilerActivity.CPU]
    assert t_api._profile_activities(fn, ("f", 4, 2), {}) == [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    auto = t_api.auto_decode_file.__wrapped__
    assert t_api._profile_activities(auto, ("f",), {"device": "cpu"}) == [ProfilerActivity.CPU]
