"""The port's metrics plane (``gpu_rscode_torch.obs.metrics`` and
``obs.percentile``) against the JAX package's, on the CPU: the same
sequence of operations gives equal snapshots and byte-equal Prometheus
text, the quantile estimators hold equal states, and a store scenario run
through both packages with ``RS_METRICS=1`` leaves equal ``rs_store_*`` and
``rs_update_*`` series (quantiles compared by count).  Tolerance 0."""

import json
import os
import random

import numpy as np
import pytest

from gpu_rscode_torch.obs import metrics as t_metrics
from gpu_rscode_torch.obs import percentile as t_pct
from gpu_rscode_torch import store as t_store
from gpu_rscode_torch.utils.fileformat import chunk_file_name
from gpu_rscode_tpu.obs import metrics as j_metrics
from gpu_rscode_tpu.obs import percentile as j_pct
from gpu_rscode_tpu import store as j_store


def _drive(mod, seed):
    """A seeded sequence of counter / gauge / histogram / quantile
    operations on a fresh registry of ``mod``."""
    reg = mod.Registry()
    rng = random.Random(seed)
    for _ in range(300):
        op = rng.randrange(4)
        labels = {"op": rng.choice(["put", "get", "delete"])} if rng.random() < 0.7 else {}
        if op == 0:
            reg.counter("rs_test_total", "a counter").labels(**labels).inc(rng.randrange(5))
        elif op == 1:
            g = reg.gauge("rs_test_gauge", "").labels(**labels)
            (g.set if rng.random() < 0.5 else g.dec)(rng.randrange(-3, 9))
        elif op == 2:
            reg.histogram("rs_test_seconds", "a histogram", buckets=(0.01, 0.1, 1.0)).labels(**labels).observe(
                rng.random() * 2)
        else:
            reg.quantile("rs_test_wall_seconds", "a quantile", cap=32).labels(**labels).observe(rng.expovariate(3))
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_registry_snapshot_and_text_equal(seed):
    t_reg, j_reg = _drive(t_metrics, seed), _drive(j_metrics, seed)
    assert t_reg.snapshot() == j_reg.snapshot()
    assert t_reg.render_text() == j_reg.render_text()
    assert t_reg.names() == j_reg.names()


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_snapshot_json_is_the_snapshot_dumped_as_series_change(seed):
    """The ledger digest's cached text stays byte-equal to the JAX
    package's ``json.dumps(snapshot, sort_keys=True)`` while some series
    change between reads and others do not."""
    t_reg, j_reg = t_metrics.Registry(), j_metrics.Registry()
    assert t_reg.snapshot_json() == json.dumps(j_reg.snapshot(), sort_keys=True) == "{}"
    rng = random.Random(seed)
    for step in range(8):
        draws = [(rng.randrange(4), rng.choice(["put", "get", ""]), rng.random()) for _ in range(1 + 20 * (step % 3))]
        for reg in (t_reg, j_reg):
            for op, label, x in draws:
                labels = {"op": label} if label else {}
                if op == 0:
                    reg.counter("rs_test_total", "a counter").labels(**labels).inc(int(x * 4))
                elif op == 1:
                    reg.gauge("rs_test_gauge").labels(**labels).set(x)
                elif op == 2:
                    reg.histogram("rs_test_seconds", "h", buckets=(0.1, 0.5)).labels(**labels).observe(x)
                else:
                    reg.quantile("rs_test_wall_seconds", "q", cap=16).labels(**labels).observe(x)
        want = json.dumps(j_reg.snapshot(), sort_keys=True)
        assert t_reg.snapshot_json() == want
        assert t_reg.snapshot_json() == want  # from the cache


def test_registry_refusals_equal():
    for mod in (t_metrics, j_metrics):
        reg = mod.Registry()
        reg.counter("x")
        with pytest.raises(TypeError, match="already registered as counter"):
            reg.gauge("x")
        reg.histogram("h", buckets=(1, 2))
        with pytest.raises(ValueError, match="already registered with buckets"):
            reg.histogram("h", buckets=(1, 3))
        reg.quantile("q", cap=8)
        with pytest.raises(ValueError, match="already registered with cap"):
            reg.quantile("q", cap=9)
        with pytest.raises(ValueError, match="counter increment must be >= 0"):
            reg.counter("x").inc(-1)
    assert t_metrics.render_text({}) == ""


@pytest.mark.parametrize("cap", [1, 7, 64, 512])
def test_quantile_estimator_states_equal(cap):
    rng = np.random.default_rng(cap)
    stream = rng.lognormal(size=2000).tolist()
    t_est, j_est = t_pct.QuantileEstimator(cap), j_pct.QuantileEstimator(cap)
    for v in stream:
        t_est.observe(v)
        j_est.observe(v)
    assert t_est.state() == j_est.state()
    assert t_est.quantiles() == j_est.quantiles()
    for q in (0.0, 0.25, 0.5, 0.99, 1.0):
        assert t_pct.quantile_of(stream, q) == j_pct.quantile_of(stream, q)


def test_merge_states_equal():
    rng = np.random.default_rng(11)
    states = []
    for n, cap in ((50, 64), (900, 64), (3, 8), (0, 16)):
        est = t_pct.QuantileEstimator(cap)
        for v in rng.random(n).tolist():
            est.observe(v)
        states.append(est.state())
    for cap in (None, 16, 1000):
        got = t_pct.merge_states(states, cap)
        assert got == j_pct.merge_states(states, cap)
        assert t_pct.state_quantiles(got) == j_pct.state_quantiles(got)
    assert t_pct.merge_states([]) == j_pct.merge_states([])
    with pytest.raises(ValueError, match="reservoir cap must be >= 1"):
        t_pct.QuantileEstimator(0)


def test_disabled_path_registers_nothing(tmp_path, monkeypatch):
    monkeypatch.delenv("RS_METRICS", raising=False)
    t_metrics.force_enable(False)
    t_metrics.REGISTRY.reset()
    assert t_metrics.counter("x") is t_metrics.NULL
    b = t_store.open_bucket(str(tmp_path), "b", create=True, k=2, p=1, stripe_bytes=64 * 1024, device="cpu")
    b.put_many([("a", b"a" * 100)])
    b.put_many([("c", b"c" * 100)])
    b.delete("a")
    assert t_metrics.REGISTRY.names() == []
    t_store.drop_cached()


def test_force_enable_latch_and_unified_snapshot(monkeypatch):
    monkeypatch.delenv("RS_METRICS", raising=False)
    t_metrics.REGISTRY.reset()
    try:
        t_metrics.force_enable()
        assert t_metrics.enabled() and t_metrics.forced()
        t_metrics.counter("rs_probe_total").inc(2)
        snap = t_metrics.unified_snapshot()
    finally:
        t_metrics.force_enable(False)
        t_metrics.REGISTRY.reset()
    assert not t_metrics.enabled()
    assert set(snap) == {"metrics_enabled", "metrics", "plan_cache", "mesh_plan_cache", "autotune_decisions"}
    assert snap["metrics"]["rs_probe_total"]["values"] == {"": 2}
    assert {"hits", "misses", "evictions"} <= set(snap["plan_cache"])
    assert {"hits", "misses", "evictions"} <= set(snap["mesh_plan_cache"])


def _store_scenario(store, root, opts):
    """PUT batches (a fresh stripe, appends through the group engine, a
    stripe roll), an overwrite, GETs (fast and degraded), DELETEs, a torn
    group recovered at reopen, and a forced compaction."""
    rng = np.random.default_rng(21)
    b = store.open_bucket(root, "bkt", create=True, k=3, p=2, stripe_bytes=64 * 1024, **opts)
    for i in range(4):
        b.put_many([(f"k{i}-{j}", rng.integers(0, 256, int(rng.integers(1, 8192)), dtype=np.uint8).tobytes())
                    for j in range(6)])
    b.put("k0-0", b"o" * 500)
    for o in b.list_objects():
        b.get(o["key"])
    b.delete("k1-1")
    b.delete("k2-2")
    arc = b.stat("k3-3")["arc"]
    os.unlink(chunk_file_name(os.path.join(root, "bkt", arc), 1))
    b.get("k3-3")
    os.environ["RS_UPDATE_CRASH"] = "mid_patch"
    try:
        b.put("torn", b"t" * 100)
    except RuntimeError:
        pass
    finally:
        del os.environ["RS_UPDATE_CRASH"]
    store.drop_cached()
    b = store.open_bucket(root, "bkt", **opts)
    b.list_objects()
    b.compact(force=True)


def _series(snapshot):
    out = {}
    for name, fam in snapshot.items():
        if not name.startswith(("rs_store_", "rs_update_")):
            continue
        for label, v in fam["values"].items():
            if isinstance(v, dict) and "reservoir" in v:
                v = ("count", v["count"])
            out[(name, fam["type"], label)] = v
    return out


def test_store_scenario_series_equal(tmp_path, monkeypatch):
    monkeypatch.setenv("RS_METRICS", "1")
    monkeypatch.setenv("RS_STORE_SNAPSHOT_RECORDS", "8")
    got = {}
    for name, store, metrics, opts in (("t", t_store, t_metrics, {"device": "cpu"}),
                                       ("j", j_store, j_metrics, {})):
        metrics.REGISTRY.reset()
        store.drop_cached()
        try:
            _store_scenario(store, str(tmp_path / name), opts)
            got[name] = _series(metrics.REGISTRY.snapshot())
        finally:
            store.drop_cached()
            metrics.REGISTRY.reset()
    assert got["t"] == got["j"]
    names = {key[0] for key in got["t"]}
    for want in ("rs_store_objects_total", "rs_store_bytes_total", "rs_store_range_reads_total",
                 "rs_store_stripes_total", "rs_store_snapshots_total", "rs_store_open_seconds",
                 "rs_store_compactions_total", "rs_store_live_bytes", "rs_store_dead_bytes",
                 "rs_update_bytes_total", "rs_update_segments_touched_total", "rs_update_wall_seconds",
                 "rs_update_group_fsyncs_total", "rs_update_group_size", "rs_update_group_coalesced_bytes_total",
                 "rs_update_recoveries_total"):
        assert want in names, want
    assert got["t"][("rs_store_range_reads_total", "counter", '{path="degraded"}')] >= 1
    assert got["t"][("rs_update_recoveries_total", "counter", '{verdict="rolled_back"}')] == 1
