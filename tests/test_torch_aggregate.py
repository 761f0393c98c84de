"""The port's obs/aggregate.py (``rs aggregate``) against the JAX package's
on the CPU: the same seeded per-process parts through both packages'
``merge_snapshots``, ``merge_unified_snapshots``, ``merge_traces`` and
``render_text`` give equal output (mirroring tests/test_aggregate.py's
seeded cases), the merge equals a single registry that saw every event,
and ``rs aggregate`` exits as the JAX package's does."""

import json
import random

import pytest

from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch.obs import aggregate as t_agg, metrics as t_metrics, tracing as t_tracing
from gpu_rscode_tpu import cli as j_cli
from gpu_rscode_tpu.obs import aggregate as j_agg, tracing as j_tracing

BUCKETS = (0.001, 0.01, 0.1, 1.0)
LABELSETS = ({}, {"op": "encode"}, {"op": "decode", "w": "16"})


def _workload(rng, nparts, nevents):
    """Random counter, gauge, histogram and quantile events into per-process
    registries and one registry that sees them all."""
    parts = [t_metrics.Registry() for _ in range(nparts)]
    ref = t_metrics.Registry()
    for _ in range(nevents):
        p = rng.randrange(nparts)
        lab = rng.choice(LABELSETS)
        kind = rng.random()
        if kind < 0.4:
            n = rng.randint(0, 5)
            for reg in (parts[p], ref):
                reg.counter("jobs_total", "j").labels(**lab).inc(n)
        elif kind < 0.8:
            v = rng.random() * rng.choice((0.0005, 0.005, 0.05, 0.5, 50.0))
            for reg in (parts[p], ref):
                reg.histogram("lat_seconds", "l", buckets=BUCKETS).labels(**lab).observe(v)
        elif kind < 0.9:
            parts[p].gauge("depth", "d").labels(**lab).set(rng.randint(0, 100))
        else:
            parts[p].quantile("wall_q", "w").labels(**lab).observe(rng.random())
    return parts, ref


@pytest.mark.parametrize("seed", [7, 1234, 987654])
def test_merge_snapshots_equal_jax_and_single_process(seed):
    rng = random.Random(seed)
    for _ in range(4):
        parts, ref = _workload(rng, nparts=rng.randint(2, 5), nevents=rng.randint(20, 300))
        snaps = [r.snapshot() for r in parts]
        merged = t_agg.merge_snapshots(snaps)
        assert merged == j_agg.merge_snapshots(snaps)
        want = ref.snapshot()
        if "jobs_total" in want:
            assert merged["jobs_total"]["values"] == want["jobs_total"]["values"]
        for label, wh in want.get("lat_seconds", {}).get("values", {}).items():
            gh = merged["lat_seconds"]["values"][label]
            assert gh["count"] == wh["count"] and gh["buckets"] == wh["buckets"]
            assert gh["sum"] == pytest.approx(wh["sum"])
        assert t_agg.render_text(merged) == j_agg.render_text(merged)


def test_unified_merge_equal_jax():
    def snap(hits, mesh_hits):
        return {
            "metrics_enabled": True,
            "metrics": {"ops_total": {"type": "counter", "help": "", "values": {"": hits}}},
            "plan_cache": {"hits": hits, "misses": 1, "enabled": True, "executables": 1, "max_size": 64,
                           "plans": [{"compile_seconds": 0.5}]},
            "mesh_plan_cache": {"hits": mesh_hits, "misses": 2, "enabled": True, "executables": 2, "max_size": 64,
                                "plans": []},
        }

    parts = [snap(2, 5), snap(3, 7), {}]
    merged = t_agg.merge_unified_snapshots(parts)
    assert merged == j_agg.merge_unified_snapshots(parts)
    assert merged["mesh_plan_cache"]["hits"] == 12 and merged["mesh_plan_cache"]["max_size"] == 64
    assert merged["merged_from"] == 3 and merged["metrics"]["ops_total"]["values"][""] == 5


def _payload(events, wall_t0, epoch=None, host="h", proc=0):
    other = {"rs_wall_t0": wall_t0, "rs_host": host, "rs_process_index": proc}
    if epoch is not None:
        other["rs_epoch"] = epoch
    return {"traceEvents": events, "displayTimeUnit": "ms", "otherData": other}


@pytest.mark.parametrize("epoch", [1000.0, None])
def test_merge_traces_equal_jax(epoch):
    rng = random.Random(11)
    payloads = []
    for proc in range(3):
        events = [{"name": f"s{i}", "ph": "X", "ts": rng.random() * 1e4, "dur": 5.0, "pid": 1, "tid": rng.randint(1, 3)}
                  for i in range(20)]
        events.append({"name": "process_name", "ph": "M", "pid": 1, "args": {"name": "rs"}})
        payloads.append(_payload(events, wall_t0=1001.0 + proc * 0.5, epoch=epoch, host=f"h{proc}", proc=proc))
    merged = t_agg.merge_traces(payloads)
    assert merged == j_agg.merge_traces(payloads)
    assert {e["pid"] for e in merged["traceEvents"]} == {1, 2, 3}


def test_real_exports_merge_equal_across_packages(tmp_path):
    """Each package's own tracer exports two parts; either package's merge
    of them gives the same fused payload."""
    bases = {}
    for name, tracing in (("t", t_tracing), ("j", j_tracing)):
        base = bases[name] = str(tmp_path / f"{name}.json")
        for i in range(2):
            tr = tracing.Tracer(t_agg.part_path(base, i, 2))
            with tr.span("dispatch", lane="dispatch", op="encode"):
                pass
            tr.export()
        assert t_agg.find_parts(base) == j_agg.find_parts(base) == [base + ".p0", base + ".p1"]
    for name in ("t", "j"):
        parts = t_agg.find_parts(bases[name])
        assert t_agg.merge_trace_files(parts) == j_agg.merge_trace_files(parts)


def test_part_discovery_equal_jax(tmp_path):
    base = str(tmp_path / "snap.json")
    assert t_agg.find_parts(base) == j_agg.find_parts(base) == []
    for i in (0, 1, 2, 10, 11):
        open(f"{base}.p{i}", "w").write("{}")
    open(base + ".p3x", "w").write("{}")
    assert t_agg.find_parts(base) == j_agg.find_parts(base)
    for args in ((base, 0, 1), (base, 3, 4)):
        assert t_agg.part_path(*args) == j_agg.part_path(*args)


def _cases(tmp_path):
    """(argv, setup) of every exit path of `rs aggregate`."""
    snap = str(tmp_path / "m.json")
    for i, hits in enumerate((2, 3)):
        reg = t_metrics.Registry()
        reg.counter("ops_total").inc(hits)
        reg.histogram("lat", "l", buckets=BUCKETS).observe(0.02 * (i + 1))
        with open(t_agg.part_path(snap, i, 2), "w") as fp:
            json.dump({"metrics_enabled": True, "metrics": reg.snapshot()}, fp)
    with open(str(tmp_path / "crashed.json.p0"), "w") as fp:
        json.dump({"metrics_enabled": True, "metrics": {}}, fp)
    open(str(tmp_path / "crashed.json.p1"), "w").write("{}\n")
    trace = str(tmp_path / "t.json")
    for i in range(2):
        tr = t_tracing.Tracer(t_agg.part_path(trace, i, 2))
        with tr.span("s", lane="l"):
            pass
        tr.export()
    open(str(tmp_path / "bad.json.p0"), "w").write("{truncated")
    return [
        ["aggregate", snap, "--text"],
        ["aggregate", snap, "--snapshot-out", str(tmp_path / "OUT.json")],
        ["aggregate", str(tmp_path / "crashed.json"), "--text"],
        ["aggregate", trace, "--trace-out", str(tmp_path / "OUT.trace.json")],
        ["aggregate", snap],
        ["aggregate", str(tmp_path / "nope.json.p0"), "--text"],
        ["aggregate", str(tmp_path / "nope.json"), "--text"],
        ["aggregate", str(tmp_path / "bad.json.p0"), "--text"],
        ["aggregate", trace + ".p0", "--text"],
        ["aggregate", snap + ".p0", "--trace-out", str(tmp_path / "o.json")],
    ]


def test_rs_aggregate_output_and_exit_codes_equal_jax(tmp_path, capsys):
    for argv in _cases(tmp_path):
        outs = []
        for main in (t_cli.main, j_cli.main):
            rc = main(argv)
            out = capsys.readouterr()
            written = {}
            for path in (tmp_path / "OUT.json", tmp_path / "OUT.trace.json"):
                if path.exists():
                    written[path.name] = json.loads(path.read_text())
                    path.unlink()
            # stderr names the package's prog on usage errors; compare the
            # verdict lines only.
            outs.append((rc, out.out, [ln for ln in out.err.splitlines() if not ln.startswith("usage:")], written))
        assert outs[0][0] == outs[1][0], argv
        assert outs[0][1] == outs[1][1], argv
        assert outs[0][3] == outs[1][3], argv
        if outs[0][0] == 1:
            assert outs[0][2] == outs[1][2], argv
