"""The strategy autotuner of the port (``gpu_rscode_torch.tune``) against
the JAX package's (``gpu_rscode_tpu.tune``) on the CPU: prior, measure and
off modes with ``_measure_one`` replaced by fixed times in both packages,
the ``rs_autotune`` records of one store read alike by both (stale
``"pallas"`` and malformed records skipped), a failing candidate that
raises, and ``auto`` through ``RSCodec`` and the file entry points with
archives equal to the JAX package's."""

import json
import os
import socket

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import codec as t_codec
from gpu_rscode_torch import plan as t_plan
from gpu_rscode_torch import tune as t_tune
from gpu_rscode_torch.utils import fileformat as t_ff
from gpu_rscode_tpu import api as j_api
from gpu_rscode_tpu import tune as j_tune

K, P = 4, 2
# Seconds per candidate for the fixed-time measurements.
TIMES = {"bitplane": 3.0, "xor": 1.0, "ring": 2.0, "table": 4.0, "cpu": 5.0}


@pytest.fixture(autouse=True)
def _env(monkeypatch, tmp_path):
    for knob in ("RS_RUNLOG", "RS_STRATEGY_AUTOTUNE", "RS_PLAN"):
        monkeypatch.delenv(knob, raising=False)
    monkeypatch.setenv("RS_SCHEDULE_STORE", str(tmp_path / "store.jsonl"))
    t_tune.clear_decisions()
    j_tune.clear_decisions()
    yield
    t_tune.clear_decisions()
    j_tune.clear_decisions()


def _fixed_times(monkeypatch, times=TIMES):
    seen = {"t": [], "j": []}

    def fake(pkg):
        def measure(strategy, A, B, w):
            seen[pkg].append(strategy)
            return times[strategy]
        return measure

    monkeypatch.setattr(t_tune, "_measure_one", fake("t"))
    monkeypatch.setattr(j_tune, "_measure_one", fake("j"))
    return seen


def _resolve_both(k=K, p=P, w=8):
    return t_tune.resolve_auto(k, p, w, device="cpu"), j_tune.resolve_auto(k, p, w)


@pytest.mark.parametrize("w", [8, 16])
def test_prior_and_off_modes_equal_jax(monkeypatch, w):
    assert _resolve_both(w=w) == ("bitplane", "bitplane")
    assert t_tune.static_choice(w, "cpu") == j_tune.static_choice(w) == "bitplane"
    assert t_tune.static_choice(w, "cuda") == "cuda"
    assert t_tune.candidate_strategies(w, "cpu") == j_tune.candidate_strategies(w)
    assert t_tune.candidate_strategies(w, "cuda")[0] == "cuda"
    monkeypatch.setenv("RS_STRATEGY_AUTOTUNE", "off")
    assert t_tune.mode() == j_tune.mode() == "off"
    assert _resolve_both(w=w) == ("bitplane", "bitplane")
    assert t_tune.decisions() == {}


@pytest.mark.parametrize("w", [8, 16])
def test_measure_mode_equals_jax(monkeypatch, tmp_path, w):
    """Both packages time the same candidates in the same order, pick the
    same winner and persist it; a fresh process (decisions cleared) in
    prior mode reads it back from the store."""
    seen = _fixed_times(monkeypatch)
    monkeypatch.setenv("RS_STRATEGY_AUTOTUNE", "measure")
    assert _resolve_both(w=w) == ("xor", "xor")
    assert seen["t"] == seen["j"] == list(j_tune.candidate_strategies(w))
    t_dec = t_tune.decisions()[f"other|{K}|{P}|{w}"]
    j_dec = j_tune.decisions()[f"other|{K}|{P}|{w}"]
    assert t_dec["source"] == j_dec["source"] == "measured"
    assert t_dec["gbps"] == {key: val for key, val in j_dec["gbps"].items() if not key.endswith("_error")}
    # A second resolution is served from memory: nothing is timed again.
    assert _resolve_both(w=w) == ("xor", "xor")
    assert len(seen["t"]) == len(j_tune.candidate_strategies(w))
    monkeypatch.setenv("RS_STRATEGY_AUTOTUNE", "prior")
    t_tune.clear_decisions()
    j_tune.clear_decisions()
    assert _resolve_both(w=w) == ("xor", "xor")
    assert t_tune.decisions()[f"other|{K}|{P}|{w}"]["source"] == "ledger"
    records = [json.loads(line) for line in open(tmp_path / "store.jsonl")]
    assert [rec["kind"] for rec in records] == ["rs_autotune", "rs_autotune"]


def _jax_record(strategy, **over):
    """An rs_autotune record written by the JAX package's own writer."""
    dec = {"strategy": strategy, "backend": "other", "k": K, "p": P, "w": 8, "gbps": {strategy: 1.0},
           "ts": over.pop("ts", 1000.0)}
    dec.update(over)
    j_tune._persist_decision(dec)


@pytest.mark.parametrize("strategy", ["xor", "ring", "table", "cpu", "bitplane"])
def test_store_written_by_jax_resolves_alike(strategy):
    _jax_record(strategy)
    assert _resolve_both() == (strategy, strategy)
    assert t_tune.decisions()[f"other|{K}|{P}|8"]["source"] == "ledger"
    codec = t_codec.RSCodec(K, P, device="cpu")
    assert codec.strategy == strategy
    assert codec.device.type == "cpu"


def test_store_written_by_the_port_resolves_alike(monkeypatch):
    _fixed_times(monkeypatch, dict(TIMES, table=0.5))
    monkeypatch.setenv("RS_STRATEGY_AUTOTUNE", "measure")
    assert t_tune.resolve_auto(K, P, 8, device="cpu") == "table"
    monkeypatch.setenv("RS_STRATEGY_AUTOTUNE", "prior")
    j_tune.clear_decisions()
    assert j_tune.resolve_auto(K, P, 8) == "table"


def test_newest_record_wins_and_stale_or_malformed_records_are_skipped(tmp_path):
    _jax_record("ring", ts=2000.0)
    _jax_record("xor", ts=1000.0)  # older, written later
    assert _resolve_both() == ("ring", "ring")
    for pkg in (t_tune, j_tune):
        pkg.clear_decisions()
    # A newer record naming the TPU kernel, no candidate on this backend
    # (the stale-record check): both take the prior.
    _jax_record("pallas", ts=3000.0)
    assert _resolve_both() == ("bitplane", "bitplane")
    store = tmp_path / "store.jsonl"
    host = socket.gethostname()
    bad = [{"kind": "rs_autotune", "host": host, "backend": "other", "k": "x", "p": P, "w": 8, "strategy": "xor"},
           {"kind": "rs_autotune", "host": host, "backend": "other", "p": P, "w": 8, "strategy": "xor"},
           {"kind": "rs_autotune", "host": host, "backend": "other", "k": 5, "p": P, "w": 8, "strategy": "auto"},
           {"kind": "rs_autotune", "host": host, "backend": "other", "k": 5, "p": P, "w": 8, "strategy": "nope"}]
    with open(store, "a") as fp:
        fp.write("not json\n")
        for rec in bad:
            fp.write(json.dumps(rec) + "\n")
    for pkg in (t_tune, j_tune):
        pkg.clear_decisions()
    assert t_tune.resolve_auto(5, P, 8, device="cpu") == j_tune.resolve_auto(5, P, 8) == "bitplane"
    # Another host's record is not this host's decision.
    other = {"kind": "rs_autotune", "host": host + "-other", "backend": "other", "k": 6, "p": P, "w": 8,
             "strategy": "table", "ts": 9e9}
    with open(store, "a") as fp:
        fp.write(json.dumps(other) + "\n")
    for pkg in (t_tune, j_tune):
        pkg.clear_decisions()
    assert t_tune.resolve_auto(6, P, 8, device="cpu") == j_tune.resolve_auto(6, P, 8) == "bitplane"


def test_record_no_longer_runnable_falls_back_to_the_prior(monkeypatch):
    """A persisted ``cpu`` winner on a host where the native codec does
    not build: the static prior, never the NumPy oracle."""
    from gpu_rscode_torch import native

    _jax_record("cpu")
    monkeypatch.setattr(native, "available", lambda: False)
    assert t_tune.resolve_auto(K, P, 8, device="cpu") == "bitplane"
    assert t_codec.RSCodec(K, P, device="cpu").strategy == "bitplane"


def test_failing_candidate_raises(monkeypatch):
    monkeypatch.setenv("RS_STRATEGY_AUTOTUNE", "measure")

    def broken(strategy, A, B, w):
        if strategy == "xor":
            raise RuntimeError("xor failed")
        return TIMES[strategy]

    monkeypatch.setattr(t_tune, "_measure_one", broken)
    with pytest.raises(RuntimeError, match="xor failed"):
        t_tune.resolve_auto(K, P, 8, device="cpu")
    assert t_tune.decisions() == {}


@pytest.mark.parametrize("w", [8, 16])
def test_measure_one_dispatches_through_the_plan(monkeypatch, w):
    """The real measurement on a small stripe: every candidate runs
    through plan.dispatch (one plan each) and the winner is a candidate."""
    monkeypatch.setattr(t_tune, "_MEASURE_COLS", 4096)
    monkeypatch.setenv("RS_STRATEGY_AUTOTUNE", "measure")
    t_plan.PLAN_CACHE.clear()
    winner = t_tune.resolve_auto(K, P, w, device="cpu")
    cands = t_tune.candidate_strategies(w, "cpu")
    assert winner in cands
    plans = t_plan.PLAN_CACHE.stats()["plans"]
    assert sorted(p["strategy"] for p in plans) == sorted(cands)
    assert all(p["calls"] == 1 + t_tune._MEASURE_REPS for p in plans)
    gbps = t_tune.decisions()[f"other|{K}|{P}|{w}"]["gbps"]
    assert set(gbps) == set(cands) and all(v > 0 for v in gbps.values())


def _seeded(path, size, seed):
    data = np.random.default_rng(seed).integers(0, 256, size=size, dtype=np.uint8).tobytes()
    with open(path, "wb") as fp:
        fp.write(data)
    return data


def _archive(path, n=K + P):
    names = [t_ff.chunk_file_name(path, i) for i in range(n)] + [t_ff.metadata_file_name(path)]
    return {os.path.basename(f): open(f, "rb").read() for f in names if os.path.exists(f)}


@pytest.mark.parametrize("winner", ["ring", "cpu"])
def test_auto_file_ops_follow_the_store_and_equal_jax(tmp_path, winner):
    """``auto`` resolved from a persisted decision: the port's encode,
    decode and update give the JAX package's archive and bytes."""
    _jax_record(winner)
    data = None
    paths = {}
    for name, api, kw in (("t", t_api, {"device": "cpu"}), ("j", j_api, {})):
        d = tmp_path / name
        d.mkdir()
        paths[name] = str(d / "f.bin")
        data = _seeded(paths[name], 30_011, 4)
        api.encode_file(paths[name], K, P, strategy="auto", segment_bytes=4096, checksums=True, **kw)
    assert t_tune.decisions()[f"other|{K}|{P}|8"]["strategy"] == winner
    assert _archive(paths["t"]) == _archive(paths["j"])
    delta = np.random.default_rng(8).integers(0, 256, size=3000, dtype=np.uint8).tobytes()
    for name, api, kw in (("t", t_api, {"device": "cpu"}), ("j", j_api, {})):
        api.update_file(paths[name], 777, delta, strategy="auto", segment_bytes=4096, **kw)
    assert _archive(paths["t"]) == _archive(paths["j"])
    path = paths["t"]
    for i in range(2):
        os.unlink(t_ff.chunk_file_name(path, i))
    conf = path + ".conf"
    with open(conf, "w") as fp:
        fp.write("".join(os.path.basename(t_ff.chunk_file_name(path, i)) + "\n" for i in (2, 3, 4, 5)))
    out = t_api.decode_file(path, conf, path + ".out", strategy="auto", segment_bytes=4096, device="cpu")
    want = bytearray(data)
    want[777:777 + len(delta)] = delta
    assert open(out, "rb").read() == bytes(want)
