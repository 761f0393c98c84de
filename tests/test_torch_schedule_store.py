"""The persistent schedule store across the two packages, on the CPU: the
port's run-ledger store half (``store_path``, ``append``, ``read_records``,
rotation) against the JAX package's, and the ``rs_xor_schedule`` /
``rs_ring_schedule`` records: a store written by either package loads in
the other with zero builds, and a corrupt record (missing fields, a wrong
``algo_version``, a bad ``payload_digest``) is rebuilt and counted
``corrupt`` by both, never trusted.  A line cut mid-way is skipped by both
readers (a miss, then rebuilt)."""

import json
import os

import numpy as np
import pytest

from gpu_rscode_torch.obs import runlog as t_runlog
from gpu_rscode_torch.ops import ring_gemm as tr
from gpu_rscode_torch.ops import xor_gemm as tx
from gpu_rscode_tpu.obs import runlog as j_runlog
from gpu_rscode_tpu.ops import ring_gemm as jr
from gpu_rscode_tpu.ops import xor_gemm as jx

# (schedule build function, module holding _STORE_STATS) per package and kind.
KINDS = {
    "rs_xor_schedule": {"t": (tx.build_schedule, tx), "j": (jx.build_schedule, jx)},
    "rs_ring_schedule": {"t": (tr.build_ring_schedule, tr), "j": (jr.build_ring_schedule, jr)},
}
FIELDS = {
    "rs_xor_schedule": ("digest", "w", "rows_out", "k", "n_inputs", "pair_ops", "rows", "terms_naive", "terms_cse",
                        "cse"),
    "rs_ring_schedule": ("digest", "w", "p", "rows_out", "k", "n_inputs", "s1_pairs", "s1_rows", "s2_pairs",
                         "s2_rows", "s2_planes", "s3_pairs", "s3_rows", "terms_naive", "terms_cse", "cse"),
}


def _clear():
    tx.clear_pipeline_cache()  # ring's caches drop through the hook
    jx.clear_pipeline_cache()


@pytest.fixture
def store(tmp_path, monkeypatch):
    path = str(tmp_path / "store.jsonl")
    monkeypatch.delenv("RS_RUNLOG", raising=False)
    monkeypatch.setenv("RS_SCHEDULE_STORE", path)
    monkeypatch.delenv("RS_XOR_CSE", raising=False)
    monkeypatch.delenv("RS_XOR_MAX_TERMS", raising=False)
    _clear()
    yield path
    _clear()


def _stats(mod) -> dict:
    return dict(mod._STORE_STATS)


def _delta(after: dict, before: dict) -> dict:
    return {k: after[k] - before[k] for k in before}


def _matrix(seed: int, w: int = 8, shape=(3, 4)) -> np.ndarray:
    return np.random.default_rng(seed).integers(1, 1 << w, size=shape).astype(np.uint8 if w == 8 else np.uint16)


@pytest.mark.parametrize("env,expect", [
    ({}, None), ({"RS_RUNLOG": "/x/ledger"}, "/x/ledger"),
    ({"RS_RUNLOG": "/x/ledger", "RS_SCHEDULE_STORE": "off"}, None),
    ({"RS_RUNLOG": "/x/ledger", "RS_SCHEDULE_STORE": "1"}, "/x/ledger"),
    ({"RS_SCHEDULE_STORE": "/y/store"}, "/y/store"), ({"RS_SCHEDULE_STORE": " "}, None),
])
def test_store_path_like_jax(monkeypatch, env, expect):
    monkeypatch.delenv("RS_RUNLOG", raising=False)
    monkeypatch.delenv("RS_SCHEDULE_STORE", raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    assert t_runlog.store_path() == j_runlog.store_path() == expect
    assert t_runlog.path() == j_runlog.path()


def test_append_read_and_rotation_byte_identical_to_jax(tmp_path, monkeypatch):
    """The same appends through each package, past a tiny rotation cap and
    after a torn tail, leave byte-identical files; each reads the other's."""
    monkeypatch.setenv("RS_RUNLOG_MAX_BYTES", "600")
    recs = [{"kind": "rs_run", "n": i, "pad": "x" * 40} for i in range(12)]
    recs[3] = {"kind": "rs_xor_schedule", "digest": "d1", "cse": True, "n": 3}
    recs[7] = {"kind": "rs_xor_schedule", "digest": "d1", "cse": True, "n": 7}
    files = {}
    for name, mod in (("t", t_runlog), ("j", j_runlog)):
        p = str(tmp_path / f"{name}.jsonl")
        for i, rec in enumerate(recs):
            mod.append(rec, p)
            if i == 9:
                with open(p, "a") as fp:
                    fp.write('{"kind": "rs_run", "torn')
        files[name] = p
    for suffix in ("", ".1"):
        with open(files["t"] + suffix, "rb") as a, open(files["j"] + suffix, "rb") as b:
            assert a.read() == b.read()
    assert t_runlog.read_records(files["j"]) == j_runlog.read_records(files["t"])
    assert t_runlog.read_records(files["t"], include_rotated=False) == \
        j_runlog.read_records(files["t"], include_rotated=False)
    assert t_runlog.append({"kind": "x"}, None) is None  # no ledger: a no-op


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("writer,reader", [("j", "t"), ("t", "j")])
def test_store_written_by_one_package_loads_in_the_other(store, kind, writer, reader):
    A = _matrix(1)
    build_w, mod_w = KINDS[kind][writer]
    build_r, mod_r = KINDS[kind][reader]
    before = _stats(mod_w)
    written = build_w(A, 8)
    assert _delta(_stats(mod_w), before)["built"] == 1 and _delta(_stats(mod_w), before)["stored"] == 1
    recs = [r for r in t_runlog.read_records(store) if r["kind"] == kind]
    assert len(recs) == 1 and recs[0]["schema"] == 1
    _clear()
    before = _stats(mod_r)
    loaded = build_r(A, 8)
    d = _delta(_stats(mod_r), before)
    assert d["built"] == 0 and d["hits"] == 1 and d["corrupt"] == 0
    for field in FIELDS[kind]:
        assert getattr(loaded, field) == getattr(written, field), field
    assert loaded.build_seconds == 0.0
    assert tx.store_stats(load=True)["enabled"] and tr.ring_store_stats()["path"] == store


def _tamper(path: str, kind: str, how: str) -> None:
    with open(path) as fp:
        lines = [json.loads(line) for line in fp if line.strip()]
    rec = next(r for r in lines if r["kind"] == kind)
    if how == "missing_field":
        del rec["rows" if kind == "rs_xor_schedule" else "s3_rows"]
    elif how == "algo_version":
        rec["algo_version"] += 1
    elif how == "payload_digest":
        rec["payload_digest"] = "0" * 16
    elif how == "node_bound":
        key = "pair_ops" if kind == "rs_xor_schedule" else "s1_pairs"
        if rec[key]:
            rec[key][0] = [10_000, 0]
        else:
            rec["payload_digest"] = "f" * 16
    with open(path, "w") as fp:
        for r in lines:
            fp.write(json.dumps(r) + "\n")
    if how == "torn_line":
        with open(path) as fp:
            text = fp.read()
        with open(path, "w") as fp:
            fp.write(text[: len(text) // 2])


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("how", ["missing_field", "algo_version", "payload_digest", "node_bound", "torn_line"])
def test_corrupt_record_is_rebuilt_and_counted_like_jax(store, kind, how):
    A = _matrix(2)
    want = KINDS[kind]["t"][0](A, 8, cse=True)
    deltas = {}
    for pkg in ("t", "j"):
        # The same damaged store for each package: a valid record, damaged.
        open(store, "w").close()
        _clear()
        KINDS[kind]["j"][0](A, 8, cse=True)
        _tamper(store, kind, how)
        _clear()
        build, mod = KINDS[kind][pkg]
        before = _stats(mod)
        got = build(A, 8, cse=True)
        deltas[pkg] = _delta(_stats(mod), before)
        for field in FIELDS[kind]:
            assert getattr(got, field) == getattr(want, field), field
    assert deltas["t"] == deltas["j"]
    outcome = "misses" if how == "torn_line" else "corrupt"
    assert deltas["t"][outcome] == 1 and deltas["t"]["built"] == 1 and deltas["t"]["hits"] == 0


def test_newest_record_wins(store):
    A = _matrix(3)
    sched = tx.build_schedule(A, 8)
    with open(store) as fp:
        rec = json.loads(fp.readline())
    stale = dict(rec, ts=rec["ts"] - 100, payload_digest="0" * 16)
    with open(store, "a") as fp:
        fp.write(json.dumps(stale) + "\n")  # later in the file, older in time
    _clear()
    before = _stats(tx)
    assert tx.build_schedule(A, 8).pair_ops == sched.pair_ops
    assert _delta(_stats(tx), before)["hits"] == 1


def test_store_off_builds_and_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("RS_RUNLOG", str(tmp_path / "ledger.jsonl"))
    monkeypatch.setenv("RS_SCHEDULE_STORE", "off")
    _clear()
    before = _stats(tx)
    tx.build_schedule(_matrix(4), 8)
    assert _delta(_stats(tx), before) == {"hits": 0, "misses": 0, "stored": 0, "corrupt": 0, "built": 1}
    assert not os.path.exists(tmp_path / "ledger.jsonl")
    assert tx.store_stats()["enabled"] is False
    _clear()
