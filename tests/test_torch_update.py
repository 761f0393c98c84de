"""The port's in-place update and append (``update_file``, ``append_file``,
``update_file_many``, ``recover_archive``) against the JAX package's, on
small seeded archives on the CPU.  Each case runs the same operations on
two copies of one archive, one per package (JAX with
``strategy="bitplane"``), and compares the chunk files, the .METADATA
bytes (generation and CRC lines included), the summaries, the journals a
simulated crash leaves and the verdicts of ``recover``.  A journal torn by
one package is rolled back by the other.  Tolerance 0."""

import os
import shutil

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch.codec import RSCodec
from gpu_rscode_torch.update import engine as t_engine
from gpu_rscode_torch.update import group as t_group
from gpu_rscode_torch.utils import backend
from gpu_rscode_torch.utils import fileformat as t_ff
from gpu_rscode_tpu import api as j_api
from gpu_rscode_tpu import update as j_update

CPU = {"device": "cpu", "segment_bytes": 4096}
JAX = {"strategy": "bitplane", "segment_bytes": 4096}
PKGS = (("t", t_api, CPU), ("j", j_api, JAX))
SIZE = 40_001


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def _bytes(n, seed):
    return np.random.default_rng(seed).integers(0, 256, size=n, dtype=np.uint8).tobytes()


def _archive(path, n):
    names = [t_ff.chunk_file_name(path, i) for i in range(n)] + [t_ff.metadata_file_name(path)]
    return {os.path.basename(f): _read(f) for f in names if os.path.exists(f)}


def _pair(tmp_path, layout, w, *, size=SIZE, k=4, p=2, checksums=True, seed=1):
    """One seeded archive (encoded by the JAX package) copied into ``t/`` and
    ``j/``; returns ({"t": path, "j": path}, data)."""
    src = tmp_path / "src"
    src.mkdir()
    path = str(src / "f.bin")
    data = _bytes(size, seed)
    with open(path, "wb") as fp:
        fp.write(data)
    j_api.encode_file(path, k, p, w=w, layout=layout, checksums=checksums, **JAX)
    paths = {}
    for name in ("t", "j"):
        d = tmp_path / name
        d.mkdir()
        for f in os.listdir(src):
            shutil.copy(src / f, d / f)
        paths[name] = str(d / "f.bin")
    return paths, data


def _same(paths, n=6):
    got, want = _archive(paths["t"], n), _archive(paths["j"], n)
    assert got == want
    assert os.path.exists(t_ff.journal_path(paths["t"])) == os.path.exists(t_ff.journal_path(paths["j"]))
    if os.path.exists(t_ff.journal_path(paths["t"])):
        assert _read(t_ff.journal_path(paths["t"])) == _read(t_ff.journal_path(paths["j"]))
    return got


def _reencode(tmp_path, data, layout, w, k=4, p=2):
    """A from-scratch encode of ``data``: what an updated archive must equal."""
    d = tmp_path / f"re{len(os.listdir(tmp_path))}"
    d.mkdir()
    path = str(d / "f.bin")
    with open(path, "wb") as fp:
        fp.write(data)
    t_api.encode_file(path, k, p, w=w, layout=layout, checksums=True, **CPU)
    return path


OPS = [
    ("update", 0, 1), ("update", 4_999, 3_001), ("update", 9_999, 1), ("update", 10_000, 20_001),
    ("update", SIZE - 7, 7), ("update", 0, SIZE),
]


@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("layout", ["row", "interleaved"])
def test_updates_and_appends_equal_jax_and_a_reencode(tmp_path, layout, w):
    paths, data = _pair(tmp_path, layout, w)
    mirror = bytearray(data)
    ops = list(OPS) + ([("append", None, 3)] if layout == "row" else [("append", None, 5_000), ("append", None, 1)])
    for i, (op, at, n) in enumerate(ops):
        payload = _bytes(n, 100 + i)
        sums = {}
        for name, pkg, kw in PKGS:
            if op == "update":
                sums[name] = pkg.update_file(paths[name], at, payload, **kw)
            else:
                sums[name] = pkg.append_file(paths[name], payload, **kw)
        assert sums["t"] == sums["j"]
        assert sums["t"]["generation"] == i + 1
        _same(paths)
        if op == "update":
            mirror[at : at + n] = payload
        else:
            mirror += payload
    ref = _reencode(tmp_path, bytes(mirror), layout, w)
    got = _archive(paths["t"], 6)
    want = _archive(ref, 6)
    for i in range(6):
        assert got[f"_{i}_f.bin"] == want[f"_{i}_f.bin"], i
    crc_lines = lambda m: [ln for ln in m.splitlines() if ln.startswith(b"# crc32")]
    assert crc_lines(got["f.bin.METADATA"]) == crc_lines(want["f.bin.METADATA"])
    for i in (0, 1):
        os.unlink(t_ff.chunk_file_name(paths["t"], i))
    assert _read(t_api.auto_decode_file(paths["t"], paths["t"] + ".out", **CPU)) == bytes(mirror)


@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("layout", ["row", "interleaved"])
def test_update_file_many_equals_jax_and_sequential(tmp_path, layout, w):
    paths, data = _pair(tmp_path, layout, w)
    rng = np.random.default_rng(7)
    edits = [{"op": "update", "at": int(a), "data": _bytes(int(n), 200 + j)}
             for j, (a, n) in enumerate([(10, 100), (50, 30), (9_000, 4_000), (39_000, 1_000), (20_000, 1), (60, 5)])]
    edits += [{"op": "update", "at": int(a), "data": _bytes(64, 300 + j)}
              for j, a in enumerate(sorted(rng.choice(SIZE - 64, size=20, replace=False)))]
    if layout == "interleaved":
        edits.insert(3, {"op": "append", "data": _bytes(777, 5)})
        edits.append({"op": "update", "at": SIZE + 100, "data": _bytes(50, 6)})  # into the appended bytes
    else:
        edits.append({"op": "append", "data": _bytes(3, 5)})
    sums = {name: pkg.update_file_many(paths[name], edits, **kw) for name, pkg, kw in PKGS}
    assert sums["t"] == sums["j"]
    assert sums["t"]["groups"] == 1 and sums["t"]["generation"] == 1 and sums["t"]["journal_fsyncs"] == 1
    _same(paths)
    mirror = bytearray(data)
    for e in edits:
        if e["op"] == "append":
            mirror += e["data"]
        else:
            mirror[e["at"] : e["at"] + len(e["data"])] = e["data"]
    seq = _reencode(tmp_path, bytes(mirror), layout, w)
    got = _archive(paths["t"], 6)
    assert [got[f"_{i}_f.bin"] for i in range(6)] == [_read(t_ff.chunk_file_name(seq, i)) for i in range(6)]


def test_small_windows_stack_into_one_gemm(tmp_path, monkeypatch):
    """1,000 disjoint 16-byte edits over an interleaved archive: their
    column windows stack into one E·Δ GEMM (one codec.update call)."""
    paths, _ = _pair(tmp_path, "interleaved", 8, size=64_000)
    calls = []
    real = RSCodec.update

    def spy(self, E, delta):
        calls.append(tuple(delta.shape))
        return real(self, E, delta)

    monkeypatch.setattr(RSCodec, "update", spy)
    edits = [{"op": "update", "at": 64 * j, "data": _bytes(16, j)} for j in range(1000)]
    summary = t_api.update_file_many(paths["t"], edits, device="cpu", segment_bytes=1 << 20)
    want = j_api.update_file_many(paths["j"], edits, strategy="bitplane", segment_bytes=1 << 20)
    assert summary == want
    assert len(calls) == 1 and summary["windows"] == 1000 and summary["segments"] == 1000
    _same(paths)


@pytest.mark.parametrize("stage", ["after_journal", "mid_patch", "before_commit"])
@pytest.mark.parametrize("case", ["update", "append", "group"])
@pytest.mark.parametrize("layout", ["row", "interleaved"])
def test_torn_ops_leave_jax_identical_journals_and_roll_back(tmp_path, monkeypatch, layout, case, stage):
    paths, _ = _pair(tmp_path, layout, 8)
    pre = _same(paths)
    monkeypatch.setenv("RS_UPDATE_CRASH", stage)
    grow = 5_000 if layout == "interleaved" else 3
    for name, pkg, kw in PKGS:
        crash = t_engine.SimulatedCrash if name == "t" else j_update.SimulatedCrash
        with pytest.raises(crash):
            if case == "update":
                pkg.update_file(paths[name], 8_000, _bytes(12_000, 9), **kw)
            elif case == "append":
                pkg.append_file(paths[name], _bytes(grow, 9), **kw)
            else:
                pkg.update_file_many(paths[name], [{"op": "update", "at": 100, "data": _bytes(50, 1)},
                                                   {"op": "append", "data": _bytes(grow, 2)},
                                                   {"op": "update", "at": 30_000, "data": _bytes(9_000, 3)}], **kw)
    monkeypatch.delenv("RS_UPDATE_CRASH")
    torn = _same(paths)  # the torn chunk files, metadata and journal bytes
    assert os.path.exists(t_ff.journal_path(paths["t"]))
    assert t_api.scan_file(paths["t"], device="cpu")["pending_journal"] is True
    assert torn["f.bin.METADATA"] == pre["f.bin.METADATA"]
    verdicts = {name: pkg.recover_archive(paths[name]) for name, pkg, _ in PKGS}
    assert verdicts == {"t": "rolled_back", "j": "rolled_back"}
    assert _same(paths) == pre
    assert {name: pkg.recover_archive(paths[name]) for name, pkg, _ in PKGS} == {"t": "none", "j": "none"}


@pytest.mark.parametrize("stage", ["after_journal", "mid_patch", "before_commit"])
@pytest.mark.parametrize("tearer", ["t", "j"])
def test_a_journal_torn_by_one_package_rolls_back_in_the_other(tmp_path, monkeypatch, tearer, stage):
    paths, _ = _pair(tmp_path, "interleaved", 16)
    pre = _archive(paths[tearer], 6)
    pkgs = dict((name, (pkg, kw)) for name, pkg, kw in PKGS)
    pkg, kw = pkgs[tearer]
    monkeypatch.setenv("RS_UPDATE_CRASH", stage)
    with pytest.raises(RuntimeError):
        pkg.append_file(paths[tearer], _bytes(6_001, 4), **kw)
    monkeypatch.delenv("RS_UPDATE_CRASH")
    assert _archive(paths[tearer], 6) != pre or stage == "after_journal"
    other, other_kw = pkgs["j" if tearer == "t" else "t"]
    assert other.recover_archive(paths[tearer]) == "rolled_back"
    assert _archive(paths[tearer], 6) == pre
    assert not os.path.exists(t_ff.journal_path(paths[tearer]))
    # The next op of the other package runs on the restored archive.
    summary = other.update_file(paths[tearer], 1, b"\x01\x02", **other_kw)
    assert summary["generation"] == 1 and summary["recovered"] == "none"


def test_the_next_op_recovers_a_torn_journal_like_jax(tmp_path, monkeypatch):
    paths, _ = _pair(tmp_path, "row", 8)
    monkeypatch.setenv("RS_UPDATE_CRASH", "mid_patch")
    for name, pkg, kw in PKGS:
        with pytest.raises(RuntimeError):
            pkg.update_file(paths[name], 5, _bytes(20_000, 1), **kw)
    monkeypatch.delenv("RS_UPDATE_CRASH")
    sums = {name: pkg.update_file(paths[name], 7, b"xyz", **kw) for name, pkg, kw in PKGS}
    assert sums["t"] == sums["j"] and sums["t"]["recovered"] == "rolled_back"
    _same(paths)


def test_stale_and_invalid_journals_are_discarded_like_jax(tmp_path):
    paths, _ = _pair(tmp_path, "interleaved", 8)
    for name, pkg, kw in PKGS:
        pkg.update_file(paths[name], 10, b"abc", **kw)
        with open(t_ff.journal_path(paths[name]), "w") as fp:
            fp.write('{"kind": "rs_update_journal", "generation": 0, "op": "update", "chunk_len": {}}\n')
    assert {name: pkg.recover_archive(paths[name]) for name, pkg, _ in PKGS} == {"t": "stale_discarded",
                                                                               "j": "stale_discarded"}
    for name, _, _ in PKGS:
        with open(t_ff.journal_path(paths[name]), "w") as fp:
            fp.write("not json\n")
    assert {name: pkg.recover_archive(paths[name]) for name, pkg, _ in PKGS} == {"t": "invalid_discarded",
                                                                               "j": "invalid_discarded"}
    _same(paths)


def test_in_process_failure_rolls_back_and_leaves_no_journal(tmp_path, monkeypatch):
    """A patch write that fails mid-op (the second pwrite) rolls the archive
    back from the durable journal in-process: the pre-op bytes, no journal."""
    paths, _ = _pair(tmp_path, "row", 8)
    pre = _archive(paths["t"], 6)
    from gpu_rscode_torch.parallel import io_executor

    real = io_executor.os.pwrite
    seen = []

    def failing(fd, data, off):
        seen.append(off)
        if len(seen) == 2:
            raise OSError("disk full")
        return real(fd, data, off)

    monkeypatch.setattr(io_executor.os, "pwrite", failing)
    with pytest.raises(OSError, match="disk full"):
        t_api.update_file(paths["t"], 100, _bytes(15_000, 3), **CPU)
    assert _archive(paths["t"], 6) == pre
    assert not os.path.exists(t_ff.journal_path(paths["t"]))


def test_row_layout_append_past_the_slack_is_refused_like_jax(tmp_path):
    """k=4 and 40,001 bytes: 3 bytes of slack; 3 fit, a 4th does not."""
    paths, _ = _pair(tmp_path, "row", 8)
    errors = {}
    for name, pkg, kw in PKGS:
        with pytest.raises(ValueError) as ei:
            pkg.append_file(paths[name], b"abcd", **kw)
        errors[name] = (type(ei.value).__name__, str(ei.value))
        with pytest.raises(ValueError) as ei:
            pkg.update_file_many(paths[name], [{"op": "append", "data": b"ab"}, {"op": "append", "data": b"cd"}],
                                 **kw)
        errors[name] += (str(ei.value),)
    assert errors["t"] == errors["j"]
    assert errors["t"][0] == "UpdateError" and "3 byte(s) of tail-padding slack" in errors["t"][1]
    _same(paths)
    sums = {name: pkg.append_file(paths[name], b"abc", **kw) for name, pkg, kw in PKGS}
    assert sums["t"] == sums["j"] and sums["t"]["total_size"] == SIZE + 3
    _same(paths)


def test_non_systematic_archive_is_refused_like_jax(tmp_path):
    paths, _ = _pair(tmp_path, "row", 8)
    errors = {}
    for name, pkg, kw in PKGS:
        meta = t_ff.metadata_file_name(paths[name])
        with open(meta) as fp:
            lines = fp.readlines()
        lines[2] = "1 1 0 0 \n"  # natives' first row no longer a unit vector
        with open(meta, "w") as fp:
            fp.writelines(lines)
        with pytest.raises(ValueError) as ei:
            pkg.update_file(paths[name], 0, b"x", **kw)
        errors[name] = (type(ei.value).__name__, str(ei.value))
    assert errors["t"] == errors["j"] and errors["t"][0] == "UpdateError" and "systematic" in errors["t"][1]
    _same(paths)


@pytest.mark.parametrize("case", [
    ("update", {"at": SIZE - 2, "data": b"abc"}),
    ("update", {"at": -1, "data": b"a"}),
    ("update", {"at": 0, "data": b"a", "src": "x"}),
    ("update", {"at": 0}),
    ("missing_chunk", {"at": 0, "data": b"a"}),
    ("truncated_chunk", {"at": 0, "data": b"a"}),
])
def test_update_errors_equal_jax(tmp_path, case):
    kind, args = case
    paths, _ = _pair(tmp_path, "row", 8)
    errors = {}
    for name, pkg, kw in PKGS:
        if kind == "missing_chunk":
            os.unlink(t_ff.chunk_file_name(paths[name], 5))
        elif kind == "truncated_chunk":
            os.truncate(t_ff.chunk_file_name(paths[name], 0), 10)
        at = args["at"]
        with pytest.raises(ValueError) as ei:
            pkg.update_file(paths[name], at, args.get("data"), src=args.get("src"), **kw)
        errors[name] = (type(ei.value).__name__, str(ei.value).replace(os.path.dirname(paths[name]), "D"))
    assert errors["t"] == errors["j"]
    _same(paths)


def test_group_window_splits_and_group_edits_override(tmp_path, monkeypatch):
    paths, _ = _pair(tmp_path, "interleaved", 8)
    monkeypatch.setenv("RS_UPDATE_GROUP_WINDOW", "2")
    assert t_group.group_window() == 2
    edits = [{"op": "update", "at": 1_000 * j, "data": _bytes(10, j)} for j in range(5)]
    sums = {name: pkg.update_file_many(paths[name], edits, **kw) for name, pkg, kw in PKGS}
    assert sums["t"] == sums["j"]
    assert sums["t"]["groups"] == 3 and sums["t"]["generation"] == 3 and sums["t"]["journal_fsyncs"] == 3
    _same(paths)
    sums = {name: pkg.update_file_many(paths[name], edits, group_edits=len(edits), group_tag="g7", **kw)
            for name, pkg, kw in PKGS}
    assert sums["t"] == sums["j"]
    assert sums["t"]["groups"] == 1 and sums["t"]["generation"] == 4 and sums["t"]["group_id"] == "g7"
    _same(paths)
    stats = t_group.group_stats()
    assert stats["window_max_edits"] == 2 and stats["groups"] >= 4


def test_batch_error_indexes_are_batch_relative_like_jax(tmp_path, monkeypatch):
    """With groups of 2, the bad edit (index 3) fails its second group:
    both packages name edit 3 and commit the first group only."""
    paths, _ = _pair(tmp_path, "interleaved", 8)
    monkeypatch.setenv("RS_UPDATE_GROUP_WINDOW", "2")
    edits = [{"op": "update", "at": 10 * j, "data": b"ab"} for j in range(3)]
    edits.append({"op": "update", "at": SIZE - 1, "data": b"abc"})
    errors = {}
    for name, pkg, kw in PKGS:
        with pytest.raises(ValueError) as ei:
            pkg.update_file_many(paths[name], edits, **kw)
        errors[name] = str(ei.value)
    assert errors["t"] == errors["j"] and errors["t"].startswith("edit 3:")
    assert t_ff.read_archive_meta(t_ff.metadata_file_name(paths["t"])).generation == 1
    _same(paths)
    for bad in ([{"op": "delete"}], [{"op": "update", "data": b"a"}], [{"op": "update", "at": -4, "data": b"a"}],
                ["x"]):
        msgs = []
        for name, pkg, kw in PKGS:
            with pytest.raises(ValueError) as ei:
                pkg.update_file_many(paths[name], bad, **kw)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def test_stage_hook_and_empty_ops(tmp_path):
    paths, _ = _pair(tmp_path, "interleaved", 8)
    stages = []
    t_api.update_file_many(paths["t"], [{"op": "update", "at": 3, "data": b"q"}], stage_hook=stages.append, **CPU)
    assert stages == ["device_done"]
    j_api.update_file_many(paths["j"], [{"op": "update", "at": 3, "data": b"q"}], **JAX)
    for name, pkg, kw in PKGS:
        assert pkg.update_file(paths[name], 5, b"", **kw)["segments"] == 0
    assert t_api.update_file_many(paths["t"], [], **CPU) == j_api.update_file_many(paths["j"], [], **JAX)
    _same(paths)


def test_update_without_checksums_keeps_metadata_crc_free(tmp_path):
    paths, _ = _pair(tmp_path, "interleaved", 16, checksums=False)
    for name, pkg, kw in PKGS:
        pkg.update_file(paths[name], 333, _bytes(5_000, 2), **kw)
        pkg.append_file(paths[name], _bytes(999, 3), **kw)
    got = _same(paths)
    assert b"# crc32" not in got["f.bin.METADATA"] and b"# generation 2" in got["f.bin.METADATA"]


def test_update_from_a_src_file(tmp_path):
    paths, _ = _pair(tmp_path, "row", 16)
    src = str(tmp_path / "delta")
    with open(src, "wb") as fp:
        fp.write(_bytes(7_777, 8))
    sums = {name: pkg.update_file(paths[name], 12_345, src=src, **kw) for name, pkg, kw in PKGS}
    assert sums["t"] == sums["j"]
    _same(paths)


def test_update_entry_points_need_a_device_without_a_gpu(tmp_path, monkeypatch):
    """With no device given and no GPU present, nothing runs on the CPU and
    the archive is left as it was."""
    paths, _ = _pair(tmp_path, "interleaved", 8)
    pre = _archive(paths["t"], 6)
    monkeypatch.setattr(backend, "cuda_devices_present", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_api.update_file(paths["t"], 0, b"a")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_api.append_file(paths["t"], b"a")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_api.update_file_many(paths["t"], [{"op": "update", "at": 0, "data": b"a"}])
    assert _archive(paths["t"], 6) == pre
    assert not os.path.exists(t_ff.journal_path(paths["t"]))
