"""The port's resilience reads against the JAX package's, on small seeded
archives on the CPU: ``scan_file`` reports, ``auto_decode_file`` outputs
and conf files, the survivor-subset cache, the mid-stream survivor swap
and resume of ``decode_file``, and ``decode_fleet``.  Tolerance 0: every
report, conf and output byte must be equal.

A mid-stream read failure is made the same way in both packages: a wrapper
on their ``native.gather_rows`` truncates a survivor before a chosen
gather, and from then on a gather over a file that ends before the
segment raises ``OSError``, as the native short read does."""

import os
import shutil

import numpy as np
import pytest
import torch

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import native as t_native
from gpu_rscode_torch.utils.fileformat import chunk_file_name
from gpu_rscode_tpu import api as j_api
from gpu_rscode_tpu import native as j_native

CPU = {"device": "cpu"}
JAX = {"strategy": "bitplane"}


def _archive(d, size, seed, k=4, p=2, w=8, checksums=True, segment_bytes=4096):
    """A seeded file and its archive in directory ``d``; returns (path, data)."""
    os.makedirs(d, exist_ok=True)
    path = os.path.join(str(d), "f.bin")
    data = np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()
    with open(path, "wb") as fp:
        fp.write(data)
    t_api.encode_file(path, k, p, w=w, checksums=checksums, segment_bytes=segment_bytes, **CPU)
    return path, data


def _copy(path, dst_dir):
    """The archive of ``path`` copied into ``dst_dir``; returns the new path."""
    os.makedirs(dst_dir, exist_ok=True)
    src_dir, base = os.path.split(path)
    for name in os.listdir(src_dir):
        if name.endswith(base) or name.startswith(base):
            shutil.copy(os.path.join(src_dir, name), os.path.join(dst_dir, name))
    return os.path.join(str(dst_dir), base)


def _flip(path, off):
    with open(path, "r+b") as fp:
        fp.seek(off)
        b = fp.read(1)[0]
        fp.seek(off)
        fp.write(bytes([b ^ 0xA5]))


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


DAMAGE = {
    "healthy": lambda path: None,
    "missing": lambda path: os.unlink(chunk_file_name(path, 1)),
    "truncated": lambda path: os.truncate(chunk_file_name(path, 2), 50),
    "crc_mismatch": lambda path: _flip(chunk_file_name(path, 4), 3),
    "three_lost": lambda path: [os.unlink(chunk_file_name(path, i)) for i in (0, 3, 5)],
}


@pytest.mark.parametrize("damage", sorted(DAMAGE))
@pytest.mark.parametrize("w", [8, 16])
def test_scan_file_report_equals_jax(tmp_path, damage, w):
    path, _ = _archive(tmp_path, 12_000, seed=65 + w, w=w)
    DAMAGE[damage](path)
    got = t_api.scan_file(path, **CPU)
    assert got == j_api.scan_file(path)
    assert got["decodable"] is (damage != "three_lost")


def test_scan_file_zero_size_archive_equals_jax(tmp_path):
    f = str(tmp_path / "empty.bin")
    (tmp_path / "empty.bin.METADATA").write_text("0 2 4\n")
    for i in range(6):
        (tmp_path / f"_{i}_empty.bin").write_bytes(b"")
    got = t_api.scan_file(f, **CPU)
    assert got == j_api.scan_file(f) and got["decodable"] is True and got["missing"] == []
    os.remove(str(tmp_path / "_1_empty.bin"))
    assert t_api.scan_file(f, **CPU) == j_api.scan_file(f)


def test_scan_file_decodable_unknown_when_capped(tmp_path, monkeypatch):
    """A subset search that hits its cap is reported as "unknown", never
    as proof either way (mirrors the JAX package's test)."""
    path, _ = _archive(tmp_path, 4_000, seed=66)

    def capped(pkg):
        def select(scan, **kw):
            raise pkg.UndecidedSubsetError("cap hit")
        return select

    monkeypatch.setattr(t_api, "_select_decodable_subset", capped(t_api))
    monkeypatch.setattr(j_api, "_select_decodable_subset", capped(j_api))
    got = t_api.scan_file(path, **CPU)
    assert got["decodable"] == "unknown" and got == j_api.scan_file(path)


def test_subset_search_capped_vs_exhausted():
    """Capped search raises UndecidedSubsetError, an exhausted one a plain
    ValueError; the windowed retry finds a pair past the singular ones."""
    from gpu_rscode_torch.ops.gf import get_field

    def scan_with(healthy, k):
        n = len(healthy)
        return t_api._ChunkScan("f", 100, n, k, np.zeros((n + k, k), dtype=np.uint8), 8, {}, 10, list(healthy), {})

    with pytest.raises(t_api.UndecidedSubsetError, match="not proven"):
        t_api._select_decodable_subset(scan_with(range(13), 3))
    with pytest.raises(ValueError, match="among healthy") as ei:
        t_api._select_decodable_subset(scan_with(range(4), 3))
    assert not isinstance(ei.value, t_api.UndecidedSubsetError)

    rows = [[1, 1]] * 6 + [[1, 2], [1, 3]]
    total = np.array(rows, dtype=np.uint8)
    scan = t_api._ChunkScan("g", 10, len(rows) - 2, 2, total, 8, {}, 5, list(range(len(rows))), {})
    with pytest.raises(t_api.UndecidedSubsetError):
        t_api._select_decodable_subset(scan, cap=5, skip=0)
    chosen, inv = t_api._select_subset_retrying(scan, attempts=40)
    j_scan = j_api._ChunkScan("g", 10, len(rows) - 2, 2, total, 8, {}, 5, list(range(len(rows))), {})
    j_chosen, j_inv = j_api._select_subset_retrying(j_scan, attempts=40)
    assert chosen == j_chosen
    np.testing.assert_array_equal(inv, j_inv)
    gf = get_field(8)
    np.testing.assert_array_equal(gf.matmul(total[chosen], inv), np.eye(2, dtype=np.uint8))


@pytest.mark.parametrize("w,checksums", [(8, True), (16, True), (8, False)])
def test_auto_decode_output_and_conf_equal_jax(tmp_path, w, checksums):
    path, data = _archive(tmp_path, 30_001, seed=7 + w, k=5, p=3, w=w, checksums=checksums)
    os.unlink(chunk_file_name(path, 0))
    os.truncate(chunk_file_name(path, 6), 10)
    if checksums:
        _flip(chunk_file_name(path, 2), 100)  # caught by its CRC
    outs = {}
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        out = pkg.auto_decode_file(path, str(tmp_path / f"{name}.out"), conf_out=str(tmp_path / f"{name}.conf"),
                                   segment_bytes=4096, **kw)
        outs[name] = (_read(out), _read(str(tmp_path / f"{name}.conf")))
    assert outs["t"] == outs["j"]
    assert outs["t"][0] == data


def test_auto_decode_default_conf_path(tmp_path):
    path, data = _archive(tmp_path, 9_000, seed=3)
    os.unlink(chunk_file_name(path, 1))
    out = t_api.auto_decode_file(path, str(tmp_path / "o"), **CPU)
    assert _read(out) == data
    assert _read(path + ".auto.conf").split() == [b"_0_f.bin", b"_2_f.bin", b"_3_f.bin", b"_4_f.bin"]


def test_auto_decode_too_few_chunks_raises_like_jax(tmp_path):
    path, _ = _archive(tmp_path, 5_000, seed=64)
    for i in (0, 1, 2):
        os.unlink(chunk_file_name(path, i))
    for pkg, kw in ((t_api, CPU), (j_api, JAX)):
        with pytest.raises(ValueError, match="healthy"):
            pkg.auto_decode_file(path, str(tmp_path / "o"), **kw)
    assert not os.path.exists(str(tmp_path / "o"))


def test_auto_decode_recovers_from_toctou(tmp_path, monkeypatch):
    """A native truncated after the scan chose it: the decode names it, and
    auto_decode_file excludes it, rescans and reselects."""
    path, data = _archive(tmp_path, 20_000, seed=5)
    real_scan = t_api._scan_chunks
    state = {"done": False}

    def scan_then_truncate(in_file, segment_bytes):
        scan = real_scan(in_file, segment_bytes)
        if not state["done"]:
            state["done"] = True
            os.truncate(chunk_file_name(path, 0), 7)
        return scan

    monkeypatch.setattr(t_api, "_scan_chunks", scan_then_truncate)
    out = t_api.auto_decode_file(path, str(tmp_path / "o"), **CPU)
    assert _read(out) == data
    assert b"_0_f.bin" not in _read(path + ".auto.conf").split()


def _subset_delta(after, before):
    return {key: after[key] - before[key] for key in ("hits", "misses", "stale")}


def test_subset_cache_hit_and_stale_like_jax(tmp_path):
    """The same scans give the same hits, misses and stale entries in both
    packages: a miss, then a hit, then stale after a generation bump (an
    update through the JAX package) and after a re-encode with another
    matrix."""
    path, _ = _archive(tmp_path, 50_000, seed=12)
    deltas = {"t": [], "j": []}

    def scans():
        for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, {})):
            before = pkg.subset_cache_stats()
            assert pkg.scan_file(path, **kw)["decodable"] is True
            deltas[name].append(_subset_delta(pkg.subset_cache_stats(), before))

    t_api.clear_subset_cache()
    j_api.clear_subset_cache()
    assert t_api.subset_cache_stats() == {"entries": 0, "hits": 0, "misses": 0, "stale": 0}
    scans()
    scans()
    j_api.update_file(path, 10, data=b"\xff" * 16)  # generation 1
    scans()
    t_api.encode_file(path, 4, 2, generator="cauchy", **CPU)
    scans()
    assert deltas["t"] == deltas["j"]
    assert deltas["t"] == [{"hits": 0, "misses": 1, "stale": 0}, {"hits": 1, "misses": 0, "stale": 0},
                           {"hits": 0, "misses": 1, "stale": 1}, {"hits": 0, "misses": 1, "stale": 1}]
    assert t_api.subset_cache_stats()["entries"] == 1


def _truncating_gather(monkeypatch, native_mod, victim, at_call, keep):
    """Wrap ``native_mod.gather_rows``: before gather ``at_call`` truncate
    ``victim`` to ``keep`` bytes; a gather over a file that ends before its
    segment raises OSError.  Returns the list of (off, names) gathered."""
    real = native_mod.gather_rows
    calls = []

    def gather_rows(files, off, cols, *args, **kw):
        calls.append((off, [os.path.basename(f.name) for f in files]))
        if len(calls) == at_call:
            os.truncate(victim, keep)
        for f in files:
            if os.fstat(f.fileno()).st_size < off + cols:
                raise OSError(f"short read from {f.name} at byte {off}")
        return real(files, off, cols, *args, **kw)

    monkeypatch.setattr(native_mod, "gather_rows", gather_rows)
    return calls


@pytest.mark.parametrize("w", [8, 16])
def test_midstream_failure_swaps_and_resumes_like_jax(tmp_path, monkeypatch, w):
    """A survivor that fails on its 3rd segment's gather is swapped for the
    pool chunk and the decode resumes from the first uncommitted segment:
    the output equals JAX's under the same failure, and the input."""
    monkeypatch.setenv("RS_RETRY_BASE_MS", "1")
    base, data = _archive(tmp_path / "src", 64_000, seed=6, k=3, p=2, w=w)
    os.unlink(chunk_file_name(base, 0))  # a recovery decode
    chunk = -(-64_000 // 3)  # even: the same chunk at w=16
    seg_cols = t_api._segment_cols(chunk, 3, 4096)
    outs = {}
    for name, pkg, native_mod, kw in (("t", t_api, t_native, CPU), ("j", j_api, j_native, JAX)):
        path = _copy(base, tmp_path / name)
        calls = _truncating_gather(monkeypatch, native_mod, chunk_file_name(path, 1), 3, 2 * seg_cols)
        out = pkg.auto_decode_file(path, str(tmp_path / f"{name}.out"), segment_bytes=4096, **kw)
        outs[name] = _read(out)
        failed = [i for i, (off, _) in enumerate(calls) if off == 2 * seg_cols and "_1_f.bin" in calls[i][1]]
        resumed = calls[failed[-1] + 1:]
        assert resumed and all("_1_f.bin" not in names for _, names in resumed)
        assert resumed[0][0] <= 2 * seg_cols  # from the first uncommitted segment
        assert resumed[-1][0] + seg_cols >= chunk  # and on to the end
        monkeypatch.undo()
        monkeypatch.setenv("RS_RETRY_BASE_MS", "1")
    assert outs["t"] == outs["j"] == data


def test_midstream_failure_without_pool_names_the_survivor_like_jax(tmp_path, monkeypatch):
    """decode_file with a conf and no pool cannot swap: the failure raises
    ChunkIntegrityError naming the survivor, in both packages, and leaves
    no output."""
    monkeypatch.setenv("RS_RETRY_BASE_MS", "1")
    base, _ = _archive(tmp_path / "src", 32_000, seed=7, k=3, p=2)
    os.unlink(chunk_file_name(base, 0))
    seg_cols = t_api._segment_cols(-(-32_000 // 3), 3, 4096)
    for name, pkg, native_mod, kw in (("t", t_api, t_native, CPU), ("j", j_api, j_native, JAX)):
        path = _copy(base, tmp_path / name)
        conf = path + ".conf"
        with open(conf, "w") as fp:
            fp.write("_1_f.bin\n_2_f.bin\n_3_f.bin\n")
        _truncating_gather(monkeypatch, native_mod, chunk_file_name(path, 1), 2, seg_cols)
        out = str(tmp_path / f"{name}.out")
        with pytest.raises(pkg.ChunkIntegrityError) as ei:
            pkg.decode_file(path, conf, out, verify_checksums=False, segment_bytes=4096, **kw)
        assert list(ei.value.bad_chunks) == [1]
        assert not os.path.exists(out) and not os.path.exists(out + ".rs_tmp")
        monkeypatch.undo()
        monkeypatch.setenv("RS_RETRY_BASE_MS", "1")


def test_midstream_reselect_bounded_by_env(tmp_path, monkeypatch):
    """RS_RETRY_RESELECT=0: no swap, the failing survivor is named."""
    monkeypatch.setenv("RS_RETRY_RESELECT", "0")
    path, _ = _archive(tmp_path, 32_000, seed=8, k=3, p=2)
    os.unlink(chunk_file_name(path, 0))
    conf = path + ".conf"
    with open(conf, "w") as fp:
        fp.write("_1_f.bin\n_2_f.bin\n_3_f.bin\n")
    seg_cols = t_api._segment_cols(-(-32_000 // 3), 3, 4096)
    _truncating_gather(monkeypatch, t_native, chunk_file_name(path, 3), 2, seg_cols)
    with pytest.raises(t_api.ChunkIntegrityError) as ei:
        t_api.decode_file(path, conf, str(tmp_path / "o"), segment_bytes=4096, _fallback_rows=[4], **CPU)
    assert list(ei.value.bad_chunks) == [3]


def test_decode_fleet_equals_jax(tmp_path):
    sizes = (20_000, 7, 33_333)
    outs = {}
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        files, datas = [], []
        for i, size in enumerate(sizes):
            path, data = _archive(tmp_path / f"{name}{i}", size, seed=40 + i)
            os.unlink(chunk_file_name(path, i))
            files.append(path)
            datas.append(data)
        res = pkg.decode_fleet(files, {f: f + ".out" for f in files}, segment_bytes=4096, **kw)
        assert list(res) == files
        outs[name] = [(_read(res[f]), _read(f + ".auto.conf")) for f in files]
        assert [o for o, _ in outs[name]] == datas
    assert outs["t"] == outs["j"]


def test_decode_fleet_midstream_swap_like_jax(tmp_path, monkeypatch):
    """A survivor of the second archive fails mid-stream inside a fleet:
    the shared lane is flushed, the survivor swapped and the decode
    resumed; every output equals JAX's under the same failure, and its
    input."""
    monkeypatch.setenv("RS_RETRY_BASE_MS", "1")
    seg_cols = t_api._segment_cols(-(-40_000 // 3), 3, 4096)
    outs = {}
    for name, pkg, native_mod, kw in (("t", t_api, t_native, CPU), ("j", j_api, j_native, JAX)):
        files, datas = [], []
        for i in range(3):
            path, data = _archive(tmp_path / f"{name}{i}", 40_000, seed=70 + i, k=3, p=2)
            os.unlink(chunk_file_name(path, 0))
            files.append(path)
            datas.append(data)
        # The first archive's 11 segments gather first; the second archive's
        # 3rd gather finds its chunk 1 cut.
        calls = _truncating_gather(monkeypatch, native_mod, chunk_file_name(files[1], 1), 11 + 3, 2 * seg_cols)
        res = pkg.decode_fleet(files, {f: f + ".out" for f in files}, segment_bytes=4096, **kw)
        outs[name] = [_read(res[f]) for f in files]
        assert outs[name] == datas
        assert calls[13] == (2 * seg_cols, ["_1_f.bin", "_2_f.bin", "_3_f.bin"])  # the failed gather
        resumed = next(c for c in calls[14:] if "_1_f.bin" not in c[1])
        assert resumed[0] <= 2 * seg_cols and resumed[1] == ["_2_f.bin", "_3_f.bin", "_4_f.bin"]
        monkeypatch.undo()
        monkeypatch.setenv("RS_RETRY_BASE_MS", "1")
    assert outs["t"] == outs["j"]


def test_decode_fleet_fails_fast_and_cleans_up(tmp_path):
    good, _ = _archive(tmp_path / "a", 9_000, seed=1)
    bad, _ = _archive(tmp_path / "b", 9_000, seed=2)
    for i in (0, 1, 2):
        os.unlink(chunk_file_name(bad, i))
    with pytest.raises(ValueError, match="healthy"):
        t_api.decode_fleet([good, bad], {good: good + ".out", bad: bad + ".out"}, **CPU)
    assert not os.path.exists(bad + ".out") and not os.path.exists(bad + ".out.rs_tmp")


def test_entry_points_need_a_device_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points run on it by default")
    path, _ = _archive(tmp_path, 3_000, seed=9)
    for call in (lambda: t_api.scan_file(path), lambda: t_api.auto_decode_file(path),
                 lambda: t_api.decode_fleet([path]), lambda: t_api.repair_file(path),
                 lambda: t_api.repair_fleet([path]), lambda: t_api.locate_decode_file(path)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
