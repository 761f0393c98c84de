"""The port's interleaved chunk layout against the JAX package's, on the
CPU: the layout math (``interleave`` / ``deinterleave``,
``touched_windows`` / ``touched_rows``, the chunk size of each layout),
the seekable CRC arithmetic against zlib, the native interleave pair
against its NumPy fallback, the ``# layout`` metadata line and the
metadata rewrite, ``submit_pwrite``, and the file operations on
interleaved archives: encode (one file and a fleet), decode, the
auto-decode with a mid-stream survivor swap, ``decode_fleet``,
``scan_file``, ``repair_file``, ``repair_fleet`` and
``locate_decode_file``.  Tolerance 0: every chunk file, .METADATA, report
and output byte must equal the JAX package's (``strategy="bitplane"``)."""

import os
import shutil
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import native as t_native
from gpu_rscode_torch.parallel import io_executor as t_io
from gpu_rscode_torch.update import crc as t_crc
from gpu_rscode_torch.update import layout as t_layout
from gpu_rscode_torch.utils import fileformat as t_ff
from gpu_rscode_tpu import api as j_api
from gpu_rscode_tpu import native as j_native
from gpu_rscode_tpu.parallel import io_executor as j_io
from gpu_rscode_tpu.tools.make_conf import make_conf as j_make_conf
from gpu_rscode_tpu.update import crc as j_crc
from gpu_rscode_tpu.update import layout as j_layout
from gpu_rscode_tpu.utils import fileformat as j_ff

CPU = {"device": "cpu"}
JAX = {"strategy": "bitplane"}
SEG = 4096


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def _write(path, size, seed):
    data = np.random.default_rng(seed).integers(0, 256, size=size, dtype=np.uint8).tobytes()
    with open(path, "wb") as fp:
        fp.write(data)
    return data


def _archive(path, n):
    names = [t_ff.chunk_file_name(path, i) for i in range(n)] + [t_ff.metadata_file_name(path)]
    return {os.path.basename(f): _read(f) for f in names}


def _copy(path, dst_dir):
    os.makedirs(dst_dir, exist_ok=True)
    src_dir, base = os.path.split(path)
    for name in os.listdir(src_dir):
        if base in name:
            shutil.copy(os.path.join(src_dir, name), os.path.join(dst_dir, name))
    return os.path.join(str(dst_dir), base)


def _encode_both(tmp_path, size, seed, k=4, p=2, w=8, checksums=True):
    """The same seeded file encoded interleaved by each package in its own
    directory; returns ({"t": path, "j": path}, data)."""
    paths = {}
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        d = tmp_path / name
        d.mkdir(exist_ok=True)
        paths[name] = str(d / "f.bin")
        data = _write(paths[name], size, seed)
        pkg.encode_file(paths[name], k, p, w=w, checksums=checksums, layout="interleaved", segment_bytes=SEG, **kw)
    return paths, data


# ---- layout math ------------------------------------------------------------------


@pytest.mark.parametrize("k,sym,cols", [(1, 1, 5), (4, 1, 1), (4, 2, 7), (10, 1, 411), (6, 2, 100), (3, 1, 4096)])
def test_interleave_roundtrip_equals_jax(k, sym, cols):
    flat = np.random.default_rng(k * 31 + cols).integers(0, 256, size=k * cols * sym, dtype=np.uint8)
    rows = t_layout.interleave(flat, k, sym)
    np.testing.assert_array_equal(rows, j_layout.interleave(flat, k, sym))
    assert rows.shape == (k, cols * sym)
    # File symbol s sits in row s % k, column s // k.
    for s in (0, 1, k * cols - 1):
        np.testing.assert_array_equal(rows[s % k, (s // k) * sym : (s // k + 1) * sym], flat[s * sym : (s + 1) * sym])
    np.testing.assert_array_equal(t_layout.deinterleave(rows, sym), flat)


@settings(max_examples=150, deadline=None)
@given(layout=st.sampled_from(["row", "interleaved"]), k=st.integers(1, 6), sym=st.sampled_from([1, 2]),
       chunk_syms=st.integers(1, 300), at_frac=st.floats(0, 1), length=st.integers(0, 3000))
def test_touched_windows_and_rows_equal_jax(layout, k, sym, chunk_syms, at_frac, length):
    chunk = chunk_syms * sym
    total = k * chunk
    at = int(at_frac * (total - 1))
    length = min(length, total - at)
    assert t_layout.touched_windows(layout, at, length, k, sym, chunk) == j_layout.touched_windows(
        layout, at, length, k, sym, chunk)
    assert t_layout.touched_rows(layout, at, length, k, chunk) == j_layout.touched_rows(layout, at, length, k, chunk)
    assert t_layout.row_file_range(layout, at % k, 0, sym, k, sym, chunk) == j_layout.row_file_range(
        layout, at % k, 0, sym, k, sym, chunk)


@pytest.mark.parametrize("total", [0, 1, 7, 20_000, 20_001, 20_003, 1 << 20])
@pytest.mark.parametrize("k,sym", [(4, 1), (4, 2), (10, 1), (3, 2)])
@pytest.mark.parametrize("layout", ["row", "interleaved"])
def test_chunk_size_for_layout_equals_jax(total, k, sym, layout):
    assert t_ff.chunk_size_for_layout(total, k, sym, layout) == j_ff.chunk_size_for_layout(total, k, sym, layout)


def test_archive_meta_chunk_honours_the_layout(tmp_path):
    """ArchiveMeta.chunk goes through chunk_size_for_layout with the
    archive's ``# layout``, as the JAX package's does, and equals the chunk
    files the JAX package wrote (total=20001, k=4, w=16 interleaved).  The
    two layouts' formulas, ceil(ceil(T/k)/s)*s and ceil(T/(k*s))*s, agree
    for every size (nested ceilings), checked here over a range."""
    path = str(tmp_path / "f.bin")
    _write(path, 20_001, 1)
    j_api.encode_file(path, 4, 2, w=16, layout="interleaved", **JAX)
    meta = t_ff.read_archive_meta(t_ff.metadata_file_name(path))
    assert meta.layout == "interleaved"
    assert t_ff.read_layout(t_ff.metadata_file_name(path)) == "interleaved"
    want = j_ff.read_archive_meta(j_ff.metadata_file_name(path)).chunk
    assert meta.chunk == want == os.path.getsize(t_ff.chunk_file_name(path, 0))
    assert meta.chunk == t_ff.chunk_size_for_layout(20_001, 4, 2, "interleaved")
    for total in range(0, 3000, 7):
        for k, sym in ((1, 2), (3, 2), (4, 2), (10, 1), (7, 2)):
            assert t_ff.chunk_size_for_layout(total, k, sym, "interleaved") == t_ff.chunk_size_for(total, k, sym)


@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("layout", ["row", "interleaved"])
def test_write_metadata_bytes_equal_jax(tmp_path, w, layout):
    from gpu_rscode_torch.codec import RSCodec

    mat = RSCodec(4, 2, w=w, device="cpu").total_matrix
    t_ff.write_metadata(str(tmp_path / "t"), 20_001, 2, 4, mat, w=w, layout=layout)
    j_ff.write_metadata(str(tmp_path / "j"), 20_001, 2, 4, mat, w=w, layout=layout)
    assert _read(str(tmp_path / "t")) == _read(str(tmp_path / "j"))
    assert (b"# layout interleaved\n" in _read(str(tmp_path / "t"))) == (layout == "interleaved")


def test_unknown_layout_is_refused_like_jax(tmp_path):
    path = str(tmp_path / "m")
    with open(path, "w") as fp:
        fp.write("10\n1 1\n1 \n1 \n# layout diagonal\n")
    for ff in (t_ff, j_ff):
        with pytest.raises(ValueError, match="layout"):
            ff.read_archive_meta(path)


@pytest.mark.parametrize("kwargs", [
    {}, {"bump_generation": True}, {"total_size": 12345, "bump_generation": True},
    {"crcs": {0: 1, 3: 0xDEADBEEF}}, {"crcs": {}, "bump_generation": True},
])
def test_rewrite_metadata_lines_bytes_equal_jax(tmp_path, kwargs):
    path = str(tmp_path / "f.bin")
    _write(path, 5_000, 2)
    j_api.encode_file(path, 4, 2, w=16, checksums=True, layout="interleaved", **JAX)
    j_ff.rewrite_metadata_lines(t_ff.metadata_file_name(path), bump_generation=True)
    meta = t_ff.metadata_file_name(path)
    shutil.copy(meta, meta + ".j")
    got = t_ff.rewrite_metadata_lines(meta, **kwargs)
    want = j_ff.rewrite_metadata_lines(meta + ".j", **kwargs)
    assert got == want
    assert _read(meta) == _read(meta + ".j")
    t_ff.rewrite_checksums(meta, {1: 7})
    j_ff.rewrite_checksums(meta + ".j", {1: 7})
    assert _read(meta) == _read(meta + ".j")


# ---- seekable CRC arithmetic ------------------------------------------------------


@pytest.mark.parametrize("la,lb", [(0, 0), (0, 5), (5, 0), (1, 1), (100, 3), (4096, 65537), (7, 1 << 16)])
def test_crc32_combine_and_zeros_match_zlib(la, lb):
    rng = np.random.default_rng(la + 3 * lb)
    a, b = rng.bytes(la), rng.bytes(lb)
    got = t_crc.crc32_combine(zlib.crc32(a), zlib.crc32(b), lb)
    assert got == zlib.crc32(a + b) == j_crc.crc32_combine(zlib.crc32(a), zlib.crc32(b), lb)
    assert t_crc.crc32_zeros(la) == zlib.crc32(b"\x00" * la) == j_crc.crc32_zeros(la)


@settings(max_examples=100, deadline=None)
@given(n=st.integers(1, 5000), off_frac=st.floats(0, 1), dlen=st.integers(0, 600), seed=st.integers(0, 2**31))
def test_crc32_patch_and_append_match_a_full_rehash(n, off_frac, dlen, seed):
    rng = np.random.default_rng(seed)
    old = rng.integers(0, 256, n, dtype=np.uint8)
    off = int(off_frac * (n - 1))
    delta = rng.integers(0, 256, min(dlen, n - off), dtype=np.uint8)
    new = old.copy()
    new[off : off + delta.shape[0]] ^= delta
    crc_old = zlib.crc32(old.tobytes())
    got = t_crc.crc32_patch(crc_old, n, off, delta.tobytes())
    assert got == zlib.crc32(new.tobytes()) == j_crc.crc32_patch(crc_old, n, off, delta.tobytes())
    tail = rng.bytes(dlen)
    assert t_crc.crc32_append(crc_old, tail) == zlib.crc32(old.tobytes() + tail)


# ---- the native interleave pair ---------------------------------------------------


@pytest.fixture(params=["built", "fallback"])
def mode(request, monkeypatch):
    if request.param == "fallback":
        def refuse():
            raise t_native.NativeUnavailable("forced fallback")

        monkeypatch.setattr(t_native, "get_lib", refuse)
    else:
        t_native.get_lib()
    return request.param


@pytest.mark.parametrize("k,sym,total,off,cols", [
    (4, 1, 20_001, 0, 5001), (4, 2, 20_001, 2000, 600), (10, 1, 100_000, 9000, 1000), (3, 2, 17, 0, 4),
    (5, 2, 1000, 90, 20), (6, 1, 70_000, 11_000, 700), (4, 1, 100, 40, 8),
])
def test_interleave_read_and_deinterleave_write(tmp_path, mode, k, sym, total, off, cols):
    path = str(tmp_path / "f")
    data = np.frombuffer(_write(path, total, k + total), dtype=np.uint8)
    want_bytes = np.zeros(cols * k, dtype=np.uint8)
    seg = data[off * k : (off + cols) * k]
    want_bytes[: seg.shape[0]] = seg
    want = j_layout.interleave(want_bytes, k, sym)
    before = (t_native.NATIVE_CALLS, t_native.FALLBACK_CALLS)
    dst = np.full((k, cols), 0x5A, dtype=np.uint8)
    got = t_native.interleave_read(path, k, sym, off, cols, total, dst=dst)
    assert got is dst
    np.testing.assert_array_equal(got, want)
    out = str(tmp_path / "o")
    with open(out, "wb") as fp:
        t_native.deinterleave_write(fp, list(got), sym, off, total)
    served = (t_native.NATIVE_CALLS - before[0], t_native.FALLBACK_CALLS - before[1])
    calls = 1 + (off * k < total)  # nothing past the file's end is written
    assert served == ((calls, 0) if mode == "built" else (0, calls))
    np.testing.assert_array_equal(np.fromfile(out, dtype=np.uint8)[off * k :], seg)


def test_interleave_read_of_a_short_file_raises(tmp_path, mode):
    path = str(tmp_path / "f")
    _write(path, 1000, 3)
    with pytest.raises(OSError):
        t_native.interleave_read(path, 4, 1, 0, 300, 1200)


# ---- submit_pwrite ----------------------------------------------------------------


@pytest.mark.parametrize("io", [t_io, j_io], ids=["torch", "jax"])
def test_submit_pwrite_commits_in_submit_order(tmp_path, io):
    path = str(tmp_path / "f")
    with open(path, "wb") as fp:
        fp.write(b"\x00" * 64)
    fd = os.open(path, os.O_RDWR)
    try:
        with io.DrainExecutor(ordered=True) as lane:
            for i in range(32):
                lane.submit_pwrite(fd, bytes([i]) * 8, (i % 8) * 8)  # later patches overwrite earlier ones
    finally:
        os.close(fd)
    assert _read(path) == b"".join(bytes([24 + j]) * 8 for j in range(8))


def test_submit_pwrite_short_write_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(t_io.os, "pwrite", lambda fd, data, off: len(data) - 1)
    with pytest.raises(OSError, match="short pwrite"):
        with t_io.DrainExecutor(ordered=True) as lane:
            lane.submit_pwrite(0, b"abcd", 0)


# ---- file operations on interleaved archives -------------------------------------


@pytest.mark.parametrize("checksums", [False, True])
@pytest.mark.parametrize("size", [17, 20_000, 20_001, 64_000])
@pytest.mark.parametrize("w", [8, 16])
def test_interleaved_encode_byte_identical_to_jax(tmp_path, w, size, checksums):
    paths, _ = _encode_both(tmp_path, size, size + w, w=w, checksums=checksums)
    assert _archive(paths["t"], 6) == _archive(paths["j"], 6)
    assert not [f for f in os.listdir(tmp_path / "t") if f.endswith(".rs_tmp")]


@pytest.mark.parametrize("depth,writers", [(1, "0"), (2, "1"), (3, "2")])
def test_interleaved_encode_pipelined_equals_jax(tmp_path, monkeypatch, depth, writers):
    monkeypatch.setenv("RS_IO_WRITERS", writers)
    path = str(tmp_path / "f.bin")
    _write(path, 50_001, 9)
    t_api.encode_file(path, 5, 3, layout="interleaved", checksums=True, segment_bytes=2048, pipeline_depth=depth, **CPU)
    got = _archive(path, 8)
    j_api.encode_file(path, 5, 3, layout="interleaved", checksums=True, segment_bytes=2048, **JAX)
    assert got == _archive(path, 8)


def test_interleaved_encode_fleet_equals_jax(tmp_path):
    sizes = (20_001, 7, 33_333)
    archives = {}
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        files = [str(tmp_path / f"{name}{i}.bin") for i in range(len(sizes))]
        for i, (f, size) in enumerate(zip(files, sizes)):
            _write(f, size, 70 + i)
        pkg.encode_fleet(files, 4, 2, layout="interleaved", checksums=True, segment_bytes=SEG, **kw)
        archives[name] = [sorted(_archive(f, 6).values()) for f in files]
    assert archives["t"] == archives["j"]


def test_bad_layout_is_refused(tmp_path):
    path = str(tmp_path / "f.bin")
    _write(path, 100, 1)
    with pytest.raises(ValueError, match="layout"):
        t_api.encode_file(path, 4, 2, layout="diagonal", **CPU)


@pytest.mark.parametrize("survivors", [[0, 1, 2, 3], [2, 3, 4, 5], [0, 2, 4, 5]])
@pytest.mark.parametrize("w", [8, 16])
def test_interleaved_decode_both_ways(tmp_path, w, survivors):
    """Each package's interleaved archive decodes through the other."""
    paths, data = _encode_both(tmp_path, 30_001, 11 + w, w=w)
    for mine, other, pkg, kw in (("t", "j", j_api, JAX), ("j", "t", t_api, CPU)):
        conf = j_make_conf(6, 4, paths[mine], survivors=survivors, out=paths[mine] + ".conf")
        out = pkg.decode_file(paths[mine], conf, str(tmp_path / f"{mine}.out"), segment_bytes=SEG, **kw)
        assert _read(out) == data


@pytest.mark.parametrize("w", [8, 16])
def test_interleaved_scan_auto_decode_and_repair_equal_jax(tmp_path, w):
    paths, data = _encode_both(tmp_path, 40_003, 21 + w, w=w)
    results = {}
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        path = paths[name]
        os.unlink(t_ff.chunk_file_name(path, 0))
        with open(t_ff.chunk_file_name(path, 4), "r+b") as fp:
            fp.seek(5)
            fp.write(b"\xee")
        scan_kw = CPU if name == "t" else {}
        report = pkg.scan_file(path, segment_bytes=SEG, **scan_kw)
        out = pkg.auto_decode_file(path, path + ".out", segment_bytes=SEG, **kw)
        rebuilt = pkg.repair_file(path, segment_bytes=SEG, **kw)
        results[name] = (report, _read(out), _read(path + ".auto.conf"), rebuilt, _archive(path, 6))
        assert _read(out) == data
    (rt, ot, ct, bt, at), (rj, oj, cj, bj, aj) = results["t"], results["j"]
    assert rt == rj and ot == oj and ct == cj and bt == bj == [0, 4] and at == aj


@pytest.mark.parametrize("w", [8, 16])
def test_interleaved_midstream_swap_equals_jax(tmp_path, monkeypatch, w):
    """A survivor truncated before its 3rd segment's gather is swapped for a
    pool chunk and the decode resumes; the interleaved output is written
    at ``off * k``, so the resumed segments land where they belong."""
    from gpu_rscode_tpu import native as j_nat

    monkeypatch.setenv("RS_RETRY_BASE_MS", "1")
    base = str(tmp_path / "src" / "f.bin")
    os.makedirs(os.path.dirname(base))
    data = _write(base, 64_000, 6 + w)
    t_api.encode_file(base, 3, 2, w=w, checksums=True, layout="interleaved", segment_bytes=SEG, **CPU)
    os.unlink(t_ff.chunk_file_name(base, 0))
    chunk = t_ff.chunk_size_for_layout(64_000, 3, w // 8, "interleaved")
    seg_cols = t_api._segment_cols(chunk, 3, SEG)
    outs = {}
    for name, pkg, nat, kw in (("t", t_api, t_native, CPU), ("j", j_api, j_nat, JAX)):
        path = _copy(base, tmp_path / name)
        victim = t_ff.chunk_file_name(path, 1)
        real = nat.gather_rows
        calls = []

        def gather_rows(files, off, cols, *args, _real=real, _victim=victim, _calls=calls, **kwargs):
            _calls.append(off)
            if len(_calls) == 3:
                os.truncate(_victim, 2 * seg_cols)
            for f in files:
                if os.fstat(f.fileno()).st_size < off + cols:
                    raise OSError(f"short read from {f.name} at byte {off}")
            return _real(files, off, cols, *args, **kwargs)

        monkeypatch.setattr(nat, "gather_rows", gather_rows)
        out = pkg.auto_decode_file(path, str(tmp_path / f"{name}.out"), segment_bytes=SEG, **kw)
        outs[name] = _read(out)
        monkeypatch.setattr(nat, "gather_rows", real)
        assert len(calls) > len(t_api._segment_spans(chunk, seg_cols))  # some segment was read twice
    assert outs["t"] == outs["j"] == data


def test_interleaved_fleets_equal_jax(tmp_path):
    sizes = (20_000, 9, 33_333)
    results = {}
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        files, datas = [], []
        for i, size in enumerate(sizes):
            path = str(tmp_path / f"{name}{i}" / "f.bin")
            os.makedirs(os.path.dirname(path))
            datas.append(_write(path, size, 90 + i))
            pkg.encode_file(path, 4, 2, checksums=True, layout="interleaved", segment_bytes=SEG, **kw)
            os.unlink(t_ff.chunk_file_name(path, i))
            os.unlink(t_ff.chunk_file_name(path, 5))
            files.append(path)
        rebuilt = pkg.repair_fleet(files, segment_bytes=SEG, **kw)
        archives = [_archive(f, 6) for f in files]
        for f in files:
            os.unlink(t_ff.chunk_file_name(f, 1))
        outs = pkg.decode_fleet(files, {f: f + ".out" for f in files}, segment_bytes=SEG, **kw)
        results[name] = (rebuilt and [rebuilt[f] for f in files], archives, [_read(outs[f]) for f in files])
        assert results[name][2] == datas
    assert results["t"] == results["j"]


@pytest.mark.parametrize("lost", [[], [1], [0, 2]])
@pytest.mark.parametrize("w", [8, 16])
def test_interleaved_locate_decode_equals_jax(tmp_path, w, lost):
    """Silent bitrot in one chunk of an archive without CRC lines, with
    ``lost`` natives erased too: both packages locate it and write the
    same bytes, the input."""
    paths, data = _encode_both(tmp_path, 30_000, 31 + w, k=4, p=4, w=w, checksums=False)
    outs = {}
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        path = paths[name]
        for i in lost:
            os.unlink(t_ff.chunk_file_name(path, i))
        with open(t_ff.chunk_file_name(path, 3), "r+b") as fp:
            for off in (4, 3000, 7000):
                fp.seek(off)
                fp.write(b"\x5a\x5a")
        outs[name] = _read(pkg.locate_decode_file(path, path + ".out", segment_bytes=SEG, **kw))
    assert outs["t"] == outs["j"] == data
