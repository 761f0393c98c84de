"""The port's ``repair_file`` and ``repair_fleet`` against the JAX package's
on copies of the same damaged archives, on the CPU: every rebuilt chunk,
every other chunk and .METADATA byte-identical, the same indices returned
and the same error classes.  The fleet's survivor inverses come from one
batched ``invert_matrix_torch_batch(..., pivot=False)`` per (k, w) group,
each verified on the host."""

import os
import shutil

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch.ops import inverse as t_inverse
from gpu_rscode_torch.utils.fileformat import chunk_file_name, metadata_file_name
from gpu_rscode_tpu import api as j_api

CPU = {"device": "cpu"}
JAX = {"strategy": "bitplane"}


def _archive(d, size, seed, k=4, p=2, w=8, checksums=True):
    os.makedirs(d, exist_ok=True)
    path = os.path.join(str(d), "f.bin")
    data = np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()
    with open(path, "wb") as fp:
        fp.write(data)
    t_api.encode_file(path, k, p, w=w, checksums=checksums, segment_bytes=4096, **CPU)
    return path, data


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def _files(path, n):
    """{basename: bytes} of the archive's chunks and .METADATA."""
    names = [chunk_file_name(path, i) for i in range(n)] + [metadata_file_name(path)]
    return {os.path.basename(f): _read(f) if os.path.exists(f) else None for f in names}


def _copy(path, dst_dir):
    os.makedirs(dst_dir, exist_ok=True)
    src_dir, base = os.path.split(path)
    for name in os.listdir(src_dir):
        if base in name:
            shutil.copy(os.path.join(src_dir, name), os.path.join(str(dst_dir), name))
    return os.path.join(str(dst_dir), base)


def _flip(path, off):
    with open(path, "r+b") as fp:
        fp.seek(off)
        b = fp.read(1)[0]
        fp.seek(off)
        fp.write(bytes([b ^ 0xA5]))


def _both(tmp_path, base, call):
    """``call(pkg, path, kw)`` on a port copy and a JAX copy of the archive
    of ``base``; returns {name: (result or exception class, files)}."""
    out = {}
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        path = _copy(base, tmp_path / name)
        try:
            res = call(pkg, path, kw)
        except ValueError as e:
            res = type(e).__name__
        out[name] = res, path
    return out


@pytest.mark.parametrize("w", [8, 16])
@pytest.mark.parametrize("checksums", [True, False])
def test_repair_file_byte_identical_to_jax(tmp_path, w, checksums):
    base, data = _archive(tmp_path / "src", 25_000, seed=61 + w, k=4, p=3, w=w, checksums=checksums)
    golden = _files(base, 7)
    os.unlink(chunk_file_name(base, 5))  # parity lost
    os.truncate(chunk_file_name(base, 0), 100)  # a native truncated
    if checksums:
        _flip(chunk_file_name(base, 1), 0)  # a native corrupt: caught by its CRC
    runs = _both(tmp_path, base, lambda pkg, path, kw: pkg.repair_file(path, segment_bytes=4096, **kw))
    want = [0, 1, 5] if checksums else [0, 5]
    assert runs["t"][0] == runs["j"][0] == want
    assert _files(runs["t"][1], 7) == _files(runs["j"][1], 7) == golden
    # Healthy afterwards, and a second repair has nothing to do.
    assert t_api.scan_file(runs["t"][1], **CPU)["healthy"] == list(range(7))
    assert t_api.repair_file(runs["t"][1], **CPU) == []


def test_repair_file_refreshes_crc_lines_and_keeps_generation(tmp_path):
    """A repair after an update keeps the archive's generation line and
    rewrites the CRC lines as the JAX package does."""
    base, _ = _archive(tmp_path / "src", 20_000, seed=3)
    j_api.update_file(base, 100, data=b"\x01" * 64)
    golden = _files(base, 6)
    os.unlink(chunk_file_name(base, 2))
    _flip(chunk_file_name(base, 4), 10)
    runs = _both(tmp_path, base, lambda pkg, path, kw: pkg.repair_file(path, **kw))
    assert runs["t"][0] == runs["j"][0] == [2, 4]
    assert _files(runs["t"][1], 6) == _files(runs["j"][1], 6) == golden
    assert "# generation 1" in golden["f.bin.METADATA"].decode()


def test_repair_too_many_losses_same_error_as_jax(tmp_path):
    base, _ = _archive(tmp_path / "src", 5_000, seed=64)
    for i in (0, 1, 2):
        os.unlink(chunk_file_name(base, i))
    runs = _both(tmp_path, base, lambda pkg, path, kw: pkg.repair_file(path, **kw))
    assert runs["t"][0] == runs["j"][0] == "ValueError"
    with pytest.raises(ValueError, match="healthy"):
        t_api.repair_file(runs["t"][1], **CPU)
    assert _files(runs["t"][1], 6) == _files(runs["j"][1], 6)


def _zero_size(d, healthy):
    os.makedirs(d, exist_ok=True)
    f = os.path.join(str(d), "empty.bin")
    with open(f + ".METADATA", "w") as fp:
        fp.write("0 2 4\n")
    for i in healthy:
        open(os.path.join(str(d), f"_{i}_empty.bin"), "wb").close()
    return f


def test_repair_zero_size_archive_like_jax(tmp_path):
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        f = _zero_size(tmp_path / name, [0, 2, 3, 4])
        assert pkg.repair_file(f, **kw) == [1, 5]
        assert all(os.path.getsize(chunk_file_name(f, i)) == 0 for i in range(6))
        out = pkg.auto_decode_file(f, f + ".out", **kw)
        assert os.path.getsize(out) == 0
        f = _zero_size(tmp_path / f"{name}_short", [0, 1, 2])
        assert pkg.scan_file(f, **({} if pkg is j_api else CPU))["decodable"] is False
        with pytest.raises(ValueError, match="healthy"):
            pkg.repair_file(f, **kw)


def test_repair_file_over_a_mesh_rebuilds_the_saved_chunks(tmp_path):
    """repair_file over a mesh (cols mode, and the stripe mode on k): the
    rebuilt chunks equal the saved ones, as the single-device repair's do;
    stripe_sharded without a mesh is the single-device repair."""
    from gpu_rscode_torch.parallel.mesh import make_mesh

    path, _ = _archive(tmp_path, 3_000, seed=1)
    saved = {i: _read(chunk_file_name(path, i)) for i in range(6)}
    for stripe, lost in ((1, [0, 5]), (2, [1, 4]), (1, [])):
        for i in lost:
            os.unlink(chunk_file_name(path, i))
        mesh = make_mesh(4, stripe=stripe, device="cpu")
        assert t_api.repair_file(path, mesh=mesh, stripe_sharded=stripe > 1, strategy="cuda", **CPU) == lost
        assert {i: _read(chunk_file_name(path, i)) for i in range(6)} == saved
    os.unlink(chunk_file_name(path, 2))
    assert t_api.repair_file(path, stripe_sharded=True, **CPU) == [2]
    assert {i: _read(chunk_file_name(path, i)) for i in range(6)} == saved


class _BatchSpy:
    """Counts invert_matrix_torch_batch calls; ``tamper`` may rewrite the
    result (inverse, ok) before repair_fleet sees it."""

    def __init__(self, monkeypatch, tamper=None):
        self.calls = []
        real = t_inverse.invert_matrix_torch_batch

        def spy(Ms, w=8, **kw):
            self.calls.append((np.shape(Ms), kw.get("pivot"), str(kw.get("device"))))
            out = real(Ms, w, **kw)
            return tamper(*out) if tamper else out

        monkeypatch.setattr(t_inverse, "invert_matrix_torch_batch", spy)


def _fleet(tmp_path, name, configs):
    paths = []
    for j, (k, p, size, w) in enumerate(configs):
        path, _ = _archive(tmp_path / name / str(j), size, seed=size + j, k=k, p=p, w=w)
        paths.append(path)
    return paths


CONFIGS = [(4, 2, 5000, 8), (4, 2, 7001, 8), (6, 3, 9000, 8), (4, 2, 6002, 16)]


def _damage(paths):
    os.unlink(chunk_file_name(paths[0], 0))
    os.unlink(chunk_file_name(paths[0], 5))
    _flip(chunk_file_name(paths[1], 2), 3)
    os.unlink(chunk_file_name(paths[3], 1))  # paths[2] stays healthy


def test_repair_fleet_byte_identical_to_jax_one_batch_per_group(tmp_path, monkeypatch):
    t_api.clear_subset_cache()
    j_api.clear_subset_cache()
    golden, results = {}, {}
    spy = _BatchSpy(monkeypatch)
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        paths = _fleet(tmp_path, name, CONFIGS)
        golden[name] = [_files(p, k + pp) for p, (k, pp, _s, _w) in zip(paths, CONFIGS)]
        _damage(paths)
        res = pkg.repair_fleet(paths, **kw)
        results[name] = [res[p] for p in paths]
        assert [_files(p, k + pp) for p, (k, pp, _s, _w) in zip(paths, CONFIGS)] == golden[name]
    assert results["t"] == results["j"] == [[0, 5], [2], [], [1]]
    assert golden["t"] == golden["j"]
    # (k=4, w=8) and (k=4, w=16): one batched no-pivot call each.
    assert sorted(spy.calls) == [((1, 4, 4), False, "cpu"), ((2, 4, 4), False, "cpu")]


def test_repair_fleet_second_pass_uses_the_subset_cache(tmp_path, monkeypatch):
    t_api.clear_subset_cache()
    paths = _fleet(tmp_path, "t", CONFIGS[:2])
    os.unlink(chunk_file_name(paths[0], 0))
    os.unlink(chunk_file_name(paths[1], 0))
    spy = _BatchSpy(monkeypatch)
    assert t_api.repair_fleet(paths, **CPU) == {paths[0]: [0], paths[1]: [0]}
    os.unlink(chunk_file_name(paths[0], 0))
    os.unlink(chunk_file_name(paths[1], 0))
    assert t_api.repair_fleet(paths, **CPU) == {paths[0]: [0], paths[1]: [0]}
    assert len(spy.calls) == 1  # the second pass took both pinned subsets
    assert t_api.subset_cache_stats()["hits"] >= 2


@pytest.mark.parametrize("fault", ["not_ok", "wrong_inverse"])
def test_repair_fleet_resolves_a_failed_device_inverse_on_the_host(tmp_path, monkeypatch, fault):
    """The verify-and-fallback: a member flagged not ok, or whose inverse
    fails the host check, is re-solved by the host subset search, and its
    chunks still rebuild byte for byte."""
    t_api.clear_subset_cache()
    paths = _fleet(tmp_path, "t", CONFIGS[:2])
    golden = [_files(p, 6) for p in paths]
    for p in paths:
        os.unlink(chunk_file_name(p, 1))

    def tamper(invs, oks):
        if fault == "not_ok":
            oks = oks.clone()
            oks[1] = False
        else:
            invs = invs.clone()
            invs[1, 0, 0] ^= 1
        return invs, oks

    _BatchSpy(monkeypatch, tamper)
    solved = []
    real = t_api._select_decodable_subset
    monkeypatch.setattr(t_api, "_select_decodable_subset", lambda scan, **kw: solved.append(scan.in_file) or
                        real(scan, **kw))
    assert t_api.repair_fleet(paths, **CPU) == {p: [1] for p in paths}
    assert solved == [paths[1]]
    assert [_files(p, 6) for p in paths] == golden


def test_repair_fleet_all_or_nothing_like_jax(tmp_path):
    for name, pkg, kw in (("t", t_api, CPU), ("j", j_api, JAX)):
        a, _ = _archive(tmp_path / name / "a", 4000, seed=1)
        b, _ = _archive(tmp_path / name / "b", 6000, seed=2)
        os.unlink(chunk_file_name(a, 1))
        for i in range(3):
            os.unlink(chunk_file_name(b, i))
        with pytest.raises(ValueError, match="unrecoverable archives"):
            pkg.repair_fleet([a, b], **kw)
        assert not os.path.exists(chunk_file_name(a, 1))  # nothing repaired
        assert pkg.repair_fleet([a], **kw) == {a: [1]}
        z = _zero_size(tmp_path / name / "z", [0, 1, 2])
        os.unlink(chunk_file_name(a, 1))
        with pytest.raises(ValueError, match="unrecoverable archives"):
            pkg.repair_fleet([a, z], **kw)
        assert not os.path.exists(chunk_file_name(a, 1))
