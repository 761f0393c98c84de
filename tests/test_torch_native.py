"""The port's native host IO (stripe_read, gather_rows, scatter_write),
built with g++ and forced to its NumPy fallback, against the JAX package's
``native`` module on the same files: ragged tails, offsets past the end of
the file, reads into a caller's buffer, and short files, which must raise.
Also where the library is built."""

import os

import numpy as np
import pytest

from gpu_rscode_torch import native as t_native
from gpu_rscode_tpu import native as j_native

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(params=["built", "fallback"])
def mode(request, monkeypatch):
    """The port's native module with its library, or with the library
    refused so that every call takes the NumPy fallback."""
    if request.param == "fallback":
        def refuse():
            raise t_native.NativeUnavailable("forced fallback")

        monkeypatch.setattr(t_native, "get_lib", refuse)
    else:
        t_native.get_lib()  # g++ is present here, so the library must build
    return request.param


def _counts():
    return t_native.NATIVE_CALLS, t_native.FALLBACK_CALLS


def _served(before, mode):
    native, fallback = _counts()
    return (native - before[0], fallback - before[1]) == ((1, 0) if mode == "built" else (0, 1))


def _file(tmp_path, name, size, seed):
    data = np.random.default_rng(seed).integers(0, 256, size=size, dtype=np.uint8)
    path = str(tmp_path / name)
    with open(path, "wb") as fp:
        fp.write(data.tobytes())
    return path, data


@pytest.mark.parametrize("off,cols", [(0, 1000), (2000, 501), (2400, 200), (0, 2501), (2500, 1), (2490, 128)])
def test_stripe_read_matches_jax(tmp_path, mode, off, cols):
    total = 10_001
    path, _ = _file(tmp_path, "f", total, 7)
    k, chunk = 4, 2501  # ceil(10001 / 4): the last row is ragged
    before = _counts()
    got = t_native.stripe_read(path, chunk, k, off, cols, total)
    assert _served(before, mode)
    np.testing.assert_array_equal(got, j_native.stripe_read(path, chunk, k, off, cols, total))


def test_stripe_read_past_the_end_is_zeros(tmp_path, mode):
    """Rows that start past the file's end (a tiny file over many rows)
    read as zeros, as in the JAX package."""
    path, data = _file(tmp_path, "tiny", 5, 8)
    got = t_native.stripe_read(path, 1, 10, 0, 1, 5)
    np.testing.assert_array_equal(got, j_native.stripe_read(path, 1, 10, 0, 1, 5))
    assert got[:5, 0].tolist() == data.tolist() and not got[5:].any()


def test_stripe_read_into_dst(tmp_path, mode):
    path, _ = _file(tmp_path, "f", 9_000, 9)
    buf = np.full(3 * 3000 + 17, 0xAB, dtype=np.uint8)
    dst = buf[: 3 * 1000].reshape(3, 1000)
    got = t_native.stripe_read(path, 3000, 3, 2500, 1000, 9_000, dst=dst)
    assert got is dst
    np.testing.assert_array_equal(dst, j_native.stripe_read(path, 3000, 3, 2500, 1000, 9_000))
    assert (buf[3000:] == 0xAB).all()  # nothing written past the view
    with pytest.raises(ValueError, match="dst"):
        t_native.stripe_read(path, 3000, 3, 0, 1000, 9_000, dst=np.empty((3, 999), dtype=np.uint8))


def test_stripe_read_short_file_raises(tmp_path, mode):
    path, _ = _file(tmp_path, "short", 5_000, 10)
    with pytest.raises(OSError):
        t_native.stripe_read(path, 2501, 4, 0, 2501, 10_001)  # the file ends before total_size


@pytest.mark.parametrize("off,cols", [(1234, 4096), (0, 10_000), (9_999, 1)])
def test_gather_rows_matches_jax(tmp_path, mode, off, cols):
    paths = [_file(tmp_path, f"c{i}", 10_000, 50 + i)[0] for i in range(3)]
    maps = [np.memmap(p, dtype=np.uint8, mode="r") for p in paths]
    fps = [open(p, "rb") for p in paths]
    try:
        before = _counts()
        got = t_native.gather_rows(fps, off, cols, fallback_maps=maps)
        assert _served(before, mode)
        np.testing.assert_array_equal(got, j_native.gather_rows(fps, off, cols, fallback_maps=maps))
        dst = np.empty((3, cols), dtype=np.uint8)
        assert t_native.gather_rows(fps, off, cols, fallback_maps=maps, dst=dst) is dst
        np.testing.assert_array_equal(dst, got)
    finally:
        for fp in fps:
            fp.close()


@pytest.mark.parametrize("off", [9_000, 10_000])
def test_gather_rows_short_chunk_raises(tmp_path, mode, off):
    """A chunk that ends before off + cols raises in both packages: zeros
    would decode into wrong bytes."""
    paths = [_file(tmp_path, f"c{i}", 10_000 if i != 1 else 9_500, 60 + i)[0] for i in range(3)]
    maps = [np.memmap(p, dtype=np.uint8, mode="r") for p in paths]
    fps = [open(p, "rb") for p in paths]
    try:
        with pytest.raises(OSError):
            t_native.gather_rows(fps, off, 1000, fallback_maps=maps)
        with pytest.raises((OSError, ValueError)):
            j_native.gather_rows(fps, off, 1000, fallback_maps=maps)
    finally:
        for fp in fps:
            fp.close()


@pytest.mark.parametrize("off", [0, 777])
def test_scatter_write_matches_jax(tmp_path, mode, off):
    arr = np.random.default_rng(off).integers(0, 256, size=(3, 2000), dtype=np.uint8)
    written = {}
    for name, mod in (("torch", t_native), ("jax", j_native)):
        files = [open(str(tmp_path / f"{name}{j}"), "wb") for j in range(3)]
        try:
            files[0].write(b"\x01" * 5)  # buffered bytes ahead of the pwrite
            mod.scatter_write(files, arr, off)
        finally:
            for fp in files:
                fp.close()
        written[name] = [(tmp_path / f"{name}{j}").read_bytes() for j in range(3)]
    assert written["torch"] == written["jax"]
    assert written["torch"][1][off:] == arr[1].tobytes()


def test_library_lands_under_build():
    path = t_native.library_path()
    root = os.path.join(REPO, "build", "gpu_rscode_torch")
    assert str(path).startswith(root + os.sep)
    assert os.path.basename(os.path.dirname(path)).startswith("rs_native_io-")
    assert path.is_file()
    # The JAX package builds next to its source; the port must not.
    assert not list((t_native.SRC.parent).glob("*.so"))
