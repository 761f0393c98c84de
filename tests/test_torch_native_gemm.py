"""The native host codec of the port (``native.gemm`` / ``native.invert``,
``rs_native_gemm.cpp``) against the JAX package's ``native`` and its
oracles ``GaloisField.matmul`` / ``invert_matrix``, tolerance 0, singular
matrices included; the counted NumPy fallback; ``strategy="cpu"`` through
``RSCodec``, the file entry points (archives equal to the JAX package's)
and the CLI, with no GPU."""

import os

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch import native as t_native
from gpu_rscode_torch.codec import RSCodec as TCodec
from gpu_rscode_torch.ops import inverse as t_inverse
from gpu_rscode_torch.utils import backend
from gpu_rscode_torch.utils import fileformat as t_ff
from gpu_rscode_tpu import api as j_api
from gpu_rscode_tpu import native as j_native
from gpu_rscode_tpu.ops.gf import get_field
from gpu_rscode_tpu.ops.inverse import SingularMatrixError as JSingular
from gpu_rscode_tpu.ops.inverse import invert_matrix as j_invert_matrix

GF = get_field(8)
K, P = 4, 3


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for knob in ("RS_RUNLOG", "RS_SCHEDULE_STORE", "RS_STRATEGY_AUTOTUNE", "RS_PLAN"):
        monkeypatch.delenv(knob, raising=False)


@pytest.mark.parametrize("p,k,m", [(1, 1, 1), (4, 10, 31), (4, 10, 64), (3, 7, 1000), (10, 10, 4097),
                                   (6, 17, 65), (4, 10, 70_001)])
def test_gemm_equals_jax_and_the_oracle(p, k, m):
    rng = np.random.default_rng(p * 1000 + m)
    A = rng.integers(0, 256, size=(p, k), dtype=np.uint8)
    B = rng.integers(0, 256, size=(k, m), dtype=np.uint8)
    got = t_native.gemm(A, B)
    np.testing.assert_array_equal(got, j_native.gemm(A, B))
    np.testing.assert_array_equal(got, GF.matmul(A, B))


def test_gemm_threads_agree():
    rng = np.random.default_rng(3)
    A = rng.integers(0, 256, size=(4, 10), dtype=np.uint8)
    B = rng.integers(0, 256, size=(10, 300_000), dtype=np.uint8)
    want = t_native.gemm(A, B, nthreads=1)
    for nt in (2, 3, 4):
        np.testing.assert_array_equal(t_native.gemm(A, B, nthreads=nt), want)
    np.testing.assert_array_equal(want, j_native.gemm(A, B, nthreads=4))


def test_gemm_counts_its_calls():
    before = t_native.GEMM_CALLS, t_native.GEMM_FALLBACK_CALLS
    t_native.gemm(np.ones((2, 3), np.uint8), np.ones((3, 5), np.uint8))
    assert (t_native.GEMM_CALLS, t_native.GEMM_FALLBACK_CALLS) == (before[0] + 1, before[1])


@pytest.mark.parametrize("k", [1, 2, 5, 10, 32])
def test_invert_equals_jax_and_the_oracle(k):
    rng = np.random.default_rng(k)
    while True:
        M = rng.integers(0, 256, size=(k, k), dtype=np.uint8)
        try:
            want = j_invert_matrix(M)
            break
        except JSingular:
            continue
    got = t_native.invert(M)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, j_native.invert(M))
    np.testing.assert_array_equal(GF.matmul(M, got), np.eye(k, dtype=np.uint8))


def test_invert_zero_pivot():
    M = np.array([[0, 1], [1, 0]], dtype=np.uint8)
    np.testing.assert_array_equal(t_native.invert(M), j_native.invert(M))


@pytest.mark.parametrize("M", [np.zeros((3, 3), np.uint8), np.array([[1, 2], [1, 2]], np.uint8),
                               np.array([[5, 7, 9], [5, 7, 9], [1, 2, 3]], np.uint8)])
def test_invert_singular_raises_in_both(M):
    with pytest.raises(t_inverse.SingularMatrixError):
        t_native.invert(M)
    with pytest.raises(JSingular):
        j_native.invert(M)


def test_fallback_is_counted_and_cpu_strategy_refused(monkeypatch):
    """Without the library, a direct call takes the oracle and counts it;
    ``RSCodec(strategy="cpu")`` is refused at construction."""
    def refuse():
        raise t_native.NativeUnavailable("no g++")

    monkeypatch.setattr(t_native, "get_gemm_lib", refuse)
    rng = np.random.default_rng(1)
    A = rng.integers(0, 256, size=(3, 5), dtype=np.uint8)
    B = rng.integers(0, 256, size=(5, 77), dtype=np.uint8)
    before = t_native.GEMM_FALLBACK_CALLS
    np.testing.assert_array_equal(t_native.gemm(A, B), j_native.gemm(A, B))
    M = np.array([[1, 2], [3, 4]], dtype=np.uint8)
    np.testing.assert_array_equal(t_native.invert(M), j_native.invert(M))
    assert t_native.GEMM_FALLBACK_CALLS == before + 2
    assert not t_native.available()
    with pytest.raises(RuntimeError, match="native GEMM library"):
        TCodec(4, 2, strategy="cpu")


def test_cpu_strategy_needs_no_gpu(monkeypatch):
    monkeypatch.setattr(backend, "cuda_devices_present", lambda: False)
    codec = TCodec(K, P, strategy="cpu")
    assert codec.device.type == "cpu" and codec.strategy == "cpu"
    with pytest.raises(ValueError, match="GF\\(2\\^8\\)"):
        TCodec(K, P, w=16, strategy="cpu")
    with pytest.raises(ValueError, match="on the host"):
        TCodec(K, P, strategy="cpu", device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TCodec(K, P)
    data = np.random.default_rng(2).integers(0, 256, size=(K, 999), dtype=np.uint8)
    before = t_native.GEMM_CALLS
    np.testing.assert_array_equal(codec.encode(data).numpy(), GF.matmul(codec.parity_block, data))
    assert t_native.GEMM_CALLS == before + 1


def _seeded(path, size, seed):
    data = np.random.default_rng(seed).integers(0, 256, size=size, dtype=np.uint8).tobytes()
    with open(path, "wb") as fp:
        fp.write(data)
    return data


def _archive(path, n=K + P):
    names = [t_ff.chunk_file_name(path, i) for i in range(n)] + [t_ff.metadata_file_name(path)]
    return {os.path.basename(f): open(f, "rb").read() for f in names if os.path.exists(f)}


def _conf(path, survivors):
    conf = path + ".conf"
    with open(conf, "w") as fp:
        fp.write("".join(os.path.basename(t_ff.chunk_file_name(path, i)) + "\n" for i in survivors))
    return conf


@pytest.mark.parametrize("layout", ["row", "interleaved"])
def test_cpu_file_ops_equal_jax_with_no_gpu(tmp_path, monkeypatch, layout):
    """encode / decode / update / append / locate under strategy cpu with
    no GPU and no device given: the JAX package's archives and bytes, and
    no oracle call."""
    monkeypatch.setattr(backend, "cuda_devices_present", lambda: False)
    paths, data = {}, None
    fallback0 = t_native.GEMM_FALLBACK_CALLS
    for name, api in (("t", t_api), ("j", j_api)):
        d = tmp_path / name
        d.mkdir()
        paths[name] = str(d / "f.bin")
        data = _seeded(paths[name], 30_011, 6)
        api.encode_file(paths[name], K, P, strategy="cpu", segment_bytes=4096, checksums=True, layout=layout)
    assert _archive(paths["t"]) == _archive(paths["j"])
    delta = np.random.default_rng(9).integers(0, 256, size=5000, dtype=np.uint8).tobytes()
    tail = np.random.default_rng(10).integers(0, 256, size=1, dtype=np.uint8).tobytes()  # the row slack
    for name, api in (("t", t_api), ("j", j_api)):
        api.update_file(paths[name], 1234, delta, strategy="cpu", segment_bytes=4096)
        api.append_file(paths[name], tail, strategy="cpu", segment_bytes=4096)
    assert _archive(paths["t"]) == _archive(paths["j"])
    want = bytearray(data)
    want[1234:1234 + len(delta)] = delta
    want += tail
    path = paths["t"]
    for i in (0, 2):
        os.unlink(t_ff.chunk_file_name(path, i))
    out = t_api.decode_file(path, _conf(path, [1, 3, 4, 5]), path + ".out", strategy="cpu", segment_bytes=4096)
    assert open(out, "rb").read() == bytes(want)
    out = t_api.locate_decode_file(path, path + ".loc", strategy="cpu", segment_bytes=4096)
    assert open(out, "rb").read() == bytes(want)
    assert t_native.GEMM_FALLBACK_CALLS == fallback0


def test_cli_strategy_cpu(tmp_path, monkeypatch, capsys):
    """``--strategy cpu`` on the main command and on ``update`` /
    ``append``, with no GPU and no --device: the JAX CLI's archive."""
    from gpu_rscode_tpu import cli as j_cli

    monkeypatch.setattr(backend, "cuda_devices_present", lambda: False)
    paths = {}
    for name in ("t", "j"):
        d = tmp_path / name
        d.mkdir()
        paths[name] = str(d / "f.bin")
        data = _seeded(paths[name], 20_000, 12)
    delta = tmp_path / "delta.bin"
    delta.write_bytes(b"\x5a" * 999)
    for name, cli in (("t", t_cli), ("j", j_cli)):
        path = paths[name]
        assert cli.main(["-k", str(K), "-n", str(K + P), "-e", path, "--strategy", "cpu", "--checksum",
                         "--quiet"]) == 0
        assert cli.main(["update", path, "--at", "100", "--in", str(delta), "--strategy", "cpu", "--quiet"]) == 0
        assert cli.main(["append", path, "--in", str(delta), "--strategy", "cpu", "--quiet"]) != 0  # past the slack
    capsys.readouterr()
    assert _archive(paths["t"]) == _archive(paths["j"])
    path = paths["t"]
    for i in range(P):
        os.unlink(t_ff.chunk_file_name(path, i))
    out = path + ".out"
    assert t_cli.main(["-d", "-i", path, "-c", _conf(path, range(P, K + P)), "-o", out, "--strategy", "cpu",
                       "--quiet"]) == 0
    want = bytearray(data)
    want[100:1099] = delta.read_bytes()
    assert open(out, "rb").read() == bytes(want)
    assert t_cli.main(["-k", "4", "-n", "6", "-e", path, "--strategy", "bogus"]) == 2
    assert "cpu" in capsys.readouterr().err
