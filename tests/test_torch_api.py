"""File encode/decode of the PyTorch port against the JAX package: chunk
files and .METADATA byte-identical, round trips both ways between the two
packages, the CLI, and the device rule of the entry points."""

import os
import subprocess
import sys

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch.tools.make_conf import make_conf as t_make_conf
from gpu_rscode_torch.utils import backend
from gpu_rscode_torch.utils import fileformat as t_ff
from gpu_rscode_tpu import api as j_api
from gpu_rscode_tpu.tools.make_conf import make_conf as j_make_conf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = 4096  # several segments per file at these sizes


def _write(path, size, seed):
    data = np.random.default_rng(seed).integers(0, 256, size=size, dtype=np.uint8).tobytes()
    with open(path, "wb") as fp:
        fp.write(data)
    return data


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


@pytest.mark.parametrize("checksums", [False, True])
@pytest.mark.parametrize("size", [20_000, 20_003])
@pytest.mark.parametrize("w", [8, 16])
def test_encode_byte_identical_to_jax(tmp_path, w, size, checksums):
    k, p = 4, 2
    mine, ref = tmp_path / "torch", tmp_path / "jax"
    mine.mkdir()
    ref.mkdir()
    _write(mine / "f.bin", size, size + w)
    _write(ref / "f.bin", size, size + w)
    got = t_api.encode_file(str(mine / "f.bin"), k, p, w=w, checksums=checksums, device="cpu", segment_bytes=SEG)
    want = j_api.encode_file(str(ref / "f.bin"), k, p, w=w, checksums=checksums, strategy="bitplane", segment_bytes=SEG)
    assert [os.path.basename(f) for f in got] == [os.path.basename(f) for f in want]
    for a, b in zip(got, want):
        assert _read(a) == _read(b), os.path.basename(a)
    assert not [f for f in os.listdir(mine) if f.endswith(".rs_tmp")]


@pytest.mark.parametrize("w", [8, 16])
def test_decode_drop_first_conf_round_trip(tmp_path, w):
    path = str(tmp_path / "f.bin")
    data = _write(path, 30_001, w)
    t_api.encode_file(path, 10, 4, w=w, checksums=True, device="cpu", segment_bytes=SEG)
    conf = t_make_conf(14, 10, path)
    assert _read(conf) == _read(j_make_conf(14, 10, path, out=str(tmp_path / "jconf")))
    for i in range(4):
        os.unlink(t_ff.chunk_file_name(path, i))
    out = t_api.decode_file(path, conf, str(tmp_path / "out"), device="cpu", segment_bytes=SEG)
    assert _read(out) == data


@pytest.mark.parametrize("w", [8, 16])
def test_jax_archive_decodes_through_port(tmp_path, w):
    path = str(tmp_path / "f.bin")
    data = _write(path, 12_345, 10 + w)
    j_api.encode_file(path, 4, 2, w=w, checksums=True, strategy="bitplane", generator="cauchy")
    conf = j_make_conf(6, 4, path, survivors=[1, 3, 4, 5])
    out = t_api.decode_file(path, conf, str(tmp_path / "out"), device="cpu")
    assert _read(out) == data


@pytest.mark.parametrize("w", [8, 16])
def test_port_archive_decodes_through_jax(tmp_path, w):
    path = str(tmp_path / "f.bin")
    data = _write(path, 12_345, 20 + w)
    t_api.encode_file(path, 4, 2, w=w, checksums=True, device="cpu", strategy="table")
    conf = t_make_conf(6, 4, path)
    out = j_api.decode_file(path, conf, str(tmp_path / "out"), strategy="bitplane")
    assert _read(out) == data


def test_all_natives_survive_and_sizes_only_metadata(tmp_path):
    """No missing native: a pure copy.  Sizes-only metadata (the reference
    CPU dialect) regenerates the Vandermonde matrix."""
    path = str(tmp_path / "f.bin")
    data = _write(path, 9_999, 1)
    t_api.encode_file(path, 4, 2, device="cpu")
    conf = t_make_conf(6, 4, path, survivors=[3, 0, 2, 1])
    assert _read(t_api.decode_file(path, conf, str(tmp_path / "a"), device="cpu")) == data
    meta = t_ff.metadata_file_name(path)
    lines = _read(meta).decode().splitlines()
    with open(meta, "w") as fp:
        fp.write("\n".join(lines[:2]) + "\n")
    conf = t_make_conf(6, 4, path)
    assert _read(t_api.decode_file(path, conf, str(tmp_path / "b"), device="cpu")) == data


def test_corrupt_survivor_raises_and_bad_inputs(tmp_path):
    path = str(tmp_path / "f.bin")
    _write(path, 8_000, 2)
    t_api.encode_file(path, 4, 2, checksums=True, device="cpu")
    victim = t_ff.chunk_file_name(path, 5)
    raw = bytearray(_read(victim))
    raw[7] ^= 0xFF
    with open(victim, "wb") as fp:
        fp.write(raw)
    conf = t_make_conf(6, 4, path)
    with pytest.raises(t_api.ChunkIntegrityError, match="5:") as e:
        t_api.decode_file(path, conf, str(tmp_path / "o"), device="cpu")
    assert e.value.bad_chunks == {5: victim}
    assert not os.path.exists(str(tmp_path / "o"))
    t_api.decode_file(path, conf, str(tmp_path / "o"), device="cpu", verify_checksums=False)
    with open(str(tmp_path / "short"), "w") as fp:
        fp.write("_0_f.bin\n")
    with pytest.raises(ValueError, match="need k=4"):
        t_api.decode_file(path, str(tmp_path / "short"), device="cpu")
    empty = str(tmp_path / "empty")
    open(empty, "wb").close()
    with pytest.raises(ValueError, match="empty"):
        t_api.encode_file(empty, 4, 2, device="cpu")
    with pytest.raises(ValueError, match="width"):
        t_api.encode_file(path, 4, 2, w=4, device="cpu")


def test_interleaved_archive_is_refused(tmp_path):
    path = str(tmp_path / "f.bin")
    _write(path, 5_000, 3)
    j_api.encode_file(path, 4, 2, strategy="bitplane", layout="interleaved")
    with pytest.raises(ValueError, match="layout"):
        t_api.decode_file(path, j_make_conf(6, 4, path), str(tmp_path / "o"), device="cpu")


@pytest.mark.parametrize("chunk,k,seg", [(5000, 4, 4096), (107374183, 10, 64 << 20), (100, 4, 4096), (300, 3, 128)])
def test_segment_cols_match_jax(chunk, k, seg):
    assert t_api._segment_cols(chunk, k, seg) == j_api._segment_cols(chunk, k, seg)
    assert t_api._segment_spans(chunk, 1000) == j_api._segment_spans(chunk, 1000)


def test_cli_round_trip_subprocess(tmp_path):
    path = str(tmp_path / "f.bin")
    data = _write(path, 7_777, 4)
    env = dict(os.environ, PYTHONPATH=REPO)
    run = lambda *a: subprocess.run([sys.executable, "-m", "gpu_rscode_torch", *a], env=env, cwd=str(tmp_path),
                                    capture_output=True, text=True, timeout=300)
    enc = run("-k", "4", "-n", "6", "-e", path, "--width", "16", "--checksum", "--device", "cpu")
    assert enc.returncode == 0, enc.stderr
    assert "== encode" in enc.stdout
    conf = t_make_conf(6, 4, path)
    dec = run("-D", "-I", path, "-C", conf, "-O", str(tmp_path / "out"), "--device", "cpu")
    assert dec.returncode == 0, dec.stderr
    assert _read(str(tmp_path / "out")) == data


def test_cli_usage_errors(capsys):
    assert t_cli.main(["-h"]) == 0
    assert t_cli.main(["-i", "x"]) == 2  # -i before -d
    assert t_cli.main(["-k", "4", "-n", "6", "-e", "f", "--strategy", "xor"]) == 2
    assert t_cli.main(["-k", "4", "-n", "4", "-e", "f", "--device", "cpu"]) == 2
    assert t_cli.main(["-d", "-i", "f", "-c", "c", "--width", "16"]) == 2
    assert t_cli.main(["-k", "4", "-n", "6", "-e", "f", "--width", "12"]) == 2
    assert t_cli.main(["-d", "-i", "f"]) == 2


def test_entry_points_raise_without_a_device(tmp_path, monkeypatch, capsys):
    """With no device given and no GPU present, nothing runs on the CPU."""
    monkeypatch.setattr(backend, "cuda_devices_present", lambda: False)
    path = str(tmp_path / "f.bin")
    _write(path, 1_000, 5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_api.encode_file(path, 4, 2)
    assert not [f for f in os.listdir(tmp_path) if f.startswith("_")]
    t_api.encode_file(path, 4, 2, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_api.decode_file(path, t_make_conf(6, 4, path), str(tmp_path / "o"))
    assert t_cli.main(["-k", "4", "-n", "6", "-e", path]) == 1
    assert "no CUDA device" in capsys.readouterr().err
