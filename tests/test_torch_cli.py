"""The port's command line against the JAX package's on the flags that go
with the pipeline: ``-s``, ``-p``, ``--segment-bytes``, ``--generator``,
``--no-verify`` and the batch encode of extra positional files.  Both
CLIs run on copies of the same files; chunk files, .METADATA and decoded
bytes must be identical."""

import os

import numpy as np
import pytest

from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch.utils import fileformat as t_ff
from gpu_rscode_tpu import cli as j_cli
from gpu_rscode_tpu.tools.make_conf import make_conf as j_make_conf

SIZE = 300_007


def _write(path, size, seed):
    data = np.random.default_rng(seed).integers(0, 256, size=size, dtype=np.uint8).tobytes()
    with open(path, "wb") as fp:
        fp.write(data)
    return data


def _read(path):
    with open(path, "rb") as fp:
        return fp.read()


def _archive(path, n):
    names = [t_ff.chunk_file_name(path, i) for i in range(n)] + [t_ff.metadata_file_name(path)]
    return {os.path.basename(f): _read(f) for f in names}


def _both(tmp_path, argv_of, sizes=(SIZE,), n=6):
    """Run ``argv_of(paths)`` through each CLI on its own copy of the
    files; returns {cli: (rc, [archive per file], [data per file], paths)}."""
    out = {}
    for name, cli in (("torch", t_cli), ("jax", j_cli)):
        d = tmp_path / name
        d.mkdir()
        paths = [str(d / f"f{i}.bin") for i in range(len(sizes))]
        datas = [_write(p, size, 5 + i) for i, (p, size) in enumerate(zip(paths, sizes))]
        argv = argv_of(paths) + (["--device", "cpu"] if cli is t_cli else [])
        rc = cli.main(argv)
        out[name] = (rc, [_archive(p, n) if rc == 0 else None for p in paths], datas, paths)
    return out


@pytest.mark.parametrize("flags", [
    ["-s", "3", "-p", "1"],                        # 128 KiB segments at depth 3
    ["-S", "1", "-P", "2"],
    ["--segment-bytes", "40000", "-s", "2"],        # --segment-bytes wins over -p
    ["--segment-bytes", "40000", "-p", "64"],
    ["--generator", "cauchy", "-p", "1"],
    ["--generator", "cauchy", "--checksum", "-s", "1", "--width", "16", "-p", "1"],
])
def test_encode_flags_byte_identical_to_jax(tmp_path, capsys, flags):
    runs = _both(tmp_path, lambda paths: ["-k", "4", "-n", "6", "-e", paths[0], *flags])
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert runs["torch"][1] == runs["jax"][1]


def test_batch_encode_byte_identical_to_jax(tmp_path, capsys):
    sizes = (SIZE, 17, 140_000)
    runs = _both(tmp_path, lambda paths: ["-k", "4", "-n", "6", "-s", "3", "-p", "1", "-e", *paths], sizes=sizes)
    assert runs["torch"][0] == runs["jax"][0] == 0
    assert runs["torch"][1] == runs["jax"][1]
    assert "== encode" in capsys.readouterr().out


@pytest.mark.parametrize("flags", [["-s", "3", "-p", "1"], ["--segment-bytes", "8192", "-s", "1"]])
def test_decode_flags_round_trip_like_jax(tmp_path, capsys, flags):
    """Encode through the JAX CLI, lose two natives, decode through both
    CLIs with the same flags: both rebuild the file."""
    path = str(tmp_path / "f.bin")
    data = _write(path, SIZE, 11)
    assert j_cli.main(["-k", "4", "-n", "6", "-e", path, "--checksum"]) == 0
    for i in (0, 1):
        os.unlink(t_ff.chunk_file_name(path, i))
    conf = j_make_conf(6, 4, path, out=str(tmp_path / "conf"))
    for name, cli, extra in (("torch", t_cli, ["--device", "cpu"]), ("jax", j_cli, [])):
        out = str(tmp_path / f"out_{name}")
        assert cli.main(["-d", "-i", path, "-c", conf, "-o", out, *flags, *extra]) == 0
        assert _read(out) == data


def test_no_verify_decodes_a_corrupt_survivor_like_jax(tmp_path, capsys):
    """With CRC lines, a corrupt survivor fails the decode in both CLIs;
    --no-verify skips the check, and both write the same bytes."""
    path = str(tmp_path / "f.bin")
    _write(path, SIZE, 12)
    assert t_cli.main(["-k", "4", "-n", "6", "-e", path, "--checksum", "--device", "cpu"]) == 0
    victim = t_ff.chunk_file_name(path, 4)
    raw = bytearray(_read(victim))
    raw[100] ^= 0x5A
    with open(victim, "wb") as fp:
        fp.write(raw)
    conf = j_make_conf(6, 4, path, out=str(tmp_path / "conf"))  # chunks 2-5: chunk 4 is used
    outs = {}
    for name, cli, extra in (("torch", t_cli, ["--device", "cpu"]), ("jax", j_cli, [])):
        out = str(tmp_path / f"out_{name}")
        assert cli.main(["-d", "-i", path, "-c", conf, "-o", out, *extra]) == 1
        assert not os.path.exists(out)
        assert cli.main(["-d", "-i", path, "-c", conf, "-o", out, "--no-verify", *extra]) == 0
        outs[name] = _read(out)
    assert outs["torch"] == outs["jax"]


def test_pipeline_flag_errors(capsys):
    assert t_cli.main(["-k", "4", "-n", "6", "-e", "f", "--no-verify", "--device", "cpu"]) == 2
    assert t_cli.main(["-d", "-i", "f", "-c", "c", "extra", "--device", "cpu"]) == 2
    assert "--no-verify is decode-only" in capsys.readouterr().err
    assert t_cli.main(["-h"]) == 0
    usage = capsys.readouterr().out
    for flag in ("[-s|-S]", "[-p|-P]", "--segment-bytes", "--generator", "--no-verify"):
        assert flag in usage
