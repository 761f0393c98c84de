"""The port's mesh file operations against the JAX package's on the CPU:
``encode_file`` / ``decode_file`` / ``auto_decode_file`` / ``repair_file``
with a mesh of ``cpu`` listed 8 times (cols mode and the wide stripe)
write chunk files and .METADATA byte-identical to the JAX package's run of
the same call on its 8 virtual devices and to its single-device encode;
``rs --devices 8 --stripe 4`` round-trips through the CLI, its
``--metrics-json`` mesh series equal the JAX package's, and every mesh
refusal of the CLI exits as the JAX package's does."""

import hashlib
import json
import os

import numpy as np
import pytest

from gpu_rscode_torch import api as t_api, cli as t_cli, plan as t_plan
from gpu_rscode_torch.obs import metrics as t_metrics
from gpu_rscode_torch.parallel.mesh import make_mesh
from gpu_rscode_torch.tools.make_conf import make_conf
from gpu_rscode_tpu import api as j_api, cli as j_cli, plan as j_plan
from gpu_rscode_tpu.obs import metrics as j_metrics
from gpu_rscode_tpu.parallel.mesh import make_mesh as j_make_mesh

SEG = 65536


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("RS_METRICS", "RS_RUNLOG", "RS_TRACE", "RS_PROF", "RS_PROFILE", "WORLD_SIZE", "RANK", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    yield
    for m in (t_metrics, j_metrics):
        m.force_enable(False)
        m.REGISTRY.reset()


def _digests(d) -> dict:
    return {f: hashlib.sha256((d / f).read_bytes()).hexdigest() for f in sorted(os.listdir(d))
            if f.startswith("_") or f.endswith(".METADATA")}


def _data(seed: int, size: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size=size, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("w,stripe,k,n", [(8, 1, 4, 6), (8, 4, 8, 12), (16, 2, 10, 14), (16, 8, 8, 10)])
def test_mesh_file_ops_match_jax(tmp_path, w, stripe, k, n):
    data = _data(k * w + stripe, 250_007)
    dirs = {}
    for name in ("t", "j", "j1"):
        d = dirs[name] = tmp_path / name
        d.mkdir()
        (d / "f.bin").write_bytes(data)
    kw = dict(w=w, segment_bytes=SEG, checksums=True, stripe_sharded=stripe > 1)
    t_api.encode_file(str(dirs["t"] / "f.bin"), k, n - k, strategy="cuda", device="cpu",
                      mesh=make_mesh(8, stripe=stripe, device="cpu"), **kw)
    j_api.encode_file(str(dirs["j"] / "f.bin"), k, n - k, strategy="bitplane", mesh=j_make_mesh(8, stripe=stripe),
                      **kw)
    j_api.encode_file(str(dirs["j1"] / "f.bin"), k, n - k, w=w, segment_bytes=SEG, checksums=True,
                      strategy="bitplane")
    want = _digests(dirs["j1"])
    assert _digests(dirs["t"]) == _digests(dirs["j"]) == want and len(want) == n + 1

    d, f = dirs["t"], str(dirs["t"] / "f.bin")
    mesh = make_mesh(8, stripe=stripe, device="cpu")
    mkw = dict(strategy="cuda", device="cpu", segment_bytes=SEG, mesh=mesh, stripe_sharded=stripe > 1)
    for i in range(n - k):  # the worst case: the first n-k chunks lost
        os.rename(d / f"_{i}_f.bin", d / f"lost_{i}")
    make_conf(n, k, f)
    assert t_api.decode_file(f, str(d / f"conf-{n}-{k}-f.bin"), f + ".out", **mkw) == f + ".out"
    assert (d / "f.bin.out").read_bytes() == data
    t_api.auto_decode_file(f, f + ".auto", **mkw)
    assert (d / "f.bin.auto").read_bytes() == data
    assert t_api.repair_file(f, **mkw) == list(range(n - k))
    assert _digests(d) == want
    # A corrupt chunk (present, CRC off) is rebuilt too.
    raw = bytearray((d / "_1_f.bin").read_bytes())
    raw[7] ^= 0xFF
    (d / "_1_f.bin").write_bytes(bytes(raw))
    assert t_api.repair_file(f, **mkw) == [1]
    assert _digests(d) == want


def test_mesh_refuses_interleaved_layout_and_fleets(tmp_path):
    f = tmp_path / "f.bin"
    f.write_bytes(_data(1, 10_000))
    mesh = make_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="single-host"):
        t_api.encode_file(str(f), 4, 2, device="cpu", mesh=mesh, layout="interleaved")
    with pytest.raises(ValueError, match="single-host"):
        j_api.encode_file(str(f), 4, 2, mesh=j_make_mesh(8), layout="interleaved")


def test_cli_devices_stripe_roundtrip_and_metrics_equal_jax(tmp_path, capsys):
    data = _data(2026, 300_011)
    snaps = {}
    for plan in (t_plan, j_plan):  # both from an empty mesh plan cache
        plan.MESH_PLAN_CACHE.clear()
    for name, main, extra in (("t", t_cli.main, ["--device", "cpu"]), ("j", j_cli.main, [])):
        d = tmp_path / name
        d.mkdir()
        (d / "f.bin").write_bytes(data)
        assert main(["-k", "8", "-n", "12", "-e", str(d / "f.bin"), "--devices", "8", "--stripe", "4", "--checksum",
                     "--quiet", "--segment-bytes", str(SEG), "--strategy", "bitplane", "--metrics-json",
                     str(d / "m.json"), *extra]) == 0
        snaps[name] = json.loads((d / "m.json").read_text())
        (t_metrics if name == "t" else j_metrics).force_enable(False)
    assert _digests(tmp_path / "t") == _digests(tmp_path / "j")
    tm, jm = snaps["t"]["metrics"], snaps["j"]["metrics"]
    for name in ("rs_mesh_collective_bytes_total", "rs_mesh_segments_staged_total", "rs_mesh_staged_bytes_total",
                 "rs_io_h2d_bytes_total", "segments_dispatched", "rs_codec_bytes_total"):
        assert tm[name]["values"] == jm[name]["values"], name
    # p * w * m over the chunk's 37,502 columns.
    assert tm["rs_mesh_collective_bytes_total"]["values"] == {'{op="psum_stripe"}': 4 * 8 * 37_502}
    for field in ("hits", "misses", "evictions"):
        assert snaps["t"]["mesh_plan_cache"][field] == snaps["j"]["mesh_plan_cache"][field], field
    d, f = tmp_path / "t", str(tmp_path / "t" / "f.bin")
    for i in range(4):
        os.unlink(d / f"_{i}_f.bin")
    assert t_cli.main(["-d", "-i", f, "--auto", "-o", f + ".out", "--devices", "8", "--stripe", "4", "--quiet",
                       "--device", "cpu"]) == 0
    assert (d / "f.bin.out").read_bytes() == data
    assert t_cli.main(["--repair", "-i", f, "--devices", "8", "--stripe", "4", "--quiet", "--device", "cpu"]) == 0
    assert _digests(d) == _digests(tmp_path / "j")
    capsys.readouterr()


REFUSALS = [
    ["--scrub", "-i", "f.bin", "--devices", "8"],
    ["--repair", "-i", "f.bin", "g.bin", "--devices", "2"],
    ["-k", "4", "-n", "6", "-e", "f.bin", "--layout", "interleaved", "--devices", "8"],
    ["-d", "-i", "f.bin", "--locate", "--devices", "8"],
    ["-k", "4", "-n", "6", "-e", "f.bin", "--stripe", "2"],
    ["-k", "4", "-n", "6", "-e", "f.bin", "g.bin", "--devices", "8"],
    ["-d", "-i", "f.bin", "--auto", "g.bin", "--devices", "8"],
]


@pytest.mark.parametrize("argv", REFUSALS, ids=lambda a: " ".join(a))
def test_cli_mesh_refusals_exit_as_jax(argv, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    t_rc = t_cli.main([*argv, "--device", "cpu"])
    t_err = capsys.readouterr().err.splitlines()[0]
    j_rc = j_cli.main(argv)
    j_err = capsys.readouterr().err.splitlines()[0]
    assert t_rc == j_rc == 2
    assert t_err == j_err


def test_cli_more_devices_than_the_card_count_fail(tmp_path, capsys, monkeypatch):
    """The JAX package refuses more devices than it has; so does the port,
    against the CUDA device count (an error exit, the mesh never built)."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    (tmp_path / "f.bin").write_bytes(b"\1" * 1000)
    assert t_cli.main(["-k", "4", "-n", "6", "-e", str(tmp_path / "f.bin"), "--devices", "2", "--quiet"]) == 1
    assert "asked for 2 devices, have 1" in capsys.readouterr().err
    assert sorted(os.listdir(tmp_path)) == ["f.bin"]
