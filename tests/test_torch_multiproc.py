"""The port's mesh across two real processes: two interpreters joined by
``torch.distributed`` over gloo on the CPU (torchrun's ``WORLD_SIZE`` /
``RANK`` / ``MASTER_ADDR`` / ``MASTER_PORT``), each running the same CLI
command with ``--devices``.  Encode, conf decode, ``--auto`` decode and
``--repair`` run as collectives; the archives must be byte-identical to the
JAX package's single-process encode of the same file (its own two-process
test is expected to fail on its pinned jaxlib's gloo transport), and the
per-process ``--metrics-json`` parts merged by ``rs aggregate`` must equal
a single-process run of the same mesh shape where the work splits between
the processes.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from gpu_rscode_torch import cli as t_cli
from gpu_rscode_torch.obs import metrics as t_metrics
from gpu_rscode_torch.tools.make_conf import make_conf
from gpu_rscode_tpu import api as j_api

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEG = "65536"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_two(argv, cwd, argv1=None, rc=0) -> list[str]:
    """The same CLI argv (``argv1`` for rank 1 when given) in two processes
    of one job; both must exit ``rc``."""
    port = _free_port()
    procs = []
    for rank in range(2):
        args = argv1 if rank == 1 and argv1 is not None else argv
        env = {k: v for k, v in os.environ.items() if not k.startswith(("RS_", "JAX_"))}
        env.update(PYTHONPATH=REPO, WORLD_SIZE="2", RANK=str(rank), MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen([sys.executable, "-m", "gpu_rscode_torch", *args, "--device", "cpu", "--quiet"],
                                      env=env, cwd=cwd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail(f"two-process job timed out: {argv}")
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == rc, f"rank {rank} of {argv} exited {p.returncode}:\n{out[-3000:]}"
    return outs


def _digests(d, name="f.bin") -> dict:
    return {f: hashlib.sha256((d / f).read_bytes()).hexdigest() for f in sorted(os.listdir(d))
            if f.startswith("_") or f == f"{name}.METADATA"}


def _jax_reference(tmp_path, data: bytes, k: int, p: int, w: int) -> dict:
    d = tmp_path / "jax"
    d.mkdir()
    (d / "f.bin").write_bytes(data)
    j_api.encode_file(str(d / "f.bin"), k, p, w=w, strategy="bitplane", segment_bytes=int(SEG), checksums=True)
    return _digests(d)


@pytest.fixture(autouse=True)
def _clean():
    yield
    t_metrics.force_enable(False)
    t_metrics.REGISTRY.reset()


def test_two_process_stripe_job_matches_jax_and_aggregates(tmp_path):
    """k=10, n=14, a (2, 1) mesh: the stripe reduction crosses the process
    boundary every segment (gloo all_reduce of int8 sums)."""
    data = np.random.default_rng(20261018).integers(0, 256, size=300_001, dtype=np.uint8).tobytes()
    want = _jax_reference(tmp_path, data, 10, 4, 8)
    d = tmp_path / "mp"
    d.mkdir()
    f = d / "f.bin"
    f.write_bytes(data)
    mesh_flags = ["--devices", "2", "--stripe", "2", "--segment-bytes", SEG]
    _run_two(["-k", "10", "-n", "14", "-e", "f.bin", "--checksum", *mesh_flags, "--metrics-json", "m.json",
              "--trace", "t.json"], d)
    assert _digests(d) == want and len(want) == 15

    # The parts against one process running the same (2, 1) mesh.
    s = tmp_path / "single"
    s.mkdir()
    (s / "f.bin").write_bytes(data)
    assert t_cli.main(["-k", "10", "-n", "14", "-e", str(s / "f.bin"), "--checksum", *mesh_flags,
                       "--metrics-json", str(s / "m.json"), "--device", "cpu", "--quiet"]) == 0
    single = json.loads((s / "m.json").read_text())["metrics"]
    assert _digests(s) == want
    assert t_cli.main(["aggregate", str(d / "m.json"), "--snapshot-out", str(d / "merged.json")]) == 0
    merged = json.loads((d / "merged.json").read_text())
    assert merged["merged_from"] == 2
    parts = [json.loads((d / f"m.json.p{i}").read_text())["metrics"] for i in range(2)]
    # Each process stages half the rows: the staged bytes sum to the
    # single-process run's.
    staged = "rs_mesh_staged_bytes_total"
    assert merged["metrics"][staged]["values"] == single[staged]["values"] == {'{stripe="True"}': 300_010}
    # Each process dispatches every segment and reduces p*w*m bytes a
    # segment: its part equals the single-process count.
    for part in parts:
        assert part["rs_mesh_collective_bytes_total"]["values"] == single["rs_mesh_collective_bytes_total"]["values"]
        assert list(part["rs_mesh_segments_staged_total"]["values"].values()) == \
            list(single["rs_mesh_segments_staged_total"]["values"].values()) == [5]
        assert list(part["rs_mesh_segments_staged_total"]["values"]) == ['{procs="2",stripe="True"}']
    assert merged["metrics"]["rs_file_ops_total"]["values"] == {'{op="encode"}': 2}
    assert t_cli.main(["aggregate", str(d / "t.json"), "--trace-out", str(d / "fused.json")]) == 0
    fused = json.loads((d / "fused.json").read_text())
    assert {e["pid"] for e in fused["traceEvents"] if e.get("ph") == "X"} == {1, 2}
    assert {e["name"] for e in fused["traceEvents"] if e.get("ph") == "X"} >= {"mesh_dispatch", "mesh_stage"}

    # Conf decode with the first four chunks lost.
    for i in range(4):
        os.rename(d / f"_{i}_f.bin", d / f"lost_{i}")
    make_conf(14, 10, str(f))
    _run_two(["-d", "-i", "f.bin", "-c", "conf-14-10-f.bin", "-o", "out.bin", *mesh_flags], d)
    assert (d / "out.bin").read_bytes() == data
    # --auto: the lead scans and writes the conf, both decode.
    _run_two(["-d", "-i", "f.bin", "--auto", "-o", "auto.bin", *mesh_flags], d)
    assert (d / "auto.bin").read_bytes() == data
    assert (d / "f.bin.auto.conf").read_text().split() == [f"_{i}_f.bin" for i in range(4, 14)]
    # --repair rebuilds the four natives byte for byte.
    _run_two(["--repair", "-i", "f.bin", *mesh_flags], d)
    assert _digests(d) == want


def test_two_process_cols_job_w16(tmp_path):
    """w=16, a (1, 4) mesh of two CPU positions a process: each process
    computes and writes its own column blocks (the last one padded), no
    collective in the loop; a lost native and a lost parity are repaired."""
    data = np.random.default_rng(7).integers(0, 256, size=200_003, dtype=np.uint8).tobytes()
    want = _jax_reference(tmp_path, data, 4, 2, 16)
    d = tmp_path / "mp"
    d.mkdir()
    (d / "f.bin").write_bytes(data)
    flags = ["--devices", "4", "--segment-bytes", SEG]
    _run_two(["-k", "4", "-n", "6", "-e", "f.bin", "--width", "16", "--checksum", *flags], d)
    assert _digests(d) == want
    os.unlink(d / "_5_f.bin")
    os.unlink(d / "_0_f.bin")
    _run_two(["--repair", "-i", "f.bin", *flags], d)
    assert _digests(d) == want


def test_a_failing_process_fails_its_peer(tmp_path):
    """Rank 1 fails before its first exchange (its input is missing): rank
    0, which holds the lead's work, must fail at that exchange instead of
    waiting at a barrier, and leave no temp behind."""
    (tmp_path / "f.bin").write_bytes(b"\x07" * 40_000)
    argv = ["-k", "4", "-n", "6", "-e", "f.bin", "--devices", "2"]
    outs = _run_two(argv, tmp_path, argv1=["-k", "4", "-n", "6", "-e", "missing.bin", "--devices", "2"], rc=1)
    assert "missing.bin" in outs[1] and "rs: error" in outs[0]
    assert sorted(os.listdir(tmp_path)) == ["f.bin"]
