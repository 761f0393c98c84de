"""The port's kernel-formulation tools (kernel_sweep, expand_probe) as entry
points on the CPU: the capture header comes first, every row is numeric,
results are checked against the GF oracle before they are timed, and with
no GPU and no ``--device`` they raise before printing anything."""

import functools
import json

import pytest

from gpu_rscode_torch.tools import _bench_timing, expand_probe, kernel_sweep
from gpu_rscode_torch.utils import backend


@pytest.fixture
def quick_timer(monkeypatch):
    """Loops of a few milliseconds instead of 1.5 s: the tests check the
    output, not the rate."""
    quick = functools.partial(_bench_timing.time_device_fn, target_s=0.005)
    monkeypatch.setattr(kernel_sweep, "time_device_fn", quick)
    monkeypatch.setattr(expand_probe, "time_device_fn", quick)


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def _header_ok(header, tool):
    assert header["kind"] == "capture_header" and header["tool"] == tool
    assert header["backend"] in ("cpu", "cuda") and header["xla_flags"] is None
    assert {"schema", "run", "ts", "git_sha", "host", "host_cpus", "intra_op_threads"} <= set(header)


@pytest.mark.parametrize("bodies,tiles", [("base,nibble,raw_dot", "8192"), ("cmp,signf,dma", "4096,8192")])
def test_kernel_sweep_on_cpu(capsys, quick_timer, bodies, tiles):
    rc = kernel_sweep.main(["--device", "cpu", "--mb", "1", "--trials", "1", "--tiles", tiles, "--bodies", bodies])
    assert rc == 0
    lines = _lines(capsys)
    _header_ok(lines[0], "kernel_sweep")
    names, tile_list = bodies.split(","), tiles.split(",")
    rows = lines[1:-1]
    assert [next(iter(r)) for r in rows] == [f"{b}@{t}" for b in names for t in tile_list] + [
        "dma_floor", "compute_only[raw_dot]" if "raw_dot" in names else "compute_only[base]"]
    final = lines[-1]
    assert final["mb"] == 1 and set(final["results"]) == {next(iter(r)) for r in rows}
    for row in rows:
        (value,) = row.values()
        assert isinstance(value, float) and value > 0


@pytest.mark.parametrize("extra", [["--expand", "shift", "pack2", "nibble32"], ["--refold", "sum", "--tile", "4096",
                                                                                 "--expand", "shift_raw", "pack2", "sign16"]])
def test_expand_probe_on_cpu(capsys, quick_timer, extra):
    rc = expand_probe.main(["--device", "cpu", "--mb", "1", "--trials", "1", *extra])
    assert rc == 0
    lines = _lines(capsys)
    _header_ok(lines[0], "expand_probe")
    names = extra[extra.index("--expand") + 1:]
    assert [next(iter(r)) for r in lines[1:]] == names
    for row in lines[1:]:
        (value,) = row.values()
        assert isinstance(value, float) and value > 0


def test_tools_default_to_cuda_and_raise_without_it(capsys, monkeypatch):
    monkeypatch.setattr(backend, "cuda_devices_present", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        kernel_sweep.main(["--mb", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        expand_probe.main(["--mb", "1", "--device", "cuda"])
    assert capsys.readouterr().out == ""


def test_tool_usage_errors(capsys):
    with pytest.raises(SystemExit):
        kernel_sweep.main(["--device", "cpu", "--bodies", "base,nope"])
    with pytest.raises(SystemExit):
        expand_probe.main(["--device", "cpu", "--refold", "autotune"])


def test_oracle_mismatch_ends_the_sweep(capsys, quick_timer, monkeypatch):
    """A wrong result is not printed as a rate: the tool raises."""
    real = kernel_sweep.cuda_planes.gf_matmul_planes

    def wrong(*args, **kwargs):
        return real(*args, **kwargs) ^ 1

    monkeypatch.setattr(kernel_sweep.cuda_planes, "gf_matmul_planes", wrong)
    with pytest.raises(AssertionError, match="differ"):
        kernel_sweep.main(["--device", "cpu", "--mb", "1", "--trials", "1", "--tiles", "8192", "--bodies", "base"])
    assert len(capsys.readouterr().out.splitlines()) == 1  # the header only


def test_time_device_fn_on_cpu():
    import torch

    secs = _bench_timing.time_device_fn(lambda: torch.ones(4), trials=2, target_s=0.001)
    assert 0 < secs < 1


def test_build_many_runs_every_build_then_raises(monkeypatch):
    """One build per library, all started; a failure surfaces after all."""
    from gpu_rscode_torch.ops import _build

    done = []

    def fake_build(name, sources):
        done.append(name)
        if name == "bad":
            raise RuntimeError("nvcc failed for bad")
        return sources

    monkeypatch.setattr(_build, "build", fake_build)
    with pytest.raises(RuntimeError, match="nvcc failed for bad"):
        _build.build_many({"a": [], "bad": [], "c": []})
    assert sorted(done) == ["a", "bad", "c"]


@pytest.mark.parametrize("tool,argv", [
    (kernel_sweep, ["--tiles", "4096", "--bodies", "base"]),
    (expand_probe, ["--expand", "shift"]),
])
def test_a_fault_in_the_last_block_ends_the_tool(capsys, quick_timer, monkeypatch, tool, argv):
    """The timed call's own output is checked over every block: one wrong
    byte in the last, ragged column fails the run."""
    from gpu_rscode_torch.ops import cuda_planes

    real = cuda_planes.gf_matmul_planes

    def wrong_last_column(*args, **kwargs):
        out = real(*args, **kwargs)
        out[:, -1] ^= 1
        return out

    monkeypatch.setattr(cuda_planes, "gf_matmul_planes", wrong_last_column)
    with pytest.raises(AssertionError, match="differ"):
        tool.main(["--device", "cpu", "--mb", "1", "--trials", "1", *argv])
    assert len(capsys.readouterr().out.splitlines()) == 1  # the header only


def test_sample_columns_cover_every_block():
    from gpu_rscode_torch.tools._check import sample_columns

    m = 10_000
    cols = sample_columns(m, [512, 4096])
    assert cols[0] == 0 and cols[-1] == m - 1 and (cols[1:] > cols[:-1]).all()
    for b in (512, 4096):
        starts = range(0, m, b)
        assert set(starts) <= set(cols) and {min(s + b, m) - 1 for s in starts} <= set(cols)


@pytest.mark.parametrize("toplevel,want", [("ROOT", "abc1234"), ("/elsewhere", None)])
def test_git_sha_only_for_the_packages_own_checkout(monkeypatch, toplevel, want):
    """An unpacked archive inside another checkout records no sha rather
    than the enclosing checkout's."""
    import os
    import subprocess

    from gpu_rscode_torch.obs import runlog

    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(runlog.__file__))))
    out = f"{root if toplevel == 'ROOT' else toplevel}\nabc1234\n"
    monkeypatch.setattr(runlog, "_GIT_SHA", False)
    monkeypatch.setattr(runlog.subprocess, "run",
                        lambda *a, **kw: subprocess.CompletedProcess(a, 0, stdout=out, stderr=""))
    assert runlog.git_sha() == want


def test_operator_cache_is_shared_and_bounded(monkeypatch):
    from gpu_rscode_torch.ops import _build

    monkeypatch.setattr(_build, "_OPERATORS", {})
    made = []
    for i in range(_build._MAX_OPERATORS + 1):
        assert _build.cached_operator(("k", i), lambda i=i: made.append(i) or i) == i
    assert _build.cached_operator(("k", _build._MAX_OPERATORS), lambda: -1) == _build._MAX_OPERATORS
    assert len(_build._OPERATORS) == 1 and len(made) == _build._MAX_OPERATORS + 1
