"""strategy_bench, k_sweep, w16_bench and stream_bench as entry points on
the CPU: the capture header first, the JAX tools' keys where they mean the
same, every number positive, a wrong result ending the tool before any rate
is printed, and every one of the seven tools of this slice refusing to run
without a GPU unless ``--device cpu`` is given."""

import functools
import json

import numpy as np
import pytest

from gpu_rscode_torch.tools import (_bench_timing, inverse_bench, k_sweep, mesh_bench, mesh_overhead, strategy_bench,
                                    stream_bench, w16_bench)
from gpu_rscode_torch.utils import backend


@pytest.fixture
def quick_timer(monkeypatch):
    quick = functools.partial(_bench_timing.time_device_fn, target_s=0.005)
    for tool in (k_sweep, w16_bench):
        monkeypatch.setattr(tool, "time_device_fn", quick)


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def _numbers(row):
    for v in row.values():
        if isinstance(v, dict):
            yield from _numbers(v)
        elif isinstance(v, (int, float)) and not isinstance(v, bool):
            yield v


def _header_then_positive(lines, tool):
    assert lines[0]["kind"] == "capture_header" and lines[0]["tool"] == tool
    for row in lines[1:]:
        values = list(_numbers(row))
        assert values and all(np.isfinite(v) and v > 0 for v in values), row


@pytest.mark.parametrize("strategies", ["cuda,xor,ring,bitplane,table,cpu,numpy", "ring,cuda"])
def test_strategy_bench_on_cpu(capsys, strategies):
    assert strategy_bench.main(["--device", "cpu", "--size", "0.5", "--iters", "1", "--strategies", strategies]) == 0
    lines = _lines(capsys)
    _header_then_positive(lines, "strategy_bench")
    names = strategies.split(",")
    assert [next(iter(r)) for r in lines[1:-1]] == names
    summary = lines[-1]
    assert set(summary) == {"metric", "unit", "results"} and summary["metric"] == "strategy_bench_k10_p4_cpu"
    assert list(summary["results"]) == names


def test_strategy_bench_refuses_an_unknown_strategy(capsys):
    with pytest.raises(SystemExit):
        strategy_bench.main(["--device", "cpu", "--strategies", "cuda,pallas"])
    assert capsys.readouterr().out == ""


def test_k_sweep_on_cpu(capsys, quick_timer):
    assert k_sweep.main(["--device", "cpu", "--mb", "1", "--trials", "1", "--ks", "4,10,33"]) == 0
    lines = _lines(capsys)
    _header_then_positive(lines, "k_sweep")
    keys = [next(iter(r)) for r in lines[1:]]
    assert keys == [f"k{k}_{key}" for k in (4, 10, 33) for key in ("folded", "preparity", "best")]
    for k in (4, 10, 33):
        best = next(r for r in lines if f"k{k}_best" in r)[f"k{k}_best"]
        assert set(best) == {"config", "gbps", "contraction_depth"} and best["contraction_depth"] == 8 * k
        assert best["config"] in (f"k{k}_folded", f"k{k}_preparity")


def test_w16_bench_on_cpu(capsys, quick_timer):
    assert w16_bench.main(["--device", "cpu", "--mb", "1", "--trials", "1"]) == 0
    lines = _lines(capsys)
    _header_then_positive(lines, "w16_bench")
    assert [next(iter(r)) for r in lines[1:-1]] == ["cuda", "bitplane"]
    assert set(lines[-1]) == {"metric", "unit", "mb", "results"} and lines[-1]["metric"] == "w16_gemm_bandwidth_k10_p4"


@pytest.mark.parametrize("extra", [[], ["--strategy", "xor", "--depth", "1", "--k", "4", "--p", "2"]])
def test_stream_bench_on_cpu(capsys, tmp_path, extra):
    assert stream_bench.main(["--device", "cpu", "--mb", "3", "--seg-mb", "1", "--dir", str(tmp_path), *extra]) == 0
    lines = _lines(capsys)
    _header_then_positive(lines, "stream_bench")
    (row,) = lines[1:]
    assert {"metric", "unit", "file_mb", "depth", "strategy", "encode_gbps", "decode_gbps", "bit_exact"} <= set(row)
    assert row["bit_exact"] is True and row["file_mb"] == 3
    assert row["strategy"] == ("xor" if extra else "cuda") and row["depth"] == (1 if extra else 2)
    assert "encode dispatch" in row["encode_phases_s"] and "decode dispatch" in row["decode_phases_s"]
    assert list(tmp_path.iterdir()) == []  # the work directory is removed


def test_stream_bench_wrong_parity_ends_the_tool(capsys, tmp_path, monkeypatch):
    real = stream_bench.encode_file

    def rot_parity(path, k, p, **kw):
        real(path, k, p, **kw)
        with open(stream_bench.chunk_file_name(path, k), "r+b") as fp:
            fp.seek(0)
            byte = fp.read(1)
            fp.seek(0)
            fp.write(bytes([byte[0] ^ 1]))

    monkeypatch.setattr(stream_bench, "encode_file", rot_parity)
    with pytest.raises(AssertionError, match="parity differs"):
        stream_bench.main(["--device", "cpu", "--mb", "1", "--dir", str(tmp_path)])
    assert len(capsys.readouterr().out.splitlines()) == 1


@pytest.mark.parametrize("tool", [k_sweep, w16_bench])
def test_a_wrong_k1_result_ends_the_tool(capsys, quick_timer, monkeypatch, tool):
    real = tool.gf_matmul_cuda

    def wrong(*args, **kwargs):
        out = real(*args, **kwargs).clone()
        out[0, -1] ^= 1
        return out

    monkeypatch.setattr(tool, "gf_matmul_cuda", wrong)
    with pytest.raises(AssertionError, match="differ"):
        tool.main(["--device", "cpu", "--mb", "1", "--trials", "1"] + (["--ks", "4"] if tool is k_sweep else []))
    assert len(capsys.readouterr().out.splitlines()) == 1


@pytest.mark.parametrize("tool", [inverse_bench, mesh_bench, mesh_overhead, strategy_bench, k_sweep, w16_bench,
                                  stream_bench])
def test_the_tools_default_to_cuda_and_raise_without_it(capsys, monkeypatch, tool):
    monkeypatch.setattr(backend, "cuda_devices_present", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tool.main([])
    assert capsys.readouterr().out == ""
