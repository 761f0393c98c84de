"""mesh_bench and mesh_overhead as entry points on the CPU: the capture
header first, the JAX tools' keys, every number positive, every mode's
output equal to the GF oracle."""

import functools
import json

import numpy as np
import pytest

from gpu_rscode_torch.models.vandermonde import vandermonde_matrix
from gpu_rscode_torch.ops.gf import get_field
from gpu_rscode_torch.tools import _bench_timing, mesh_bench, mesh_overhead


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def _positive(row):
    for key, v in row.items():
        if isinstance(v, (int, float)) and not isinstance(v, bool):
            assert np.isfinite(v) and v > 0, key


@pytest.fixture
def quick_timer(monkeypatch):
    monkeypatch.setattr(mesh_bench, "time_device_fn", functools.partial(_bench_timing.time_device_fn, target_s=0.005))


@pytest.mark.parametrize("k,p", [(10, 4), (6, 3)])
def test_mesh_bench_on_cpu_and_its_outputs_equal_the_oracle(capsys, monkeypatch, quick_timer, k, p):
    outs = []
    real = mesh_bench.sharded_gf_matmul

    def spy(A, B, **kw):
        out = real(A, B, **kw)
        outs.append((kw["strategy"], kw["stripe_sharded"], out))
        return out

    placed = []
    real_put = mesh_bench.put_sharded
    monkeypatch.setattr(mesh_bench, "put_sharded",
                        lambda B, mesh, ss: placed.append(B.clone()) or real_put(B, mesh, ss))
    monkeypatch.setattr(mesh_bench, "sharded_gf_matmul", spy)
    assert mesh_bench.main(["--device", "cpu", "--mb", "1", "--trials", "1", "--k", str(k), "--p", str(p)]) == 0
    lines = _lines(capsys)
    assert lines[0]["kind"] == "capture_header" and lines[0]["tool"] == "mesh_bench"
    assert [next(iter(r)) for r in lines[1:-1]] == ["cols_cuda", "stripe_cuda", "cols_bitplane"]
    summary = lines[-1]
    assert set(summary) == {"metric", "unit", "devices", "mb", "results"}
    assert summary["metric"] == f"mesh_gemm_bandwidth_k{k}_p{p}_cpu" and summary["devices"] == 1
    for row in lines[1:-1] + [summary["results"], {"mb": summary["mb"]}]:
        _positive(row)
    oracle = get_field(8).matmul(vandermonde_matrix(p, k), placed[0].numpy())
    assert {(s, ss) for s, ss, _ in outs} == {("cuda", False), ("cuda", True), ("bitplane", False)}
    for _, _, out in outs:
        np.testing.assert_array_equal(out.numpy(), oracle)


def test_mesh_overhead_on_cpu(capsys):
    assert mesh_overhead.main(["--device", "cpu", "--mb", "1", "2", "--trials", "1"]) == 0
    lines = _lines(capsys)
    assert lines[0]["kind"] == "capture_header" and lines[0]["tool"] == "mesh_overhead"
    rows, ratios = lines[1:4], lines[4:]
    assert [r["mode"] for r in rows] == ["single", "cols", "stripe"]
    for r in rows:
        keys = {"metric", "mode", "devices", "put_ms[1mb]", "dispatch_ms[1mb]", "put_ms[2mb]", "dispatch_ms[2mb]",
                "dispatches_per_s_tiny"}
        assert set(r) == keys | ({"psum_bytes_per_seg_per_dev"} if r["mode"] == "stripe" else set())
        assert r["metric"] == "mesh_overhead_cpu"
        _positive(r)
    m_large = 2 * 1024 * 1024 // 10 // 128 * 128
    assert rows[2]["psum_bytes_per_seg_per_dev"] == 4 * 8 * m_large
    assert [r["mode"] for r in ratios] == ["cols", "stripe"]
    for r in ratios:
        assert set(r) == {"metric", "mode", "overhead_vs_single", "put_vs_single"}
        assert r["metric"] == "mesh_overhead_ratio_cpu"
        _positive(r)


def test_a_wrong_stripe_result_ends_mesh_bench(capsys, monkeypatch, quick_timer):
    real = mesh_bench.sharded_gf_matmul

    def wrong(A, B, **kw):
        out = real(A, B, **kw)
        if kw["stripe_sharded"]:
            out = out.clone()
            out[-1, -1] ^= 1  # the last column of the last block
        return out

    monkeypatch.setattr(mesh_bench, "sharded_gf_matmul", wrong)
    with pytest.raises(AssertionError, match="stripe_cuda"):
        mesh_bench.main(["--device", "cpu", "--mb", "1", "--trials", "1"])
    assert [next(iter(json.loads(x))) for x in capsys.readouterr().out.splitlines()] == ["kind", "cols_cuda"]
