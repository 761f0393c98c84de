"""The port's schedule optimizer (``gpu_rscode_torch.ops.xor_opt``) against the
JAX package's on the CPU: reordering, term grouping, the tile choice and
the knobs, and the ``opt`` block each pipeline reports, for xor and ring,
with ``RS_XOR_TILE`` unset, 0 and 256.  A tiled chain on the CPU gives the
bytes of the whole-width one; on CUDA the chain runs whole-width unless
the knob forces a tile.  Tolerance 0."""

import numpy as np
import pytest

from gpu_rscode_torch.ops import ring_gemm as tr
from gpu_rscode_torch.ops import xor_gemm as tx
from gpu_rscode_torch.ops import xor_opt as to
from gpu_rscode_torch.ops.gemm import to_numpy, to_tensor
from gpu_rscode_torch.ops.gf import get_field
from gpu_rscode_tpu.ops import ring_gemm as jr
from gpu_rscode_tpu.ops import xor_gemm as jx
from gpu_rscode_tpu.ops import xor_opt as jo


@pytest.fixture(autouse=True)
def _knobs(monkeypatch):
    monkeypatch.delenv("RS_RUNLOG", raising=False)
    monkeypatch.delenv("RS_SCHEDULE_STORE", raising=False)
    for knob in ("RS_XOR_CSE", "RS_XOR_OPT", "RS_XOR_TILE", "RS_XOR_TILE_BUDGET"):
        monkeypatch.delenv(knob, raising=False)


def _schedules():
    rng = np.random.default_rng(3)
    out = []
    for w, (p, k) in ((8, (4, 10)), (8, (10, 10)), (16, (2, 3)), (8, (1, 1))):
        A = rng.integers(0, 1 << w, size=(p, k))
        out.append(jx.build_schedule(A, w))
    return out


@pytest.mark.parametrize("idx", range(4))
def test_reorder_and_group_equal_jax(idx):
    s = _schedules()[idx]
    got = to.reorder_pairs(s.pair_ops, s.rows, s.n_inputs)
    assert got == jo.reorder_pairs(s.pair_ops, s.rows, s.n_inputs)
    assert to.group_row_terms(got[0], got[1], s.n_inputs) == jo.group_row_terms(got[0], got[1], s.n_inputs)
    assert to.optimize_program(s.pair_ops, s.rows, s.n_inputs) == jo.optimize_program(s.pair_ops, s.rows, s.n_inputs)


def test_reorder_keeps_unreached_pairs():
    pairs = ((0, 1), (1, 2), (3, 4))
    rows = ((3,), (0, 2))
    assert to.reorder_pairs(pairs, rows, 3) == jo.reorder_pairs(pairs, rows, 3)


@pytest.mark.parametrize("tile,budget", [(None, None), ("0", None), ("256", None), ("1000", None), ("7", None),
                                         (None, "65536"), (None, "1000"), ("x", "y")])
def test_choose_tile_and_knobs_equal_jax(monkeypatch, tile, budget):
    if tile is not None:
        monkeypatch.setenv("RS_XOR_TILE", tile)
    if budget is not None:
        monkeypatch.setenv("RS_XOR_TILE_BUDGET", budget)
    assert to.env_fingerprint() == jo.env_fingerprint()
    for n_planes, nw in ((35, 100), (35, 512), (210, 209_712), (4000, 1 << 22), (1, 1)):
        assert to.choose_tile(n_planes, nw) == jo.choose_tile(n_planes, nw)
        assert to.device_tile(n_planes, nw, "cpu") == jo.choose_tile(n_planes, nw)
        assert to.device_tile(n_planes, nw, "cuda") == (
            jo.choose_tile(n_planes, nw) if to.tile_override() is not None else (0, 1, n_planes * nw * 4))
    for nw in (100, 16384, 16383):
        assert to.split_unpack(nw) == jo.split_unpack(nw)
    assert to.disabled_stats().as_dict() == jo.disabled_stats().as_dict()


@pytest.mark.parametrize("strategy", ["xor", "ring"])
@pytest.mark.parametrize("tile", [None, "0", "256"])
def test_pipeline_opt_block_equals_jax_and_tiled_bytes(monkeypatch, strategy, tile):
    """The opt block a CPU pipeline reports equals the JAX pipeline's at the
    same class; with a budget of 256 words a live plane the automatic
    choice tiles, so every case but RS_XOR_TILE=0 runs the chain over
    column tiles (the last one ragged)."""
    if tile is not None:
        monkeypatch.setenv("RS_XOR_TILE", tile)
    w, k, cols = 8, 3, 16384 + 96
    rng = np.random.default_rng(7)
    A = rng.integers(0, 256, size=(2, k))
    B = rng.integers(0, 256, size=(k, cols)).astype(np.uint8)
    t_get, j_get, pipe_cls, build = (
        (tx.get_pipeline, jx.get_pipeline, tx.XorPipeline, tx.build_schedule) if strategy == "xor"
        else (tr.get_ring_pipeline, jr.get_ring_pipeline, tr.RingPipeline, tr.build_ring_schedule))
    monkeypatch.setenv("RS_XOR_TILE_BUDGET", str(pipe_cls._n_planes(build(A, w)) * 256 * 4))
    t_pipe, j_pipe = t_get(A, (k, cols), np.uint8, w, "cpu"), j_get(A, (k, cols), np.uint8, w)
    assert t_pipe.describe()["opt"] == j_pipe.describe()["opt"]
    assert (t_pipe.opt.tile_words > 0) == (tile != "0")
    got = to_numpy(t_pipe(A, to_tensor(B)))
    np.testing.assert_array_equal(got, get_field(w).matmul(A.astype(np.uint8), B))
    np.testing.assert_array_equal(got, np.asarray(j_pipe(A, B)))
    cuda = t_get(A, (k, cols), np.uint8, w, "cuda").opt
    assert cuda.tile_words == (0 if tile is None else t_pipe.opt.tile_words)


def test_opt_off_reports_disabled(monkeypatch):
    monkeypatch.setenv("RS_XOR_OPT", "0")
    A = np.array([[3, 5], [7, 9]], dtype=np.uint8)
    pipe = tx.get_pipeline(A, (2, 64), np.uint8, 8)
    assert pipe.describe()["opt"] == jo.disabled_stats().as_dict()
    assert pipe._emit is pipe.schedule
