"""The port's mesh (parallel/mesh.py, sharded.py, distributed.py, _compat.py)
against the JAX package's on the CPU: ``sharded_gf_matmul`` in cols and
stripe mode on a mesh of ``cpu`` listed 8 times, held bit-exact against the
JAX package's on its 8 virtual CPU devices and against the GF oracle, at
the JAX tests' (stripe, k) cases, w=8 and w=16 and ragged widths; the
mesh codec's metric values and mesh plan-cache counts equal to the JAX
package's; and the refusals.  ``cuda`` on a CPU tensor runs K1's plain
version (the kernels run only on the card, in chip_smoke.py)."""

import numpy as np
import pytest
import torch

from gpu_rscode_torch import codec as t_codec_mod, plan as t_plan
from gpu_rscode_torch.codec import RSCodec as TCodec
from gpu_rscode_torch.obs import metrics as t_metrics
from gpu_rscode_torch.ops.gemm import to_numpy
from gpu_rscode_torch.ops.gf import get_field
from gpu_rscode_torch.parallel import _compat, distributed
from gpu_rscode_torch.parallel.mesh import COLS, STRIPE, Mesh, make_mesh
from gpu_rscode_torch.parallel.sharded import local_block, put_sharded, sharded_gf_matmul
from gpu_rscode_tpu import plan as j_plan
from gpu_rscode_tpu.codec import RSCodec as JCodec
from gpu_rscode_tpu.obs import metrics as j_metrics
from gpu_rscode_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_rscode_tpu.parallel.sharded import put_sharded as j_put_sharded, sharded_gf_matmul as j_sharded_gf_matmul

MESH_METRICS = ("rs_mesh_collective_bytes_total", "rs_mesh_segments_staged_total", "rs_mesh_staged_bytes_total")


@pytest.fixture(autouse=True)
def _clean():
    yield
    for m in (t_metrics, j_metrics):
        m.force_enable(False)
        m.REGISTRY.reset()


def _case(p, k, m, w, seed):
    gf = get_field(w)
    rng = np.random.default_rng(seed)
    A = rng.integers(0, 1 << w, size=(p, k)).astype(gf.dtype)
    B = rng.integers(0, 1 << w, size=(k, m)).astype(gf.dtype)
    return A, B, gf.matmul(A, B)


def _both(A, B, w, stripe, t_strategy, j_strategy):
    sharded = stripe > 1
    t_mesh = make_mesh(8, stripe=stripe, device="cpu")
    got = to_numpy(sharded_gf_matmul(A, put_sharded(B, t_mesh, sharded), mesh=t_mesh, w=w, strategy=t_strategy,
                                     stripe_sharded=sharded))
    j_mesh = j_make_mesh(8, stripe=stripe)
    ref = np.asarray(j_sharded_gf_matmul(A, j_put_sharded(B, j_mesh, sharded), mesh=j_mesh, w=w, strategy=j_strategy,
                                         stripe_sharded=sharded))
    return got, ref


@pytest.mark.parametrize("strategy", ["bitplane", "table", "cuda"])
def test_cols_mode_matches_jax_and_oracle(strategy):
    A, B, want = _case(4, 10, 8 * 512, 8, seed=1)
    got, ref = _both(A, B, 8, 1, strategy, {"cuda": "pallas"}.get(strategy, strategy))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(ref, want)


@pytest.mark.parametrize("strategy", ["bitplane", "cuda"])
@pytest.mark.parametrize("stripe,k", [(2, 8), (4, 32), (8, 128), (2, 128)])
def test_stripe_mode_wide_k_matches_jax_and_oracle(stripe, k, strategy):
    """The JAX tests' cases: at (2, 128) each shard's depth is 64*8 = 512,
    so its sums pass int8's range and wrap mod 256 before the reduction;
    parity must survive."""
    A, B, want = _case(4, k, (8 // stripe) * 256, 8, seed=k)
    got, ref = _both(A, B, 8, stripe, strategy, "bitplane")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("stripe,k", [(1, 10), (2, 8), (4, 32), (8, 16)])
def test_w16_both_modes_match_jax_and_oracle(stripe, k):
    A, B, want = _case(3, k, (8 // stripe) * 64, 16, seed=16 + k)
    got, ref = _both(A, B, 16, stripe, "cuda", "bitplane")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


def test_wide_stripe_k128_baseline_config():
    """BASELINE config 4: (k=128, n=144), the k axis over 8 positions."""
    A, B, want = _case(16, 128, 256, 8, seed=99)
    got, ref = _both(A, B, 8, 8, "cuda", "pallas")
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, ref)


def test_stripe_mode_without_preparity_form_warns_and_takes_bitplane():
    A, B, want = _case(2, 8, 4 * 64, 8, seed=3)
    mesh = make_mesh(8, stripe=2, device="cpu")
    with pytest.warns(UserWarning, match="pre-parity form"):
        got = sharded_gf_matmul(A, B, mesh=mesh, strategy="table", stripe_sharded=True)
    np.testing.assert_array_equal(to_numpy(got), want)


def test_uneven_columns_are_refused_not_corrupted():
    """m not divisible by the cols axis: the caller pads (the codec does);
    a direct placement is a clear error, as the JAX package's may be."""
    A, B, _ = _case(2, 4, 1001, 8, seed=7)
    with pytest.raises(ValueError, match="pad the columns"):
        put_sharded(B, make_mesh(8, device="cpu"))


@pytest.mark.parametrize("w,stripe,k,m", [(8, 1, 10, 1), (8, 4, 8, 1001), (8, 2, 10, 4096 + 3), (16, 1, 10, 1001),
                                          (16, 4, 8, 4096 + 3), (16, 2, 10, 1)])
def test_mesh_codec_ragged_widths_match_jax(w, stripe, k, m):
    """The codec pads a segment to the cols axis and trims it back; every
    GEMM of encode and decode on a ragged width equals the JAX package's
    mesh codec and the oracle."""
    gf = get_field(w)
    data = np.random.default_rng(m + k).integers(0, 1 << w, size=(k, m)).astype(gf.dtype)
    tc = TCodec(k, 4, w=w, strategy="cuda", mesh=make_mesh(8, stripe=stripe, device="cpu"),
                stripe_sharded=stripe > 1)
    jc = JCodec(k, 4, w=w, strategy="bitplane", mesh=j_make_mesh(8, stripe=stripe), stripe_sharded=stripe > 1)
    parity = to_numpy(tc.encode(data))
    np.testing.assert_array_equal(parity, np.asarray(jc.encode(data)))
    np.testing.assert_array_equal(parity, gf.matmul(tc.parity_block, data))
    code = np.concatenate([data, parity], axis=0)
    surv = list(range(4, 4 + k))
    np.testing.assert_array_equal(to_numpy(tc.decode(tc.decode_matrix(surv), code[surv])), data)


def test_mesh_metrics_and_plan_cache_counts_equal_jax():
    """The same dispatch sequence through both mesh codecs: equal
    rs_mesh_* series and equal mesh plan-cache hits, misses and
    evictions (one entry per exact width, as the JAX package counts)."""
    widths = [4096, 4096, 1001, 4096, 37, 1001]
    for m in (t_metrics, j_metrics):
        m.force_enable()
    for plan in (t_plan, j_plan):
        plan.MESH_PLAN_CACHE.clear()
    for stripe in (1, 4):
        tc = TCodec(8, 4, strategy="cuda", mesh=make_mesh(8, stripe=stripe, device="cpu"), stripe_sharded=stripe > 1)
        jc = JCodec(8, 4, strategy="bitplane", mesh=j_make_mesh(8, stripe=stripe), stripe_sharded=stripe > 1)
        for m in widths:
            data = np.random.default_rng(m).integers(0, 256, size=(8, m), dtype=np.uint8)
            np.testing.assert_array_equal(to_numpy(tc.encode(data)), np.asarray(jc.encode(data)))
    t_snap, j_snap = t_metrics.REGISTRY.snapshot(), j_metrics.REGISTRY.snapshot()
    for name in MESH_METRICS:
        assert t_snap[name]["values"] == j_snap[name]["values"], name
    assert t_snap["rs_plan_cache_events_total"]["values"] == j_snap["rs_plan_cache_events_total"]["values"]
    t_stats, j_stats = t_plan.MESH_PLAN_CACHE.stats(), j_plan.MESH_PLAN_CACHE.stats()
    for field in ("hits", "misses", "evictions", "executables"):
        assert t_stats[field] == j_stats[field], field
    assert (t_stats["hits"], t_stats["misses"]) == (6, 6)
    assert t_stats["calls"] == 12
    assert t_metrics.unified_snapshot()["mesh_plan_cache"]["misses"] == 6


@pytest.mark.parametrize("strategy", ["xor", "ring", "cpu"])
def test_single_device_strategies_are_refused_on_a_mesh(strategy):
    with pytest.raises(ValueError):
        TCodec(4, 2, strategy=strategy, mesh=make_mesh(8, device="cpu"))
    with pytest.raises(ValueError):
        JCodec(4, 2, strategy=strategy, mesh=j_make_mesh(8))


def test_k_not_divisible_by_the_stripe_axis_is_refused():
    with pytest.raises(ValueError, match="not divisible by stripe axis"):
        TCodec(10, 4, strategy="cuda", mesh=make_mesh(8, stripe=4, device="cpu"), stripe_sharded=True)
    with pytest.raises(ValueError, match="not divisible by stripe axis"):
        JCodec(10, 4, strategy="bitplane", mesh=j_make_mesh(8, stripe=4), stripe_sharded=True)


def test_make_mesh_refusals(monkeypatch):
    with pytest.raises(ValueError, match="not divisible by stripe"):
        make_mesh(6, stripe=4, device="cpu")
    with pytest.raises(ValueError, match="not divisible by stripe"):
        j_make_mesh(6, stripe=4)
    with pytest.raises(ValueError, match="asked for 9 devices, have 8"):
        j_make_mesh(9)
    # No GPU and no device: refused, as every entry point is.
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh(1)
    # More devices than the CUDA device count: refused as the JAX package
    # refuses more than it has.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(ValueError, match="asked for 2 devices, have 1"):
        make_mesh(2)
    mesh = make_mesh(1, device="cuda")
    assert mesh.shape == {STRIPE: 1, COLS: 1} and str(mesh.devices[0, 0]) == "cuda:0"


def test_a_mesh_may_list_one_device_several_times():
    """The one-card machine's wide stripe: cuda:0 listed four times is a
    (4, 1) mesh; each position is placed and computed on its own."""
    mesh = Mesh([[torch.device("cpu")]] * 4)
    assert mesh.shape == {STRIPE: 4, COLS: 1} and mesh.local_positions() == [(s, 0) for s in range(4)]
    A, B, want = _case(16, 128, 300, 8, seed=5)
    Bd = put_sharded(B, mesh, stripe_sharded=True)
    assert sorted(Bd.shards) == [(s, 0) for s in range(4)]
    assert len({t.data_ptr() for t in Bd.shards.values()}) == 4
    np.testing.assert_array_equal(to_numpy(sharded_gf_matmul(A, Bd, mesh=mesh, strategy="cuda",
                                                             stripe_sharded=True)), want)


def test_local_block_of_a_multiprocess_layout():
    """Two processes on a (2, 2) mesh: process r holds stripe row r; in
    stripe mode its block is its rows and every column, in cols mode every
    row."""
    mesh = Mesh([["cpu", "cpu"], ["cpu", "cpu"]], processes=[[0, 0], [1, 1]])
    assert local_block(mesh, (8, 100), True, rank=1) == (4, 8, 0, 100)
    assert local_block(mesh, (8, 100), False, rank=0) == (0, 8, 0, 100)
    cols = Mesh([["cpu"] * 4], processes=[[0, 0, 1, 1]])
    assert local_block(cols, (8, 100), False, rank=1) == (0, 8, 50, 100)
    bad = Mesh([["cpu"] * 4], processes=[[0, 1, 0, 1]])
    with pytest.raises(ValueError, match="non-contiguous"):
        local_block(bad, (8, 100), False, rank=0)


def test_distributed_initialize_is_a_noop_single_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT", "RS_DISTRIBUTED"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    assert not _compat.distributed_is_initialized()
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.global_mesh(device="cpu").shape == {STRIPE: 1, COLS: 1}


def test_backend_choice(monkeypatch):
    """NCCL only when every process of the host has a card of its own."""
    assert _compat.choose_backend("cpu", 2) == "gloo"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert _compat.choose_backend("cuda", 1) == "nccl"
    assert _compat.choose_backend("cuda", 2) == "gloo"  # two ranks, one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert _compat.choose_backend("cuda", 4) == "nccl"


def test_mesh_codec_auto_takes_the_static_prior():
    assert TCodec(4, 2, strategy="auto", mesh=make_mesh(8, device="cpu")).strategy == "bitplane"
    with pytest.raises(ValueError, match="does not match the mesh"):
        TCodec(4, 2, strategy="bitplane", device="cuda", mesh=make_mesh(8, device="cpu"))
    assert t_codec_mod.RSCodec(4, 2, strategy="bitplane", device="cpu").mesh is None
