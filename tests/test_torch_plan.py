"""The plan layer of the port (``gpu_rscode_torch.plan``) against the JAX
package's (``gpu_rscode_tpu.plan``) on the CPU: the bucket ladder, the
dispatch's bytes at ragged widths with and without a cap (tolerance 0),
the cache's hit / miss / eviction counts for one key sequence, the clear
that drops the survivor-subset cache, the bucket-padded staging of the
segment loops, ``RS_PLAN=0``, and ``warm_plan``.  The graphs are a card
matter: ``chip_smoke.py`` phase 5e runs them."""

import numpy as np
import pytest
import torch

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch import plan as t_plan
from gpu_rscode_torch.codec import RSCodec as TCodec
from gpu_rscode_torch.ops.gemm import to_numpy, to_tensor
from gpu_rscode_torch import tune as t_tune
from gpu_rscode_torch.parallel import pipeline as t_pipe
from gpu_rscode_tpu import api as j_api
from gpu_rscode_tpu import codec as j_codec
from gpu_rscode_tpu import native as j_native
from gpu_rscode_tpu import plan as j_plan
from gpu_rscode_tpu import tune as j_tune

CPU = torch.device("cpu")
STRATEGIES = ("bitplane", "table", "xor", "ring", "cpu")
# strategy cpu is GF(2^8) only, in both packages.
STRATEGY_W = [(s, w) for s in STRATEGIES for w in (8, 16) if s != "cpu" or w == 8]


@pytest.fixture(autouse=True)
def _env(monkeypatch):
    for knob in ("RS_PLAN", "RS_PLAN_MIN_BUCKET", "RS_PLAN_CACHE_SIZE", "RS_RUNLOG", "RS_SCHEDULE_STORE",
                 "RS_STRATEGY_AUTOTUNE", "RS_XOR_OPT", "RS_XOR_TILE", "RS_XOR_PACK_REUSE"):
        monkeypatch.delenv(knob, raising=False)
    t_tune.clear_decisions()
    j_tune.clear_decisions()


@pytest.fixture
def fresh():
    """Both packages' plan caches (and the schedules they drop) emptied,
    for a test that reads the cache's counts."""
    t_plan.PLAN_CACHE.clear()
    j_plan.PLAN_CACHE.clear()
    yield
    t_plan.PLAN_CACHE.clear()
    j_plan.PLAN_CACHE.clear()


@pytest.mark.parametrize("floor", [None, "256", "0", "junk", "64"])
def test_bucket_cols_equals_jax(monkeypatch, floor):
    if floor is not None:
        monkeypatch.setenv("RS_PLAN_MIN_BUCKET", floor)
    for cap in (None, 1, 50, 127, 128, 129, 1000, 1024, 4096, 6_710_784):
        for m in (0, 1, 2, 63, 64, 65, 127, 128, 129, 255, 256, 257, 700, 1023, 1024, 1025, 4095, 4097,
                  1_337, 6_710_783, 6_710_784):
            assert t_plan.bucket_cols(m, cap) == j_plan.bucket_cols(m, cap), (m, cap)


def _operands(w, p, k, m, seed):
    """One matrix per (w, p, k), so both packages build each xor / ring
    schedule once across the widths; the data seeded by ``seed``."""
    dtype = np.uint8 if w == 8 else np.uint16
    A = np.random.default_rng(w * 100 + p * 10 + k).integers(0, 1 << w, size=(p, k)).astype(dtype)
    B = np.random.default_rng(seed).integers(0, 1 << w, size=(k, m)).astype(dtype)
    return A, B


def _jax_reference(A, B, w, strategy, cap):
    if strategy == "cpu":
        return j_native.gemm(A, B)
    return np.asarray(j_plan.dispatch(A, B, w=w, strategy=strategy, cap=cap))


@pytest.mark.parametrize("strategy,w", STRATEGY_W)
@pytest.mark.parametrize("m,cap", [(1, None), (33, None), (100, 1024), (129, 1024), (700, 1024), (1000, 1000),
                                   (517, 600)])
def test_dispatch_equals_jax(strategy, w, m, cap):
    A, B = _operands(w, 3, 5, m, seed=w * 1000 + m)
    got = t_plan.dispatch(A, to_tensor(B), w=w, strategy=strategy, cap=cap)
    assert tuple(got.shape) == (3, m)
    np.testing.assert_array_equal(to_numpy(got), _jax_reference(A, B, w, strategy, cap))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_staged_dispatch_trims_to_the_true_width(strategy, fresh):
    """A segment staged at its bucket (what the loops hand the codec)
    gives the bytes of the unpadded product."""
    A, B = _operands(8, 4, 6, 300, seed=7)
    staged = t_plan.StagedSegment(to_tensor(t_plan.pad_host(B, 512)), 300, 1024)
    got = t_plan.dispatch(A, staged, w=8, strategy=strategy)
    np.testing.assert_array_equal(to_numpy(got), _jax_reference(A, B, 8, "bitplane", None))
    stats = t_plan.PLAN_CACHE.stats()
    assert [p["bucket"] for p in stats["plans"]] == [512]


def test_cache_counts_equal_jax(monkeypatch, fresh):
    """One key sequence (strategies, widths, matrices, caps) through both
    packages' dispatch under a bound of 3 plans: the same hits, misses,
    evictions and plan count."""
    monkeypatch.setenv("RS_PLAN_CACHE_SIZE", "3")
    rng = np.random.default_rng(11)
    A1 = rng.integers(0, 256, size=(2, 4)).astype(np.uint8)
    A2 = rng.integers(0, 256, size=(2, 4)).astype(np.uint8)
    seq = [("bitplane", A1, 100, 1024), ("bitplane", A1, 120, 1024), ("bitplane", A1, 300, 1024),
           ("table", A1, 100, 1024), ("xor", A1, 100, 1024), ("xor", A2, 100, 1024), ("xor", A1, 110, 1024),
           ("bitplane", A1, 100, 1024), ("ring", A2, 1000, 1000), ("ring", A2, 999, 1000),
           ("bitplane", A1, 50, None), ("bitplane", A1, 50, None), ("xor", A2, 33, 40), ("table", A1, 1, 1024)]
    for strategy, A, m, cap in seq:
        B = rng.integers(0, 256, size=(4, m)).astype(np.uint8)
        t_plan.dispatch(A, to_tensor(B), w=8, strategy=strategy, cap=cap)
        j_plan.dispatch(A, B, w=8, strategy=strategy, cap=cap)
    t, j = t_plan.PLAN_CACHE.stats(), j_plan.PLAN_CACHE.stats()
    assert {key: t[key] for key in ("hits", "misses", "evictions", "executables", "max_size")} == \
        {key: j[key] for key in ("hits", "misses", "evictions", "executables", "max_size")}
    assert t["evictions"] > 0 and t["hits"] > 0
    assert sorted(p["bucket"] for p in t["plans"]) == sorted(p["bucket"] for p in j["plans"])


def test_clear_drops_the_subset_cache(tmp_path, fresh):
    path = str(tmp_path / "f.bin")
    with open(path, "wb") as fp:
        fp.write(np.random.default_rng(3).integers(0, 256, size=20_000, dtype=np.uint8).tobytes())
    t_api.encode_file(path, 4, 2, device="cpu", segment_bytes=4096)
    scan = t_api._scan_chunks(path, 4096)
    t_api._select_decodable_subset(scan)
    assert t_api.subset_cache_stats()["entries"] == 1
    assert t_plan.PLAN_CACHE.stats()["executables"] > 0
    t_plan.PLAN_CACHE.clear()
    assert t_api.subset_cache_stats() == {"entries": 0, "hits": 0, "misses": 0, "stale": 0}
    assert t_plan.PLAN_CACHE.stats()["executables"] == 0


@pytest.mark.parametrize("sym", [1, 2])
def test_loop_stages_bucket_padded_segments(sym):
    """While the plan layer is on, a CPU StreamLoop pads the segment to its
    bucket under the cap ``seg_cols // sym`` and the codec trims the
    product back."""
    w = 8 * sym
    loop = t_pipe.StreamLoop(CPU, 4, 2048, 2)
    slot, host = loop.host_segment(300 * sym)
    host[:] = np.random.default_rng(sym).integers(0, 256, size=host.shape, dtype=np.uint8)
    staged = loop.stage((slot, host), sym)
    assert isinstance(staged, t_plan.StagedSegment)
    assert (staged.cols, staged.cap, tuple(staged.shape)) == (300, 2048 // sym, (4, 512))
    codec = TCodec(4, 2, w=w, device="cpu")
    got = loop.result(loop.dispatch(codec.encode, staged))
    syms = host.view(np.uint16) if sym == 2 else host
    want = np.asarray(j_codec.RSCodec(4, 2, w=w).encode(syms))
    np.testing.assert_array_equal(got, np.ascontiguousarray(want).view(np.uint8))


def test_plan_off_stages_exact_widths(monkeypatch):
    monkeypatch.setenv("RS_PLAN", "0")
    loop = t_pipe.StreamLoop(CPU, 4, 2048, 2)
    slot, host = loop.host_segment(300)
    host[:] = 7
    staged = loop.stage((slot, host), 1)
    assert isinstance(staged, torch.Tensor) and tuple(staged.shape) == (4, 300)
    codec = TCodec(4, 2, device="cpu")
    before = t_plan.PLAN_CACHE.stats()["misses"]
    out = loop.result(loop.dispatch(codec.encode, staged))
    assert out.shape == (2, 300)
    assert t_plan.PLAN_CACHE.stats()["misses"] == before  # no plan was looked up


@pytest.mark.parametrize("strategy", ["bitplane", "xor", "cpu"])
def test_segment_loop_reuses_its_plans(tmp_path, strategy, fresh):
    """A file's segment loop meets its full bucket and one tail bucket: a
    second encode of the same shape adds hits and no plan."""
    path = str(tmp_path / "f.bin")
    with open(path, "wb") as fp:
        # chunk 4,396: four 1,024-column segments and a 300-column tail
        # (bucket 512).
        fp.write(np.random.default_rng(5).integers(0, 256, size=4 * 4396, dtype=np.uint8).tobytes())
    t_api.encode_file(path, 4, 2, device="cpu", strategy=strategy, segment_bytes=4 * 1024)
    first = t_plan.PLAN_CACHE.stats()
    assert first["executables"] == 2 and first["misses"] == 2
    t_api.encode_file(path, 4, 2, device="cpu", strategy=strategy, segment_bytes=4 * 1024)
    second = t_plan.PLAN_CACHE.stats()
    assert second["executables"] == 2 and second["misses"] == 2
    assert second["hits"] == first["hits"] + first["calls"]


@pytest.mark.parametrize("strategy,w,file_bytes", [
    (s, w, f) for s in ("auto", "bitplane", "xor", "cpu") for w, f in ((8, None), (16, None), (8, 30_011))
    if s != "cpu" or w == 8
])
def test_warm_plan_returns_jax_dict(strategy, w, file_bytes, fresh):
    kw = dict(w=w, strategy=strategy, segment_bytes=64 * 1024, file_bytes=file_bytes)
    got = t_api.warm_plan(10, 4, device="cpu", **kw)
    assert got == j_api.warm_plan(10, 4, **kw)
    plans = t_plan.PLAN_CACHE.stats()["plans"]
    assert len(plans) == 1 and plans[0]["strategy"] == got["strategy"] and plans[0]["calls"] == 1


def test_packed_operand_must_match_its_bucket():
    from gpu_rscode_torch.ops import xor_gemm

    A, B = _operands(8, 2, 4, 300, seed=2)
    packed = xor_gemm.pack_operand(to_tensor(t_plan.pad_host(B, 320)), 8, cols_true=300)
    got = t_plan.dispatch(A, packed, w=8, strategy="xor", cols=300)
    np.testing.assert_array_equal(to_numpy(got), _jax_reference(A, B, 8, "bitplane", None))
    with pytest.raises(ValueError, match="does not match the plan bucket"):
        t_plan.dispatch(A, packed, w=8, strategy="xor", cap=1024, cols=300)
    with pytest.raises(ValueError, match="packed operands"):
        t_plan.dispatch(A, packed, w=8, strategy="bitplane")
