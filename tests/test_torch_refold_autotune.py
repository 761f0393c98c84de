"""The RS_PALLAS_* knobs and refold="autotune" of the port, against the JAX
package's ``gf_matmul_pallas`` and its codec and plan contracts.

``gf_matmul_cuda`` resolves ``RS_PALLAS_EXPAND``, ``RS_PALLAS_REFOLD`` and
``RS_PALLAS_TILE`` as ``gf_matmul_pallas`` does (the same defaults, the
same warnings, the same fall-backs), and with no knob and no argument runs
K1 as before.  ``refold="autotune"`` times both refolds through the
module-level ``_time_refold`` (a fake here, as in the JAX package's tests),
ships dot only below the 0.9 margin, caches per dispatch class and caches
nothing over an error: unlike the JAX package no candidate's failure is
caught.  A codec's first dispatch calibrates eagerly and its plan times
its own candidates at the next; the mesh resolves the knob statically.
Each is the counterpart of a JAX test (``tests/test_pallas.py``,
``test_api.py``, ``test_plan.py``), on the CPU through the kernels' plain
versions."""

import warnings

import numpy as np
import pytest
import torch

from gpu_rscode_torch import codec as t_codec
from gpu_rscode_torch import plan as t_plan
from gpu_rscode_torch.obs import metrics as t_metrics
from gpu_rscode_torch.ops import cuda_gemm, cuda_pack2, cuda_planes
from gpu_rscode_torch.ops.gemm import from_bitplanes, to_numpy, to_tensor
from gpu_rscode_torch.parallel.mesh import make_mesh
from gpu_rscode_torch.parallel.sharded import put_sharded, sharded_gf_matmul
from gpu_rscode_torch.tools import w16_bench
from gpu_rscode_tpu.ops import pallas_gemm as pg
from gpu_rscode_tpu.ops.gf import get_field


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in cuda_gemm.KNOBS:
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(cuda_gemm, "_AUTOTUNE_CACHE", {})
    yield
    t_plan.PLAN_CACHE.clear()


def _operands(p, k, m, w, seed):
    rng = np.random.default_rng(seed)
    dt = np.uint8 if w == 8 else np.uint16
    return rng.integers(0, 1 << w, size=(p, k)).astype(dt), rng.integers(0, 1 << w, size=(k, m)).astype(dt)


def _spy(monkeypatch, seen):
    """Record what reaches the kernel wrappers (every formulation gives the
    same bytes, so the output cannot show which one ran)."""
    real_planes, real_pack2, real_k1 = cuda_planes.gf_matmul_planes, cuda_pack2.gf_matmul_pack2, cuda_gemm._gf_matmul_k1

    def planes(A, B, expand, refold, tile=None, pinned=False, w=8):
        seen.append(dict(kernel="K3", expand=expand, refold=refold, tile=tile, w=w))
        return real_planes(A, B, expand, refold, tile, pinned, w)

    def pack2(A, B, w=8, fold_parity=True, refold=None, tile=None):
        seen.append(dict(kernel="K2", expand="pack2", refold=refold, tile=tile, w=w))
        return real_pack2(A, B, w, fold_parity, refold, tile)

    def k1(A, B, w, fold_parity):
        seen.append(dict(kernel="K1", w=w))
        return real_k1(A, B, w, fold_parity)

    monkeypatch.setattr(cuda_planes, "gf_matmul_planes", planes)
    monkeypatch.setattr(cuda_pack2, "gf_matmul_pack2", pack2)
    monkeypatch.setattr(cuda_gemm, "_gf_matmul_k1", k1)


def _fake_timer(monkeypatch, results):
    """_time_refold replaced by a fake consumed in the candidates' order
    ("sum", "dot"); an exception instance raises instead.  Returns the
    call log."""
    calls = []

    def fake(run):
        calls.append(run)
        r = results[len(calls) - 1]
        if isinstance(r, BaseException):
            raise r
        return r

    monkeypatch.setattr(cuda_gemm, "_time_refold", fake)
    monkeypatch.setattr(cuda_gemm, "_AUTOTUNE_CACHE", {})
    return calls


def _cuda(A, B, w=8, **kw):
    return to_numpy(cuda_gemm.gf_matmul_cuda(A, to_tensor(B), w, **kw))


def test_no_knob_runs_k1(monkeypatch):
    """No knob and no argument: K1, as before this port of the knobs."""
    seen = []
    _spy(monkeypatch, seen)
    A, B = _operands(3, 5, 256, 8, 1)
    for fold in (True, False):
        cuda_gemm.gf_matmul_cuda(A, torch.from_numpy(B), 8, fold_parity=fold)
    assert [s["kernel"] for s in seen] == ["K1", "K1"]
    assert cuda_gemm.static_refold(8) is None and cuda_gemm.plan_refold_resolution(16) is None


@pytest.mark.parametrize("w", [8, 16])
def test_production_defaults_match_jax(monkeypatch, w):
    """A knob or an argument takes the JAX package's defaults: shift_raw,
    with dot at w=8 and sum at w=16; the bytes equal gf_matmul_pallas's."""
    seen = []
    _spy(monkeypatch, seen)
    A, B = _operands(2, 4, 512, w, 31)
    monkeypatch.setenv("RS_PALLAS_TILE", "256")
    np.testing.assert_array_equal(_cuda(A, B, w), np.asarray(pg.gf_matmul_pallas(A, B, w=w)))
    assert seen[-1] == dict(kernel="K3", expand="shift_raw", refold="dot" if w == 8 else "sum", tile=256, w=w)


def test_refold_env_override(monkeypatch):
    seen = []
    _spy(monkeypatch, seen)
    A, B = _operands(2, 4, 512, 8, 30)
    want = get_field(8).matmul(A, B)
    monkeypatch.setenv("RS_PALLAS_REFOLD", "sum")
    np.testing.assert_array_equal(_cuda(A, B), want)
    assert seen[-1]["refold"] == "sum"
    monkeypatch.setenv("RS_PALLAS_REFOLD", "bogus")
    with pytest.warns(UserWarning, match="RS_PALLAS_REFOLD") as t_warn:
        np.testing.assert_array_equal(_cuda(A, B), want)
    assert seen[-1]["refold"] == "dot"
    with pytest.warns(UserWarning) as j_warn:
        pg.gf_matmul_pallas(A, B)
    assert str(t_warn[0].message) == str(j_warn[0].message)


def test_refold_autotune_decision(monkeypatch):
    """dot ships only on a real win (dot < 0.9 x sum), the decision is
    cached per dispatch class, and an error raises and caches nothing,
    whatever its type (the JAX package lets a backend failure lose the
    race; the port catches nothing)."""
    seen = []
    _spy(monkeypatch, seen)
    A, B = _operands(2, 4, 512, 16, 33)
    want = get_field(16).matmul(A, B)
    calls = _fake_timer(monkeypatch, [1.0, 0.5])
    np.testing.assert_array_equal(_cuda(A, B, 16, refold="autotune"), want)
    assert seen[-1]["refold"] == "dot" and len(calls) == 2
    np.testing.assert_array_equal(_cuda(A, B, 16, refold="autotune"), want)
    assert seen[-1]["refold"] == "dot" and len(calls) == 2  # cached
    (key,) = cuda_gemm.autotune_decisions()
    assert key == ((2, 4), "uint16", (4, 512), "uint16", 16, cuda_planes.DEFAULT_TILE, "shift_raw", "cpu")
    calls = _fake_timer(monkeypatch, [1.0, 0.95])
    np.testing.assert_array_equal(_cuda(A, B, 16, refold="autotune"), want)
    assert seen[-1]["refold"] == "sum" and len(calls) == 2
    for err in (ValueError("shape bug"), RuntimeError("gf_planes kernel launch failed")):
        calls = _fake_timer(monkeypatch, [1.0, err])
        with pytest.raises(type(err), match=str(err)):
            _cuda(A, B, 16, refold="autotune")
        assert not cuda_gemm.autotune_decisions() and len(calls) == 2


def test_refold_autotune_env_and_preparity(monkeypatch):
    seen = []
    _spy(monkeypatch, seen)
    A, B = _operands(2, 4, 512, 8, 34)
    want = get_field(8).matmul(A, B)
    calls = _fake_timer(monkeypatch, [1.0, 0.5])
    monkeypatch.setenv("RS_PALLAS_REFOLD", "autotune")
    np.testing.assert_array_equal(_cuda(A, B), want)
    assert seen[-1]["refold"] == "dot" and len(calls) == 2
    acc = cuda_gemm.gf_matmul_cuda(A, torch.from_numpy(B), fold_parity=False, refold="autotune")
    np.testing.assert_array_equal(to_numpy(from_bitplanes(acc, 8)), want)
    assert len(calls) == 2 and seen[-1]["refold"] == "none"


def test_refold_autotune_real_calibration():
    """No fakes: the real timer picks one of the two and the output is
    exact either way."""
    for w in (8, 16):
        A, B = _operands(2, 4, 512, w, 35)
        np.testing.assert_array_equal(_cuda(A, B, w, refold="autotune"), get_field(w).matmul(A, B))
    assert set(cuda_gemm.autotune_decisions().values()) <= {"sum", "dot"}
    assert len(cuda_gemm.autotune_decisions()) == 2


def test_tile_env_override(monkeypatch):
    seen = []
    _spy(monkeypatch, seen)
    A, B = _operands(2, 4, 2048, 8, 33)
    want = get_field(8).matmul(A, B)
    monkeypatch.setenv("RS_PALLAS_TILE", "256")
    np.testing.assert_array_equal(_cuda(A, B), want)
    assert seen[-1]["tile"] == 256
    np.testing.assert_array_equal(_cuda(A, B, tile=512), want)
    assert seen[-1]["tile"] == 512
    monkeypatch.setenv("RS_PALLAS_TILE", "200")
    with pytest.warns(UserWarning, match="128-lane"):
        np.testing.assert_array_equal(_cuda(A, B), want)
    assert seen[-1]["tile"] == 256
    monkeypatch.setenv("RS_PALLAS_TILE", "zero")
    with pytest.warns(UserWarning, match="RS_PALLAS_TILE") as t_warn:
        np.testing.assert_array_equal(_cuda(A, B), want)
    assert seen[-1]["tile"] is None  # the kernel's default, cuda_planes.DEFAULT_TILE
    with pytest.warns(UserWarning) as j_warn:
        pg.gf_matmul_pallas(A, B)
    assert str(t_warn[0].message) == str(j_warn[0].message)


def test_expand_env_default(monkeypatch):
    seen = []
    _spy(monkeypatch, seen)
    A, B = _operands(2, 4, 512, 8, 3)
    want = get_field(8).matmul(A, B)
    monkeypatch.setenv("RS_PALLAS_EXPAND", "packed32")
    np.testing.assert_array_equal(_cuda(A, B), want)
    assert seen[-1]["expand"] == "shift"  # packed32's algebra is shift's
    A16, B16 = _operands(2, 4, 512, 16, 4)
    with pytest.warns(UserWarning, match="does not apply"):
        np.testing.assert_array_equal(_cuda(A16, B16, 16), get_field(16).matmul(A16, B16))
    assert seen[-1]["expand"] == "shift_raw"
    for env, match in (("packed_32", "unknown"), ("cmp", "unknown")):  # cmp is the sweep's name, not JAX's
        monkeypatch.setenv("RS_PALLAS_EXPAND", env)
        with pytest.warns(UserWarning, match=match) as t_warn:
            np.testing.assert_array_equal(_cuda(A, B), want)
        assert seen[-1]["expand"] == "shift_raw"
        with pytest.warns(UserWarning) as j_warn:
            pg.gf_matmul_pallas(A, B)
        assert str(t_warn[0].message) == str(j_warn[0].message)
    monkeypatch.setenv("RS_PALLAS_EXPAND", "nonsense")
    np.testing.assert_array_equal(_cuda(A, B, expand="sign"), want)
    assert seen[-1]["expand"] == "sign"
    monkeypatch.setenv("RS_PALLAS_EXPAND", "pack2")
    np.testing.assert_array_equal(_cuda(A, B), want)
    assert seen[-1]["kernel"] == "K2"
    B10 = _operands(2, 10, 256, 8, 5)[1]
    with pytest.warns(UserWarning, match="does not apply"):
        acc = cuda_gemm.gf_matmul_cuda(A[:, :4].repeat(3, axis=1)[:, :10], torch.from_numpy(B10), fold_parity=False)
    assert seen[-1] == dict(kernel="K3", expand="shift_raw", refold="none", tile=None, w=8)
    np.testing.assert_array_equal(to_numpy(from_bitplanes(acc, 8)),
                                  get_field(8).matmul(A[:, :4].repeat(3, axis=1)[:, :10], B10))


def test_codec_first_dispatch_calibrates_eagerly_then_the_plan(monkeypatch):
    """The counts of the JAX package's codec and plan under autotune
    (test_api.py's eager calibration, test_plan.py's own-executables
    calibration): the first encode times both candidates eagerly, the
    second has the plan time its own two, and the plan records its refold;
    the eager and the plan decision are counted by mode."""
    t_plan.PLAN_CACHE.clear()
    t_metrics.force_enable()
    try:
        t_metrics.REGISTRY.reset()
        timed = []
        real = cuda_gemm._time_refold
        monkeypatch.setattr(cuda_gemm, "_time_refold", lambda run: timed.append(1) or real(run))
        monkeypatch.setenv("RS_PALLAS_REFOLD", "autotune")
        c = t_codec.RSCodec(4, 2, strategy="cuda", device="cpu")
        B = np.random.default_rng(31).integers(0, 256, size=(4, 256), dtype=np.uint8)
        want = get_field(8).matmul(c.parity_block, B)
        np.testing.assert_array_equal(to_numpy(c.encode(B)), want)
        assert len(timed) == 2
        np.testing.assert_array_equal(to_numpy(c.encode(B)), want)
        assert len(timed) == 4
        np.testing.assert_array_equal(to_numpy(c.encode(B)), want)
        assert len(timed) == 4
        (p,) = [p for p in t_plan.PLAN_CACHE.stats()["plans"] if p["strategy"] == "cuda"]
        assert p["refold"] in ("sum", "dot") and p["calls"] == 3
        snap = t_metrics.unified_snapshot()
        modes = {label for label in snap["metrics"]["rs_pallas_autotune_total"]["values"]}
        assert {"eager", "aot"} == {lab.split('mode="')[1].split('"')[0] for lab in modes}
        assert len(snap["autotune_decisions"]) == 1
        assert snap["metrics"]["rs_pallas_refold_total"]["values"]
    finally:
        t_metrics.force_enable(False)
        t_metrics.REGISTRY.reset()


def test_plan_refold_static_and_k1(monkeypatch):
    """A knob's static refold is what a plan records; with no knob a cuda
    plan runs K1 and records none."""
    for env, want in ((None, None), ("sum", "sum"), ("dot", "dot")):
        t_plan.PLAN_CACHE.clear()
        if env:
            monkeypatch.setenv("RS_PALLAS_REFOLD", env)
        c = t_codec.RSCodec(4, 2, strategy="cuda", device="cpu")
        B = np.random.default_rng(32).integers(0, 256, size=(4, 256), dtype=np.uint8)
        for _ in range(2):
            np.testing.assert_array_equal(to_numpy(c.encode(B)), get_field(8).matmul(c.parity_block, B))
        (p,) = t_plan.PLAN_CACHE.stats()["plans"]
        assert p["refold"] == want


def test_pack2_expand_survives_plan_rebuild(monkeypatch):
    """RS_PALLAS_EXPAND=pack2 rejects an explicit refold: the plan leaves
    its refold unset and every dispatch stays on K2."""
    monkeypatch.setenv("RS_PALLAS_EXPAND", "pack2")
    monkeypatch.setenv("RS_PALLAS_REFOLD", "autotune")
    seen = []
    _spy(monkeypatch, seen)
    t_plan.PLAN_CACHE.clear()
    c = t_codec.RSCodec(4, 2, strategy="cuda", device="cpu")
    B = np.random.default_rng(29).integers(0, 256, size=(4, 256), dtype=np.uint8)
    for _ in range(3):
        np.testing.assert_array_equal(to_numpy(c.encode(B)), get_field(8).matmul(c.parity_block, B))
    assert [s["kernel"] for s in seen] == ["K2"] * 3
    assert t_plan.PLAN_CACHE.stats()["plans"][0]["refold"] is None
    assert not cuda_gemm.autotune_decisions()


def test_clear_also_clears_autotune_cache():
    with cuda_gemm._AUTOTUNE_LOCK:
        cuda_gemm._AUTOTUNE_CACHE[("sentinel",)] = "dot"
    t_plan.PLAN_CACHE.clear()
    assert cuda_gemm.autotune_decisions() == {}


def test_mesh_resolves_the_knob_statically(monkeypatch):
    """The mesh's cols path never calibrates or warns under autotune (the
    per-width default), and its stripe path runs K3's pre-parity form under
    RS_PALLAS_EXPAND; both give the single device's bytes."""
    seen = []
    _spy(monkeypatch, seen)
    calls = _fake_timer(monkeypatch, [])
    A, B = _operands(4, 8, 512, 8, 36)
    want = get_field(8).matmul(A, B)
    monkeypatch.setenv("RS_PALLAS_REFOLD", "autotune")
    cols = make_mesh(4, stripe=1, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out = sharded_gf_matmul(A, put_sharded(torch.from_numpy(B), cols), mesh=cols, w=8, strategy="cuda")
    np.testing.assert_array_equal(out.numpy(), want)
    assert not calls and {s["refold"] for s in seen} == {"dot"} and len(seen) == 4
    monkeypatch.delenv("RS_PALLAS_REFOLD")
    monkeypatch.setenv("RS_PALLAS_EXPAND", "sign")
    stripe = make_mesh(2, stripe=2, device="cpu")
    out = sharded_gf_matmul(A, put_sharded(torch.from_numpy(B), stripe, True), mesh=stripe, w=8, strategy="cuda",
                            stripe_sharded=True)
    np.testing.assert_array_equal(out.numpy(), want)
    assert [(s["expand"], s["refold"]) for s in seen[4:]] == [("sign", "none")] * 2


def test_w16_bench_reports_the_autotune_choice(monkeypatch, capsys):
    import json

    monkeypatch.setenv("RS_PALLAS_REFOLD", "autotune")
    monkeypatch.setattr(w16_bench, "time_device_fn", lambda fn, trials: 1.0)
    assert w16_bench.main(["--device", "cpu", "--mb", "1", "--trials", "1"]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert summary["autotune"] and set(summary["autotune"]) <= {"sum", "dot"}
