"""inverse_bench and the card's routing of repair_fleet's inversions, on the
CPU: the tool's rows (the JAX tool's keys, every number positive), its
batches against the JAX package's batched inverter, the committed H100 grid
against ``api._device_invert_min_batch_cuda`` (the evidence lock), and the
routing itself with a card faked."""

import json
import os

import numpy as np
import pytest
import torch

from gpu_rscode_torch import api as t_api
from gpu_rscode_torch.ops import inverse as t_inverse
from gpu_rscode_torch.tools import inverse_bench
from gpu_rscode_torch.utils.fileformat import chunk_file_name
from gpu_rscode_tpu.ops import inverse as j_inverse

# The JAX tool's row keys; every one means the same on the card.
JAX_KEYS = {"metric", "k", "batch", "invertible", "nopivot_ok", "device_dispatch_s", "nopivot_dispatch_s",
            "device_per_matrix_us", "nopivot_per_matrix_us", "host_per_matrix_us", "speedup_vs_host_loop",
            "nopivot_speedup_vs_host_loop"}


def _lines(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("ks,batches", [(["4", "10"], ["1", "3", "16"]), (["32"], ["2", "5"])])
def test_inverse_bench_on_cpu(capsys, ks, batches):
    assert inverse_bench.main(["--device", "cpu", "--trials", "1", "--k", *ks, "--batch", *batches]) == 0
    lines = _lines(capsys)
    assert lines[0]["kind"] == "capture_header" and lines[0]["tool"] == "inverse_bench"
    rows = lines[1:]
    assert [(r["k"], r["batch"]) for r in rows] == [(int(k), int(b)) for k in ks for b in batches]
    for r in rows:
        assert set(r) == JAX_KEYS and r["metric"] == "batched_inverse_cpu"
        assert r["invertible"] == r["batch"] and 0 < r["nopivot_ok"] <= r["batch"]
        for key, v in r.items():
            if key != "metric":
                assert np.isfinite(v) and v > 0, key


@pytest.mark.parametrize("k,batch", [(4, 3), (10, 16), (32, 5)])
@pytest.mark.parametrize("pivot", [True, False])
def test_bench_batches_invert_like_jax(k, batch, pivot):
    """The tool's survivor batch through the port's inverter and the JAX
    package's: the same inverses and the same ok flags, bit for bit."""
    subs = inverse_bench.survivor_batch(k, batch, np.random.default_rng(k))
    invs, oks = t_inverse.invert_matrix_torch_batch(subs, 8, pivot=pivot, device=torch.device("cpu"))
    j_invs, j_oks = j_inverse.invert_matrix_jax_batch(subs, 8, pivot=pivot)
    np.testing.assert_array_equal(invs.numpy(), np.asarray(j_invs))
    np.testing.assert_array_equal(oks.numpy(), np.asarray(j_oks))
    if pivot:
        assert oks.all()  # every k-subset of an MDS total matrix inverts


def test_a_wrong_inverse_ends_the_bench(capsys, monkeypatch):
    real = t_inverse.invert_matrix_torch_batch

    def wrong(Ms, w=8, **kw):
        invs, oks = real(Ms, w, **kw)
        invs = invs.clone()
        invs[-1, 0, 0] ^= 1
        return invs, oks

    monkeypatch.setattr(inverse_bench, "invert_matrix_torch_batch", wrong)
    with pytest.raises(AssertionError, match="differs from the host"):
        inverse_bench.main(["--device", "cpu", "--trials", "1", "--k", "4", "--batch", "3"])
    assert len(capsys.readouterr().out.splitlines()) == 1  # the header only


def _grid():
    cells: dict[int, dict[int, float]] = {}
    header = None
    with open(t_api.INVERSE_ROUTING) as fp:
        for line in fp:
            if line.startswith("# "):
                header = header or line[2:].strip()
            elif line.startswith("{"):
                row = json.loads(line)
                if row.get("kind") != "capture_header":
                    assert set(row) == JAX_KEYS and row["metric"] == "batched_inverse_cuda"
                    cells.setdefault(row["k"], {})[row["batch"]] = row["nopivot_speedup_vs_host_loop"]
    return header, cells


def test_device_invert_routing_matches_committed_h100_grid():
    """Evidence lock: every measured cell the function routes to the device
    measured a device win, the largest measured batch below a threshold a
    loss, and a depth routed wholly to the host lost at its largest batch;
    the grid names its card and power limit and covers the card's routing
    grid (k 4-128 x batch 1-1024)."""
    header, cells = _grid()
    assert header and "H100" in header and " W" in header
    assert sorted(cells) == [4, 10, 32, 64, 128]
    for k, batches in cells.items():
        assert sorted(batches) == [1, 3, 16, 64, 256, 1024]
        min_batch = t_api._device_invert_min_batch_cuda(k)
        if min_batch is None:
            assert batches[max(batches)] < 1.0, (k, batches)
            continue
        assert min_batch in batches
        assert all(s >= 1.0 for b, s in batches.items() if b >= min_batch), (k, min_batch, batches)
        below = [b for b in batches if b < min_batch]
        if below:
            assert batches[max(below)] < 1.0, (k, min_batch, batches)


@pytest.mark.parametrize("k", [1, 5, 20, 48, 100, 200])
def test_unmeasured_depths_take_the_stricter_neighbour(k):
    _, cells = _grid()
    measured = sorted(cells)
    near = [d for d in (max([d for d in measured if d < k], default=None),
                        min([d for d in measured if d > k], default=None)) if d is not None]
    thresholds = [t_api._device_invert_min_batch_cuda(d) for d in near]
    want = None if None in thresholds else max(thresholds)
    assert t_api._device_invert_min_batch_cuda(k) == want


def _archive(d, size, seed, k=4, p=2):
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "f.bin")
    with open(path, "wb") as fp:
        fp.write(np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes())
    t_api.encode_file(path, k, p, checksums=True, device="cpu")
    return path


def _chunks(path, n):
    out = {}
    for i in range(n):
        with open(chunk_file_name(path, i), "rb") as fp:
            out[i] = fp.read()
    return out


@pytest.mark.parametrize("threshold,fleet,batched", [(3, 2, 0), (None, 3, 0), (2, 2, 1), (2, 3, 1)])
def test_repair_fleet_routes_small_groups_to_the_host_on_a_card(tmp_path, monkeypatch, threshold, fleet, batched):
    """With a card faked and the threshold set: a group below it never
    reaches the batched inverter (the host search solves each archive), one
    at or above it makes one batched call; the chunks rebuild byte for byte
    either way."""
    t_api.clear_subset_cache()
    paths = [_archive(tmp_path / str(j), 3000 + 7 * j, seed=40 + j) for j in range(fleet)]
    golden = [_chunks(p, 6) for p in paths]
    for p in paths:
        os.unlink(chunk_file_name(p, 1))
    calls, searched = [], []
    real_batch, real_select = t_inverse.invert_matrix_torch_batch, t_api._select_decodable_subset

    def batch_spy(Ms, w=8, **kw):
        calls.append(np.shape(Ms))
        return real_batch(Ms, w, **kw)

    monkeypatch.setattr(t_inverse, "invert_matrix_torch_batch", batch_spy)
    monkeypatch.setattr(t_api, "_select_decodable_subset", lambda scan, **kw: searched.append(scan.in_file) or
                        real_select(scan, **kw))
    monkeypatch.setattr(t_api, "_on_card", lambda device: True)
    monkeypatch.setattr(t_api, "_device_invert_min_batch_cuda", lambda k: threshold)
    assert t_api.repair_fleet(paths, device="cpu") == {p: [1] for p in paths}
    assert len(calls) == batched
    assert sorted(searched) == ([] if batched else sorted(paths))
    assert [_chunks(p, 6) for p in paths] == golden


def test_repair_fleet_on_the_cpu_keeps_the_batched_inverter(tmp_path, monkeypatch):
    """Off the card the routing does not apply: one archive still goes
    through one batched call, whatever the card's threshold."""
    t_api.clear_subset_cache()
    path = _archive(tmp_path, 4000, seed=9)
    os.unlink(chunk_file_name(path, 0))
    calls = []
    real = t_inverse.invert_matrix_torch_batch
    monkeypatch.setattr(t_inverse, "invert_matrix_torch_batch",
                        lambda Ms, w=8, **kw: calls.append(np.shape(Ms)) or real(Ms, w, **kw))
    monkeypatch.setattr(t_api, "_device_invert_min_batch_cuda", lambda k: None)
    assert t_api.repair_fleet([path], device="cpu") == {path: [0]}
    assert calls == [(1, 4, 4)]
