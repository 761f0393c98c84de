"""The port's pipeline classes (AsyncWindow, SegmentPrefetcher,
DeviceStagingRing) against the JAX package's on the same scripted
scenarios: consume order, the in-flight bound, the stage-ahead count, error
propagation, the early-exit worker stop and the context-manager guard.
Also the CPU half of StreamLoop, which the file loops run on the CPU."""

import threading

import numpy as np
import pytest
import torch

from gpu_rscode_torch.parallel import pipeline as t_pipe
from gpu_rscode_tpu.parallel import pipeline as j_pipe

IMPLS = pytest.mark.parametrize("impl", [t_pipe, j_pipe], ids=["torch", "jax"])


def _window_trace(mod, depth, n):
    """(drained after each push, peak pending) for n pushes at ``depth``."""
    drained, after_push, peak = [], [], 0
    w = mod.AsyncWindow(depth, lambda tag, fut: drained.append((tag, fut)))
    for i in range(n):
        w.push(i, f"f{i}")
        after_push.append(list(drained))
        peak = max(peak, len(w._pending))
    w.flush()
    return after_push, drained, peak


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_window_order_and_bound_match_jax(depth):
    got = _window_trace(t_pipe, depth, 7)
    assert got == _window_trace(j_pipe, depth, 7)
    after_push, drained, peak = got
    assert drained == [(i, f"f{i}") for i in range(7)]
    assert peak == depth
    assert after_push[depth - 1] == []  # exactly depth in flight, nothing drained yet


@IMPLS
def test_window_context_flushes_and_discards_on_error(impl):
    drained = []
    with impl.AsyncWindow(4, lambda t, f: drained.append(t)) as w:
        for i in range(3):
            w.push(i, i)
    assert drained == [0, 1, 2]
    drained.clear()
    with pytest.raises(RuntimeError):
        with impl.AsyncWindow(4, lambda t, f: drained.append(t)) as w:
            w.push(0, 0)
            raise RuntimeError("boom")
    assert drained == []


class _ListExecutor:
    """Stands in for a DrainExecutor: records the drains it is handed."""

    def __init__(self):
        self.fns = []

    def submit(self, fn, **_):
        self.fns.append(fn)


def test_window_hands_drains_to_executor_like_jax():
    runs = {}
    for mod in (t_pipe, j_pipe):
        ex, drained = _ListExecutor(), []
        with mod.AsyncWindow(2, lambda t, f: drained.append((t, f)), executor=ex) as w:
            for i in range(5):
                w.push(i, f"f{i}")
                assert drained == []  # nothing runs on the pushing thread
        handed = len(ex.fns)
        for fn in ex.fns:
            fn()
        runs[mod.__name__.split(".")[0]] = (handed, drained)
    assert runs["gpu_rscode_torch"] == runs["gpu_rscode_tpu"] == (5, [(i, f"f{i}") for i in range(5)])


def _prefetch(mod, segs, produce, depth):
    with mod.SegmentPrefetcher(segs, produce, depth=depth) as pf:
        return list(pf)


@pytest.mark.parametrize("depth", [1, 2, 4])
def test_prefetcher_order_matches_jax(depth):
    segs = [(i * 10, 10) for i in range(9)] + [(90, 3)]
    produce = lambda off, cols: (off * 7, cols)  # noqa: E731
    got = _prefetch(t_pipe, segs, produce, depth)
    assert got == _prefetch(j_pipe, segs, produce, depth)
    assert [tag for tag, _ in got] == segs


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_prefetcher_bounds_produced_ahead_like_jax(depth):
    """At most depth segments wait in the queue, beside the one the worker
    is producing and the one the consumer holds: the same bound in both
    packages."""
    peaks = []
    for mod in (t_pipe, j_pipe):
        produced, peak = [], [0]
        consumed = [0]
        gate = threading.Event()

        def produce(off, cols):
            produced.append(off)
            peak[0] = max(peak[0], len(produced) - consumed[0])
            return off

        with mod.SegmentPrefetcher([(i, 1) for i in range(12)], produce, depth=depth) as pf:
            for _ in pf:
                gate.wait(0.02)  # let the worker run ahead as far as it can
                consumed[0] += 1
        peaks.append(peak[0])
    assert max(peaks) <= depth + 2


@IMPLS
def test_prefetcher_propagates_producer_error(impl):
    def produce(off, cols):
        if off == 2:
            raise OSError("disk gone")
        return off

    seen = []
    with pytest.raises(OSError, match="disk gone"):
        with impl.SegmentPrefetcher([(i, 1) for i in range(5)], produce) as pf:
            for tag, _ in pf:
                seen.append(tag)
    assert seen == [(0, 1), (1, 1)]


@IMPLS
def test_prefetcher_early_exit_stops_worker(impl):
    started = threading.Event()
    produced = []

    def produce(off, cols):
        started.set()
        produced.append(off)
        return off

    pf = impl.SegmentPrefetcher([(i, 1) for i in range(100)], produce, depth=1)
    with pytest.raises(RuntimeError):
        with pf:
            started.wait(timeout=5)
            raise RuntimeError("consumer died")
    pf._thread.join(timeout=5)
    assert not pf._thread.is_alive()
    assert len(produced) < 100


@IMPLS
def test_prefetcher_outside_context_raises(impl):
    pf = impl.SegmentPrefetcher([(0, 1)], lambda off, cols: off)
    with pytest.raises(RuntimeError, match="context manager"):
        next(pf)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_staging_ring_stage_ahead_matches_jax(depth):
    """Segment i+depth is staged before segment i is handed out, each
    exactly once, in source order."""
    traces = []
    for mod in (t_pipe, j_pipe):
        staged, at_handout = [], []
        src = [((i, 1), f"h{i}") for i in range(6)]
        ring = mod.DeviceStagingRing(src, lambda tag, h: staged.append(tag[0]) or f"d{h}", depth=depth)
        out = []
        for tag, dev in ring:
            at_handout.append(len(staged))
            out.append((tag, dev))
        traces.append((out, at_handout, staged))
    assert traces[0] == traces[1]
    out, at_handout, staged = traces[0]
    assert out == [((i, 1), f"dh{i}") for i in range(6)]
    assert staged == list(range(6))
    assert at_handout[0] == min(6, depth + 1)


@IMPLS
def test_staging_ring_propagates_stage_error(impl):
    def stage(tag, h):
        if tag[0] == 2:
            raise OSError("dma gone")
        return h

    ring = impl.DeviceStagingRing([((i, 1), i) for i in range(5)], stage, depth=2)
    with pytest.raises(OSError, match="dma gone"):
        list(ring)


@pytest.mark.parametrize("sym", [1, 2])
def test_stream_loop_on_cpu_passes_numpy_through(sym):
    """On the CPU a StreamLoop hands out fresh NumPy buffers, stages them
    without a copy, runs the dispatch at once and returns its output's
    bytes; it counts no pinned stage and no stream dispatch."""
    before = (t_pipe.PINNED_STAGES, t_pipe.STREAM_DISPATCHES)
    loop = t_pipe.StreamLoop(torch.device("cpu"), 4, 256, 2)
    slot, host = loop.host_segment(128)
    assert slot is None and host.shape == (4, 128) and host.dtype == np.uint8
    host[:] = np.arange(4 * 128, dtype=np.uint32).reshape(4, 128).astype(np.uint8)
    staged = loop.stage((slot, host), sym)
    assert staged.dtype == (torch.uint16 if sym == 2 else torch.uint8)
    assert staged.shape == (4, 128 // sym)
    out = loop.dispatch(lambda seg: seg[1:3].clone(), staged)
    np.testing.assert_array_equal(loop.result(out), host[1:3])
    assert (t_pipe.PINNED_STAGES, t_pipe.STREAM_DISPATCHES) == before
