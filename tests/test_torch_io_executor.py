"""The port's write-behind executor (DrainExecutor, FleetPipeline,
run_rows), case by case as the JAX package's own tests hold its
counterpart, each case run through both packages: ordered FIFO, unordered
completeness, the inline mode, backpressure, error relay at submit and
flush, cancel on an exceptional exit, the context-manager guard, the fleet
lane's commit order and abort, the reader pool, and AsyncWindow handing
its drains to the executor."""

import threading
import time

import pytest

from gpu_rscode_torch.parallel import io_executor as t_io
from gpu_rscode_torch.parallel import pipeline as t_pipe
from gpu_rscode_tpu.parallel import io_executor as j_io
from gpu_rscode_tpu.parallel import pipeline as j_pipe

IMPLS = pytest.mark.parametrize("io", [t_io, j_io], ids=["torch", "jax"])


def _raise(exc):
    raise exc


@IMPLS
def test_executor_ordered_commits_fifo(io):
    got = []
    with io.DrainExecutor(workers=3, ordered=True) as ex:
        assert ex.workers == 1  # ordered clamps to one consumer
        for i in range(20):
            ex.submit(lambda i=i: got.append(i))
    assert got == list(range(20))


@IMPLS
def test_executor_unordered_runs_everything(io):
    got = []
    lock = threading.Lock()

    def task(i):
        with lock:
            got.append(i)

    with io.DrainExecutor(workers=3, ordered=False) as ex:
        for i in range(30):
            ex.submit(lambda i=i: task(i))
    assert sorted(got) == list(range(30))


@IMPLS
def test_executor_sync_mode_runs_inline(io):
    got = []
    ex = io.DrainExecutor(workers=0)
    ex.submit(lambda: got.append(threading.current_thread().name))
    assert got == [threading.current_thread().name]
    ex.flush()


@IMPLS
def test_executor_backpressure_bounds_queue(io):
    """depth=2 and a stalled worker: two drains queue behind the running
    one, the next submit blocks until the worker moves."""
    release = threading.Event()
    ran = []
    with io.DrainExecutor(workers=1, depth=2) as ex:
        t0 = time.perf_counter()
        ex.submit(lambda: release.wait(timeout=10))
        ex.submit(lambda: None)
        ex.submit(lambda: None)
        assert time.perf_counter() - t0 < 1.0
        blocked = threading.Event()

        def fourth():
            ex.submit(lambda: ran.append("ran"))
            blocked.set()

        t = threading.Thread(target=fourth, daemon=True)
        t.start()
        assert not blocked.wait(timeout=0.3)  # queue full: submit blocks
        release.set()
        assert blocked.wait(timeout=10)
        t.join(timeout=10)
        assert not t.is_alive()
    assert ran == ["ran"]


@IMPLS
def test_executor_error_reraises_at_submit_and_flush(io):
    with pytest.raises(OSError, match="disk gone"):
        with io.DrainExecutor(workers=1) as ex:
            ex.submit(lambda: _raise(OSError("disk gone")))
            for _ in range(50):
                ex.submit(lambda: None)
                time.sleep(0.01)
            ex.flush()


@IMPLS
def test_executor_flush_reraises_without_further_submits(io):
    ex = io.DrainExecutor(workers=1)
    with pytest.raises(ValueError, match="boom"):
        with ex:
            ex.submit(lambda: _raise(ValueError("boom")))


@IMPLS
def test_executor_exceptional_exit_cancels_queued(io):
    ran = []
    release = threading.Event()
    with pytest.raises(RuntimeError, match="dispatch died"):
        with io.DrainExecutor(workers=1, depth=8) as ex:
            ex.submit(lambda: release.wait(timeout=10))
            for i in range(5):
                ex.submit(lambda i=i: ran.append(i))
            release.set()
            raise RuntimeError("dispatch died")
    assert len(ran) < 5


@IMPLS
def test_executor_error_cancels_queue_before_reraise(io):
    """Once the error re-raises, nothing still queued may run (in a fleet
    it could be an archive's promote)."""
    ran = []
    gate = threading.Event()
    with pytest.raises(OSError, match="disk gone"):
        with io.DrainExecutor(workers=2, ordered=False, depth=8) as ex:
            ex.submit(lambda: _raise(OSError("disk gone")))
            ex.submit(lambda: gate.wait(timeout=1))
            ex.submit(lambda: ran.append("late"))
            deadline = time.time() + 5
            while time.time() < deadline:
                time.sleep(0.01)
                ex.submit(lambda: None)  # raises once the error latched
            pytest.fail("error never surfaced")
    gate.set()
    time.sleep(0.1)
    assert ran == []


@IMPLS
def test_executor_submit_outside_context_raises(io):
    ex = io.DrainExecutor(workers=1)
    with pytest.raises(RuntimeError, match="context manager"):
        ex.submit(lambda: None)


@IMPLS
def test_fleet_pipeline_rejects_unordered_lane(io):
    with pytest.raises(ValueError, match="ordered"):
        io.FleetPipeline(io.DrainExecutor(workers=2, ordered=False))


@IMPLS
def test_fleet_pipeline_commit_order_and_abort(io):
    events = []
    pipe = io.FleetPipeline(io.DrainExecutor(ordered=True))
    with pipe.executor:
        k1 = pipe.register(lambda: events.append("cleanup1"))
        pipe.executor.submit(lambda: events.append("write1"))
        pipe.commit(k1, lambda: events.append("final1"))
        k2 = pipe.register(lambda: events.append("cleanup2"))
        pipe.executor.submit(lambda: events.append("write2"))
        pipe.commit(k2, lambda: events.append("final2"))
    pipe.abort()
    assert events == ["write1", "final1", "write2", "final2"]


@IMPLS
def test_fleet_pipeline_abort_runs_uncommitted_cleanups(io):
    events = []
    pipe = io.FleetPipeline(io.DrainExecutor(workers=0))
    pipe.register(lambda: events.append("cleanup"))
    pipe.abort()
    assert events == ["cleanup"]


@IMPLS
def test_fleet_pipeline_failed_finalize_keeps_its_cleanup(io):
    events = []
    pipe = io.FleetPipeline(io.DrainExecutor(workers=0))
    key = pipe.register(lambda: events.append("cleanup"))
    with pytest.raises(OSError):
        pipe.commit(key, lambda: _raise(OSError("promote failed")))
    pipe.abort()
    assert events == ["cleanup"]


@IMPLS
def test_run_rows_parallel_and_error(io, monkeypatch):
    monkeypatch.setenv("RS_IO_READERS", "3")
    out = [0] * 16
    io.run_rows(16, lambda i: out.__setitem__(i, i * i))
    assert out == [i * i for i in range(16)]
    with pytest.raises(OSError, match="pread"):
        io.run_rows(8, lambda i: _raise(OSError("pread")))


@pytest.mark.parametrize("env,want", [({}, (1, 2)), ({"RS_IO_WRITERS": "0"}, (0, 2)), ({"RS_IO_WRITERS": "3"}, (3, 6)),
                                      ({"RS_IO_WRITERS": "2", "RS_IO_WRITE_DEPTH": "5"}, (2, 5)),
                                      ({"RS_IO_WRITERS": "x"}, (1, 2))])
def test_knobs_match_jax(monkeypatch, env, want):
    for name in ("RS_IO_WRITERS", "RS_IO_WRITE_DEPTH", "RS_IO_READERS"):
        monkeypatch.delenv(name, raising=False)
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    for io in (t_io, j_io):
        workers = io.writer_count()
        assert (workers, io.writer_depth(workers)) == want
        assert io.reader_count() == j_io.reader_count()


@pytest.mark.parametrize("io,pipe", [(t_io, t_pipe), (j_io, j_pipe)], ids=["torch", "jax"])
def test_window_delegates_drain_to_executor(io, pipe):
    drained = []
    with io.DrainExecutor(workers=1) as ex:
        with pipe.AsyncWindow(2, lambda t, f: drained.append((t, f)), executor=ex) as w:
            for i in range(5):
                w.push(i, f"f{i}")
        ex.flush()
        assert drained == [(i, f"f{i}") for i in range(5)]
