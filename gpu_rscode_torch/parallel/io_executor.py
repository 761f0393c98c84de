"""Write-behind IO: the fifth stage of the file pipeline,

    read || H2D || compute || D2H || write

the reference's stream loop (encode.cu:165-218) with the host's writes
taken off the dispatch thread.

* :class:`DrainExecutor`: a bounded queue of writer threads that
  :class:`.pipeline.AsyncWindow` hands its drains to.  ``depth`` bounds
  queued-but-unwritten drains (a slow disk blocks dispatch instead of
  growing a backlog of live device buffers); a worker's exception
  re-raises at the next ``submit`` or ``flush``; ``ordered=True`` commits
  in submit order on one worker (shared-``fp`` writes and incremental CRCs
  need it), ``ordered=False`` lets ``workers`` threads race offset-addressed
  writes.  ``workers=0`` drains inline on the caller (``RS_IO_WRITERS=0``).
  ``submit_pwrite`` queues one offset-addressed ``os.pwrite``, the patch
  lane of the in-place update.
* :class:`FleetPipeline`: per-archive commit for multi-file operations.
  Each archive's finalize (close, promote, checksum lines) rides the shared
  ordered lane behind that archive's own writes, so the next archive's
  reads and dispatches overlap this one's writes.
* :func:`run_rows`: a small reader pool for the NumPy fallback of the
  native gathers (:mod:`..native`).

Every drain crosses the resilience write boundary (:mod:`..resilience`),
as the JAX package's do: the fault plane's write hook fires once per
attempt on the drain's lane (named from the writer thread, ``writer-0``,
or ``drain-sync`` inline) with the task's ``nbytes``, and a transient
failure retries the whole drain under the default policy.

Knobs: ``RS_IO_WRITERS`` (writer threads, 0 = inline; default 1),
``RS_IO_WRITE_DEPTH`` (queued drains before ``submit`` blocks; default 2 x
writers), ``RS_IO_READERS`` (fallback read pool; default min(4, cores)).

Import cost: the standard library only.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections.abc import Callable

from ..obs import metrics as _metrics, tracing as _tracing
from ..resilience import faults as _faults, retry as _retry


def writer_count(default: int = 1) -> int:
    """``RS_IO_WRITERS``: write-behind worker threads (0 = drain inline on
    the dispatch thread)."""
    try:
        return max(0, int(os.environ.get("RS_IO_WRITERS", default)))
    except ValueError:
        return default


def writer_depth(workers: int) -> int:
    """``RS_IO_WRITE_DEPTH``: queued-but-unwritten drains allowed before
    ``submit`` blocks.  Each queued drain holds a segment's output buffers,
    so this bounds device and pinned memory as well as the host backlog."""
    fallback = 2 * max(1, workers)
    try:
        return max(1, int(os.environ.get("RS_IO_WRITE_DEPTH", fallback)))
    except ValueError:
        return fallback


def reader_count() -> int:
    """``RS_IO_READERS``: threads of the fallback per-row read fan-out (1 =
    serial).  The native library's own pool (``RS_NATIVE_IO_THREADS``)
    applies when it serves the read."""
    try:
        return max(1, int(os.environ.get("RS_IO_READERS", 0) or min(4, os.cpu_count() or 1)))
    except ValueError:
        return min(4, os.cpu_count() or 1)


class DrainExecutor:
    """Bounded background executor for the pipeline's drain stage.

    ``submit(fn, nbytes=...)`` enqueues one drain and returns at once unless ``depth``
    drains are already queued (backpressure).  A worker's exception is
    latched and re-raised at the next ``submit`` or ``flush``; after it the
    workers discard the rest of the queue, so ``flush`` cannot deadlock.

    Context manager: a clean exit flushes (barrier, then the error if any);
    an exceptional exit cancels the queued drains (a failed stream commits
    nothing more) and joins the workers, so the caller's ``finally`` may
    close the files the drains write to.
    """

    _STOP = object()

    def __init__(self, workers: int | None = None, depth: int | None = None, ordered: bool = False,
                 name: str = "rs-io-writer"):
        if workers is None:
            workers = writer_count()
        self.ordered = ordered
        self.workers = min(workers, 1) if ordered else workers
        self.depth = depth if depth is not None else writer_depth(self.workers)
        self._q: queue.Queue | None = queue.Queue(maxsize=self.depth) if self.workers else None
        self._error: BaseException | None = None
        self._lock = threading.Lock()
        self._cancelled = False
        self._threads = [threading.Thread(target=self._run, name=f"{name}-{i}", daemon=True)
                         for i in range(self.workers)]
        self._started = False

    def _run(self) -> None:
        lane = threading.current_thread().name.replace("rs-io-", "")
        while True:
            item = self._q.get()
            try:
                if item is self._STOP:
                    return
                fn, nbytes = item
                if self._error is None and not self._cancelled:
                    self._run_task(fn, nbytes, lane)
            except BaseException as e:  # noqa: BLE001 - relayed to submit/flush
                with self._lock:
                    if self._error is None:
                        self._error = e
            finally:
                self._q.task_done()
                self._report_depth()

    @staticmethod
    def _run_task(fn: Callable[[], None], nbytes: int, lane: str) -> None:
        # The resilience write boundary: the fault hook fires per attempt,
        # and a transient failure retries the whole drain.  Drains are
        # idempotent (offset-addressed writes, restart-from-scratch copies,
        # CRCs advanced only after the write landed); the lane's attempted
        # bytes (torn faults) count a task once, not per retry.
        t0 = time.perf_counter()
        first = True

        def attempt() -> None:
            nonlocal first
            nb = nbytes if first else 0
            first = False
            _faults.on_write(lane, nb)
            fn()

        with _tracing.span("write_drain", lane=lane, nbytes=nbytes):
            _retry.default_policy().call(attempt, op="write_drain")
        dt = time.perf_counter() - t0
        _metrics.counter("rs_io_write_seconds_total", "wall seconds spent in drain (D2H wait + write) tasks").labels(
            lane=lane).inc(dt)
        _metrics.quantile("rs_io_drain_wall_seconds", "writer-lane drain task wall seconds (streaming quantiles)").labels(
            lane=lane).observe(dt)

    def _report_depth(self) -> None:
        n = self._q.qsize()
        _metrics.gauge("rs_io_writer_queue_depth", "drain tasks queued behind the write-behind workers").set(n)
        _tracing.counter("io_writer_queue_depth", queued=n)

    def _check_error(self) -> None:
        with self._lock:
            err = self._error
        if err is not None:
            # Cancel before re-raising: nothing queued behind the failure
            # (in a fleet, an archive's promote) may run after the caller
            # saw the error.
            self._cancelled = True
            raise err

    def submit(self, fn: Callable[[], None], *, nbytes: int = 0) -> None:
        """Enqueue one drain of ``nbytes`` attempted bytes; blocks while
        ``depth`` are queued.  Re-raises a pending worker exception instead
        of queueing behind it."""
        if self.workers == 0:
            self._run_task(fn, nbytes, "drain-sync")
            return
        if not self._started:
            raise RuntimeError("DrainExecutor must be entered as a context manager before submit() "
                               "(worker threads not started)")
        self._check_error()
        self._q.put((fn, nbytes))
        self._report_depth()

    def submit_pwrite(self, fileno: int, data: bytes, offset: int) -> None:
        """Queue one offset-addressed ``os.pwrite``: the patch lane of the
        in-place update (:mod:`..update`).  An ``ordered=True`` executor
        commits patches in submit order, the ascending-offset order per
        chunk that the incremental CRCs are accounted in; a short write
        raises ``OSError``.  The drain crosses the write boundary like
        every other; a retry re-pwrites the same bytes at the same
        offset."""
        nbytes = len(data)

        def task() -> None:
            done = os.pwrite(fileno, data, offset)
            if done != nbytes:
                raise OSError(f"short pwrite ({done} of {nbytes} bytes at {offset})")
            _metrics.counter("rs_io_write_bytes_total", "bytes written by the staging-I/O layer").labels(
                call="patch_pwrite").inc(nbytes)

        self.submit(task, nbytes=nbytes)

    def flush(self) -> None:
        """Barrier: wait until every submitted drain ran (or was discarded
        after an error), then re-raise the first worker exception."""
        if self._q is not None:
            self._q.join()
        self._check_error()

    def cancel(self) -> None:
        """Discard queued drains that have not started."""
        self._cancelled = True

    def _shutdown(self) -> None:
        if not self._started:
            return
        for _ in self._threads:
            self._q.put(self._STOP)
        for t in self._threads:
            t.join()
        self._started = False

    def __enter__(self) -> "DrainExecutor":
        for t in self._threads:
            t.start()
        self._started = bool(self._threads)
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            try:
                self.flush()
            finally:
                self._shutdown()
        else:
            self.cancel()
            self._shutdown()
        return False


class FleetPipeline:
    """Deferred per-archive commit over a shared ordered
    :class:`DrainExecutor`.

    Per archive: ``register(cleanup)`` before streaming starts, then
    ``commit(key, finalize)`` after its last drain was submitted.  FIFO
    runs the finalize behind the archive's writes while the caller streams
    the next archive.  A finalize that succeeds releases its cleanup;
    :meth:`abort` runs every cleanup still registered.  Call ``abort`` only
    after the executor's workers joined, so no drain races a cleanup.
    """

    def __init__(self, executor: DrainExecutor):
        if executor.workers and not executor.ordered:
            raise ValueError("FleetPipeline needs an ordered executor: an out-of-order lane could "
                             "promote an archive before its writes landed")
        self.executor = executor
        self._cleanups: dict[int, Callable[[], None]] = {}
        self._n = 0
        self._lock = threading.Lock()

    def register(self, cleanup: Callable[[], None]) -> int:
        """Register an archive's failure cleanup; returns its key."""
        with self._lock:
            key = self._n
            self._n += 1
            self._cleanups[key] = cleanup
        return key

    def commit(self, key: int, finalize: Callable[[], None]) -> None:
        """Queue the archive's commit behind its writes.  Only a finalize
        that succeeds releases the cleanup."""

        def run() -> None:
            finalize()
            with self._lock:
                self._cleanups.pop(key, None)

        self.executor.submit(run)

    def abort(self) -> None:
        with self._lock:
            pending = list(self._cleanups.values())
            self._cleanups.clear()
        for cb in pending:
            try:
                cb()
            except OSError:
                pass  # best-effort temp cleanup must not bury the cause


_POOLS: dict[int, object] = {}
_POOL_LOCK = threading.Lock()


def _pool(n: int):
    from concurrent.futures import ThreadPoolExecutor

    with _POOL_LOCK:
        pool = _POOLS.get(n)
        if pool is None:
            pool = _POOLS[n] = ThreadPoolExecutor(max_workers=n, thread_name_prefix="rs-io-reader")
        return pool


def run_rows(n: int, fn: Callable[[int], None]) -> None:
    """``fn(i)`` for each ``i`` in ``range(n)`` over the shared reader pool
    (``RS_IO_READERS`` wide; serial when 1).  Blocks until every row ran;
    the first row exception re-raises here."""
    workers = min(reader_count(), n)
    if workers <= 1:
        for i in range(n):
            fn(i)
        return
    pool = _pool(workers)
    futures = [pool.submit(fn, i) for i in range(n)]
    err = None
    for f in futures:
        try:
            f.result()
        except BaseException as e:  # noqa: BLE001 - re-raised after the join
            if err is None:
                err = e
    if err is not None:
        raise err
