"""Host <-> device streaming for the file loops: the reference's stream
loop (encode.cu:165-218), read || H2D || compute || D2H || write.

* :class:`SegmentPrefetcher` reads segments on a worker thread, ``depth``
  ahead of the consumer.
* :class:`DeviceStagingRing` issues each segment's H2D copy ``depth``
  segments ahead of the dispatch that reads it.
* :class:`AsyncWindow` keeps ``depth`` dispatched segments in flight and
  hands the oldest to its drain (inline, or to a
  :class:`.io_executor.DrainExecutor`, which writes behind).
* :class:`StreamLoop` is what those three carry on one device.  On CUDA:
  a ring of ``depth + 2`` pinned host buffers that the prefetcher reads
  into, an H2D stream that copies each into device memory, a compute
  stream on which the GEMM runs, and a D2H stream that copies each output
  into a pinned buffer of its own; events order the streams, and one
  event per buffer says when the host may touch it again.  On the CPU the
  same calls pass plain NumPy buffers through, with no streams.

``depth`` is the ``-s`` flag.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from collections.abc import Callable, Iterable
from typing import Any

import numpy as np
import torch

from .. import plan as _plan
from ..obs import metrics as _metrics, tracing as _tracing

# Segments staged from pinned memory through the H2D stream, and dispatches
# launched on the compute stream, since the counts were last reset.  Only
# StreamLoop.stage and StreamLoop.dispatch add to them, on the dispatch
# thread.
PINNED_STAGES = 0
STREAM_DISPATCHES = 0

# The process-wide high watermark of staged segments ahead of a consumer
# (DeviceStagingRing._report_occupancy); a list, so tests reset it in place.
_RING_PEAK = [0]


def _nbytes(result) -> int:
    """Bytes a dispatched result holds: a tensor's ``nbytes``, or the host
    tensor's of a CUDA (host, event) handle.  Any other pair (the
    interleaved encode's (segment, output)) and a pure-copy drain count 0,
    as a tuple and None do in the JAX package."""
    if isinstance(result, tuple):
        host = result[0]
        return int(host.nbytes) if isinstance(host, torch.Tensor) else 0
    return int(getattr(result, "nbytes", 0) or 0)


class AsyncWindow:
    """Bounded window of in-flight results.

    After any ``push`` returns, at most ``depth`` results are pending; the
    oldest beyond that is drained through ``consume(tag, result)``, which
    waits for it and commits it.  ``flush`` drains the rest in order.

    With an ``executor`` the drain is handed to the executor's bounded
    writer queue instead of running here (write-behind); its exceptions
    re-raise at the next ``push`` or ``flush``, and the executor's own
    ``flush`` (its context exit) is the write barrier.  An exceptional exit
    drops the pending results unconsumed.
    """

    def __init__(self, depth: int, consume: Callable[[Any, Any], None], executor=None):
        self.depth = max(1, depth)
        self.consume = consume
        self.executor = executor
        self._pending: list[tuple[Any, Any]] = []

    def _report_depth(self) -> None:
        n = len(self._pending)
        _metrics.gauge("rs_pipeline_inflight", "async segments in flight (AsyncWindow pending results)").set(n)
        _tracing.counter("pipeline_inflight", inflight=n)

    def _drain_oldest(self) -> None:
        tag, result = self._pending.pop(0)
        if self.executor is not None:
            # The byte count of the result feeds the drain's write boundary
            # (the fault plane's per-lane accounting), as a JAX device
            # array's ``nbytes`` does there.
            self.executor.submit(lambda: self.consume(tag, result), nbytes=_nbytes(result))
        else:
            self.consume(tag, result)

    def push(self, tag: Any, result: Any) -> None:
        self._pending.append((tag, result))
        self._report_depth()
        while len(self._pending) > self.depth:
            self._drain_oldest()
            self._report_depth()

    def flush(self) -> None:
        while self._pending:
            self._drain_oldest()
            self._report_depth()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.flush()
        else:
            # The gauge goes back to zero, not frozen at a dead window's depth.
            dropped = len(self._pending)
            self._pending.clear()
            if dropped:
                self._report_depth()
                _tracing.instant("pipeline_aborted", lane="dispatch", dropped=dropped)
        return False


class DeviceStagingRing:
    """Issues ``stage(tag, host_segment)`` (the H2D copy) ``depth``
    segments ahead of the consumer.

    ``source`` yields ``(tag, host_segment)`` (a :class:`SegmentPrefetcher`
    does); iterating yields ``(tag, staged)`` in source order.  ``stage``
    runs on the consumer's thread, and its exceptions propagate at the
    consuming ``__next__``.
    """

    def __init__(self, source, stage, depth: int = 2):
        self._source = iter(source)
        self._stage = stage
        self._depth = max(1, depth)
        self._staged: list = []
        self._exhausted = False

    def _report_occupancy(self) -> None:
        n = len(self._staged)
        _metrics.gauge("rs_staging_ring_occupancy", "segments staged on-device ahead of the consumer").set(n)
        # The watermark across every ring of the process; it moves only
        # with metrics on, so a disabled run cannot hide a later gauge.
        if _metrics.enabled() and n > _RING_PEAK[0]:
            _RING_PEAK[0] = n
            _metrics.gauge("rs_staging_ring_occupancy_peak",
                           "process-wide high watermark of staged segments ahead of the consumer").set(n)
        _tracing.counter("staging_ring_occupancy", staged=n)

    def _fill(self) -> None:
        while not self._exhausted and len(self._staged) < self._depth:
            try:
                tag, host = next(self._source)
            except StopIteration:
                self._exhausted = True
                return
            self._staged.append((tag, self._stage(tag, host)))

    def __iter__(self):
        return self

    def __next__(self):
        self._fill()
        if not self._staged:
            raise StopIteration
        tag, staged = self._staged.pop(0)
        self._fill()  # issue the next H2D before handing this segment out
        self._report_occupancy()  # one sample a segment handed out
        return tag, staged


class SegmentPrefetcher:
    """Produces segments on a worker thread into a bounded queue.

    ``segments``: (off, cols) tags, produced in order by ``produce(off,
    cols)`` on the worker (which must be safe against the consumer's work:
    preads of distinct offsets are).  ``depth`` bounds produced but
    unconsumed segments.  Iterating yields ``((off, cols), produced)`` in
    order; a ``produce`` exception re-raises at the consuming ``__next__``.
    Must be used as a context manager; leaving the context early stops the
    worker, which checks a stop flag before each segment and puts with a
    timeout.
    """

    _STOP = object()

    def __init__(self, segments: Iterable[tuple[int, int]], produce: Callable[[int, int], Any], depth: int = 2):
        self._segments = list(segments)
        self._produce = produce
        self._q: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._started = False
        self._thread = threading.Thread(target=self._run, name="rs-segment-prefetch", daemon=True)

    def _run(self) -> None:
        try:
            for off, cols in self._segments:
                if self._stop.is_set():
                    return
                if not self._put(((off, cols), self._produce(off, cols))):
                    return
            self._put((self._STOP, None))
        except BaseException as e:  # noqa: BLE001 - relayed to the consumer
            self._put((self._STOP, e))

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self):
        return self

    def __next__(self):
        if not self._started:
            raise RuntimeError("SegmentPrefetcher must be used as a context manager "
                               "(worker thread not started; iterate inside 'with')")
        tag, item = self._q.get()
        if tag is self._STOP:
            self._stop.set()
            if item is not None:
                raise item
            raise StopIteration
        return tag, item

    def __enter__(self):
        self._thread.start()
        self._started = True
        return self

    def __exit__(self, exc_type, exc, tb):
        self._stop.set()
        try:  # unblock a worker waiting to put
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=30)
        return False


def _return_slots(slots: set, h2d, compute) -> None:
    if not slots:
        return
    h2d.wait_stream(compute)
    done = torch.cuda.Event()
    done.record(h2d)
    for slot in list(slots):
        _plan.STAGING.release(slot, done)
    slots.clear()


class StreamLoop:
    """The streams, events and host buffers of one file operation's
    segment loop on ``device``, for segments of ``rows`` x at most
    ``seg_cols`` bytes.

    The three pipeline classes call it from their own threads:

    * :meth:`host_segment` (prefetch thread): a (rows, cols) uint8 host
      buffer to read a segment into, with its slot.  On CUDA the slot is
      one of ``depth + 2`` pinned buffers: the prefetcher's queue
      (``depth``), the segment being staged and the one being read, so a
      slot is always free; the call waits only for the event of the H2D
      copy that last read the slot.
    * :meth:`stage` (dispatch thread, in :class:`DeviceStagingRing`):
      issues the H2D copy on the H2D stream into a device buffer, records
      the slot's event and returns the slot to the ring.
    * :meth:`dispatch` (dispatch thread): runs ``fn`` on the staged
      segment on the compute stream, after the H2D event, then issues the
      D2H copy of its output on the D2H stream into a fresh pinned buffer
      (PyTorch's pinned-memory cache reuses a freed one only after the copy
      that used it), and returns a handle with that copy's event.
      ``record_stream`` keeps the device buffers from being reused while
      another stream still reads them.
    * :meth:`result` (writer thread): waits for the handle's event and
      returns the output's bytes.  It issues no copy: a copy from this
      thread would run on its own default stream.

    On the CPU: fresh NumPy buffers, ``torch.from_numpy`` staging, ``fn``
    run at dispatch, and its output's bytes as the result.

    ``hold=True``: :meth:`stage` keeps the slot taken until
    :meth:`release`, for a segment whose host bytes a drain still reads
    after its H2D copy (the interleaved encode writes its natives from the
    slot).  The ring then also covers the staging ring and the window, and
    :meth:`host_segment` waits for a release; :meth:`close` ends such a
    wait.

    While the plan layer is on (:func:`..plan.enabled`, ``RS_PLAN``),
    :meth:`stage` pads each segment to its bucket
    (:func:`..plan.bucket_cols` under the cap ``seg_cols // sym``) and
    returns a :class:`..plan.StagedSegment`, so the dispatch goes through
    a cached plan and is trimmed back.  On CUDA the H2D copy lands in a
    buffer of :data:`..plan.STAGING` (a ragged tail through a device-side
    pad), which the plan's graphs read; the buffer goes back to the pool
    with the event of the D2H copy of the dispatch's output, and its next
    H2D copy waits for that event.  ``bucketed=False`` (a mesh codec's
    loop, whose dispatch pads to the mesh instead) stages exact widths
    whatever the plan layer says, as the JAX package's mesh stages pass
    through.
    """

    def __init__(self, device: torch.device, rows: int, seg_cols: int, depth: int, hold: bool = False,
                 bucketed: bool = True):
        self.device = device
        self.rows = rows
        self.seg_cols = seg_cols
        self.hold = hold
        self.bucketed = bucketed
        self.cuda = device.type == "cuda"
        self._closed = False
        if not self.cuda:
            return
        self.h2d = torch.cuda.Stream(device)
        self.compute = torch.cuda.Stream(device)
        self.d2h = torch.cuda.Stream(device)
        # Held slots sit in the prefetch queue, the staging ring and the
        # window (depth each, one more in hand in the last two) and on the
        # writer lane, whose drains release them; one slot past the first
        # three means a waiting prefetch always has a drain to wait for.
        slots = max(1, depth) * 3 + 3 if hold else max(1, depth) + 2
        self._bufs = [torch.empty(rows * seg_cols, dtype=torch.uint8, pin_memory=True) for _ in range(slots)]
        self._events: list[torch.cuda.Event | None] = [None] * slots
        # Staging buffers staged and not yet handed back (a segment staged
        # ahead of a failed dispatch): the pool gets them back when the loop
        # is collected, once both streams' work so far is done.
        self._staged_slots: set = set()
        weakref.finalize(self, _return_slots, self._staged_slots, self.h2d, self.compute).atexit = False
        self._free: queue.Queue = queue.Queue()
        for slot in range(slots):
            self._free.put(slot)

    def _host_view(self, slot: int, cols: int) -> torch.Tensor:
        return self._bufs[slot][: self.rows * cols].view(self.rows, cols)

    def _take(self) -> int:
        if not self.hold:
            try:
                return self._free.get_nowait()
            except queue.Empty:
                raise RuntimeError("no free pinned buffer: the prefetcher runs deeper than the StreamLoop's depth") from None
        while not self._closed:
            try:
                return self._free.get(timeout=0.1)
            except queue.Empty:
                continue
        raise RuntimeError("the StreamLoop was closed while a segment waited for a pinned buffer")

    def host_segment(self, cols: int) -> tuple[int | None, np.ndarray]:
        if not self.cuda:
            return None, np.empty((self.rows, cols), dtype=np.uint8)
        slot = self._take()
        event = self._events[slot]
        if event is not None:
            event.synchronize()
        return slot, self._host_view(slot, cols).numpy()

    def stage(self, segment: tuple[int | None, np.ndarray], sym: int):
        """(slot, (rows, cols) bytes) -> the segment as (rows, cols/sym)
        symbols where the dispatch reads it (bucket-padded in a
        :class:`..plan.StagedSegment` while the plan layer is on, under an
        ``h2d_stage`` span and counted as staged for the plan)."""
        host = segment[1]
        cols = host.shape[1]
        cap = bucket = None
        if self.bucketed and _plan.enabled():
            cap = self.seg_cols // sym
            bucket = _plan.bucket_cols(cols // sym, cap) * sym
        _metrics.counter("rs_io_h2d_bytes_total", "segment bytes entering the H2D stage of the pipeline").labels(
            path="passthrough" if bucket is None else "plan").inc(host.nbytes)
        if bucket is None:
            return self._copy(segment, sym, None, None)
        t0 = time.monotonic()
        with _tracing.span("h2d_stage", lane="stage", cols=cols // sym, bucket=bucket // sym):
            staged = self._copy(segment, sym, cap, bucket)
        _plan.note_staged(time.monotonic() - t0, self.rows * bucket)
        return staged

    def _copy(self, segment: tuple[int | None, np.ndarray], sym: int, cap: int | None, bucket: int | None):
        global PINNED_STAGES
        slot, host = segment
        cols = host.shape[1]
        if not self.cuda:
            t = torch.from_numpy(host if bucket is None else _plan.pad_host(host, bucket))
            t = t.view(torch.uint16) if sym == 2 else t
            return t if bucket is None else _plan.StagedSegment(t, cols // sym, cap)
        src = self._host_view(slot, cols)
        dslot = None
        with torch.cuda.stream(self.h2d):
            if bucket is None:
                dev = torch.empty(src.shape, dtype=torch.uint8, device=self.device)
                dev.copy_(src, non_blocking=True)
            else:
                dslot = _plan.STAGING.acquire(self.device, self.rows * bucket)
                self._staged_slots.add(dslot)
                if dslot.ready is not None:
                    self.h2d.wait_event(dslot.ready)
                dev = dslot.tensor.view(self.rows, bucket)
                if bucket == cols:
                    dev.copy_(src, non_blocking=True)
                else:
                    # A ragged tail: the pinned rows are (rows, cols), the
                    # bucket wider; pad on the device.
                    tail = torch.empty(src.shape, dtype=torch.uint8, device=self.device)
                    tail.copy_(src, non_blocking=True)
                    dev[:, :cols].copy_(tail)
                    dev[:, cols:].zero_()
            event = torch.cuda.Event()
            event.record(self.h2d)
        self._events[slot] = event
        if not self.hold:
            self._free.put(slot)
        PINNED_STAGES += 1
        data = dev.view(torch.uint16) if sym == 2 else dev
        if dslot is not None:
            data = _plan.StagedSegment(data, cols // sym, cap, slot=dslot)
        return data, event

    def stage_copy(self, arr: np.ndarray, sym: int, rows=None):
        """Copy host bytes ``arr`` (or its ``rows``) into a free slot and
        stage it: for a segment the caller keeps and reuses (the locate
        loop corrects its own copy in place; the update keeps its delta)."""
        slot, dst = self.host_segment(arr.shape[1])
        if rows is None:
            dst[...] = arr
        else:
            np.take(arr, rows, axis=0, out=dst)
        return self.stage((slot, dst), sym)

    def release(self, slot: int | None) -> None:
        """Return a held slot (``hold=True``) once its host bytes are used."""
        if self.cuda and self.hold and slot is not None:
            self._free.put(slot)

    def close(self) -> None:
        """End any wait in :meth:`host_segment` (the loop's stream is over)."""
        self._closed = True

    def dispatch(self, fn: Callable[[torch.Tensor], torch.Tensor], staged):
        if not self.cuda:
            return fn(staged)
        data, h2d_done = staged
        self.compute.wait_event(h2d_done)
        if isinstance(data, _plan.StagedSegment):
            # A pool buffer: never freed, handed back after the D2H copy.
            return self._compute(lambda: fn(data), release=data.slot)
        data.record_stream(self.compute)
        return self._compute(lambda: fn(data))

    def dispatch_resident(self, fn: Callable[[], torch.Tensor]):
        """:meth:`dispatch` of ``fn()``, which reads only what earlier
        dispatches of this loop left on the device (the locate decode's
        packed planes): no staging, and stream order on the compute stream
        is the only wait."""
        if not self.cuda:
            return fn()
        return self._compute(fn)

    def _compute(self, thunk: Callable[[], torch.Tensor], release=None):
        global STREAM_DISPATCHES
        with torch.cuda.stream(self.compute):
            out = thunk()
            computed = torch.cuda.Event()
            computed.record(self.compute)
        STREAM_DISPATCHES += 1
        out = out.view(torch.uint8)  # the copy moves bytes, whatever the symbol width
        self.d2h.wait_event(computed)
        with torch.cuda.stream(self.d2h):
            host = torch.empty(out.shape, dtype=torch.uint8, pin_memory=True)
            host.copy_(out, non_blocking=True)
            out.record_stream(self.d2h)
            copied = torch.cuda.Event()
            copied.record(self.d2h)
        if release is not None:
            # The staging buffer (and the output of the graph that read it)
            # may be overwritten once this copy is done.
            self._staged_slots.discard(release)
            _plan.STAGING.release(release, copied)
        return host, copied

    def result(self, handle) -> np.ndarray:
        if not self.cuda:
            return np.ascontiguousarray(handle.view(torch.uint8).numpy())
        host, copied = handle
        copied.synchronize()
        return host.numpy()
