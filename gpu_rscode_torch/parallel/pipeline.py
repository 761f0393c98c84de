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
from collections.abc import Callable, Iterable
from typing import Any

import numpy as np
import torch

# Segments staged from pinned memory through the H2D stream, and dispatches
# launched on the compute stream, since the counts were last reset.  Only
# StreamLoop.stage and StreamLoop.dispatch add to them, on the dispatch
# thread.
PINNED_STAGES = 0
STREAM_DISPATCHES = 0


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

    def _drain_oldest(self) -> None:
        tag, result = self._pending.pop(0)
        if self.executor is not None:
            self.executor.submit(lambda: self.consume(tag, result))
        else:
            self.consume(tag, result)

    def push(self, tag: Any, result: Any) -> None:
        self._pending.append((tag, result))
        while len(self._pending) > self.depth:
            self._drain_oldest()

    def flush(self) -> None:
        while self._pending:
            self._drain_oldest()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.flush()
        else:
            self._pending.clear()
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
    """

    def __init__(self, device: torch.device, rows: int, seg_cols: int, depth: int):
        self.device = device
        self.rows = rows
        self.cuda = device.type == "cuda"
        if not self.cuda:
            return
        self.h2d = torch.cuda.Stream(device)
        self.compute = torch.cuda.Stream(device)
        self.d2h = torch.cuda.Stream(device)
        slots = max(1, depth) + 2
        self._bufs = [torch.empty(rows * seg_cols, dtype=torch.uint8, pin_memory=True) for _ in range(slots)]
        self._events: list[torch.cuda.Event | None] = [None] * slots
        self._free: queue.Queue = queue.Queue()
        for slot in range(slots):
            self._free.put(slot)

    def _host_view(self, slot: int, cols: int) -> torch.Tensor:
        return self._bufs[slot][: self.rows * cols].view(self.rows, cols)

    def host_segment(self, cols: int) -> tuple[int | None, np.ndarray]:
        if not self.cuda:
            return None, np.empty((self.rows, cols), dtype=np.uint8)
        try:
            slot = self._free.get_nowait()
        except queue.Empty:
            raise RuntimeError("no free pinned buffer: the prefetcher runs deeper than the StreamLoop's depth") from None
        event = self._events[slot]
        if event is not None:
            event.synchronize()
        return slot, self._host_view(slot, cols).numpy()

    def stage(self, segment: tuple[int | None, np.ndarray], sym: int):
        """(slot, (rows, cols) bytes) -> the segment as (rows, cols/sym)
        symbols where the dispatch reads it."""
        global PINNED_STAGES
        slot, host = segment
        if not self.cuda:
            t = torch.from_numpy(host)
            return t.view(torch.uint16) if sym == 2 else t
        src = self._host_view(slot, host.shape[1])
        with torch.cuda.stream(self.h2d):
            dev = torch.empty(src.shape, dtype=torch.uint8, device=self.device)
            dev.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self.h2d)
        self._events[slot] = event
        self._free.put(slot)
        PINNED_STAGES += 1
        return (dev.view(torch.uint16) if sym == 2 else dev), event

    def dispatch(self, fn: Callable[[torch.Tensor], torch.Tensor], staged):
        global STREAM_DISPATCHES
        if not self.cuda:
            return fn(staged)
        data, h2d_done = staged
        self.compute.wait_event(h2d_done)
        with torch.cuda.stream(self.compute):
            data.record_stream(self.compute)
            out = fn(data)
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
        return host, copied

    def result(self, handle) -> np.ndarray:
        if not self.cuda:
            return handle.view(torch.uint8).numpy()
        host, copied = handle
        copied.synchronize()
        return host.numpy()
