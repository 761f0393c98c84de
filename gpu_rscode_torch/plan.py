"""Shape-bucketed execution plans replayed from CUDA graphs: the dispatch
layer of the segment loops, the counterpart of the JAX package's
``plan.py``.

Every GEMM of the codec (encode, decode, syndrome, repair, E·Δ) goes
through :func:`dispatch` while the layer is on.  What it removes from the
segment loop is the host's cost per launch: the xor and ring dispatches
are chains of hundreds of small device ops, and K1's wrapper does tens of
microseconds of host work a call.

* **Shape bucketing**: a segment's column count is rounded up a ladder of
  powers of two of a 128-column floor, capped at the full segment width
  (:func:`bucket_cols`, the JAX package's ladder), so a file's segment
  loop meets at most O(log(seg_cols/128)) shapes per (k, n, w, strategy).
  The pad columns are zeros; GF linearity makes their output zeros, and
  the result is trimmed back to the true width.
* **A bounded, thread-safe plan cache** (:class:`PlanCache`, LRU bound
  ``RS_PLAN_CACHE_SIZE``) keyed on (strategy, w, matrix shape and type,
  bucket, data type, target), with the matrix digest added for xor and
  ring, whose schedule depends on the values.  Hit, miss and eviction
  counts match the JAX package's for the same key sequence.
  :meth:`PlanCache.clear` also drops the xor/ring pipelines, the staging
  pool and the api's survivor-subset cache.
* **CUDA graphs**, the counterpart of the JAX package's AOT executables:
  on the card a plan captures its dispatch (K1, or the xor / ring chain)
  into a ``torch.cuda.CUDAGraph`` and replays it.  A graph reads and
  writes the addresses it was captured with, and K1's graph bakes in the
  device operator of its coefficient matrix, which the plan key (the JAX
  package's, where the matrix is an argument) does not name.  So a plan
  keeps one graph a (staging buffer, matrix digest) pair (at most
  :data:`MAX_GRAPHS_PER_PLAN`, LRU): the segment
  loops stage into the persistent buffers of :data:`STAGING`, and a
  buffer goes back to the pool only with the event of the D2H copy that
  read the dispatch's output, so neither the next H2D copy into it nor the
  next replay of its graph can overwrite bytes still being read.  The
  first dispatch of a buffer runs eagerly (its result is returned, and it
  warms the operator caches), then the graph is captured on a side stream;
  the plan holds the device operators the capture read.  The strategies
  captured are :data:`GRAPH_STRATEGIES` (``cuda``, ``xor``, ``ring``);
  what is not staged (a direct call, a packed operand whose planes were
  made by an eager pack) and the plain strategies run eagerly through the
  plan.  On the CPU a plan's
  executable is the strategy's function, and the ladder, the padding, the
  trim and the counters work the same way.  The JAX package's buffer
  donation (``RS_PLAN_DONATE``) has no counterpart: a plan owns its static
  buffers.
* **Counts under replay**: a replay runs no Python, so the plan adds what
  the captured call would have counted: K1 launches to
  ``cuda_gemm.REPLAYED`` (captured launches count in
  ``cuda_gemm.CAPTURED``, eager ones in ``cuda_gemm.LAUNCHES``), and the
  xor / ring pipelines' ``calls`` and ``PACK_REUSE``.

Strategies: ``cuda`` (K1), ``bitplane``, ``table``, ``xor``, ``ring`` and
``cpu`` (the native host codec, never on the card).  The mesh dispatch
waits for the port's mesh.

Env knobs (read per call): ``RS_PLAN=0`` turns the layer off (the codec
calls each strategy's function directly and the loops stage exact
widths), ``RS_PLAN_MIN_BUCKET`` (ladder floor, default 128) and
``RS_PLAN_CACHE_SIZE`` (default 64).
"""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from .ops import _build
from .ops import cuda_gemm as _cuda_gemm
from .ops import xor_gemm as _xor_gemm

# Graphs a plan keeps (one per staging buffer and coefficient matrix it
# was dispatched on).
MAX_GRAPHS_PER_PLAN = 16
# Strategies captured into graphs on the card.  bitplane and table copy
# their operators from host arrays at each call, which a capture refuses:
# they run eagerly through their plans.
GRAPH_STRATEGIES = ("cuda", "xor", "ring")


def enabled() -> bool:
    """Whether the plan layer is on (RS_PLAN=0/false/off/no turns it off)."""
    return os.environ.get("RS_PLAN", "1").lower() not in ("0", "false", "off", "no")


def _min_bucket() -> int:
    try:
        v = int(os.environ.get("RS_PLAN_MIN_BUCKET", "128"))
        return v if v > 0 else 128
    except ValueError:
        return 128


def bucket_cols(m: int, cap: int | None = None) -> int:
    """Round a segment column count up the bucket ladder.

    ``cap`` is the plan's widest width (the full segment): the ladder is
    ``min_bucket * 2^j`` capped there.  ``cap=None`` keeps the exact width
    (direct callers pay no pad), and widths at or above the cap pass
    through unchanged.
    """
    if cap is None or m >= cap or m <= 0:
        return m
    b = _min_bucket()
    while b < m:
        b <<= 1
    return min(b, cap)


# -- staging -----------------------------------------------------------------


class _Slot:
    """One persistent device staging buffer and the event after which it
    may be written again."""

    __slots__ = ("tensor", "ready", "free")

    def __init__(self, tensor: torch.Tensor):
        self.tensor = tensor
        self.ready: torch.cuda.Event | None = None
        self.free = False


class StagingPool:
    """Device buffers the segment loops stage into, kept across operations
    so a plan's graphs replay on the same addresses in every file operation.

    :meth:`acquire` hands out the first free buffer of a size (the same
    buffers, in the same order, each time); :meth:`release` takes it back
    with the event after which it may be overwritten.  A buffer is held
    from its H2D copy until the D2H copy of the dispatch that read it was
    issued, so two loops never share one.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._slots: dict[tuple, list[_Slot]] = {}

    def acquire(self, device: torch.device, nbytes: int) -> _Slot:
        key = (str(device), int(nbytes))
        with self._lock:
            slots = self._slots.setdefault(key, [])
            for slot in slots:
                if slot.free:
                    slot.free = False
                    return slot
            slot = _Slot(torch.empty(nbytes, dtype=torch.uint8, device=device))
            slots.append(slot)
            return slot

    def release(self, slot: _Slot, event) -> None:
        with self._lock:
            slot.ready = event
            slot.free = True

    def stats(self) -> dict:
        with self._lock:
            slots = [s for group in self._slots.values() for s in group]
        return {"buffers": len(slots), "bytes": sum(s.tensor.numel() for s in slots),
                "in_use": sum(not s.free for s in slots)}

    def clear(self) -> None:
        with self._lock:
            self._slots.clear()


STAGING = StagingPool()


class StagedSegment:
    """A segment staged for one dispatch: ``array`` is the (rows, bucket)
    symbol tensor where the dispatch reads it, ``cols`` its true width and
    ``cap`` the ladder cap it was bucketed under.  ``slot`` is the
    :data:`STAGING` buffer under ``array`` on the card (None elsewhere):
    the loop hands it back after the dispatch's output was copied out, and
    a plan keys its graphs on it."""

    __slots__ = ("array", "cols", "cap", "slot")

    def __init__(self, array, cols: int, cap: int | None, slot: _Slot | None = None):
        self.array = array
        self.cols = int(cols)
        self.cap = cap
        self.slot = slot

    @property
    def shape(self):
        return self.array.shape


def pad_host(B: np.ndarray, bucket: int) -> np.ndarray:
    """``B`` with zero columns appended up to ``bucket``."""
    if B.shape[1] == bucket:
        return B
    padded = np.zeros((B.shape[0], bucket), dtype=B.dtype)
    padded[:, : B.shape[1]] = B
    return padded


def stage_segment(B: np.ndarray, cap: int | None, device) -> StagedSegment:
    """Pad a host (rows, cols) symbol segment to its bucket and copy it to
    ``device`` on the current stream, for a caller outside the segment
    loops (``api.warm_plan``).  On the card it lands in a :data:`STAGING`
    buffer, which the caller hands back with :func:`release` once it read
    the dispatch's output."""
    from .ops.gemm import to_tensor

    host = to_tensor(pad_host(B, bucket_cols(B.shape[1], cap)))
    device = torch.device(device)
    if device.type != "cuda":
        return StagedSegment(host.to(device), B.shape[1], cap)
    slot = STAGING.acquire(device, host.numel() * host.element_size())
    if slot.ready is not None:
        torch.cuda.current_stream(device).wait_event(slot.ready)
    arr = slot.tensor.view(host.dtype).view(host.shape)
    arr.copy_(host)
    return StagedSegment(arr, B.shape[1], cap, slot=slot)


def release(staged: StagedSegment) -> None:
    """Hand a :func:`stage_segment` buffer back after the caller's work on
    the current stream (the dispatch and the read of its output)."""
    if staged.slot is not None:
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(staged.array.device))
        STAGING.release(staged.slot, done)


def _pad_to(B, bucket: int):
    m = B.shape[1]
    if m == bucket:
        return B
    if isinstance(B, np.ndarray):
        return pad_host(B, bucket)
    padded = torch.zeros((B.shape[0], bucket), dtype=B.dtype, device=B.device)
    padded[:, :m] = B
    return padded


# -- the strategies' functions -------------------------------------------------


def _cpu_gemm(A, B) -> torch.Tensor:
    from . import native
    from .ops.gemm import to_numpy

    Bh = B if isinstance(B, np.ndarray) else to_numpy(B)
    return torch.from_numpy(native.gemm(np.asarray(A, dtype=np.uint8), Bh))


def eager(strategy: str, A, B, w: int):
    """``C = A . B`` through ``strategy``'s own function, no plan: what the
    codec runs with the layer off.  ``B`` is a (k, m) tensor (a host one
    for ``cpu``) or, for xor and ring, a packed operand."""
    from .ops import gemm as _gemm

    if strategy == "xor":
        from .ops.xor_gemm import gf_matmul_xor

        return gf_matmul_xor(A, B, w)
    if strategy == "ring":
        from .ops.ring_gemm import gf_matmul_ring

        return gf_matmul_ring(A, B, w)
    if strategy == "cuda":
        from .ops.cuda_gemm import gf_matmul_cuda

        return gf_matmul_cuda(A, B.contiguous(), w)
    if strategy == "cpu":
        return _cpu_gemm(A, B)
    if strategy == "table":
        return _gemm.gf_matmul_table(A, B, w)
    if strategy == "bitplane":
        return _gemm.gf_matmul_bitplane(A, B, w)
    raise ValueError(f"unknown strategy {strategy!r}")


def _np_dtype(B) -> np.dtype:
    if isinstance(B, (np.ndarray, _xor_gemm.PackedOperand)):
        return np.dtype(B.dtype)
    return np.dtype(np.uint16) if B.dtype == torch.uint16 else np.dtype(np.uint8)


_HOST = torch.device("cpu")


def _device_of(B) -> torch.device:
    return _HOST if isinstance(B, np.ndarray) else B.device


# -- graphs ------------------------------------------------------------------


_SIDE_STREAMS: dict[str, torch.cuda.Stream] = {}
# One capture at a time: every capture runs on its device's one side
# stream, and plans capture under their own locks.
_CAPTURE_LOCK = threading.Lock()


def _side_stream(device: torch.device) -> torch.cuda.Stream:
    # A stream of its own priority class: PyTorch hands out default-priority
    # streams round-robin from a pool of 32, so after 32 StreamLoops the
    # capture stream would also be some loop's H2D, compute or D2H stream,
    # and another thread's copy or event record on it while this thread
    # captures joins the capture (the pinned allocator's event queries then
    # fail with "invalid argument").  No StreamLoop asks for this priority.
    key = str(device)
    stream = _SIDE_STREAMS.get(key)
    if stream is None:
        stream = _SIDE_STREAMS[key] = torch.cuda.Stream(device, priority=-1)
    return stream


def _python_counts(pipe) -> tuple:
    """The Python-side counts one dispatch adds to: K1 launches made under
    capture, the xor pack counts, and the pipeline's calls."""
    return (_cuda_gemm.CAPTURED, _xor_gemm.PACK_REUSE["packed"], _xor_gemm.PACK_REUSE["reused"],
            pipe.calls if pipe is not None else 0)


class _Graph:
    """A captured dispatch: the graph, its static output, the device
    operators its kernels read, and what one replay adds to the counts."""

    __slots__ = ("graph", "out", "operators", "counts")

    def __init__(self, graph, out, operators, counts):
        self.graph = graph
        self.out = out
        self.operators = operators
        self.counts = counts

    def replay(self, pipe) -> torch.Tensor:
        self.graph.replay()
        k1, packed, reused, calls = self.counts
        with _cuda_gemm.COUNT_LOCK:
            _cuda_gemm.REPLAYED += k1
        _xor_gemm.PACK_REUSE["packed"] += packed
        _xor_gemm.PACK_REUSE["reused"] += reused
        if pipe is not None:
            pipe.calls += calls
        return self.out


def _capture(fn, A, B: torch.Tensor, pipe) -> _Graph:
    """Capture ``fn(A, B)`` on a side stream into a CUDA graph.  The counts
    the captured Python added are taken back (nothing ran) and kept as what
    a replay adds; a capture error raises after the capture is ended."""
    graph = torch.cuda.CUDAGraph()
    current = torch.cuda.current_stream(B.device)
    side = _side_stream(B.device)
    side.wait_stream(current)
    # The counts are read and restored under the capture lock, so a
    # concurrent capture on another thread cannot fall between them.
    with _CAPTURE_LOCK:
        before = _python_counts(pipe)
        with torch.cuda.stream(side), _build.collect_operators() as operators:
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                out = fn(A, B)
            except BaseException:
                try:
                    graph.capture_end()
                except RuntimeError:
                    pass  # the capture is void already; the error above is the one to raise
                raise
            graph.capture_end()
        after = _python_counts(pipe)
        _xor_gemm.PACK_REUSE["packed"], _xor_gemm.PACK_REUSE["reused"] = before[1], before[2]
        if pipe is not None:
            pipe.calls = before[3]
    current.wait_stream(side)
    return _Graph(graph, out, operators, tuple(a - b for a, b in zip(after, before)))


# -- plans -------------------------------------------------------------------


class ExecutionPlan:
    """One cached dispatch class: a (strategy, shapes, bucket, target)
    combination, its built function (the xor / ring pipeline, or the
    strategy's GEMM) and, on the card, its graphs."""

    __slots__ = ("key", "strategy", "w", "bucket", "calls", "captures", "replays", "compile_seconds",
                 "capture_seconds", "xor_stats", "_fn", "_pipe", "_graphs", "_lock")

    def __init__(self, key, strategy, w, bucket):
        self.key = key
        self.strategy = strategy
        self.w = w
        self.bucket = bucket
        self.calls = 0
        self.captures = 0
        self.replays = 0
        self.compile_seconds = 0.0  # building the function (schedules, optimizer)
        self.capture_seconds = 0.0  # capturing and instantiating graphs
        self.xor_stats = None  # xor / ring plans: the pipeline's description
        self._fn = None
        self._pipe = None
        self._graphs: OrderedDict = OrderedDict()
        self._lock = threading.Lock()  # serializes this plan's builds and captures

    def _build(self, A, B) -> None:
        t0 = time.perf_counter()
        strategy, w = self.strategy, self.w
        if strategy in ("xor", "ring"):
            from .ops import ring_gemm, xor_gemm

            get = xor_gemm.get_pipeline if strategy == "xor" else ring_gemm.get_ring_pipeline
            cols = B.cols if isinstance(B, xor_gemm.PackedOperand) else B.shape[1]
            rows = B.rows if isinstance(B, xor_gemm.PackedOperand) else B.shape[0]
            pipe = get(np.asarray(A), (rows, cols), _np_dtype(B), w, _device_of(B).type)
            self._pipe = pipe
            self._fn = pipe
            self.xor_stats = pipe.describe()
        else:
            self._fn = lambda a, b: eager(strategy, a, b, w)
        self.compile_seconds += time.perf_counter() - t0

    def run(self, A, B, graph: str | None = None):
        """``fn(A, B)``; with ``graph`` (the matrix digest, when ``B`` is a
        staged CUDA buffer), the replay of the graph of this buffer and
        matrix, captured after their first dispatch."""
        with self._lock:
            if self._fn is None:
                self._build(A, B)
            self.calls += 1
            if not graph:
                fn = self._fn
            else:
                vkey = (B.data_ptr(), tuple(B.shape), B.dtype, graph)
                g = self._graphs.get(vkey)
                if g is None:
                    out = self._fn(A, B)  # this dispatch's result, and the warm-up
                    t0 = time.perf_counter()
                    self._graphs[vkey] = _capture(self._fn, A, B, self._pipe)
                    self.capture_seconds += time.perf_counter() - t0
                    self.captures += 1
                    while len(self._graphs) > MAX_GRAPHS_PER_PLAN:
                        self._graphs.popitem(last=False)
                    return out
                self._graphs.move_to_end(vkey)
                self.replays += 1
                return g.replay(self._pipe)
        return fn(A, B)

    def describe(self) -> dict:
        with self._lock:
            out = {
                "strategy": self.strategy,
                "w": self.w,
                "bucket": self.bucket,
                "a_shape": list(self.key[2]),
                "b_dtype": self.key[5],
                "target": self.key[6][1],
                "graphs": len(self._graphs),
                "calls": self.calls,
                "captures": self.captures,
                "replays": self.replays,
                "compile_seconds": self.compile_seconds,
                "capture_seconds": self.capture_seconds,
            }
        if self.xor_stats is not None:
            out[self.strategy] = self.xor_stats
        return out


class PlanCache:
    """Bounded, thread-safe LRU of :class:`ExecutionPlan`.

    The cache lock covers lookup and eviction; each plan's own lock covers
    its builds and captures, so a slow capture of one class never blocks
    dispatches of another.
    """

    def __init__(self, max_size: int | None = None, name: str = "local"):
        self._lock = threading.RLock()
        self._plans: OrderedDict = OrderedDict()
        self._max_size = max_size
        self.name = name
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def _bound(self) -> int:
        if self._max_size is not None:
            return self._max_size
        try:
            v = int(os.environ.get("RS_PLAN_CACHE_SIZE", "64"))
            return v if v > 0 else 64
        except ValueError:
            return 64

    def lookup(self, key, strategy, w, bucket) -> ExecutionPlan:
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self.hits += 1
                self._plans.move_to_end(key)
                return plan
            self.misses += 1
            plan = ExecutionPlan(key, strategy, w, bucket)
            self._plans[key] = plan
            while len(self._plans) > self._bound():
                self._plans.popitem(last=False)
                self.evictions += 1
            return plan

    def drop(self, strategies) -> None:
        """Drop the plans of ``strategies`` (no count changes)."""
        with self._lock:
            for key in [key for key, plan in self._plans.items() if plan.strategy in strategies]:
                del self._plans[key]

    def clear(self) -> None:
        """Drop every plan and its graphs, the xor / ring pipelines and
        schedules, the staging pool and the api's survivor-subset cache
        (whose pinned inverses' schedules lived in the caches dropped here;
        the store's records survive and are re-validated when read)."""
        with self._lock:
            self._plans.clear()
            self.hits = self.misses = self.evictions = 0
        from .api import clear_subset_cache
        from .ops.xor_gemm import clear_pipeline_cache

        clear_pipeline_cache()
        STAGING.clear()
        clear_subset_cache()

    def stats(self) -> dict:
        with self._lock:
            plans = list(self._plans.values())
            out = {
                "enabled": enabled(),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "executables": len(plans),
                "max_size": self._bound(),
            }
        out["plans"] = [p.describe() for p in plans]
        for field in ("calls", "captures", "replays", "compile_seconds", "capture_seconds"):
            out[field] = sum(p[field] for p in out["plans"])
        out["staging"] = STAGING.stats()
        return out


PLAN_CACHE = PlanCache(name="local")


def _drop_schedule_plans() -> None:
    # The xor / ring plans hold the pipelines (and their call counts) the
    # pipeline cache just dropped: they go stale together.
    PLAN_CACHE.drop(("xor", "ring"))


_xor_gemm.register_clear_hook(_drop_schedule_plans)


def dispatch(A, B, *, w: int, strategy: str, cap: int | None = None, cols: int | None = None):
    """Plan-cached GEMM dispatch on one device.

    ``A`` (p, k) coefficients; ``B`` the (k, m) data: a tensor (a host
    array for ``cpu``), a :class:`StagedSegment` (already padded to its
    bucket), or for xor and ring a :class:`.ops.xor_gemm.PackedOperand`;
    the last two carry the defaults of ``cap`` and ``cols`` (the true
    width).  Pads to
    the bucket, runs the cached plan (a graph replay for a staged CUDA
    buffer) and trims the result back to the true width.  A staged
    dispatch's result on the card may be the graph's static output: valid
    until the staging buffer is handed back and dispatched again.
    """
    PackedOperand = _xor_gemm.PackedOperand
    staged = isinstance(B, StagedSegment)
    if staged:
        cap = B.cap if cap is None else cap
        cols = B.cols if cols is None else cols
        arr = B.array
    else:
        arr = B
    A = np.asarray(A)
    packed = isinstance(arr, PackedOperand)
    if packed:
        cap = arr.cap if cap is None else cap
        cols = arr.cols_true if cols is None else cols
    width = arr.cols if packed else arr.shape[1]
    m = cols if cols is not None else width
    bucket = max(bucket_cols(m, cap), width)
    device = arr.device if not isinstance(arr, np.ndarray) else _HOST
    graph = staged and B.slot is not None and strategy in GRAPH_STRATEGIES and not packed
    digest = _xor_gemm.matrix_digest(A, w) if graph or strategy in ("xor", "ring") else None
    # The target is ("local", device type); the mesh's fingerprint joins it
    # with the port's mesh.
    key = (strategy, w, A.shape, A.dtype.name, bucket, _np_dtype(arr).name, ("local", device.type))
    if strategy in ("xor", "ring"):
        # The schedule depends on the coefficient values: the key carries
        # the matrix digest, and the bucket rounds up to the pipeline's
        # 32-symbol alignment (only ragged caps need it).
        bucket = max(bucket, _xor_gemm.padded_cols(bucket))
        key = key[:4] + (bucket,) + key[5:] + (digest,)
        if packed and arr.cols != bucket:
            raise ValueError(f"packed operand cols {arr.cols} does not match the plan bucket {bucket}: pack after "
                             "staging, with the same cap")
    elif packed:
        raise ValueError("packed operands require strategy='xor' or 'ring'")
    plan = PLAN_CACHE.lookup(key, strategy, w, bucket)
    if not packed:
        arr = _pad_to(arr, bucket)
    out = plan.run(A, arr, graph=digest if graph else None)
    return out if bucket == m else out[:, :m]
