"""Cross-request batching by plan-cache shape bucket.

The port's copy of the JAX package's ``serve/batcher.py``: the same names,
knobs, records and payloads.

The residency win (docs/SERVE.md): concurrent small requests that share a
``(k, n, w, strategy)`` shape dispatch through ONE warm plan of the plan
cache (plan.py; a replayed CUDA graph on the card) and stream their writes
through one shared write-behind lane (parallel/io_executor.py) — the
fleet entry points (``api.encode_fleet`` / ``api.decode_fleet``) already
implement exactly that interleave for CLI batches; the batcher's job is
to FORM those batches out of an online arrival stream.

Discipline: when the scheduler pops the first waiting request it opens a
coalescing window of ``RS_SERVE_BATCH_MS`` (default 5 ms — a latency tax
any single request pays at most once) and keeps popping — still under the
admission queue's fairness order — until the window closes or
``RS_SERVE_MAX_BATCH`` requests are in hand.  The window's harvest is
then grouped by shape bucket; each group executes as one fleet.  A window
of one request degrades to the solo path with zero extra delay beyond the
window itself; ``RS_SERVE_BATCH_MS=0`` disables coalescing entirely.

Import cost: stdlib only.
"""

from __future__ import annotations

import threading
import time

from ..obs import reqtrace as _reqtrace
from ..utils.env import float_env as _float_env, int_env as _int_env
from .queue import AdmissionQueue, Request


DEFAULT_BATCH_MS = 5.0
DEFAULT_MAX_BATCH = 16


class Batcher:
    """Forms shape-bucketed batches from an :class:`AdmissionQueue`.

    One consumer (the daemon's scheduler thread) calls
    :meth:`next_batches`; stats are read by ``/stats`` under a lock.
    """

    def __init__(self, queue: AdmissionQueue,
                 batch_ms: float | None = None,
                 max_batch: int | None = None):
        self.queue = queue
        self.batch_ms = (
            _float_env("RS_SERVE_BATCH_MS", DEFAULT_BATCH_MS)
            if batch_ms is None else float(batch_ms)
        )
        self.max_batch = max(1, (
            _int_env("RS_SERVE_MAX_BATCH", DEFAULT_MAX_BATCH)
            if max_batch is None else int(max_batch)
        ))
        self._lock = threading.Lock()
        self.windows = 0
        self.batches = 0
        self.coalesced = 0  # requests that rode along in a batch of > 1
        self.max_batch_seen = 0
        self._batch_seq = 0  # batch-id source (unique per formed batch)

    def next_batches(self, timeout: float | None = None) \
            -> list[list[Request]] | None:
        """Block up to ``timeout`` for work; returns the next window's
        shape-bucketed batches (each a non-empty list of requests sharing
        one plan-cache key), or None on timeout / drained-empty."""
        first = self.queue.pop(timeout=timeout)
        if first is None:
            return None
        window = [first]
        if self.batch_ms > 0:
            close = time.monotonic() + self.batch_ms / 1000.0
            while len(window) < self.max_batch:
                remaining = close - time.monotonic()
                if remaining <= 0:
                    break
                nxt = self.queue.pop(timeout=remaining)
                if nxt is None:
                    break
                window.append(nxt)
        groups: dict[tuple, list[Request]] = {}
        for req in window:
            groups.setdefault(req.shape_key(), []).append(req)
        batches = list(groups.values())
        formed = time.monotonic()
        with self._lock:
            self.windows += 1
            self.batches += len(batches)
            for b in batches:
                self._batch_seq += 1
                for req in b:
                    # Batch identity + the batch_formed stage stamp: the
                    # window just closed, so every member shares one
                    # instant (the lifecycle plane's batch-wait boundary).
                    req.batch_id = self._batch_seq
                    _reqtrace.mark(req, "batch_formed", formed)
                if len(b) > 1:
                    self.coalesced += len(b)
                self.max_batch_seen = max(self.max_batch_seen, len(b))
        return batches

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "batch_ms": self.batch_ms,
                "max_batch": self.max_batch,
                "windows": self.windows,
                "batches": self.batches,
                "coalesced": self.coalesced,
                "max_batch_seen": self.max_batch_seen,
            }
