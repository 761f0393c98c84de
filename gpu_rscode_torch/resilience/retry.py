"""Retry policy engine — bounded backoff with seeded jitter and a budget:
the port's copy of the JAX package's ``resilience/retry.py``, delay for
delay.

The file layer's I/O used to be one-shot: a single EIO from a flaky disk
killed a multi-GB encode even though the very next read would have
succeeded.  This module is the recovery half of the resilience subsystem
(:mod:`.faults` is the provocation half): a :class:`RetryPolicy` wraps an
I/O callable, classifies each failure transient-or-fatal, and retries
transients under bounded exponential backoff with *seeded* jitter — the
same seed replays the same delays, so chaos runs stay bit-reproducible.

Classification (:func:`is_transient`):

* :class:`..resilience.faults.InjectedFault` carries its own verdict
  (``ioerror`` transient, ``torn`` fatal);
* ``TimeoutError`` / ``InterruptedError`` / ``BlockingIOError`` and
  ``OSError`` with errno in {EIO, EAGAIN, EINTR, ETIMEDOUT, EBUSY} are
  transient;
* ``FileNotFoundError`` / ``PermissionError`` / path-shape errors and
  everything else (ValueError, ChunkIntegrityError, ...) are fatal —
  retrying them burns time without changing the outcome.

Retried callables MUST be idempotent.  The call sites keep that contract
structurally: chunk opens are pure reads, segment gathers write into
fresh buffers, and the drain lanes commit offset-addressed (or
restart-from-scratch) writes with cross-segment state (incremental CRC)
updated only AFTER the write landed (see ``api._drain_parity``).

Knobs: ``RS_RETRY_ATTEMPTS`` (retries per call, default 3; 0 disables),
``RS_RETRY_BASE_MS`` / ``RS_RETRY_MAX_MS`` (backoff ladder, default
5/250), ``RS_RETRY_SEED`` (jitter seed), ``RS_RETRY_BUDGET``
(retry budget, default 256 — a storm of transients must degrade to
failure, not retry forever; rearmed by :func:`reset_budget` at every
file-level entry point (``api._observed_file_op``) so it bounds ONE
operation's storm without a long-lived process permanently losing retry
protection; the chaos harness also rearms per iteration).

Observability: ``rs_retries_total{outcome}`` counts ``retried`` (each
backoff taken), ``recovered`` (success after >= 1 retry), ``exhausted``
(attempts or budget ran out) and ``fatal`` (a non-retryable OSError
passed straight through); each backoff records a ``retry`` instant on
the ``retry`` trace lane.

The policy wraps IO callables only (chunk opens, segment gathers, drains),
never a GEMM dispatch: a CUDA error is a ``RuntimeError``, which
:func:`is_transient` classes as fatal, so a kernel failure raises at once.

Import cost: the standard library only.
"""

from __future__ import annotations

import errno
import os
import threading
import time
import zlib
from collections.abc import Callable

from ..obs import metrics as _metrics, tracing as _tracing
from ..utils.env import float_env as _float_env, int_env
from . import faults as _faults

_TRANSIENT_ERRNO = {
    errno.EIO, errno.EAGAIN, errno.EWOULDBLOCK, errno.EINTR,
    errno.ETIMEDOUT, errno.EBUSY,
}
_FATAL_OSERRORS = (
    FileNotFoundError, PermissionError, NotADirectoryError,
    IsADirectoryError, FileExistsError,
)


def is_transient(exc: BaseException) -> bool:
    """Whether ``exc`` is worth retrying (see the module doc for the
    classification table)."""
    if isinstance(exc, _faults.InjectedFault):
        return exc.transient
    if isinstance(exc, _FATAL_OSERRORS):
        return False
    if isinstance(exc, (TimeoutError, InterruptedError, BlockingIOError)):
        return True
    if isinstance(exc, OSError):
        return exc.errno in _TRANSIENT_ERRNO
    return False


# -- process-wide retry budget -----------------------------------------------

_BUDGET_LOCK = threading.Lock()
_BUDGET: dict = {"left": None}


def take_budget() -> bool:
    """Spend one retry from the process budget; False when exhausted."""
    with _BUDGET_LOCK:
        if _BUDGET["left"] is None:
            _BUDGET["left"] = max(0, int_env("RS_RETRY_BUDGET", 256))
        if _BUDGET["left"] <= 0:
            return False
        _BUDGET["left"] -= 1
        return True


def reset_budget() -> None:
    """Rearm the process retry budget (re-read from the env on next use)."""
    with _BUDGET_LOCK:
        _BUDGET["left"] = None


def budget_left() -> int | None:
    with _BUDGET_LOCK:
        return _BUDGET["left"]


class RetryPolicy:
    """Bounded exponential backoff with seeded jitter.

    ``retries`` transient failures are retried per :meth:`call`; delay for
    attempt i is ``min(max_ms, base_ms * 2**i)`` scaled by a deterministic
    jitter factor in [0.5, 1.5) drawn from ``(seed, op, attempt, seq)`` —
    reproducible, but still decorrelated across concurrent callers.
    """

    def __init__(self, retries: int | None = None,
                 base_ms: float | None = None,
                 max_ms: float | None = None,
                 seed: int | None = None):
        self.retries = (
            max(0, int_env("RS_RETRY_ATTEMPTS", 3))
            if retries is None else max(0, retries)
        )
        self.base_ms = (
            _float_env("RS_RETRY_BASE_MS", 5.0)
            if base_ms is None else base_ms
        )
        self.max_ms = (
            _float_env("RS_RETRY_MAX_MS", 250.0)
            if max_ms is None else max_ms
        )
        self.seed = int_env("RS_RETRY_SEED", 0) if seed is None else seed
        self._seq = 0
        self._lock = threading.Lock()

    def backoff_s(self, op: str, attempt: int) -> float:
        with self._lock:
            self._seq += 1
            seq = self._seq
        exp = min(self.max_ms, self.base_ms * (2 ** attempt))
        frac = zlib.crc32(
            repr((self.seed, op, attempt, seq)).encode()
        ) / 2 ** 32
        return exp * (0.5 + frac) / 1000.0

    def call(self, fn: Callable, *, op: str = "io"):
        """Run ``fn`` retrying transient failures; re-raises the last
        error when attempts or the process budget run out."""
        attempt = 0
        while True:
            try:
                out = fn()
            except Exception as e:
                if not is_transient(e):
                    if isinstance(e, OSError):
                        _metrics.counter(
                            "rs_retries_total", "retry-policy outcomes"
                        ).labels(outcome="fatal").inc()
                    raise
                if attempt >= self.retries or not take_budget():
                    _metrics.counter(
                        "rs_retries_total", "retry-policy outcomes"
                    ).labels(outcome="exhausted").inc()
                    raise
                delay = self.backoff_s(op, attempt)
                attempt += 1
                _metrics.counter(
                    "rs_retries_total", "retry-policy outcomes"
                ).labels(outcome="retried").inc()
                _tracing.instant(
                    "retry", lane="retry", op=op, attempt=attempt,
                    error=type(e).__name__,
                    backoff_ms=round(delay * 1e3, 3),
                )
                time.sleep(delay)
                continue
            if attempt:
                _metrics.counter(
                    "rs_retries_total", "retry-policy outcomes"
                ).labels(outcome="recovered").inc()
            return out


_DEFAULT_LOCK = threading.Lock()
_DEFAULT_KEY: tuple | None = None
_DEFAULT: RetryPolicy | None = None


def default_policy() -> RetryPolicy:
    """The process's shared policy, rebuilt when the RS_RETRY_* env
    changes (so tests and the chaos harness can reconfigure mid-process)."""
    global _DEFAULT_KEY, _DEFAULT
    key = tuple(
        os.environ.get(name)
        for name in ("RS_RETRY_ATTEMPTS", "RS_RETRY_BASE_MS",
                     "RS_RETRY_MAX_MS", "RS_RETRY_SEED")
    )
    with _DEFAULT_LOCK:
        if _DEFAULT is None or key != _DEFAULT_KEY:
            _DEFAULT = RetryPolicy()
            _DEFAULT_KEY = key
        return _DEFAULT
