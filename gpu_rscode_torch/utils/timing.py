"""Phase timing: a minimal counterpart of the JAX package's
``utils/timing.py`` (no tracing hook).

Phases tagged ``(io)``, ``(transfer)`` or ``(stage)`` count as
communication, everything else as computation, the split the reference
encoder reports.  A phase that ends in a device synchronisation times the
device work; the others time host work.
"""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager


class PhaseTimer:
    """Accumulates named phase durations."""

    COMM_TAGS = frozenset({"io", "transfer", "stage"})

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.acc: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.best: dict[str, float] = {}  # per-phase minimum duration
        self._t0 = time.perf_counter()

    @classmethod
    def is_comm(cls, name: str) -> bool:
        if not name.endswith(")") or "(" not in name:
            return False
        return name[name.rfind("(") + 1 : -1] in cls.COMM_TAGS

    @contextmanager
    def phase(self, name: str):
        if not self.enabled:
            yield
            return
        t = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t)

    def add(self, name: str, seconds: float) -> None:
        """Record a duration measured elsewhere (a device timer), with the
        same accounting as a :meth:`phase` block."""
        if not self.enabled:
            return
        self.acc[name] += seconds
        self.counts[name] += 1
        if name not in self.best or seconds < self.best[name]:
            self.best[name] = seconds

    @property
    def total(self) -> float:
        return time.perf_counter() - self._t0

    def summary(self, data_bytes: int | None = None) -> str:
        comm = sum(v for k, v in self.acc.items() if self.is_comm(k))
        comp = sum(v for k, v in self.acc.items() if not self.is_comm(k))
        lines = [f"  {name}: {1e3 * v:.3f} ms  (x{self.counts[name]})" for name, v in sorted(self.acc.items())]
        lines.append(f"  total computation: {1e3 * comp:.3f} ms")
        lines.append(f"  total communication: {1e3 * comm:.3f} ms")
        lines.append(f"  total wall: {1e3 * self.total:.3f} ms")
        if data_bytes is not None and self.total > 0:
            lines.append(f"  throughput: {data_bytes / self.total / 1e9:.3f} GB/s")
        return "\n".join(lines)
