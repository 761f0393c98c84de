"""Streaming tail-latency quantiles: fixed-size, mergeable estimators.

The estimator the :class:`~.metrics.Quantile` metric wraps: p50/p90/p99/max
of a stream without choosing bucket edges up front.

* **Fixed-size reservoir** (Vitter's algorithm R): O(cap) memory per
  series whatever the stream's length; while the stream is shorter than
  the reservoir the sample is exact.  ``sum``, ``count``, ``min`` and
  ``max`` are tracked exactly beside it.
* **Deterministic**: replacement decisions come from a PRNG seeded per
  estimator (``0x5EED``), so the same observation stream always yields the
  same state, in this package and in the one it was ported from.
* **Mergeable**: :func:`merge_states` folds N estimator states into one:
  exact concatenation while the union fits the cap, count-weighted
  sampling beyond it.

Import cost: stdlib only.
"""

from __future__ import annotations

import random

# 512 samples bound the p99 estimate's standard error near 0.4% of rank
# while keeping a snapshot's reservoir list JSON-friendly.
DEFAULT_RESERVOIR = 512

# The percentile family every surface reports: median, tail, deep tail.
DEFAULT_QUANTILES = (0.5, 0.9, 0.99)


def quantile_of(values, q: float) -> float | None:
    """Linear-interpolated quantile of a sequence (None when empty).

    The one quantile definition shared by the estimator, the aggregator
    and ``rs history`` — two surfaces disagreeing about interpolation
    would report different p99s for the same data.
    """
    vals = sorted(values)
    if not vals:
        return None
    if len(vals) == 1:
        return float(vals[0])
    pos = (len(vals) - 1) * min(max(q, 0.0), 1.0)
    lo = int(pos)
    frac = pos - lo
    if frac == 0.0:
        return float(vals[lo])
    return float(vals[lo] + (vals[lo + 1] - vals[lo]) * frac)


class QuantileEstimator:
    """One streaming quantile series: reservoir + exact count/sum/min/max."""

    __slots__ = ("cap", "count", "sum", "min", "max", "reservoir", "_rng")

    def __init__(self, cap: int = DEFAULT_RESERVOIR, _seed: int = 0x5EED):
        if cap < 1:
            raise ValueError(f"reservoir cap must be >= 1, got {cap}")
        self.cap = cap
        self.count = 0
        self.sum = 0.0
        self.min: float | None = None
        self.max: float | None = None
        self.reservoir: list[float] = []
        # Seeded per estimator: replacement decisions are a pure function
        # of the observation sequence, so tests (and re-runs) reproduce.
        self._rng = random.Random(_seed)

    def observe(self, v) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        if self.min is None or v < self.min:
            self.min = v
        if self.max is None or v > self.max:
            self.max = v
        if len(self.reservoir) < self.cap:
            self.reservoir.append(v)
            return
        # Algorithm R: keep each of the count seen so far with equal
        # probability cap/count.
        j = self._rng.randrange(self.count)
        if j < self.cap:
            self.reservoir[j] = v

    def quantile(self, q: float) -> float | None:
        return quantile_of(self.reservoir, q)

    def quantiles(self, qs=DEFAULT_QUANTILES) -> dict:
        """``{"0.5": v, ...}`` — string keys, JSON/Prometheus-ready."""
        return {repr(float(q)): self.quantile(q) for q in qs}

    def state(self) -> dict:
        """JSON-ready estimator state (what metric snapshots embed and
        :func:`merge_states` consumes)."""
        return {
            "count": self.count,
            "sum": self.sum,
            "min": self.min,
            "max": self.max,
            "cap": self.cap,
            "reservoir": list(self.reservoir),
        }


def merge_states(states: list[dict], cap: int | None = None) -> dict:
    """Fold N estimator states into one (the multi-host merge).

    Exact while the union of reservoirs fits ``cap`` (each part whose
    ``count`` <= its own cap carries every value it saw).  Beyond that,
    parts are down-sampled *count-weighted*: a part that observed 10x the
    events contributes ~10x the samples, so the merged reservoir
    approximates the distribution a single process observing every event
    would have sampled.  ``count``/``sum``/``min``/``max`` merge exactly.
    Deterministic: the sampling PRNG is seeded from the merged counts.
    """
    states = [s for s in states if isinstance(s, dict)]
    if not states:
        return QuantileEstimator().state()
    cap = cap or max(int(s.get("cap") or DEFAULT_RESERVOIR) for s in states)
    count = sum(int(s.get("count") or 0) for s in states)
    total_sum = sum(float(s.get("sum") or 0.0) for s in states)
    mins = [s["min"] for s in states if s.get("min") is not None]
    maxs = [s["max"] for s in states if s.get("max") is not None]
    pooled: list[float] = []
    weights: list[float] = []
    for s in states:
        res = [float(v) for v in (s.get("reservoir") or [])]
        if not res:
            continue
        # Each retained sample stands for count/len(reservoir) events.
        w = max(1.0, float(s.get("count") or len(res)) / len(res))
        pooled.extend(res)
        weights.extend([w] * len(res))
    if len(pooled) > cap:
        # Efraimidis-Spirakis A-Res: weighted sample without replacement —
        # keep the cap items with the largest u^(1/w) keys.
        rng = random.Random(count ^ 0xA6E5)
        keyed = sorted(
            (rng.random() ** (1.0 / w), v) for w, v in zip(weights, pooled)
        )
        pooled = [v for _, v in keyed[-cap:]]
    return {
        "count": count,
        "sum": total_sum,
        "min": min(mins) if mins else None,
        "max": max(maxs) if maxs else None,
        "cap": cap,
        "reservoir": pooled,
    }


def state_quantiles(state: dict, qs=DEFAULT_QUANTILES) -> dict:
    """Quantile family of a (possibly merged) estimator state."""
    res = state.get("reservoir") or []
    return {repr(float(q)): quantile_of(res, q) for q in qs}
