"""Process-wide metrics registry: counters, gauges, bucketed histograms and
streaming quantiles.

* **Metric types**: :class:`Counter` (monotonic), :class:`Gauge`
  (set/inc/dec), :class:`Histogram` (bucketed, cumulative ``le`` counts +
  sum/count) and :class:`Quantile` (a mergeable reservoir,
  :mod:`.percentile`).  Every metric takes *labeled children*
  (``counter("rs_store_objects_total").labels(op="put").inc()``), so one
  name covers a family of time series.
* **Registry**: a thread-safe process-wide name -> metric table with
  ``snapshot()`` (plain dict, JSON-ready) and ``render_text()``
  (Prometheus text exposition).  Both are equal, byte for byte, to the
  package this one was ported from for the same sequence of operations.
* **Digest**: :meth:`Registry.snapshot_json` is ``json.dumps(snapshot(),
  sort_keys=True)``, built from each series' JSON cached against the
  series' mutation count, so a ledger record's digest re-serialises only
  the series that changed since the last one.
* **Off by default**: the accessors (:func:`counter`, :func:`gauge`,
  :func:`histogram`, :func:`quantile`) return a shared no-op :data:`NULL`
  unless metrics are enabled (``RS_METRICS=1``, read per call, or
  :func:`force_enable`).  The disabled path registers nothing and costs
  one env read and a no-op call per instrumentation site.

Import cost: stdlib only.
"""

from __future__ import annotations

import bisect
import json
import os
import threading

from . import percentile as _percentile
from .percentile import DEFAULT_RESERVOIR, QuantileEstimator

_TRUTHY = ("1", "true", "on", "yes")

# force_enable() latch: the CLI's --metrics-json/stats surfaces must be able
# to collect without asking the user to also export RS_METRICS=1.
_FORCED = False


def enabled() -> bool:
    """Whether metrics collection is on: ``RS_METRICS`` truthy (read per
    call so tests can monkeypatch) or :func:`force_enable` latched."""
    return _FORCED or os.environ.get("RS_METRICS", "").lower() in _TRUTHY


def force_enable(on: bool = True) -> None:
    """Latch metrics on (off) regardless of ``RS_METRICS``: the in-process
    equivalent of exporting the env var."""
    global _FORCED
    _FORCED = on


def forced() -> bool:
    """Current latch state, so that a temporary enabler can save and
    restore it instead of flipping the process-global gate for good."""
    return _FORCED


class _Null:
    """Shared no-op metric: every mutator is a pass, ``labels`` returns
    itself — the whole disabled instrumentation path in one object."""

    __slots__ = ()

    def labels(self, **_kv):
        return self

    def inc(self, n=1):
        pass

    def dec(self, n=1):
        pass

    def set(self, v):
        pass

    def observe(self, v):
        pass


NULL = _Null()


def _label_key(kv: dict) -> tuple:
    return tuple(sorted((k, str(v)) for k, v in kv.items()))


def _label_str(key: tuple) -> str:
    if not key:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in key) + "}"


class _ChildBase:
    # ``gen`` counts mutations (bumped under the lock); ``_json`` caches
    # (gen, the series' snapshot value as JSON) for Registry.snapshot_json.
    __slots__ = ("_lock", "gen", "_json")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.gen = 0
        self._json = (-1, "")

    def _value(self):
        """The series' snapshot value; called under the lock."""
        return self.value

    def to_json(self) -> str:
        with self._lock:
            gen, cached = self._json
            if gen == self.gen:
                return cached
            gen, value = self.gen, self._value()
        text = json.dumps(_finish_value(value), sort_keys=True)
        self._json = (gen, text)
        return text


def _finish_value(value):
    # A quantile series' computed percentiles ride along in its snapshot.
    if isinstance(value, dict) and "reservoir" in value:
        value["quantiles"] = _percentile.state_quantiles(value)
    return value


class _CounterChild(_ChildBase):
    __slots__ = ("value",)

    def __init__(self, lock):
        super().__init__(lock)
        self.value = 0

    def inc(self, n=1):
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        with self._lock:
            self.value += n
            self.gen += 1


class _GaugeChild(_ChildBase):
    __slots__ = ("value",)

    def __init__(self, lock):
        super().__init__(lock)
        self.value = 0

    def set(self, v):
        with self._lock:
            self.value = v
            self.gen += 1

    def inc(self, n=1):
        with self._lock:
            self.value += n
            self.gen += 1

    def dec(self, n=1):
        with self._lock:
            self.value -= n
            self.gen += 1


class _HistogramChild(_ChildBase):
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, lock, bounds):
        super().__init__(lock)
        self.bounds = bounds  # ascending upper edges; +Inf implicit
        self.counts = [0] * (len(bounds) + 1)  # per-bucket (not cumulative)
        self.sum = 0.0
        self.count = 0

    def observe(self, v):
        # Prometheus convention: bucket "le=b" includes v == b.
        i = bisect.bisect_left(self.bounds, v)
        with self._lock:
            self.counts[i] += 1
            self.sum += v
            self.count += 1
            self.gen += 1

    def _value(self):
        return {"count": self.count, "sum": self.sum, "buckets": self._cumulative(self.counts)}

    def cumulative(self) -> dict:
        """``{le: cumulative count}`` including the +Inf bucket."""
        with self._lock:
            counts = list(self.counts)
        return self._cumulative(counts)

    def _cumulative(self, counts) -> dict:
        out, acc = {}, 0
        for b, c in zip(self.bounds, counts):
            acc += c
            out[repr(float(b))] = acc
        out["+Inf"] = acc + counts[-1]
        return out


class _Metric:
    """One named metric family: a default (label-less) series plus any
    labeled children, sharing a single lock."""

    kind = "untyped"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._children: dict = {}

    def _new_child(self):  # pragma: no cover - overridden
        raise NotImplementedError

    def labels(self, **kv):
        key = _label_key(kv)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
        return child

    def _default(self):
        return self.labels()

    def series(self) -> dict:
        """``{label_string: child}`` snapshot of the family."""
        with self._lock:
            return dict(self._children)


class Counter(_Metric):
    kind = "counter"

    def _new_child(self):
        return _CounterChild(self._lock)

    def inc(self, n=1):
        self._default().inc(n)

    @property
    def value(self):
        return self._default().value


class Gauge(_Metric):
    kind = "gauge"

    def _new_child(self):
        return _GaugeChild(self._lock)

    def set(self, v):
        self._default().set(v)

    def inc(self, n=1):
        self._default().inc(n)

    def dec(self, n=1):
        self._default().dec(n)

    @property
    def value(self):
        return self._default().value


# Default edges suit the latencies this codebase measures: sub-ms dispatch
# overheads up to multi-second compiles.
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0,
)


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help="", buckets=DEFAULT_BUCKETS):
        super().__init__(name, help)
        bounds = sorted(float(b) for b in buckets)
        if not bounds:
            raise ValueError("histogram needs at least one bucket edge")
        self.buckets = tuple(bounds)

    def _new_child(self):
        return _HistogramChild(self._lock, self.buckets)

    def observe(self, v):
        self._default().observe(v)


class _QuantileChild(_ChildBase):
    __slots__ = ("est",)

    def __init__(self, lock, cap):
        super().__init__(lock)
        self.est = QuantileEstimator(cap)

    def observe(self, v):
        with self._lock:
            self.est.observe(v)
            self.gen += 1

    def _value(self):
        return self.est.state()

    def state(self) -> dict:
        with self._lock:
            return self.est.state()


class Quantile(_Metric):
    """Streaming-percentile metric (tail latency): a mergeable
    fixed-size reservoir per labeled series (obs/percentile.py), reported
    as p50/p90/p99 + exact min/max/sum/count.  The percentile sibling of
    :class:`Histogram` — same ``observe()`` surface, no bucket edges to
    choose, and the snapshot carries the estimator state so that parts
    from several processes merge (:func:`.percentile.merge_states`)."""

    kind = "quantile"

    def __init__(self, name, help="", cap=DEFAULT_RESERVOIR):
        super().__init__(name, help)
        self.cap = int(cap)

    def _new_child(self):
        return _QuantileChild(self._lock, self.cap)

    def observe(self, v):
        self._default().observe(v)


class Registry:
    """Thread-safe name -> metric table.

    ``get-or-create`` semantics: asking for an existing name returns the
    existing metric (type-checked — silently returning a counter where a
    gauge was asked for would corrupt series downstream).
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: dict[str, _Metric] = {}

    def _get_or_create(self, cls, name, help, **kwargs):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = cls(name, help, **kwargs)
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as {m.kind}, "
                    f"requested {cls.kind}"
                )
            return m

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get_or_create(Counter, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get_or_create(Gauge, name, help)

    def histogram(
        self, name: str, help: str = "", buckets=DEFAULT_BUCKETS
    ) -> Histogram:
        h = self._get_or_create(Histogram, name, help, buckets=buckets)
        if h.buckets != tuple(sorted(float(b) for b in buckets)):
            # Same contract as the type check: silently bucketing one
            # site's observations with another site's edges would corrupt
            # the series downstream.
            raise ValueError(
                f"histogram {name!r} already registered with buckets "
                f"{h.buckets}, requested {tuple(buckets)}"
            )
        return h

    def quantile(
        self, name: str, help: str = "", cap=DEFAULT_RESERVOIR
    ) -> Quantile:
        q = self._get_or_create(Quantile, name, help, cap=cap)
        if q.cap != int(cap):
            # Same contract as the histogram bucket check: one series,
            # one reservoir size.
            raise ValueError(
                f"quantile {name!r} already registered with cap {q.cap}, "
                f"requested {cap}"
            )
        return q

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._metrics)

    def reset(self) -> None:
        """Drop every registered metric (tests and in-process embedders)."""
        with self._lock:
            self._metrics.clear()

    def snapshot(self) -> dict:
        """JSON-ready dict of every registered series.

        ``{name: {"type", "help", "values": {label_str: value}}}`` where a
        histogram's value is ``{"count", "sum", "buckets": {le: cum}}``.
        """
        with self._lock:
            metrics = list(self._metrics.values())
        out = {}
        for m in metrics:
            values = {}
            for key, child in m.series().items():
                if isinstance(child, _HistogramChild):
                    values[_label_str(key)] = {
                        "count": child.count,
                        "sum": child.sum,
                        "buckets": child.cumulative(),
                    }
                elif isinstance(child, _QuantileChild):
                    state = child.state()
                    # The computed percentile family rides along so every
                    # reader sees the same numbers; the raw reservoir
                    # state is what a merge of parts folds.
                    state["quantiles"] = _percentile.state_quantiles(state)
                    values[_label_str(key)] = state
                else:
                    values[_label_str(key)] = child.value
            out[m.name] = {"type": m.kind, "help": m.help, "values": values}
        return out

    def snapshot_json(self) -> str:
        """``json.dumps(self.snapshot(), sort_keys=True)``, byte for byte,
        re-serialising only the series mutated since the last call."""
        with self._lock:
            metrics = sorted(self._metrics.items())
        fams = []
        for name, m in metrics:
            values = {_label_str(key): child.to_json() for key, child in m.series().items()}
            body = ", ".join(f"{json.dumps(label)}: {text}" for label, text in sorted(values.items()))
            fams.append(f'{json.dumps(name)}: {{"help": {json.dumps(m.help)}, "type": {json.dumps(m.kind)}, '
                        f'"values": {{{body}}}}}')
        return "{" + ", ".join(fams) + "}"

    def render_text(self) -> str:
        """Prometheus text exposition (scrape-format) of the registry:
        :func:`render_text` of :meth:`snapshot`."""
        return render_text(self.snapshot())


def render_text(metrics_snapshot: dict) -> str:
    """Prometheus text exposition of a registry snapshot (live, or one
    loaded back from JSON).  Prometheus has no native quantile type; a
    quantile series renders as a summary (pre-computed quantile labels,
    ``_sum``, ``_count`` and ``_max``)."""
    lines = []
    for name in sorted(metrics_snapshot):
        fam = metrics_snapshot[name]
        if fam.get("help"):
            lines.append(f"# HELP {name} {fam['help']}")
        ftype = fam.get("type", "untyped")
        lines.append(
            f"# TYPE {name} {'summary' if ftype == 'quantile' else ftype}"
        )
        for label, v in sorted(fam.get("values", {}).items()):
            inner = label[1:-1] if label else ""
            sep = "," if inner else ""
            if isinstance(v, dict) and "reservoir" in v:
                qs = v.get("quantiles") or _percentile.state_quantiles(v)
                for q, qv in sorted(qs.items(), key=lambda kv: float(kv[0])):
                    if qv is not None:
                        lines.append(
                            f'{name}{{{inner}{sep}quantile="{q}"}} {qv}'
                        )
                lines.append(f"{name}_sum{label} {v.get('sum', 0.0)}")
                lines.append(f"{name}_count{label} {v.get('count', 0)}")
                if v.get("max") is not None:
                    lines.append(f"{name}_max{label} {v['max']}")
            elif isinstance(v, dict) and "buckets" in v:
                for le, cum in v["buckets"].items():
                    lines.append(
                        f'{name}_bucket{{{inner}{sep}le="{le}"}} {cum}'
                    )
                lines.append(f"{name}_sum{label} {v['sum']}")
                lines.append(f"{name}_count{label} {v['count']}")
            else:
                lines.append(f"{name}{label} {v}")
    return "\n".join(lines) + ("\n" if lines else "")


REGISTRY = Registry()


# -- gated accessors (the instrumentation surface) ---------------------------
#
# Hot paths call these per event; when metrics are off they cost one env
# read and return the shared NULL (nothing registers).  Handles are looked
# up per call, not cached at import, so flipping RS_METRICS mid-process
# (tests, force_enable) takes effect immediately.

def counter(name: str, help: str = ""):
    return REGISTRY.counter(name, help) if enabled() else NULL


def gauge(name: str, help: str = ""):
    return REGISTRY.gauge(name, help) if enabled() else NULL


def histogram(name: str, help: str = "", buckets=DEFAULT_BUCKETS):
    return REGISTRY.histogram(name, help, buckets) if enabled() else NULL


def quantile(name: str, help: str = "", cap=DEFAULT_RESERVOIR):
    return REGISTRY.quantile(name, help, cap) if enabled() else NULL


def unified_snapshot() -> dict:
    """The one observability snapshot: the registry's metrics, the plan
    caches' counters (:meth:`..plan.PlanCache.stats`, the local and the
    mesh cache) and the refold="autotune" decisions
    (:func:`..ops.cuda_gemm.autotune_decisions`, keyed by the repr of the
    dispatch class).  The plan-cache sections are included even with
    metrics disabled: their counters are plan-layer state, always
    counted."""
    from .. import plan
    from ..ops.cuda_gemm import autotune_decisions

    return {"metrics_enabled": enabled(), "metrics": REGISTRY.snapshot(),
            "plan_cache": plan.PLAN_CACHE.stats(), "mesh_plan_cache": plan.MESH_PLAN_CACHE.stats(),
            "autotune_decisions": {repr(k): v for k, v in sorted(autotune_decisions().items(), key=repr)}}
