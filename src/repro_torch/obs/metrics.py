"""Metrics registry: labeled counters, gauges, histograms (stdlib only).

A copy of ``repro.obs.metrics`` (stdlib only).

Prometheus-shaped naming without the dependency: a *series* is
``name{label=value,...}`` with sorted labels, and the registry is a flat
dict of series. ``to_stats()`` flattens everything to scalar floats in
the shape ``benchmarks/common.emit(stats=)`` persists and the golden
tests pin; ``to_dict()`` keeps structure (histogram buckets) for the
event-log header.

Conventions used across the repo (see docs/ARCHITECTURE.md):

``steps_total{kind=...}``          training/virtual steps completed
``revocations_total{kind=,region=}`` lifetime revocations observed
``cost_usd{kind=...}``             billed dollars (gauge: latest total)
``step_latency_ms``                per-step wall latency histogram
``staleness``                      async-PS push staleness histogram
"""
from __future__ import annotations

import dataclasses
from bisect import bisect_left
from typing import Any, Dict, Iterable, List, Optional, Tuple

# step-latency-friendly default: ~log-spaced ms buckets
DEFAULT_BUCKETS = (1.0, 2.0, 5.0, 10.0, 20.0, 50.0, 100.0, 200.0, 500.0,
                   1000.0, 2000.0, 5000.0)


def series_key(name: str, labels: Dict[str, Any]) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


@dataclasses.dataclass
class Counter:
    """Monotonically increasing total."""
    value: float = 0.0

    def inc(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError(f"counter increment must be >= 0, got {v}")
        self.value += v


@dataclasses.dataclass
class Gauge:
    """Last-write-wins scalar."""
    value: float = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with exact count/sum/min/max.

    ``bucket_counts[i]`` counts observations ``<= bounds[i]``; the last
    slot is the +inf overflow. Integer-valued histograms (staleness) use
    their own exact dict via ``observe_counts``.
    """

    def __init__(self, bounds: Optional[Iterable[float]] = None):
        self.bounds: Tuple[float, ...] = tuple(bounds or DEFAULT_BUCKETS)
        if list(self.bounds) != sorted(self.bounds):
            raise ValueError("histogram bounds must be sorted")
        self.bucket_counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")

    def observe(self, v: float, n: int = 1) -> None:
        v = float(v)
        # first bucket whose bound is >= v; bisect_left(bounds, v) is
        # exactly that index (len(bounds) = the +inf overflow slot)
        self.bucket_counts[bisect_left(self.bounds, v)] += n
        self.count += n
        self.sum += v * n
        self.min = min(self.min, v)
        self.max = max(self.max, v)

    def observe_counts(self, counts: Dict[int, int]) -> None:
        """Bulk-feed an exact ``{value: count}`` histogram (e.g.
        ``AsyncResult.staleness_histogram()``)."""
        for v, n in counts.items():
            self.observe(float(v), int(n))

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def quantile(self, q: float) -> float:
        """Bucket-interpolated quantile estimate (Prometheus-style): find
        the bucket the rank lands in and interpolate linearly between its
        bounds, clamped to the exact observed [min, max]. Error is bounded
        by the bucket width — good enough for TTFT/TPOT percentiles
        without retaining raw samples."""
        if self.count == 0:
            return 0.0
        rank = min(max(q, 0.0), 1.0) * self.count
        cum = 0
        for i, c in enumerate(self.bucket_counts):
            if c == 0:
                continue
            lo = self.bounds[i - 1] if i > 0 else self.min
            hi = self.bounds[i] if i < len(self.bounds) else self.max
            lo = max(lo, self.min)
            hi = min(hi, self.max)
            if hi < lo:                   # single-value bucket edge case
                hi = lo
            if cum + c >= rank:
                return lo + (hi - lo) * ((rank - cum) / c)
            cum += c
        return self.max

    def summary(self) -> Dict[str, float]:
        return {"count": float(self.count), "sum": self.sum,
                "mean": self.mean,
                "min": self.min if self.count else 0.0,
                "max": self.max if self.count else 0.0,
                "p50": self.quantile(0.50), "p90": self.quantile(0.90),
                "p99": self.quantile(0.99)}

    def to_dict(self) -> Dict[str, Any]:
        return {"type": "histogram", "bounds": list(self.bounds),
                "bucket_counts": list(self.bucket_counts),
                **self.summary()}


class MetricsRegistry:
    """Get-or-create store of labeled series."""

    def __init__(self):
        self._series: Dict[str, Tuple[str, Dict[str, Any], Any]] = {}

    def _get(self, name: str, labels: Dict[str, Any], factory):
        key = series_key(name, labels)
        hit = self._series.get(key)
        if hit is None:
            hit = (name, dict(labels), factory())
            self._series[key] = hit
        return hit[2]

    def counter(self, name: str, **labels: Any) -> Counter:
        return self._get(name, labels, Counter)

    def gauge(self, name: str, **labels: Any) -> Gauge:
        return self._get(name, labels, Gauge)

    def histogram(self, name: str, bounds: Optional[Iterable[float]] = None,
                  **labels: Any) -> Histogram:
        return self._get(name, labels, lambda: Histogram(bounds))

    def series(self) -> Dict[str, Any]:
        """``{series_key: metric object}`` in insertion order."""
        return {k: v[2] for k, v in self._series.items()}

    # -- summaries -----------------------------------------------------------
    def to_stats(self) -> Dict[str, float]:
        """Flat scalar view, ``emit(stats=)``/golden-file compatible:
        counters/gauges become ``key -> value``; histograms expand to
        ``key/count``, ``key/sum``, ``key/mean``, ``key/min``, ``key/max``.
        """
        out: Dict[str, float] = {}
        for key, m in self.series().items():
            if isinstance(m, Histogram):
                for stat, v in m.summary().items():
                    out[f"{key}/{stat}"] = v
            else:
                out[key] = float(m.value)
        return out

    def to_dict(self) -> Dict[str, Any]:
        """Structured JSON view (histogram buckets preserved)."""
        out: Dict[str, Any] = {}
        for key, m in self.series().items():
            out[key] = m.to_dict() if isinstance(m, Histogram) \
                else float(m.value)
        return out

    def total(self, name: str) -> float:
        """Sum of every series of ``name`` across label sets — e.g.
        ``total("cost_usd")`` over per-kind gauges gives the fleet bill."""
        return sum(float(m.value) for (n, _l, m) in self._series.values()
                   if n == name and not isinstance(m, Histogram))
