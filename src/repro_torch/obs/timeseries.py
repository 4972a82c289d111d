"""Windowed time-series: labeled gauges sampled on a cadence.

A copy of ``repro.obs.timeseries`` (stdlib only).

The aggregate-only ``MetricsRegistry`` answers "how much in total"; this
module answers "when" — a :class:`TimeSeries` is a bounded ring buffer of
``(t, value)`` points and a :class:`TimeSeriesSampler` polls registered
sources on a fixed cadence of whatever clock drives the run (the serving
replay's *virtual* clock, so sampled series are machine-independent and
deterministic under fixed seeds).

Three source shapes cover every signal the serving fleet exposes:

- ``register(name, fn, **labels)`` — a gauge: ``fn(now) -> float``
  sampled verbatim (queue depth, pool occupancy, live replicas);
- ``register_rate(name, fn, **labels)`` — a monotonic counter turned
  into a per-second rate between consecutive samples (decode throughput
  from ``tokens_decoded``, billed cost rate from ``replica_seconds``);
- ``register_many(fn)`` — a dynamic fan-out: ``fn(now)`` yields
  ``(name, labels, value)`` tuples, for per-replica series whose label
  set changes as the autoscaler grows/drains the fleet.

``attach_serve_cluster`` wires a ``ServeCluster`` into a sampler with
the standard serving signal set. Series export as JSONL/CSV and feed the
ops report's sparklines (``obs/report.py``).
"""
from __future__ import annotations

import csv
import json
import math
from collections import deque
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.metrics import series_key


class TimeSeries:
    """Bounded ring buffer of ``(t, value)`` samples for one series."""

    def __init__(self, name: str, labels: Optional[Dict[str, Any]] = None,
                 *, capacity: int = 4096):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.name = name
        self.labels = dict(labels or {})
        self.key = series_key(name, self.labels)
        self.capacity = capacity
        self._t: deque = deque(maxlen=capacity)
        self._v: deque = deque(maxlen=capacity)

    def append(self, t: float, v: float) -> None:
        self._t.append(float(t))
        self._v.append(float(v))

    def __len__(self) -> int:
        return len(self._t)

    @property
    def times(self) -> List[float]:
        return list(self._t)

    @property
    def values(self) -> List[float]:
        return list(self._v)

    def last(self) -> Optional[Tuple[float, float]]:
        if not self._t:
            return None
        return self._t[-1], self._v[-1]

    def window(self, t0: float, t1: float = math.inf
               ) -> List[Tuple[float, float]]:
        """Samples with ``t0 <= t <= t1`` (ring-buffer retention applies:
        points older than ``capacity`` samples are gone)."""
        return [(t, v) for t, v in zip(self._t, self._v) if t0 <= t <= t1]

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "labels": self.labels,
                "t": self.times, "v": self.values}


class TimeSeriesSampler:
    """Polls registered sources every ``interval_s`` of the driving clock.

    ``maybe_sample(now)`` is the hot-loop entry point: it no-ops until a
    full interval has elapsed, so a per-engine-step call costs one float
    compare. Samples are taken for ALL sources at one shared timestamp,
    so series stay aligned for the report's overlaid sparklines.
    """

    def __init__(self, *, interval_s: float = 1.0, capacity: int = 4096):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.interval_s = interval_s
        self.capacity = capacity
        self._gauges: List[Tuple[str, Dict[str, Any], Callable]] = []
        self._rates: List[Tuple[str, Dict[str, Any], Callable]] = []
        self._many: List[Callable] = []
        self._series: Dict[str, TimeSeries] = {}
        self._rate_prev: Dict[str, Tuple[float, float]] = {}
        self._t_last: Optional[float] = None
        self.n_samples = 0

    # -- registration --------------------------------------------------------
    def register(self, name: str, fn: Callable[[float], float],
                 **labels: Any) -> None:
        """Gauge source: ``fn(now)`` sampled verbatim each cadence."""
        self._gauges.append((name, labels, fn))

    def register_rate(self, name: str, fn: Callable[[float], float],
                      **labels: Any) -> None:
        """Rate source: ``fn(now)`` is a monotonic total; the series gets
        ``(cur - prev) / dt`` per sample (0.0 on the first)."""
        self._rates.append((name, labels, fn))

    def register_many(self, fn: Callable[[float], Iterable[Tuple]]) -> None:
        """Dynamic source: ``fn(now)`` yields ``(name, labels, value)``
        tuples — one per (possibly changing) label set."""
        self._many.append(fn)

    def _sink(self, name: str, labels: Dict[str, Any]) -> TimeSeries:
        key = series_key(name, labels)
        ts = self._series.get(key)
        if ts is None:
            ts = TimeSeries(name, labels, capacity=self.capacity)
            self._series[key] = ts
        return ts

    # -- sampling ------------------------------------------------------------
    def maybe_sample(self, now: float) -> bool:
        """Sample iff a full interval has elapsed since the last sample.
        Returns whether a sample was taken."""
        if self._t_last is not None \
                and now - self._t_last < self.interval_s:
            return False
        self.sample(now)
        return True

    def sample(self, now: float) -> None:
        """Force one sample of every source at ``now``."""
        for name, labels, fn in self._gauges:
            self._sink(name, labels).append(now, fn(now))
        for name, labels, fn in self._rates:
            key = series_key(name, labels)
            cur = float(fn(now))
            prev = self._rate_prev.get(key)
            if prev is None or now <= prev[0]:
                rate = 0.0
            else:
                rate = (cur - prev[1]) / (now - prev[0])
            self._rate_prev[key] = (now, cur)
            self._sink(name, labels).append(now, rate)
        for fn in self._many:
            for name, labels, value in fn(now):
                self._sink(name, dict(labels)).append(now, float(value))
        self._t_last = now
        self.n_samples += 1

    # -- views / export ------------------------------------------------------
    def series(self) -> Dict[str, TimeSeries]:
        """``{series_key: TimeSeries}`` in creation order."""
        return dict(self._series)

    def to_rows(self) -> List[Dict[str, Any]]:
        """Long-form rows ``{"t", "series", "value"}`` across all series,
        sorted by time then series key (stable for goldens/CSV diffs)."""
        rows = [{"t": t, "series": ts.key, "value": v}
                for ts in self._series.values()
                for t, v in zip(ts.times, ts.values)]
        rows.sort(key=lambda r: (r["t"], r["series"]))
        return rows

    def write_jsonl(self, path: str) -> str:
        """One JSON object per series: name, labels, aligned t/v arrays."""
        with open(path, "w") as f:
            for ts in self._series.values():
                f.write(json.dumps(ts.to_dict()) + "\n")
        return path

    def write_csv(self, path: str) -> str:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["t", "series", "value"])
            for r in self.to_rows():
                w.writerow([r["t"], r["series"], r["value"]])
        return path


def load_series_jsonl(path: str) -> Dict[str, TimeSeries]:
    """Inverse of ``TimeSeriesSampler.write_jsonl``."""
    out: Dict[str, TimeSeries] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            ts = TimeSeries(d["name"], d.get("labels"),
                            capacity=max(len(d["t"]), 1))
            for t, v in zip(d["t"], d["v"]):
                ts.append(t, v)
            out[ts.key] = ts
    return out


def attach_serve_cluster(sampler: TimeSeriesSampler, cluster, *,
                         price_hr: Optional[float] = None) -> None:
    """Register the standard serving-fleet signal set on ``sampler``.

    Cluster-level: queue depth, oldest queued wait, live replicas, mean
    slot utilization, decode throughput (tokens/s), billed cost rate
    (replica-seconds/s, scaled to $/h when ``price_hr`` is given).
    Per-replica (dynamic label sets, following autoscaler churn): active
    slots, page-pool occupancy and ``peak_used`` high-water mark.
    """
    sampler.register("queue_depth", lambda now: float(cluster.queue_depth))
    sampler.register("queue_age_s", lambda now: max(
        (e.queue.oldest_wait_s(now) for e in cluster.replicas),
        default=0.0))
    sampler.register("replicas_live", lambda now: float(
        sum(1 for e in cluster.replicas if not e.draining)))
    sampler.register("utilization", lambda now: cluster.load)
    sampler.register_rate("throughput_tok_s",
                          lambda now: float(cluster.tokens_decoded))
    scale = (price_hr / 3600.0) if price_hr is not None else 1.0
    sampler.register_rate(
        "cost_rate" + ("_usd_s" if price_hr is not None else "_rs"),
        lambda now: cluster.replica_seconds * scale)

    def per_replica(now):
        for e in cluster.replicas:
            rid = e.replica_id if e.replica_id is not None else 0
            yield ("active_slots", {"replica": rid}, float(e.n_active))
            if e.allocator is not None:
                yield ("page_pool_util", {"replica": rid},
                       e.page_utilization)
                yield ("page_pool_peak", {"replica": rid},
                       float(e.allocator.peak_used))

    sampler.register_many(per_replica)
