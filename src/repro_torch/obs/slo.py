"""SLO health monitor: rolling attainment, burn rates, typed alerts.

A copy of ``repro.obs.slo`` (stdlib only).

The paper's redesign lesson — observe current conditions, reconfigure in
response — needs a *health* signal, not just raw load: a revocation
storm or a creeping TTFT regression is invisible to queue-length
autoscaling until the run is already missing deadlines. This module
computes SRE-style **multi-window burn rates** against an
:class:`SLOSpec` and emits typed :class:`Alert` objects that the
``ReplicaAutoscaler`` consumes as a first-class scale-up signal.

Definitions (all on the run's driving clock, virtual or host):

- a request **attains** its SLO when it completes by its deadline AND
  under the TTFT target; drops/expiries are automatic misses;
- ``error rate(W)`` = fraction of outcomes in the trailing window ``W``
  that missed; ``burn rate(W)`` = error rate / error budget, where the
  budget is ``1 - attainment_target`` (burn 1.0 = exactly spending the
  budget; burn 2.0 = exhausting it at twice the sustainable pace);
- an **SLO-burn alert** fires when BOTH the short and the long window
  burn above ``burn_threshold`` — the short window makes detection fast,
  the long window keeps a transient blip from paging;
- a **revocation storm** is ``>= storm_revocations`` warn/fire events
  inside ``storm_window_s`` — the correlated-revocation signature of
  "Characterizing and Modeling Distributed Training with Transient
  Cloud GPU Servers";
- **pool exhaustion** is sustained page-pool occupancy at or above
  ``pool_util_threshold`` inside ``pool_window_s``.

The monitor is observation-only (feed it via ``observe_*``; the serving
engine/cluster call these when a monitor is attached) and O(1) amortized
per observation — deques pruned to the longest window. Alerts re-fire at
most once per ``cooldown_s`` per kind so a sustained burn reads as a
sparse alert stream, not one alert per engine step.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from repro_torch import obs as _obs

ALERT_SLO_BURN = "slo_burn"
ALERT_REVOCATION_STORM = "revocation_storm"
ALERT_POOL_EXHAUSTION = "pool_exhaustion"

ALERT_KINDS = (ALERT_SLO_BURN, ALERT_REVOCATION_STORM, ALERT_POOL_EXHAUSTION)


@dataclasses.dataclass(frozen=True)
class SLOSpec:
    """Targets + window geometry the monitor evaluates against."""
    attainment_target: float = 0.95   # SLO objective (deadline + TTFT)
    ttft_target_s: float = math.inf   # per-request TTFT bound (inf = off)
    long_window_s: float = 60.0
    short_window_s: float = 5.0
    burn_threshold: float = 2.0       # both windows must burn past this
    min_requests: int = 8             # evidence floor in the long window
    storm_revocations: int = 3
    storm_window_s: float = 10.0
    pool_util_threshold: float = 0.95
    pool_window_s: float = 5.0
    cooldown_s: float = 10.0          # per-kind alert re-fire spacing

    def __post_init__(self):
        if not (0.0 < self.attainment_target < 1.0):
            raise ValueError(f"attainment_target must be in (0, 1), got "
                             f"{self.attainment_target}")
        if self.short_window_s > self.long_window_s:
            raise ValueError("short_window_s must be <= long_window_s")

    @property
    def error_budget(self) -> float:
        return 1.0 - self.attainment_target


@dataclasses.dataclass(frozen=True)
class Alert:
    """One typed monitor alert (immutable; the alert log is append-only)."""
    kind: str                         # ALERT_* constant
    t_s: float                        # clock time the alert fired
    value: float                      # the measurement that tripped it
    threshold: float                  # what it tripped against
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def label(self) -> str:
        return (f"[{self.t_s:.1f}s] {self.kind}: "
                f"{self.value:.3g} > {self.threshold:.3g}")

    def to_json(self) -> Dict[str, Any]:
        return {"kind": self.kind, "t_s": self.t_s, "value": self.value,
                "threshold": self.threshold, "detail": self.detail}


class SLOMonitor:
    """Rolling serving-health state machine; see module docstring.

    ``recorder`` (optional) mirrors every fired alert as an ``EV_ALERT``
    instant + an ``alerts_total{kind=}`` counter, so the alert stream
    lands on the same timeline as the request lifecycle it explains.
    """

    def __init__(self, spec: Optional[SLOSpec] = None, *,
                 recorder: Optional["_obs.Recorder"] = None):
        self.spec = spec if spec is not None else SLOSpec()
        self.rec = recorder if recorder is not None else _obs.NULL
        # (t, ok, ttft_or_None, tpot_or_None) outcomes, pruned to the
        # long window
        self._outcomes: deque = deque()
        self._revocations: deque = deque()       # t of each warn/fire
        self._pool: deque = deque()              # (t, util) observations
        self.alerts: List[Alert] = []
        self._last_fire: Dict[str, float] = {}
        self.n_outcomes = 0
        self.n_misses = 0

    # -- observation feed ----------------------------------------------------
    def observe_completion(self, req, *, now: float) -> None:
        """A retired request: attained iff it beat its deadline and the
        TTFT target. ``req`` duck-types ``serving.Request``."""
        t_done = req.timing.t_complete
        ok = t_done is not None and t_done <= req.deadline_s
        ttft = req.timing.ttft_s
        if ok and ttft is not None and ttft > self.spec.ttft_target_s:
            ok = False
        tpot = None
        tpot_fn = getattr(req.timing, "tpot_s", None)
        if callable(tpot_fn):
            tpot = tpot_fn(len(getattr(req, "generated", None) or ()))
        self._outcomes.append((now, ok, ttft, tpot))
        self.n_outcomes += 1
        self.n_misses += not ok
        self._prune(now)

    def observe_drop(self, req, *, now: float, reason: str = "") -> None:
        """A shed/expired request: an automatic SLO miss."""
        self._outcomes.append((now, False, None, None))
        self.n_outcomes += 1
        self.n_misses += 1
        self._prune(now)

    def observe_revocation(self, *, now: float,
                           replica: Optional[int] = None) -> None:
        self._revocations.append(now)
        self._prune(now)

    def observe_pool(self, util: float, *, now: float) -> None:
        self._pool.append((now, float(util)))
        self._prune(now)

    def _prune(self, now: float) -> None:
        keep = now - self.spec.long_window_s
        while self._outcomes and self._outcomes[0][0] < keep:
            self._outcomes.popleft()
        keep = now - self.spec.storm_window_s
        while self._revocations and self._revocations[0] < keep:
            self._revocations.popleft()
        keep = now - self.spec.pool_window_s
        while self._pool and self._pool[0][0] < keep:
            self._pool.popleft()

    # -- rolling statistics --------------------------------------------------
    def _window(self, window_s: float, now: float):
        t0 = now - window_s
        return [o for o in self._outcomes if o[0] >= t0]

    def error_rate(self, window_s: float, *, now: float) -> Optional[float]:
        """Miss fraction over the trailing window; None without data."""
        w = self._window(window_s, now)
        if not w:
            return None
        return sum(1 for o in w if not o[1]) / len(w)

    def burn_rate(self, window_s: float, *, now: float) -> Optional[float]:
        """Error rate over the window divided by the error budget."""
        er = self.error_rate(window_s, now=now)
        if er is None:
            return None
        return er / max(self.spec.error_budget, 1e-9)

    def attainment(self, *, now: float,
                   window_s: Optional[float] = None) -> Optional[float]:
        er = self.error_rate(window_s or self.spec.long_window_s, now=now)
        return None if er is None else 1.0 - er

    def _latency_quantile(self, idx: int, q: float, now: float,
                          window_s: Optional[float]) -> Optional[float]:
        w = self._window(window_s or self.spec.long_window_s, now)
        ts = sorted(o[idx] for o in w if o[idx] is not None)
        if not ts:
            return None
        i = min(int(q * len(ts)), len(ts) - 1)
        return ts[i]

    def ttft_quantile(self, q: float, *, now: float,
                      window_s: Optional[float] = None) -> Optional[float]:
        """Windowed TTFT percentile from retained outcomes (the window
        bounds retention; unbounded runs use ``Histogram.quantile``)."""
        return self._latency_quantile(2, q, now, window_s)

    def tpot_quantile(self, q: float, *, now: float,
                      window_s: Optional[float] = None) -> Optional[float]:
        """Windowed TPOT (time-per-output-token) percentile."""
        return self._latency_quantile(3, q, now, window_s)

    # -- alert evaluation ----------------------------------------------------
    def _fire(self, kind: str, now: float, value: float, threshold: float,
              **detail: Any) -> Optional[Alert]:
        last = self._last_fire.get(kind)
        if last is not None and now - last < self.spec.cooldown_s:
            return None
        self._last_fire[kind] = now
        alert = Alert(kind=kind, t_s=now, value=value, threshold=threshold,
                      detail=detail)
        self.alerts.append(alert)
        rec = self.rec
        if rec.enabled:
            rec.instant(_obs.EV_ALERT, cat=_obs.CAT_SERVE, track="monitor",
                        sim_t=now, kind=kind, value=value,
                        threshold=threshold, **detail)
            rec.metrics.counter("alerts_total", kind=kind).inc()
        return alert

    def evaluate(self, *, now: float) -> List[Alert]:
        """Run every alert rule at ``now``; returns alerts fired by THIS
        call (the full history stays on ``self.alerts``)."""
        self._prune(now)
        spec = self.spec
        fired: List[Alert] = []

        long_w = self._window(spec.long_window_s, now)
        if len(long_w) >= spec.min_requests:
            b_long = self.burn_rate(spec.long_window_s, now=now)
            b_short = self.burn_rate(spec.short_window_s, now=now)
            if b_long is not None and b_long > spec.burn_threshold \
                    and b_short is not None \
                    and b_short > spec.burn_threshold:
                a = self._fire(ALERT_SLO_BURN, now, b_long,
                               spec.burn_threshold,
                               burn_short=b_short,
                               window_s=spec.long_window_s,
                               n=len(long_w))
                if a:
                    fired.append(a)

        if len(self._revocations) >= spec.storm_revocations:
            a = self._fire(ALERT_REVOCATION_STORM, now,
                           float(len(self._revocations)),
                           float(spec.storm_revocations),
                           window_s=spec.storm_window_s)
            if a:
                fired.append(a)

        if self._pool:
            worst = max(u for _, u in self._pool)
            if worst >= spec.pool_util_threshold:
                a = self._fire(ALERT_POOL_EXHAUSTION, now, worst,
                               spec.pool_util_threshold,
                               window_s=spec.pool_window_s)
                if a:
                    fired.append(a)
        return fired

    def recent_alerts(self, *, now: float,
                      ttl_s: Optional[float] = None) -> Tuple[Alert, ...]:
        """Alerts still 'hot' at ``now`` (within ``ttl_s``, default the
        long window) — what the autoscaler should react to."""
        ttl = ttl_s if ttl_s is not None else self.spec.long_window_s
        return tuple(a for a in self.alerts if now - a.t_s <= ttl)
