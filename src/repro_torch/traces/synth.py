"""Deterministic synthetic trace generators.

A copy of ``repro.traces.synth``: the same code and the same numpy draws in the
same order, so one seed gives the same numbers in both packages.

Two stochastic processes, both seeded and reproducible:

- **Lifetimes**: revocation observations drawn from the paper's Fig-3
  calibrated mixtures (``transient.LIFETIMES``), with optional
  *burst windows* that scale lifetimes down for a stretch of the horizon
  — the time-correlated revocation behaviour measured by the follow-up
  characterization study (arXiv:2004.03072) that static mixtures miss.
- **Spot prices**: a mean-reverting (Ornstein-Uhlenbeck) process in
  log-price around a per-kind mean level, sampled on a fixed grid.
  Regime shifts (demand surges) move the mean level for a window, which
  is what makes "which server type is cheapest per step?" change over
  time — the question the online policies exist to answer.

``trace_from_model`` is the null generator: i.i.d. lifetime draws and
constant book prices. Replaying it must agree statistically with direct
distribution sampling (pinned in ``tests/test_traces.py``), which anchors
the whole replay path to the validated engine.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import pricing
from repro_torch.core.transient import LIFETIMES, LifetimeModel
from repro_torch.traces.schema import Trace, TraceEvent

DAY_S = 24 * 3600.0

# (t0_frac, t1_frac, factor) — multiplicative windows on the horizon
Regime = Tuple[float, float, float]


def ou_log_price_path(rng: np.random.Generator, n: int, dt_s: float,
                      sigma: float, reversion_hr: float = 2.0) -> np.ndarray:
    """Discrete OU in log-space: x_{i+1} = a x_i + sigma*sqrt(1-a^2) eps.

    ``sigma`` is the stationary std of log-price; ``reversion_hr`` the
    mean-reversion time constant. Returns exp(x), mean ~1, length n.
    """
    a = math.exp(-(dt_s / 3600.0) / reversion_hr)
    noise = rng.normal(size=n) * sigma * math.sqrt(max(1.0 - a * a, 0.0))
    x = np.empty(n)
    x[0] = rng.normal() * sigma
    for i in range(1, n):
        x[i] = a * x[i - 1] + noise[i]
    return np.exp(x)


def _regime_factor(t: np.ndarray, horizon_s: float,
                   regimes: Sequence[Regime]) -> np.ndarray:
    f = np.ones_like(t)
    for t0, t1, factor in regimes:
        f = np.where((t >= t0 * horizon_s) & (t < t1 * horizon_s),
                     f * factor, f)
    return f


def synthetic_trace(name: str, *, seed: int, horizon_s: float = DAY_S,
                    kinds: Sequence[str] = ("K80", "P100", "V100"),
                    zones: Sequence[str] = ("us-east1",),
                    price_interval_s: float = 900.0,
                    price_sigma: float = 0.05,
                    price_regimes: Optional[Dict[str, Sequence[Regime]]] = None,
                    revocations_per_kind: int = 384,
                    lifetime_burst: Optional[Dict[str, Sequence[Regime]]] = None,
                    capacity_events_per_kind: int = 4,
                    models: Optional[Dict[str, LifetimeModel]] = None
                    ) -> Trace:
    """One deterministic synthetic market timeline.

    ``price_regimes[kind]`` multiplies the OU mean level inside fractional
    windows of the horizon; ``lifetime_burst[kind]`` scales lifetimes of
    revocations observed inside the window (shorter = a revocation burst).
    """
    rng = np.random.default_rng(seed)
    models = models or LIFETIMES
    events: List[TraceEvent] = []
    grid = np.arange(0.0, horizon_s, price_interval_s)
    for kind in kinds:
        book = pricing.SERVER_TYPES[kind].transient_hr
        for zone in zones:
            # prices: OU around book, regime-shifted
            path = book * ou_log_price_path(rng, len(grid), price_interval_s,
                                            price_sigma)
            path = path * _regime_factor(grid, horizon_s,
                                         (price_regimes or {}).get(kind, ()))
            events.extend(TraceEvent(float(t), "price", kind, zone,
                                     float(p))
                          for t, p in zip(grid, path))
            # revocation observations: uniform event times, mixture
            # lifetimes, burst windows shorten them
            n_rev = revocations_per_kind
            ts = np.sort(rng.uniform(0.0, horizon_s, size=n_rev))
            lives = models[kind].sample(rng, n_rev)
            burst = _regime_factor(ts, horizon_s,
                                   (lifetime_burst or {}).get(kind, ()))
            lives = np.maximum(lives * burst, 1.0)
            events.extend(TraceEvent(float(t), "revoke", kind, zone,
                                     float(v))
                          for t, v in zip(ts, lives))
            # coarse capacity signal (policies only; engine ignores it)
            for t in rng.uniform(0.0, horizon_s,
                                 size=capacity_events_per_kind):
                events.append(TraceEvent(float(t), "capacity", kind, zone,
                                         float(rng.integers(4, 64))))
    return Trace(name=name, horizon_s=horizon_s, events=tuple(events),
                 source="synthetic", seed=seed)


def trace_from_model(*, seed: int, horizon_s: float = DAY_S,
                     kinds: Sequence[str] = ("K80", "P100", "V100", "PS"),
                     zone: str = "us-east1",
                     events_per_kind: int = 4096,
                     models: Optional[Dict[str, LifetimeModel]] = None
                     ) -> Trace:
    """Null-hypothesis trace: i.i.d. mixture lifetimes + constant book
    prices. Replaying it must reproduce distribution-sampling statistics."""
    rng = np.random.default_rng(seed)
    models = models or LIFETIMES
    events: List[TraceEvent] = []
    for kind in kinds:
        events.append(TraceEvent(0.0, "price", kind, zone,
                                 pricing.SERVER_TYPES[kind].transient_hr))
        ts = rng.uniform(0.0, horizon_s, size=events_per_kind)
        lives = models[kind].sample(rng, events_per_kind)
        events.extend(TraceEvent(float(t), "revoke", kind, zone, float(v))
                      for t, v in zip(ts, lives))
    return Trace(name=f"model-iid-{seed}", horizon_s=horizon_s,
                 events=tuple(events), source="synthetic", seed=seed)


def default_trace_suite(seed: int = 0) -> List[Trace]:
    """The deterministic three-trace suite the policy benchmark replays.

    Training runs last ~1-2 h, so every regime window sits inside the
    first few hours of the 24 h horizon — the dynamics must bite *during*
    a run for online adaptation to matter.

    calm      low price noise, no regimes — online policies must not
              re-provision mid-run (hysteresis holds against OU noise;
              any win over a static baseline is the initial pick only).
    volatile  a demand surge holds P100/V100 at ~2x for the first ~26 min,
              then releases — the cheapest $/step type crosses over
              mid-run, so a static pick is wrong in one half or the other
              and online policies switch at the next decision epoch.
    bursty    a V100 fire sale (price x0.75) coinciding with a revocation
              storm (lifetimes x0.05) for the first ~3 h. The quote alone
              cannot say whether the sale is worth taking — that depends
              on the lifetime process, which only a planner that
              *simulates* the trace (LookaheadMC) evaluates; greedy's
              quote-only score happens to land safely here (the PS cap
              discounts the 4xV100 fleet rate) but has no way to price
              the storm itself.
    """
    surge = {"P100": [(0.0, 0.018, 2.2)], "V100": [(0.0, 0.018, 2.1)]}
    trap_price = {"V100": [(0.0, 0.125, 0.75)]}
    trap_life = {"V100": [(0.0, 0.125, 0.05)]}
    return [
        synthetic_trace("calm", seed=seed, price_sigma=0.02),
        synthetic_trace("volatile", seed=seed + 1, price_sigma=0.08,
                        price_regimes=surge),
        synthetic_trace("bursty", seed=seed + 2, price_sigma=0.05,
                        price_regimes=trap_price,
                        lifetime_burst=trap_life),
    ]
