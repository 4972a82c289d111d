"""Vectorized trace replay for the batched Monte-Carlo engine.

A copy of ``repro.traces.replay``: the same code and the same numpy draws in the
same order, so one seed gives the same numbers in both packages.

``ReplayContext`` turns a ``Trace`` into the two things the engine needs,
both as array programs over the trial axis:

1. **Lifetimes** — instead of sampling the closed-form mixtures, trials
   bootstrap-resample the trace's observed revocation lifetimes. The
   horizon is split into ``n_windows`` equal windows, each holding the
   empirical lifetime distribution of the revocations observed inside it
   — this is what preserves the trace's time-correlation (a burst window
   has short lifetimes). A draw for a server activating at time ``t`` is
   conditioned on the window containing ``t``, so a revocation storm
   hits every trial that provisions during the storm. Windows with too
   few observations fall back to the kind's full observation vector;
   kinds with no observations at all fall back to the calibrated mixture
   (``transient.LIFETIMES``) so a price-only trace still replays.

2. **Prices** — the piecewise-constant per-kind spot path, integrated
   exactly: cost over ``[t0, t1)`` is the difference of the cumulative
   price integral, evaluated per slot column. The path holds flat after
   its last update (and past the horizon). Kinds with no price events
   bill at the book transient price.

Trial diversity comes from ``bind``'s bootstrap mode: ``"windows"``
(the ``simulate_many(trace=...)`` default) starts each trial at a
uniformly drawn window boundary of the trace — block-bootstrap over
launch conditions, so N trials sweep the whole timeline; ``"zero"``
(used by the policy evaluator and the lookahead planner) starts every
trial at the context's ``t0`` and replays the one realized timeline,
trials differing only in their independent bootstrap draws — the mode
that keeps price/revocation correlations aligned with policy decisions.

``simulate_many(..., trace=...)`` wraps the trace in a ``ReplayContext``;
``mc.simulate_batch(..., replay=...)`` consumes it. Policies reuse the
same object for spot quotes (``price_at``) and revocation-intensity
observations. A context can be re-based at ``t0 > 0`` (``tail``) so a
lookahead planner replays only the remainder of the trace.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import pricing
from repro_torch.core.transient import (EmpiricalLifetime, LIFETIMES,
                                  MAX_LIFETIME_S)
from repro_torch.traces.schema import Trace

_MIN_WINDOW_OBS = 8          # fewer observations than this -> whole-trace


class _PricePath:
    """Piecewise-constant $/hr path with an exact cumulative integral."""

    def __init__(self, times_s: np.ndarray, prices_hr: np.ndarray,
                 book_hr: float, t0: float):
        if times_s.size == 0:
            times_s = np.array([t0])
            prices_hr = np.array([book_hr])
        # price in force at t0: the last update at or before t0 (or the
        # first update, for traces whose first quote lands after t0)
        i0 = max(int(np.searchsorted(times_s, t0, side="right")) - 1, 0)
        knots = np.concatenate([[t0], times_s[i0 + 1:]])
        vals = np.concatenate([[prices_hr[i0]], prices_hr[i0 + 1:]])
        # cumulative integral of the step function at each knot; the last
        # segment extends flat to +inf via linear extrapolation below
        seg = np.diff(knots) * vals[:-1]
        self._knots = knots
        self._vals = vals
        self._cum = np.concatenate([[0.0], np.cumsum(seg)])
        self._t0 = t0

    def price_at(self, t_s) -> np.ndarray:
        """Spot $/hr at ``t_s`` seconds after the context's t0."""
        t = np.asarray(t_s, dtype=np.float64) + self._t0
        i = np.clip(np.searchsorted(self._knots, t, side="right") - 1,
                    0, self._vals.size - 1)
        return self._vals[i]

    def integral_usd(self, t_start_s, t_end_s) -> np.ndarray:
        """$ billed for one instance active on ``[t_start, t_end)``."""
        a = np.asarray(t_start_s, dtype=np.float64) + self._t0
        b = np.asarray(t_end_s, dtype=np.float64) + self._t0

        def cum(t):
            t = np.clip(t, self._knots[0], None)
            i = np.clip(np.searchsorted(self._knots, t, side="right") - 1,
                        0, self._vals.size - 1)
            return self._cum[i] + (t - self._knots[i]) * self._vals[i]

        return np.maximum(cum(b) - cum(a), 0.0) / 3600.0


class ReplayContext:
    """A ``Trace`` compiled for vectorized playback from time ``t0``."""

    def __init__(self, trace: Trace, *, t0: float = 0.0, n_windows: int = 8,
                 zone: Optional[str] = None, bootstrap: str = "windows"):
        if not 0.0 <= t0 < trace.horizon_s:
            raise ValueError(f"t0={t0} outside trace horizon "
                             f"{trace.horizon_s}")
        if bootstrap not in ("windows", "zero"):
            raise ValueError(f"unknown bootstrap mode {bootstrap!r}")
        self.trace = trace
        self.t0 = float(t0)
        self.n_windows = int(n_windows)
        self.zone = zone
        self.bootstrap = bootstrap
        self.remaining_s = trace.horizon_s - self.t0
        self._prices: Dict[str, _PricePath] = {}
        self._windows: Dict[str, list] = {}
        self._all_obs: Dict[str, object] = {}
        unknown = set(trace.kinds) - set(pricing.SERVER_TYPES)
        if unknown:
            raise ValueError(f"trace has unknown server kinds {sorted(unknown)}; "
                             f"known: {sorted(pricing.SERVER_TYPES)}")
        kinds = set(trace.kinds) | set(LIFETIMES)
        self._has_prices: Dict[str, bool] = {}
        self._revoke_ts: Dict[str, np.ndarray] = {}   # sorted event times
        for kind in kinds:
            ts, ps = trace.price_series(kind, zone)
            book = pricing.SERVER_TYPES[kind].transient_hr
            self._prices[kind] = _PricePath(ts, ps, book, self.t0)
            self._has_prices[kind] = ts.size > 0
            self._compile_lifetimes(kind)

    def _compile_lifetimes(self, kind: str) -> None:
        c = self.trace.columns(event="revoke", kind=kind, zone=self.zone)
        ts, lives = c["t"], c["value"]
        self._revoke_ts[kind] = ts          # sorted (Trace sorts events)
        sel = ts >= self.t0
        ts, lives = ts[sel], lives[sel]
        if lives.size == 0:
            self._all_obs[kind] = LIFETIMES[kind]
            self._windows[kind] = [LIFETIMES[kind]] * self.n_windows
            return
        full = EmpiricalLifetime(lives)
        self._all_obs[kind] = full
        edges = np.linspace(self.t0, self.trace.horizon_s,
                            self.n_windows + 1)
        wins = []
        for w in range(self.n_windows):
            m = (ts >= edges[w]) & (ts < edges[w + 1])
            wins.append(EmpiricalLifetime(lives[m])
                        if int(m.sum()) >= _MIN_WINDOW_OBS else full)
        self._windows[kind] = wins

    def tail(self, dt_s: float) -> "ReplayContext":
        """Context re-based ``dt_s`` seconds later, in ``"zero"`` mode —
        a lookahead planner asks "what if I launch X *now*", so its plan
        trials all replay the realized remainder of the trace."""
        t0 = min(self.t0 + max(dt_s, 0.0), self.trace.horizon_s * 0.999)
        return ReplayContext(self.trace, t0=t0, n_windows=self.n_windows,
                             zone=self.zone, bootstrap="zero")

    def window_at(self, t_abs_s: np.ndarray) -> np.ndarray:
        """Window index containing each (absolute-trace-time) instant."""
        frac = (np.asarray(t_abs_s, dtype=np.float64) - self.t0) \
            / max(self.remaining_s, 1e-9)
        return np.clip((frac * self.n_windows).astype(np.int64), 0,
                       self.n_windows - 1)

    # -- engine-facing API -------------------------------------------------

    def bind(self, n_trials: int, rng: np.random.Generator,
             bootstrap: Optional[str] = None) -> "BoundReplay":
        """Assign each trial its replay start offset (see module doc)."""
        mode = bootstrap or self.bootstrap
        if mode == "windows":
            w = rng.integers(self.n_windows, size=n_trials)
            offsets = w * (self.remaining_s / self.n_windows)
        elif mode == "zero":
            offsets = np.zeros(n_trials)
        else:
            raise ValueError(f"unknown bootstrap mode {mode!r}; "
                             "expected 'windows' or 'zero'")
        return BoundReplay(self, offsets)

    def price_at(self, kind: str, t_s) -> np.ndarray:
        return self._prices[kind].price_at(t_s)

    def cost_usd(self, kind: str, t_start_s, t_end_s) -> np.ndarray:
        return self._prices[kind].integral_usd(t_start_s, t_end_s)

    def has_prices(self, kind: str) -> bool:
        return self._has_prices.get(kind, False)

    def revocation_intensity(self, kind: str, t_s: float,
                             lookback_s: float = 3600.0) -> float:
        """Observed revocations/hour for ``kind`` in the trailing window."""
        ts = self._revoke_ts.get(kind, np.empty(0))
        t_abs = self.t0 + t_s
        lo = max(t_abs - lookback_s, 0.0)
        n = int(np.searchsorted(ts, t_abs, side="left")
                - np.searchsorted(ts, lo, side="left"))
        return n / max((t_abs - lo) / 3600.0, 1e-9)

    def p_revoked_by(self, kind: str, t_s: float) -> float:
        """Empirical CDF over the context's observations (planner hook)."""
        return self._all_obs[kind].p_revoked_by(t_s)


@dataclasses.dataclass(frozen=True)
class BoundReplay:
    """A ``ReplayContext`` plus per-trial replay start offsets."""
    ctx: ReplayContext
    offset_s: np.ndarray          # (N,) float64, added to every sim time

    def lifetimes(self, kind: str, trial_idx: np.ndarray, at_s: np.ndarray,
                  rng: np.random.Generator) -> np.ndarray:
        """One bootstrap lifetime per entry of ``trial_idx``, conditioned
        on the trace window each server *activates* in (``at_s`` is the
        per-entry simulation time of the activation)."""
        idx = np.asarray(trial_idx)
        at = np.broadcast_to(np.asarray(at_s, dtype=np.float64), idx.shape)
        out = np.empty(idx.size, dtype=np.float64)
        wins = self.ctx.window_at(self.ctx.t0 + self.offset_s[idx] + at)
        for w in np.unique(wins):
            m = wins == w
            out[m] = self.ctx._windows[kind][int(w)].sample(rng,
                                                            int(m.sum()))
        return np.minimum(out, MAX_LIFETIME_S)

    def cost_usd(self, kind: str, t_start_s, t_end_s) -> np.ndarray:
        """$ per trial for [t_start, t_end), full-length trial-order
        arrays (offsets applied elementwise)."""
        return self.ctx.cost_usd(kind, self.offset_s + t_start_s,
                                 self.offset_s + t_end_s)

    def has_prices(self, kind: str) -> bool:
        return self.ctx.has_prices(kind)


def context_for(trace) -> ReplayContext:
    """Coerce a ``Trace`` (memoized) or pass through a ``ReplayContext``.

    The compiled context is memoized on the trace object itself (the
    dataclass is frozen but not slotted), so its lifetime is exactly the
    trace's — no global cache to leak when traces are streamed through
    ``simulate_many(trace=...)``/``price_at``. The reference cycle
    (trace -> ctx -> trace) is ordinary gc fodder.
    """
    if isinstance(trace, ReplayContext):
        return trace
    ctx = getattr(trace, "_default_ctx", None)
    if ctx is None:
        ctx = ReplayContext(trace)
        object.__setattr__(trace, "_default_ctx", ctx)
    return ctx
