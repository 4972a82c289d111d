"""Batched Monte-Carlo simulation engine — the trial axis as an array axis.

A copy of ``repro.core.mc``: the same code and the same numpy draws in the
same order, so one seed gives the same numbers in both packages.

The legacy path (``simulator.simulate_run``) replays ONE training run with a
per-event Python loop; ``simulate_many`` used to call it N times.  That is
fine for the paper's 32-cluster tables but far too slow to sweep cluster
configurations or to report tight confidence intervals (>=1024 trials).

This module re-expresses the same event-driven semantics as a *synchronized*
event loop over a batch of N independent trials: every iteration advances
each still-running trial to its own next event, but all the bookkeeping
(piecewise-constant rate integration, revocation masks, join scheduling,
per-second billing) is NumPy array arithmetic of shape ``(N,)`` / ``(N, W)``.
The iteration count is bounded by the per-trial event count (a handful:
W revocations + 2 events per dynamic join + completion), so 1024 trials cost
a few dozen vectorized passes instead of 1024 Python event loops — two
orders of magnitude faster in practice.

Semantics are identical to the legacy loop (cross-validated on fixed seeds
in ``tests/test_mc_engine.py``); only the RNG *consumption order* differs,
so individual trials are not bitwise-reproducible across engines — means,
failure rates, and distributions agree within Monte-Carlo noise.

The arithmetic is plain ``numpy`` on purpose: every per-iteration update is
elementwise or a masked reduction over the trial axis, so the state
arrays could move onto the card as tensors if sweeps ever need it.  On
the host, NumPy already beats the Python loop by far more than the sweeps
need.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import pricing
from repro_torch.core.simulator import (ACC_ANCHORS, JOIN_OVERHEAD_S,
                                  PS_CONTENTION_K, PS_RATE_STEPS_S,
                                  ClusterSpec, RunResult, _worker_rate)
from repro_torch.core.transient import LIFETIMES, MAX_LIFETIME_S
from repro_torch.hetero.rates import aggregate_rate_batch

# Trial status codes (mirrors simulate_run's ``failure`` strings).
RUNNING = 0
COMPLETED = 1
MASTER_REVOKED = 2
PS_REVOKED = 3
ALL_REVOKED = 4
NO_PROGRESS = 5

FAILURE_NAMES = {COMPLETED: None, MASTER_REVOKED: "master_revoked",
                 PS_REVOKED: "ps_revoked", ALL_REVOKED: "all_revoked",
                 NO_PROGRESS: "no_progress"}

# Event codes for the per-iteration argmin (order matches the legacy event
# list so simultaneous events tie-break identically: revoke < ps_revoke <
# join_active < join_request < done).
_EV_REVOKE, _EV_PS, _EV_JOIN_ACT, _EV_JOIN_REQ, _EV_DONE = range(5)

_MAX_EVENTS = 10_000            # same no-progress guard as the legacy loop


def ps_capped_rate_batch(sum_rate: np.ndarray, n_ps: int) -> np.ndarray:
    """Vectorized ``simulator.ps_capped_rate`` over a trial axis (Fig 6)."""
    s = np.asarray(sum_rate, dtype=np.float64)
    if n_ps == 0:
        return np.maximum(s, 0.0)
    cap = n_ps * PS_RATE_STEPS_S
    with np.errstate(invalid="ignore"):
        capped = s / (1.0 + (s / cap) ** PS_CONTENTION_K) ** (1.0 / PS_CONTENTION_K)
    return np.where(s > 0, capped, 0.0)


def accuracy_model_batch(avg_workers: np.ndarray, *, dynamic: bool = False,
                         adaptive_lr: bool = True) -> np.ndarray:
    """Vectorized ``simulator.accuracy_model``: piecewise-linear in log2(W)
    through the paper's anchors, linear extrapolation past the last one."""
    w = np.maximum(1.0, np.asarray(avg_workers, dtype=np.float64))
    lx = np.log2(w)
    xs = np.array([math.log2(k) for k in sorted(ACC_ANCHORS)])
    ys = np.array([v for _, v in sorted(ACC_ANCHORS.items())])
    acc = np.interp(lx, xs, ys)           # clamps flat on both ends
    slope = (ys[-1] - ys[-2]) / (xs[-1] - xs[-2])
    acc = np.where(lx > xs[-1], ys[-1] + slope * (lx - xs[-1]), acc)
    if dynamic:
        acc = acc - (1.17 if not adaptive_lr else 0.17)
    return acc


@dataclasses.dataclass
class MCBatch:
    """Raw per-trial outcome arrays for N Monte-Carlo trials of one spec.

    Shape/dtype invariants (asserted in tests): every per-trial array has
    shape ``(n_trials,)``; per-slot arrays are ``(n_trials, n_workers)``;
    floats are float64, counters int64, masks bool.
    """
    spec: ClusterSpec
    status: np.ndarray            # (N,) int64, COMPLETED/..-codes
    time_h: np.ndarray            # (N,) float64  (failure time for failures)
    cost_usd: np.ndarray          # (N,) float64
    accuracy: np.ndarray          # (N,) float64, NaN for failed trials
    revocations: np.ndarray       # (N,) int64, non-fatal worker revocations
    steps_done: np.ndarray        # (N,) float64
    avg_active_workers: np.ndarray  # (N,) float64
    lifetimes_h: np.ndarray       # (N, W) float64, NaN = never provisioned

    @property
    def n_trials(self) -> int:
        return int(self.status.shape[0])

    @property
    def completed(self) -> np.ndarray:
        return self.status == COMPLETED

    def to_results(self) -> List[RunResult]:
        """Materialize legacy ``RunResult`` objects (compat path).

        Converts through ``.tolist()`` once per column — per-element numpy
        scalar indexing would dominate the whole engine's runtime.
        """
        cols = zip(self.status.tolist(), self.time_h.tolist(),
                   self.cost_usd.tolist(), self.accuracy.tolist(),
                   self.revocations.tolist(), self.steps_done.tolist(),
                   self.avg_active_workers.tolist(),
                   self.lifetimes_h.tolist())
        return [RunResult(completed=st == COMPLETED,
                          failure=FAILURE_NAMES[st], time_h=th,
                          cost_usd=c, accuracy=a, revocations=rv,
                          steps_done=int(sd), avg_active_workers=aw,
                          worker_lifetimes_h=[x for x in lt if x == x])
                for st, th, c, a, rv, sd, aw, lt in cols]


def _sample_lifetimes(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    return LIFETIMES[kind].sample(rng, n)


def _masked_mean_std(x: np.ndarray, m: np.ndarray) -> Tuple[float, float]:
    """Mean/std over the masked selection; (0, 0) when nothing is selected
    — degenerate aggregates must stay finite and warning-free (consumers
    gate on ``n_completed``, not on NaN sentinels). NaN entries inside the
    selection are skipped for the same reason: engine trials never produce
    them, but gym ledgers may mix measured accuracies with plan-only NaN
    placeholders, and one placeholder must not poison the aggregate."""
    sel = x[m]
    sel = sel[~np.isnan(sel)]
    if sel.size == 0:
        return (0.0, 0.0)
    return (float(sel.mean()), float(sel.std()))


class _LazyResults:
    """List-like view of a batch's ``RunResult``s, materialized on first
    access — building 1024 Python objects costs more than the batched
    simulation itself, and sweep consumers never touch ``Summary.results``."""

    def __init__(self, batch: "MCBatch"):
        self._batch = batch
        self._items: Optional[List[RunResult]] = None

    def _force(self) -> List[RunResult]:
        if self._items is None:
            self._items = self._batch.to_results()
        return self._items

    def __iter__(self):
        return iter(self._force())

    def __len__(self) -> int:
        return self._batch.n_trials

    def __getitem__(self, i):
        return self._force()[i]

    def __repr__(self) -> str:
        return repr(self._force())


def summarize_arrays(status: np.ndarray, time_h: np.ndarray,
                     cost_usd: np.ndarray, accuracy: np.ndarray,
                     revocations: np.ndarray, *, results=None):
    """Aggregate trial-axis outcome arrays into a ``simulator.Summary``.

    The one schema seam shared by every producer of per-trial outcomes:
    ``summarize_batch`` (the engine) and ``gym.GymLedger`` (real training
    replays) both call this, so their reports are field-for-field
    comparable — which is what the differential validator relies on.
    ``status`` uses this module's codes (COMPLETED, ...).
    """
    from repro_torch.core.simulator import Summary   # late: simulator imports mc
    status = np.asarray(status)
    n = int(status.shape[0])
    done = status == COMPLETED
    n_done = int(done.sum())
    revocations = np.asarray(revocations)
    rs, counts = np.unique(revocations[done], return_counts=True)
    rev_counts = {int(r): int(c) for r, c in zip(rs, counts)}
    by_r = {}
    for r in rev_counts:
        sel = done & (revocations == r)
        by_r[r] = {"time_h": _masked_mean_std(time_h, sel),
                   "cost": _masked_mean_std(cost_usd, sel),
                   "acc": _masked_mean_std(accuracy, sel)}
    return Summary(
        n_runs=n,
        n_completed=n_done,
        failure_rate=1.0 - n_done / n if n else 0.0,
        revocation_counts=rev_counts,
        time_h=_masked_mean_std(time_h, done),
        cost=_masked_mean_std(cost_usd, done),
        acc=_masked_mean_std(accuracy, done),
        by_r=by_r,
        results=[] if results is None else results,
    )


def summarize_batch(batch: MCBatch):
    """Vectorized counterpart of ``simulator.summarize`` — same ``Summary``
    values, computed on the trial-axis arrays instead of per-run objects."""
    return summarize_arrays(batch.status, batch.time_h, batch.cost_usd,
                            batch.accuracy, batch.revocations,
                            results=_LazyResults(batch))


def simulate_batch(spec: ClusterSpec, n_trials: int,
                   rng: np.random.Generator, *,
                   replay=None, recorder=None,
                   record_trials: int = 4) -> MCBatch:
    """Run ``n_trials`` independent Monte-Carlo trials of ``spec``, batched.

    Equivalent to ``[simulate_run(spec, rng) for _ in range(n_trials)]`` up
    to RNG consumption order; see the module docstring.

    ``replay`` (a ``traces.replay.ReplayContext``) swaps the stochastic
    lifetime sampling for trace playback: each trial is assigned a
    bootstrap window of the trace and draws its lifetimes from that
    window's observed revocations, and transient servers bill against the
    trace's piecewise-constant spot-price path instead of the static book
    price. With ``replay=None`` behaviour is unchanged.

    ``recorder`` (an ``obs.Recorder``) attaches observability: aggregate
    counters over ALL trials plus full per-trial event streams (tracks
    ``trial0..``) for the first ``record_trials`` trials — recording every
    trial of a 1024-trial sweep would dwarf the simulation itself, so the
    stream is a sampled subset while the counters stay exact.
    """
    if n_trials <= 0:
        raise ValueError(f"n_trials must be positive, got {n_trials}")
    N, W = n_trials, len(spec.workers)
    if W == 0:
        raise ValueError("spec has no workers")
    rec = recorder if recorder is not None else obs.NULL
    n_rec = min(record_trials, N) if rec.enabled else 0
    kind_w = [w.kind for w in spec.workers]

    bound = replay.bind(N, rng) if replay is not None else None

    def draw_lifetimes(kind: str, trial_idx: np.ndarray,
                       at_s) -> np.ndarray:
        if bound is not None:
            return bound.lifetimes(kind, trial_idx, at_s, rng)
        return _sample_lifetimes(kind, trial_idx.size, rng)

    # --- static per-slot attributes ------------------------------------
    rate_w = np.array([_worker_rate(w, spec.ps_region) for w in spec.workers])
    price_s = np.array([pricing.SERVER_TYPES[w.kind].price_hr(w.transient)
                        for w in spec.workers]) / 3600.0
    transient_w = np.array([w.transient for w in spec.workers], dtype=bool)
    join_step_w = np.array([w.join_step for w in spec.workers], dtype=np.float64)
    initial_w = join_step_w == 0

    # --- per-(trial, slot) state ---------------------------------------
    active = np.zeros((N, W), dtype=bool)
    joined = np.zeros((N, W), dtype=bool)
    provisioned = np.zeros((N, W), dtype=bool)
    start_t = np.full((N, W), np.nan)
    revoke_t = np.full((N, W), np.inf)     # absolute; inf = never revokes
    pending_t = np.full((N, W), np.inf)    # join activation time; inf = none

    for j in range(W):
        if initial_w[j]:
            active[:, j] = True
            joined[:, j] = True
            provisioned[:, j] = True
            start_t[:, j] = 0.0
            if transient_w[j]:
                revoke_t[:, j] = draw_lifetimes(spec.workers[j].kind,
                                                np.arange(N), 0.0)

    # Parameter servers: the run dies at the FIRST PS revocation, so only
    # min-over-PS matters; each PS bills to the trial's end either way.
    if spec.n_ps > 0 and spec.ps_transient:
        ps_revoke = draw_lifetimes("PS", np.repeat(np.arange(N), spec.n_ps),
                                   0.0).reshape(N, spec.n_ps).min(axis=1)
    else:
        ps_revoke = np.full(N, np.inf)

    # --- per-trial state -----------------------------------------------
    t = np.zeros(N)
    steps = np.zeros(N)
    worker_int = np.zeros(N)               # ∫ active_workers dt
    revocations = np.zeros(N, dtype=np.int64)
    status = np.full(N, RUNNING, dtype=np.int64)
    total = float(spec.total_steps)

    # --- synchronized event loop over the batch ------------------------
    # (fleet rate per the spec's batching mode — hetero layer: "dynamic"
    # = sum of active rates; "uniform" = n * slowest member)
    for _ in range(_MAX_EVENTS):
        m = status == RUNNING
        if not m.any():
            break
        rate = ps_capped_rate_batch(
            aggregate_rate_batch(active, rate_w, spec.batching), spec.n_ps)
        n_active = active.sum(axis=1).astype(np.float64)
        has_rate = rate > 0

        # candidate event times, all (N,)
        rv = np.where(active & transient_w, revoke_t, np.inf)
        t_rev = rv.min(axis=1)
        rev_slot = rv.argmin(axis=1)

        t_jact = pending_t.min(axis=1)
        jact_slot = pending_t.argmin(axis=1)

        with np.errstate(invalid="ignore", divide="ignore"):
            eligible = (~joined) & (join_step_w > 0) \
                & (steps[:, None] < join_step_w) & has_rate[:, None]
            cross = t[:, None] + (join_step_w - steps[:, None]) / rate[:, None]
            cross = np.where(eligible, cross, np.inf)
            t_jreq = cross.min(axis=1)
            jreq_slot = cross.argmin(axis=1)
            t_done = np.where(has_rate, t + (total - steps) / rate, np.inf)

        # stalled: no compute AND nothing pending -> all_revoked (legacy)
        dead = m & ~has_rate & np.isinf(t_jact)
        status[dead] = ALL_REVOKED
        m = m & ~dead

        ev_t = np.stack([t_rev, ps_revoke, t_jact, t_jreq, t_done])
        ev = ev_t.argmin(axis=0)           # ties resolve in legacy order
        t_next = ev_t.min(axis=0)

        # integrate the piecewise-constant rate up to each trial's event
        dt = np.where(m, np.maximum(0.0, t_next - t), 0.0)
        finite = np.isfinite(dt)
        steps += np.where(finite, rate * dt, 0.0)
        worker_int += np.where(finite, n_active * dt, 0.0)
        t_prev = t if n_rec == 0 else t.copy()
        t = np.where(m & finite, t_next, t)

        if n_rec:       # sampled trial streams: constant-rate segments
            for i in range(n_rec):
                if m[i] and finite[i] and dt[i] > 0 and rate[i] > 0:
                    rec.sim_span(obs.EV_STEP, cat=obs.CAT_SIM,
                                 track=f"trial{i}", t0=float(t_prev[i]),
                                 t1=float(t[i]), rate=float(rate[i]),
                                 n_active=float(n_active[i]))

        # --- apply events, masked per type -----------------------------
        done = m & (ev == _EV_DONE)
        steps[done] = total
        status[done] = COMPLETED
        if n_rec:
            for i in np.nonzero(done[:n_rec])[0]:
                rec.instant(obs.EV_TRIAL_DONE, cat=obs.CAT_SIM,
                            track=f"trial{i}", sim_t=float(t[i]),
                            steps=float(total))

        psk = m & (ev == _EV_PS)
        status[psk] = PS_REVOKED
        if n_rec:
            for i in np.nonzero(psk[:n_rec])[0]:
                rec.instant(obs.EV_REVOKE_FIRE, cat=obs.CAT_SIM,
                            track=f"trial{i}", sim_t=float(t[i]),
                            kind="PS", fatal=True)

        rev = m & (ev == _EV_REVOKE)
        if rev.any():
            idx = np.nonzero(rev)[0]
            slots = rev_slot[idx]
            active[idx, slots] = False
            # processed revocations never fire twice: the slot leaves the
            # active set, and billing reads revoke_t directly.
            fatal = (slots == 0) & (not spec.master_failover)
            status[idx[fatal]] = MASTER_REVOKED
            revocations[idx[~fatal]] += 1
            if rec.enabled:
                for s in np.unique(slots):
                    rec.metrics.counter("revocations_total",
                                        kind=kind_w[s]).inc(
                                            int((slots == s).sum()))
                for i, s in zip(idx, slots):
                    if i < n_rec:
                        rec.instant(obs.EV_REVOKE_FIRE, cat=obs.CAT_SIM,
                                    track=f"trial{i}", sim_t=float(t[i]),
                                    kind=kind_w[s], slot=int(s),
                                    fatal=bool(s == 0
                                               and not spec.master_failover))

        jrq = m & (ev == _EV_JOIN_REQ)
        if jrq.any():
            idx = np.nonzero(jrq)[0]
            slots = jreq_slot[idx]
            joined[idx, slots] = True
            pending_t[idx, slots] = t[idx] + JOIN_OVERHEAD_S
            if n_rec:
                for i, s in zip(idx, slots):
                    if i < n_rec:
                        rec.instant(obs.EV_SLOT_REQUEST, cat=obs.CAT_SIM,
                                    track=f"trial{i}", sim_t=float(t[i]),
                                    kind=kind_w[s], slot=int(s))

        jac = m & (ev == _EV_JOIN_ACT)
        if jac.any():
            idx = np.nonzero(jac)[0]
            slots = jact_slot[idx]
            pending_t[idx, slots] = np.inf
            provisioned[idx, slots] = True
            active[idx, slots] = True
            start_t[idx, slots] = t[idx]
            if n_rec:
                for i, s in zip(idx, slots):
                    if i < n_rec:
                        rec.instant(obs.EV_SLOT_JOIN, cat=obs.CAT_SIM,
                                    track=f"trial{i}", sim_t=float(t[i]),
                                    kind=kind_w[s], slot=int(s))
            # fresh lifetime sampled at activation, grouped per slot so the
            # draw stays one vectorized call per server kind
            for s in np.unique(slots):
                sel = idx[slots == s]
                if transient_w[s]:
                    revoke_t[sel, s] = t[sel] + draw_lifetimes(
                        spec.workers[s].kind, sel, t[sel])
    status[status == RUNNING] = NO_PROGRESS

    # --- billing: per-second, each server to min(revocation, run end) ---
    t_end = t[:, None]
    bill_end = np.minimum(revoke_t, t_end)     # inf (never revoked) -> t_end
    with np.errstate(invalid="ignore"):        # NaN start = never provisioned
        secs = np.where(provisioned, np.maximum(0.0, bill_end - start_t), 0.0)
    if bound is None:
        cost = (secs * price_s).sum(axis=1)
    else:
        # transient slots bill against the trace's spot path (exact
        # piecewise-constant integral); on-demand slots keep book price
        cost = np.zeros(N)
        for j in range(W):
            if transient_w[j] and bound.has_prices(spec.workers[j].kind):
                s0 = np.where(provisioned[:, j],
                              np.nan_to_num(start_t[:, j]), 0.0)
                cost += bound.cost_usd(spec.workers[j].kind, s0,
                                       s0 + secs[:, j])
            else:
                cost += secs[:, j] * price_s[j]
    if bound is not None and spec.ps_transient and bound.has_prices("PS"):
        cost += spec.n_ps * bound.cost_usd("PS", np.zeros(N), t)
    else:
        cost += spec.n_ps * pricing.SERVER_TYPES["PS"].price_hr(
            spec.ps_transient) * t / 3600.0

    avg_w = np.divide(worker_int, t, out=np.zeros(N), where=t > 0)
    dynamic = bool((join_step_w > 0).any())
    acc = accuracy_model_batch(avg_w, dynamic=dynamic,
                               adaptive_lr=spec.adaptive_lr)
    acc = np.where(status == COMPLETED, acc, np.nan)

    if rec.enabled:
        rec.metrics.counter("trials_total").inc(N)
        rec.metrics.counter("trials_completed").inc(
            int((status == COMPLETED).sum()))
        rec.metrics.counter("steps_total", kind="virtual").inc(
            float(np.where(status == COMPLETED, total, steps).sum()))

    lifetimes_h = np.where(provisioned, secs / 3600.0, np.nan)
    return MCBatch(spec=spec, status=status, time_h=t / 3600.0,
                   cost_usd=cost, accuracy=acc, revocations=revocations,
                   steps_done=np.where(status == COMPLETED, total, steps),
                   avg_active_workers=avg_w, lifetimes_h=lifetimes_h)
