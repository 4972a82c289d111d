"""Online transient-aware provisioning policies + vectorized evaluator.

A copy of ``repro.core.policy``: the same code and the same numpy draws in the
same order, so one seed gives the same numbers in both packages.

The paper's redesign call: *"the dynamic cost and availability
characteristics of transient servers suggest the need for frameworks to
dynamically change cluster configurations to best take advantage of
current conditions."* ``optimize_provisioning`` picks ONE configuration
up front; this module closes the loop — policies observe the market (a
``Trace`` via its ``ReplayContext``) at decision epochs and re-plan the
cluster, driving the same join/revoke flow the sparse-mapping runtime
executes (``cluster.py``/``elastic.py``: joins pay ``JOIN_OVERHEAD_S``,
revoked slots refill at the next epoch, membership changes are the
masked/remesh path, so ``master_failover`` semantics apply).

Policies
--------
``StaticPolicy``    today's behaviour: one up-front decision, never
                    revisited (the ``optimize_provisioning`` output).
``GreedyCheapest``  at each epoch, move the fleet to the server type with
                    the best spot $/step right now (with hysteresis so
                    noise does not thrash the cluster through rejoin
                    overhead).
``LookaheadMC``     re-plans by running the batched MC engine as its
                    internal planner: each candidate configuration is
                    simulated over the *remaining* trace
                    (``ReplayContext.tail``) and scored on expected cost
                    + failure risk; switching must beat the current plan
                    by a margin that covers the rejoin overhead.
``OraclePolicy``    offline upper bound: every candidate is replayed as a
                    static plan over the same trace and each trial keeps
                    its best-in-hindsight outcome (complete first, then
                    cheapest). No online policy is expected to beat it;
                    the *oracle gap* is the headroom left on the table.

``evaluate_policy`` is the harness: N trials advance in lock-step wall
clock through shared decision epochs, but each trial carries its own
bootstrap-resampled revocations from the trace — the trial axis stays an
array axis end-to-end, same as ``core/mc.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs as obslib     # "obs" locally names the observation
from repro_torch.core import pricing
from repro_torch.core.mc import accuracy_model_batch, ps_capped_rate_batch
from repro_torch.core.simulator import (DEFAULT_TOTAL_STEPS, JOIN_OVERHEAD_S,
                                  ClusterSpec, ci95_halfwidth)
from repro_torch.traces.replay import ReplayContext, context_for

# Event codes for the segment event loop (tie-break order matters: a
# revocation at the same instant as completion resolves like the engine).
_EV_REVOKE, _EV_ACT, _EV_DONE, _EV_SEG = range(4)
_MAX_EVENTS = 100_000


@dataclasses.dataclass(frozen=True)
class PolicyDecision:
    """Target fleet + PS count. Homogeneous by default (``n_workers``
    servers of ``kind``); ``fleet`` makes it heterogeneous — an ordered
    ``((kind, count), ...)`` whose first entry provides the master slot
    (build with ``PolicyDecision.mixed``)."""
    kind: str
    n_workers: int
    n_ps: int = 1
    fleet: Optional[Tuple[Tuple[str, int], ...]] = None

    def __post_init__(self):
        if self.kind not in pricing.SERVER_TYPES:
            raise ValueError(f"unknown kind {self.kind!r}")
        if self.n_workers < 1:
            raise ValueError("n_workers must be >= 1")
        if self.fleet is not None:
            for kd, n in self.fleet:
                if kd not in pricing.SERVER_TYPES:
                    raise ValueError(f"unknown kind {kd!r} in fleet")
                if n < 1:
                    raise ValueError(f"fleet count for {kd} must be >= 1")
            kinds = [kd for kd, _ in self.fleet]
            if len(set(kinds)) != len(kinds):
                raise ValueError("fleet kinds must be unique (merge counts "
                                 "per kind)")
            if sum(n for _, n in self.fleet) != self.n_workers:
                raise ValueError("fleet counts must sum to n_workers")
            if self.fleet[0][0] != self.kind:
                raise ValueError("kind must match the fleet's first entry")

    @staticmethod
    def mixed(counts, n_ps: int = 1) -> "PolicyDecision":
        """Heterogeneous decision from ``{kind: count}`` / pair sequence."""
        pairs = tuple(counts.items()) if isinstance(counts, dict) \
            else tuple(counts)
        if not pairs:
            raise ValueError("mixed fleet needs at least one kind")
        return PolicyDecision(kind=pairs[0][0],
                              n_workers=sum(n for _, n in pairs),
                              n_ps=n_ps, fleet=pairs)

    def composition(self) -> Dict[str, int]:
        """Kind -> target worker count (the reconcile target)."""
        if self.fleet is not None:
            return dict(self.fleet)
        return {self.kind: self.n_workers}

    def to_spec(self, *, total_steps: int = DEFAULT_TOTAL_STEPS,
                master_failover: bool = True, transient: bool = True,
                batching: str = "dynamic",
                n_ps: Optional[int] = None) -> ClusterSpec:
        """The engine's ``ClusterSpec`` for this fleet — the one seam the
        lookahead planner, the differential validator, and the benchmarks
        all use, so a decision always prices the same everywhere.

        ``n_ps`` defaults to the decision's own PS count (the gym and the
        policy evaluator bill that many parameter servers, so validators
        must model the same fleet); pass an override to drop the PS for
        single-server planning."""
        n_ps = self.n_ps if n_ps is None else n_ps
        return ClusterSpec.mixed(self.composition(), batching=batching,
                                 transient=transient, n_ps=n_ps,
                                 total_steps=total_steps,
                                 master_failover=master_failover)

    @property
    def label(self) -> str:
        if self.fleet is not None:
            mix = "+".join(f"{n}x{kd}" for kd, n in self.fleet)
            return f"{mix}+{self.n_ps}PS"
        return f"{self.n_workers}x{self.kind}+{self.n_ps}PS"


@dataclasses.dataclass(frozen=True)
class PolicyObservation:
    """What a policy may look at — current conditions only, no future."""
    t_s: float
    steps_done: float               # mean over still-running trials
    total_steps: int
    frac_running: float             # trials neither completed nor timed out
    prices_hr: Dict[str, float]     # spot quote per kind, right now
    revocations_per_hr: Dict[str, float]  # trailing-hour observed intensity
    current: Optional[PolicyDecision]     # None before the first decision:
                                          # no incumbent, no hysteresis
    fleet_by_kind: Dict[str, int] = dataclasses.field(default_factory=dict)
    # ^ realized composition of the live fleet (kind -> active workers),
    #   which can differ from ``current``'s target mid-revocation-storm —
    #   the heterogeneity-aware signal mixed-fleet policies plan from


class Policy:
    """Interface: ``decide`` is called once per epoch, decisions are
    shared across trials (the observation aggregates per-trial state).

    ``act`` is the *online* entry point: it owns the incumbent-decision
    bookkeeping (fills ``obs.current``, appends kind/fleet changes to
    ``decision_log``) so any driver — the vectorized ``evaluate_policy``
    harness and the trace-driven training gym alike — replans a fleet
    with one call per epoch instead of re-implementing the plumbing.
    ``decide`` stays the pure strategy hook subclasses override.

    The interface is deliberately duck-typed: ``obs`` can be ANY frozen
    dataclass with a ``current`` field and ``ctx`` is optional, so the
    same act/decide/hysteresis machinery drives non-market controllers
    too — ``serving.autoscale.ReplicaAutoscaler`` replans inference
    replica counts from a ``ServeLoad`` observation with no trace at all.
    """
    name = "policy"

    def __init__(self):
        self._incumbent: Optional[PolicyDecision] = None
        self.decision_log: List[Tuple[float, PolicyDecision]] = []
        # label -> score for the most recent decide(); policies that rank
        # candidates fill it so drivers can attach the considered
        # alternatives to their replan spans (EV_REPLAN "candidates" arg)
        self.last_scores: Optional[Dict[str, float]] = None

    def reset(self, rng: np.random.Generator) -> None:
        """Clear online state; called once per evaluation/episode."""
        self._incumbent = None
        self.decision_log = []
        self.last_scores = None

    def decide(self, obs: PolicyObservation,
               ctx: Optional[ReplayContext] = None) -> PolicyDecision:
        raise NotImplementedError

    def act(self, obs: PolicyObservation,
            ctx: Optional[ReplayContext] = None) -> PolicyDecision:
        """One online replanning step: observe -> decide -> record.

        If the driver did not track an incumbent (``obs.current`` is
        None), the policy's own is substituted so hysteresis works; the
        returned decision becomes the new incumbent either way.
        """
        if obs.current is None and self._incumbent is not None:
            obs = dataclasses.replace(obs, current=self._incumbent)
        dec = self.decide(obs, ctx)
        if self._incumbent is None or dec != self._incumbent:
            self.decision_log.append((obs.t_s, dec))
        self._incumbent = dec
        return dec

    @property
    def switches(self) -> int:
        """Decision *changes* recorded since the last ``reset``."""
        return max(len(self.decision_log) - 1, 0)


class StaticPolicy(Policy):
    def __init__(self, decision: PolicyDecision):
        super().__init__()
        self.name = f"static({decision.label})"
        self.decision = decision

    def decide(self, obs, ctx):
        return self.decision


class GreedyCheapest(Policy):
    """Chase the best spot $/step, with switching hysteresis.

    The score is ``price / effective_rate`` (rate under the decision's PS
    cap), i.e. dollars per training step *right now*; a switch must beat
    the incumbent by ``switch_margin`` because rejoining costs
    ``JOIN_OVERHEAD_S`` of dead time per worker.
    """

    def __init__(self, n_workers: int = 4, n_ps: int = 1,
                 kinds: Sequence[str] = ("K80", "P100", "V100"),
                 switch_margin: float = 0.15):
        super().__init__()
        self.name = f"greedy({n_workers}w)"
        self.n_workers, self.n_ps = n_workers, n_ps
        self.kinds = tuple(kinds)
        self.switch_margin = switch_margin

    def _dollars_per_step(self, kind: str, price_hr: float) -> float:
        rate_1 = pricing.SERVER_TYPES[kind].steps_per_sec
        fleet = float(ps_capped_rate_batch(
            np.array([rate_1 * self.n_workers]), self.n_ps)[0])
        return price_hr * self.n_workers / (fleet * 3600.0)

    def decide(self, obs, ctx):
        scores = {k: self._dollars_per_step(k, obs.prices_hr[k])
                  for k in self.kinds}
        self.last_scores = dict(scores)     # kind -> $/step, for replan spans
        best = min(scores, key=scores.get)
        cur = obs.current.kind if obs.current is not None else None
        if cur in scores and \
                scores[best] >= (1.0 - self.switch_margin) * scores[cur]:
            best = cur          # hysteresis only against a real incumbent
        return PolicyDecision(best, self.n_workers, self.n_ps)


class LookaheadMC(Policy):
    """Re-plan at each epoch with the batched MC engine over the trace
    tail: simulate every candidate on the remaining workload against
    ``ctx.tail(now)`` and keep the incumbent unless a challenger's
    expected cost (plus a failure-risk penalty) beats it by
    ``switch_margin`` — the margin is what keeps a calm trace from paying
    rejoin overhead for noise.
    """

    def __init__(self, candidates: Optional[Sequence[PolicyDecision]] = None,
                 n_plan_trials: int = 48, switch_margin: float = 0.08,
                 failure_penalty_usd: float = 10.0, seed: int = 0):
        super().__init__()
        self.name = "lookahead-mc"
        self.candidates = tuple(candidates) if candidates else tuple(
            PolicyDecision(kind, n)
            for kind in ("K80", "P100", "V100") for n in (2, 4, 8))
        self.n_plan_trials = n_plan_trials
        self.switch_margin = switch_margin
        self.failure_penalty_usd = failure_penalty_usd
        self._seed = seed
        self._rng = np.random.default_rng(seed)

    def reset(self, rng):
        super().reset(rng)
        self._rng = np.random.default_rng(self._seed)

    def _score(self, dec: PolicyDecision, remaining_steps: int,
               tail: ReplayContext) -> float:
        from repro_torch.core import mc
        spec = dec.to_spec(total_steps=remaining_steps,
                           master_failover=True,
                           n_ps=dec.n_ps if dec.n_workers > 1 else 0)
        batch = mc.simulate_batch(spec, self.n_plan_trials, self._rng,
                                  replay=tail)
        fail = 1.0 - batch.completed.mean()
        return float(batch.cost_usd.mean()) + self.failure_penalty_usd * fail

    def decide(self, obs, ctx):
        remaining = int(max(obs.total_steps - obs.steps_done, 1.0))
        tail = ctx.tail(obs.t_s)
        scores = {dec: self._score(dec, remaining, tail)
                  for dec in self.candidates}
        self.last_scores = {d.label: s for d, s in scores.items()}
        best = min(scores, key=scores.get)
        cur = obs.current
        if cur is not None and cur in scores and \
                scores[best] >= (1.0 - self.switch_margin) * scores[cur]:
            return cur          # hysteresis only against a real incumbent
        return best


class OraclePolicy(Policy):
    """Offline best-in-hindsight bound over a candidate set.

    Not an online policy: ``evaluate_policy`` replays every candidate as
    a static plan over the same trace and keeps, per trial, the best
    outcome (completion first, then cost, then time). The gap between an
    online policy and this envelope is its regret against the best static
    choice made with full knowledge of the future.
    """

    def __init__(self, candidates: Optional[Sequence[PolicyDecision]] = None):
        super().__init__()
        self.name = "oracle"
        self.candidates = tuple(candidates) if candidates else tuple(
            PolicyDecision(kind, n)
            for kind in ("K80", "P100", "V100") for n in (2, 4, 8))

    def decide(self, obs, ctx):   # pragma: no cover - evaluator special-cases
        raise RuntimeError("OraclePolicy is evaluated offline, not stepped")


def make_observation(ctx: ReplayContext, *, t_s: float, steps_done: float,
                     total_steps: int, frac_running: float = 1.0,
                     current: Optional[PolicyDecision] = None,
                     fleet_by_kind: Optional[Dict[str, int]] = None
                     ) -> PolicyObservation:
    """Assemble the current-conditions-only observation from a context.

    Shared by ``evaluate_policy`` and the training gym so both drivers
    show policies exactly the same market view: the spot quote per kind
    at ``t_s``, the trailing-hour revocation intensity, and the realized
    per-kind fleet composition — never the future of the trace.
    """
    return PolicyObservation(
        t_s=t_s,
        steps_done=steps_done,
        total_steps=total_steps,
        frac_running=frac_running,
        prices_hr={kd: float(ctx.price_at(kd, t_s))
                   for kd in pricing.SERVER_TYPES},
        revocations_per_hr={kd: ctx.revocation_intensity(kd, t_s)
                            for kd in ("K80", "P100", "V100")},
        current=current,
        fleet_by_kind=dict(fleet_by_kind or {}))


# ---------------------------------------------------------------------------
# The vectorized evaluation harness
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PolicyOutcome:
    """Per-trial outcome arrays for one (policy, trace) evaluation."""
    policy: str
    trace: str
    n_trials: int
    completed: np.ndarray          # (N,) bool
    time_h: np.ndarray             # (N,) float64 (cap time if incomplete)
    cost_usd: np.ndarray           # (N,) float64
    accuracy: np.ndarray           # (N,) float64, NaN when not completed
    switches: int                  # shared decision changes over the run
    decisions: Tuple[Tuple[float, PolicyDecision], ...]

    @property
    def completion_rate(self) -> float:
        return float(self.completed.mean())

    def mean_ci(self, field: str, completed_only: bool = True
                ) -> Tuple[float, float]:
        """(mean, 95% CI half-width); degenerate counts give (0, 0)."""
        x = getattr(self, field)
        m = self.completed if completed_only else np.ones_like(x, bool)
        sel = x[m]
        if sel.size == 0:
            return (0.0, 0.0)
        return (float(sel.mean()),
                ci95_halfwidth(float(sel.std()), sel.size))


def evaluate_policy(policy: Policy, trace, *, n_trials: int = 256,
                    seed: int = 0,
                    total_steps: int = DEFAULT_TOTAL_STEPS,
                    epoch_s: float = 1800.0,
                    max_h: float = 48.0,
                    recorder=None) -> PolicyOutcome:
    """Replay ``policy`` against ``trace`` over ``n_trials`` trials.

    Wall clock advances in shared decision epochs; between epochs each
    trial runs its own event sequence (bootstrap revocations, joins
    activating after ``JOIN_OVERHEAD_S``, completion) as array programs
    over the trial axis. Parameter servers are on-demand (the redesigned
    flow; policies choose worker fleets) and revoked workers are refilled
    at the next epoch, so there is no fatal failure mode — trials that
    outlive ``max_h`` count as incomplete.

    ``recorder`` (an ``obs.Recorder``) records each shared replanning
    epoch as an ``EV_REPLAN`` span carrying the chosen decision and, for
    ranking policies, the considered-candidate scores (``last_scores``).
    """
    ctx = context_for(trace)
    rec = recorder if recorder is not None else obslib.NULL
    if isinstance(policy, OraclePolicy):
        return _oracle_envelope(policy, ctx, n_trials=n_trials, seed=seed,
                                total_steps=total_steps, epoch_s=epoch_s,
                                max_h=max_h)
    rng = np.random.default_rng(seed)
    policy.reset(rng)
    # "zero" bootstrap: every trial replays the one realized timeline, so
    # shared policy decisions stay aligned with what trials experience
    bound = ctx.bind(n_trials, rng, bootstrap="zero")
    N = n_trials
    max_s = max_h * 3600.0

    # per-trial state
    t = np.zeros(N)
    steps = np.zeros(N)
    worker_int = np.zeros(N)              # ∫ active_workers dt
    ps_int = np.zeros(N)                  # ∫ n_ps dt (on-demand PS billing)
    done = np.zeros(N, dtype=bool)
    ever_joined_late = np.zeros(N, dtype=bool)   # membership changed mid-run

    # slot columns: metadata shared, occupancy per-trial
    slot_kind: List[str] = []
    active = np.zeros((N, 0), dtype=bool)
    start_t = np.zeros((N, 0))
    revoke_t = np.zeros((N, 0))
    release_t = np.zeros((N, 0))
    pend_t = np.zeros((N, 0))

    def add_columns(kind: str, need: np.ndarray, t0: float,
                    overhead_s: float):
        # one block append per decision, not one concatenate per column
        nonlocal active, start_t, revoke_t, release_t, pend_t
        n_new = int(need.max())
        slot_kind.extend([kind] * n_new)
        pend_block = np.where(need[:, None] > np.arange(n_new),
                              t0 + overhead_s, np.inf)
        pend_t = np.concatenate([pend_t, pend_block], axis=1)
        active = np.concatenate(
            [active, np.zeros((N, n_new), dtype=bool)], axis=1)
        start_t = np.concatenate([start_t, np.full((N, n_new), np.nan)],
                                 axis=1)
        revoke_t = np.concatenate([revoke_t, np.full((N, n_new), np.inf)],
                                  axis=1)
        release_t = np.concatenate([release_t, np.full((N, n_new), np.inf)],
                                   axis=1)

    current = None
    total = float(total_steps)
    k = 0
    while True:
        t_epoch = k * epoch_s
        running = ~done & (t_epoch < max_s)
        if not running.any():
            break

        # --- observe + act (decision shared across trials) ---------------
        fleet_now: Dict[str, int] = {}
        if slot_kind and running.any():
            rows = np.nonzero(running)[0]
            for kd in dict.fromkeys(slot_kind):      # first-seen order
                cols = [i for i, kk in enumerate(slot_kind) if kk == kd]
                mean = float(active[np.ix_(rows, cols)].sum(axis=1).mean())
                n = int(round(mean))
                if n > 0:                # no phantom zero-count kinds
                    fleet_now[kd] = n
        obs = make_observation(ctx, t_s=t_epoch,
                               steps_done=float(steps[running].mean()),
                               total_steps=total_steps,
                               frac_running=float(running.mean()),
                               current=current,
                               fleet_by_kind=fleet_now)
        with rec.span(obslib.EV_REPLAN, cat=obslib.CAT_POLICY,
                      sim_t=t_epoch, epoch=k) as replan_args:
            dec = policy.act(obs, ctx)
            if rec.enabled:
                replan_args["decision"] = dec.label
                replan_args["frac_running"] = obs.frac_running
                replan_args["fleet_by_kind"] = dict(fleet_now)
                if policy.last_scores:
                    replan_args["candidates"] = dict(policy.last_scores)
        current = dec

        # --- reconcile the fleet to the decision (per target kind) ------
        target = dec.composition()
        S = len(slot_kind)
        off = np.array([kd not in target for kd in slot_kind],
                       dtype=bool) if S else np.zeros(0, dtype=bool)
        if S and off.any():
            # release every slot of an untargeted type (all trials at once)
            rel = running[:, None] & active[:, off]
            release_t[:, off] = np.where(rel,
                                         np.minimum(release_t[:, off],
                                                    t_epoch),
                                         release_t[:, off])
            active[:, off] &= ~rel
            pend_t[:, off] = np.where(running[:, None], np.inf,
                                      pend_t[:, off])
        kinds_arr = list(slot_kind)          # snapshot: columns added below
        for tkind, t_n in target.items():
            cols = np.array([i for i, kd in enumerate(kinds_arr)
                             if kd == tkind], dtype=np.int64)
            have = np.zeros(N, dtype=np.int64)
            if cols.size:
                have = (active[:, cols]
                        | np.isfinite(pend_t[:, cols])).sum(axis=1)
                # shrink: release surplus columns, last-joined first
                excess = np.where(running, have - t_n, 0)
                for c in cols[::-1]:
                    if not (excess > 0).any():
                        break
                    hit = (excess > 0) & active[:, c]
                    release_t[hit, c] = t_epoch
                    active[hit, c] = False
                    excess[hit] -= 1
                    drop = (excess > 0) & np.isfinite(pend_t[:, c])
                    pend_t[drop, c] = np.inf
                    excess[drop] -= 1
            need = np.where(running, np.maximum(t_n - have, 0), 0)
            if (need > 0).any():
                # initial provisioning (t=0) is free, like the engine's
                # slot 0; later joins pay the sparse-mapping overhead
                add_columns(tkind, need, t_epoch,
                            0.0 if k == 0 else JOIN_OVERHEAD_S)
                if k > 0:
                    ever_joined_late |= need > 0

        # --- advance the segment [t_epoch, t_epoch + epoch_s) -----------
        S = len(slot_kind)
        rate_w = np.array([pricing.SERVER_TYPES[kd].steps_per_sec
                           for kd in slot_kind])
        transient_cols = np.ones(S, dtype=bool)     # worker fleets only
        t_seg_end = min(t_epoch + epoch_s, max_s)
        t = np.where(running & (t < t_epoch), t_epoch, t)
        for _ in range(_MAX_EVENTS):
            m = running & ~done & (t < t_seg_end)
            if not m.any():
                break
            rate = ps_capped_rate_batch((active * rate_w).sum(axis=1),
                                        dec.n_ps)
            n_active = active.sum(axis=1).astype(np.float64)
            has_rate = rate > 0

            rv = np.where(active & transient_cols, revoke_t, np.inf)
            t_rev = rv.min(axis=1) if S else np.full(N, np.inf)
            rev_slot = rv.argmin(axis=1) if S else np.zeros(N, np.int64)
            t_act = pend_t.min(axis=1) if S else np.full(N, np.inf)
            act_slot = pend_t.argmin(axis=1) if S else np.zeros(N, np.int64)
            with np.errstate(invalid="ignore", divide="ignore"):
                t_done = np.where(has_rate, t + (total - steps) / rate,
                                  np.inf)

            ev_t = np.stack([t_rev, t_act, t_done,
                             np.full(N, t_seg_end)])
            ev = ev_t.argmin(axis=0)
            t_next = ev_t.min(axis=0)

            dt = np.where(m, np.maximum(0.0, t_next - t), 0.0)
            steps += np.where(m, rate * dt, 0.0)
            worker_int += np.where(m, n_active * dt, 0.0)
            ps_int += np.where(m, float(dec.n_ps) * dt, 0.0)
            t = np.where(m, t_next, t)

            hit_done = m & (ev == _EV_DONE)
            steps[hit_done] = total
            done[hit_done] = True

            hit_rev = m & (ev == _EV_REVOKE)
            if hit_rev.any():
                idx = np.nonzero(hit_rev)[0]
                cols = rev_slot[idx]
                active[idx, cols] = False
                # billing reads revoke_t; refill happens next epoch
            hit_act = m & (ev == _EV_ACT)
            if hit_act.any():
                idx = np.nonzero(hit_act)[0]
                cols = act_slot[idx]
                pend_t[idx, cols] = np.inf
                active[idx, cols] = True
                start_t[idx, cols] = t[idx]
                for c in np.unique(cols):
                    sel = idx[cols == c]
                    revoke_t[sel, c] = t[sel] + bound.lifetimes(
                        slot_kind[c], sel, t[sel], rng)
        k += 1

    # trials that never finished: clock stops at the cap
    time_cap = np.minimum(t, max_s)
    t_final = np.where(done, t, time_cap)

    # --- billing ---------------------------------------------------------
    bill_end = np.minimum(np.minimum(revoke_t, release_t), t_final[:, None])
    with np.errstate(invalid="ignore"):
        secs = np.where(np.isfinite(start_t),
                        np.maximum(0.0, bill_end - start_t), 0.0)
    cost = np.zeros(N)
    for c, kd in enumerate(slot_kind):
        if ctx.has_prices(kd):
            s0 = np.nan_to_num(start_t[:, c])
            cost += bound.cost_usd(kd, s0, s0 + secs[:, c])
        else:
            cost += secs[:, c] * pricing.SERVER_TYPES[kd].transient_hr \
                / 3600.0
    cost += ps_int * pricing.SERVER_TYPES["PS"].ondemand_hr / 3600.0

    avg_w = np.divide(worker_int, t_final, out=np.zeros(N),
                      where=t_final > 0)
    acc_static = accuracy_model_batch(avg_w, dynamic=False)
    acc_dyn = accuracy_model_batch(avg_w, dynamic=True, adaptive_lr=True)
    acc = np.where(ever_joined_late, acc_dyn, acc_static)
    acc = np.where(done, acc, np.nan)

    return PolicyOutcome(policy=policy.name, trace=ctx.trace.name,
                         n_trials=N, completed=done,
                         time_h=t_final / 3600.0, cost_usd=cost,
                         accuracy=acc,
                         switches=policy.switches,
                         decisions=tuple(policy.decision_log))


def _oracle_envelope(policy: OraclePolicy, ctx: ReplayContext, *,
                     n_trials: int, seed: int, total_steps: int,
                     epoch_s: float, max_h: float) -> PolicyOutcome:
    """Best-in-hindsight: per trial, the best static candidate outcome."""
    runs = [evaluate_policy(StaticPolicy(dec), ctx, n_trials=n_trials,
                            seed=seed, total_steps=total_steps,
                            epoch_s=epoch_s, max_h=max_h)
            for dec in policy.candidates]
    # order: completion beats cost beats time
    big = 1e12
    score = np.stack([np.where(r.completed, r.cost_usd + r.time_h * 1e-6,
                               big + r.cost_usd) for r in runs])
    pick = score.argmin(axis=0)
    take = lambda field: np.stack(
        [getattr(r, field) for r in runs])[pick, np.arange(n_trials)]
    return PolicyOutcome(policy=policy.name, trace=ctx.trace.name,
                         n_trials=n_trials,
                         completed=take("completed"),
                         time_h=take("time_h"),
                         cost_usd=take("cost_usd"),
                         accuracy=take("accuracy"),
                         switches=0,
                         decisions=tuple())


def default_policies(n_workers: int = 4) -> List[Policy]:
    """The benchmark's 4-policy panel (static baseline = paper's 4xK80)."""
    return [StaticPolicy(PolicyDecision("K80", n_workers)),
            GreedyCheapest(n_workers=n_workers),
            LookaheadMC(),
            OraclePolicy()]
