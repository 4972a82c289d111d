"""Cost model + budget-constrained cluster planning (C1, Table III).

A copy of ``repro.core.cost``: the same closed forms, so one candidate gives
the same numbers in both packages.

Analytic counterparts of the Monte-Carlo simulator: expected training time,
expected cost under per-second billing, and revocation-risk terms derived
from the calibrated lifetime CDFs. The planner answers the paper's §III-C
question — *given a fixed budget, scale up or scale out?* — by enumerating
candidate configurations, scoring expected completion time with revocation
overheads, and filtering to the budget.

Everything here is deterministic (closed-form expectations), so the planner
can run inside a scheduler loop at negligible cost; the simulator
(core/simulator.py) cross-validates these expectations in tests.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core import pricing
from repro_torch.core.simulator import accuracy_model, ps_capped_rate
from repro_torch.core.transient import LIFETIMES

DEFAULT_STEPS = 64_000


@dataclasses.dataclass(frozen=True)
class PlanConfig:
    """One candidate cluster: counts per server kind + PS count."""
    workers: Tuple[Tuple[str, int], ...]     # ((kind, count), ...)
    n_ps: int = 1
    transient: bool = True

    @property
    def n_workers(self) -> int:
        return sum(c for _, c in self.workers)

    def describe(self) -> str:
        w = "+".join(f"{c}x{k}" for k, c in self.workers if c)
        ps = f"+{self.n_ps}PS" if self.n_ps else ""
        t = "transient" if self.transient else "on-demand"
        return f"{w}{ps} ({t})"


@dataclasses.dataclass(frozen=True)
class PlanEstimate:
    config: PlanConfig
    time_h: float                 # expected completion (incl. revocation drag)
    cost_usd: float               # expected per-second-billed cost
    failure_p: float              # P(master revoked before completion)
    exp_revocations: float
    accuracy: float               # staleness model estimate
    speedup_vs_1k80: float

    def within(self, budget: float) -> bool:
        return self.cost_usd <= budget + 1e-9


# ---------------------------------------------------------------------------
# Expectations
# ---------------------------------------------------------------------------

def ideal_rate(cfg: PlanConfig) -> float:
    """Aggregate steps/s with every worker alive, PS-capacity capped."""
    s = sum(pricing.SERVER_TYPES[k].steps_per_sec * c for k, c in cfg.workers)
    n_ps = cfg.n_ps if cfg.n_workers > 1 else 0
    return ps_capped_rate(s, n_ps)


def expected_time_h(cfg: PlanConfig, total_steps: int = DEFAULT_STEPS) -> float:
    """Expected completion hours, folding in expected revocation drag.

    First-order model validated against the simulator: each expected
    revocation removes one worker's rate for the *remaining* half of the
    run on average, so drag = sum_i p_i * (rate_i / R) * T_ideal / 2.
    (Matches Table IV: 4-K80 r=1 overhead ~15.3% ~= (1/4)/2 + restart.)
    """
    R = ideal_rate(cfg)
    if R <= 0:
        return math.inf
    t_ideal = total_steps / R
    if not cfg.transient:
        return t_ideal / 3600.0
    drag = 0.0
    for kind, count in cfg.workers:
        p = LIFETIMES[kind].p_revoked_by(t_ideal)
        share = pricing.SERVER_TYPES[kind].steps_per_sec / R
        drag += count * p * share * 0.5
    return t_ideal * (1.0 + drag) / 3600.0


def expected_cost_usd(cfg: PlanConfig, total_steps: int = DEFAULT_STEPS) -> float:
    t_h = expected_time_h(cfg, total_steps)
    if math.isinf(t_h):
        return math.inf
    cost = 0.0
    for kind, count in cfg.workers:
        # a revoked worker is billed only to its revocation (~T/2 on average)
        p = (LIFETIMES[kind].p_revoked_by(t_h * 3600) if cfg.transient else 0.0)
        eff_h = t_h * (1.0 - 0.5 * p)
        cost += count * pricing.SERVER_TYPES[kind].price_hr(cfg.transient) * eff_h
    if cfg.n_workers > 1:
        cost += cfg.n_ps * pricing.SERVER_TYPES["PS"].ondemand_hr * t_h
    return cost


def master_failure_p(cfg: PlanConfig, total_steps: int = DEFAULT_STEPS) -> float:
    """P(job fails) under the paper's TF semantics: master revocation kills
    the run. With our master-less checkpointing this becomes ~0 (C2)."""
    if not cfg.transient:
        return 0.0
    t_s = expected_time_h(cfg, total_steps) * 3600
    kind = cfg.workers[0][0]
    return LIFETIMES[kind].p_revoked_by(t_s)


def estimate(cfg: PlanConfig, total_steps: int = DEFAULT_STEPS,
             baseline_rate: Optional[float] = None) -> PlanEstimate:
    t_h = expected_time_h(cfg, total_steps)
    base = baseline_rate or pricing.SERVER_TYPES["K80"].steps_per_sec
    t_base_h = total_steps / base / 3600.0
    exp_rev = sum(c * LIFETIMES[k].p_revoked_by(t_h * 3600)
                  for k, c in cfg.workers) if cfg.transient else 0.0
    return PlanEstimate(
        config=cfg,
        time_h=t_h,
        cost_usd=expected_cost_usd(cfg, total_steps),
        failure_p=master_failure_p(cfg, total_steps),
        exp_revocations=exp_rev,
        accuracy=accuracy_model(cfg.n_workers),
        speedup_vs_1k80=t_base_h / t_h if t_h > 0 else 0.0,
    )


# ---------------------------------------------------------------------------
# Budget planner (scale up vs scale out, §III-C)
# ---------------------------------------------------------------------------

def enumerate_candidates(max_workers: int = 16, kinds: Sequence[str] = ("K80", "P100", "V100"),
                         heterogeneous: bool = False,
                         max_ps: int = 2) -> List[PlanConfig]:
    cands: List[PlanConfig] = []
    if heterogeneous:
        for counts in itertools.product(range(max_workers + 1), repeat=len(kinds)):
            n = sum(counts)
            if not (1 <= n <= max_workers):
                continue
            w = tuple((k, c) for k, c in zip(kinds, counts) if c)
            for n_ps in range(1, max_ps + 1):
                cands.append(PlanConfig(w, n_ps=n_ps))
    else:
        for kind in kinds:
            for n in range(1, max_workers + 1):
                for n_ps in range(1, max_ps + 1):
                    if n == 1 and n_ps > 1:
                        continue
                    cands.append(PlanConfig(((kind, n),), n_ps=n_ps))
    return cands


def plan_within_budget(budget_usd: float = pricing.SINGLE_K80_BUDGET,
                       total_steps: int = DEFAULT_STEPS,
                       *, max_workers: int = 16,
                       heterogeneous: bool = False,
                       min_accuracy: float = 0.0,
                       max_failure_p: float = 1.0) -> List[PlanEstimate]:
    """All feasible candidates sorted fastest-first (the paper's question)."""
    out = []
    for cfg in enumerate_candidates(max_workers, heterogeneous=heterogeneous):
        est = estimate(cfg, total_steps)
        if (est.within(budget_usd) and est.accuracy >= min_accuracy
                and est.failure_p <= max_failure_p):
            out.append(est)
    return sorted(out, key=lambda e: e.time_h)


def dominates(a, b) -> bool:
    """Pareto dominance over (time, cost, -accuracy): ``a`` is no worse on
    every axis and strictly better on at least one.  Works on anything with
    ``time_h`` / ``cost_usd`` / ``accuracy`` attributes (the analytic
    ``PlanEstimate`` and the scheduler's Monte-Carlo ``MCPlanEstimate``)."""
    return (a.time_h <= b.time_h and a.cost_usd <= b.cost_usd
            and a.accuracy >= b.accuracy
            and (a.time_h < b.time_h or a.cost_usd < b.cost_usd
                 or a.accuracy > b.accuracy))


def pareto_front(estimates: Sequence) -> List:
    """Non-dominated set over (time, cost, -accuracy), fastest-first."""
    front = [e for e in estimates
             if not any(dominates(o, e) for o in estimates)]
    return sorted(front, key=lambda e: e.time_h)


# ---------------------------------------------------------------------------
# Monte-Carlo cross-validation of the analytic expectations
# ---------------------------------------------------------------------------

def plan_to_spec(cfg: PlanConfig, total_steps: int = DEFAULT_STEPS,
                 *, master_failover: bool = False):
    """Bridge a planner candidate to a simulator ``ClusterSpec``."""
    from repro_torch.core.simulator import ClusterSpec, WorkerSpec
    workers = tuple(WorkerSpec(kind, cfg.transient)
                    for kind, count in cfg.workers for _ in range(count))
    n_ps = cfg.n_ps if len(workers) > 1 else 0
    return ClusterSpec(workers=workers, n_ps=n_ps, total_steps=total_steps,
                       master_failover=master_failover)


def mc_validate(cfg: PlanConfig, total_steps: int = DEFAULT_STEPS,
                n_trials: int = 1024, seed: int = 0):
    """Run the batched Monte-Carlo engine on a planner candidate.

    Returns a ``simulator.Summary`` whose means the closed-form
    ``estimate(cfg)`` should bracket — the cheap analytic model steers the
    search, the MC distributions arbitrate (tests/test_torch_scheduler.py
    pins this agreement).
    """
    from repro_torch.core.simulator import simulate_many
    return simulate_many(plan_to_spec(cfg, total_steps), n_runs=n_trials,
                         seed=seed, engine="batched")
