"""Differential validation: the gym's trained runs vs the MC engine
(counterpart of ``repro.gym.validate``; the comparison is numpy, the
sweep trains with torch on ``device``).

The tolerance contract (documented here, cited by README/ARCHITECTURE,
asserted in ``tests/test_gym.py`` and the CI ``gym-smoke`` job):

- **steps**: mean virtual steps completed (over all trials, failures
  included) agree within ``TOLERANCE["steps_rel"]`` relative error;
- **cost**: mean billed cost over *completed* trials agrees within
  ``TOLERANCE["cost_rel"]`` relative error (spot-path integrals on both
  sides);
- **completion**: completion rates agree within
  ``TOLERANCE["completion_abs"]`` absolute;
- **accuracy**: NOT compared by value — the engine reports the paper's
  calibrated 64K-step accuracy model while the gym reports real eval
  accuracy of a reduced run. Accuracy is instead pinned by *shape*:
  across a sweep of revocation intensities, gym eval accuracy must be
  monotonically non-increasing (within ``TOLERANCE["acc_slack"]``) while
  executed steps are non-increasing — the paper's Table IV / Fig 5
  degradation story, reproduced in real training.

Both sides replay the SAME trace in "zero"-bootstrap mode: each trial
starts at t=0 of the realized timeline and draws its lifetimes from the
trace's windowed empirical distributions, so the two implementations
(the scalar gym fleet model and the vectorized batched engine) see
identical stochastic processes and may differ only through their event
semantics — which is exactly what this module pins.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.policy import PolicyDecision, StaticPolicy
from repro_torch.core.simulator import DEFAULT_TOTAL_STEPS, Summary, simulate_many
from repro_torch.gym.gym import GymLedger, TransientGym, summarize_ledgers
from repro_torch.traces.replay import ReplayContext
from repro_torch.traces.synth import synthetic_trace

TOLERANCE = {
    "steps_rel": 0.10,        # mean virtual steps, all trials
    "cost_rel": 0.15,         # mean billed $, completed trials
    "completion_abs": 0.15,   # completion-rate gap
    "acc_slack": 0.02,        # allowed accuracy rise between intensities
}


@dataclasses.dataclass
class DiffReport:
    """One gym-vs-engine comparison on one (trace, fleet) pair."""
    trace: str
    label: str                    # the static fleet under test
    n_gym: int
    n_engine: int
    gym_summary: Summary
    engine_summary: Summary
    gym_steps_mean: float
    engine_steps_mean: float
    gym_cost_mean: float          # completed trials
    engine_cost_mean: float
    gym_completion: float
    engine_completion: float

    @property
    def steps_rel_err(self) -> float:
        return abs(self.gym_steps_mean - self.engine_steps_mean) \
            / max(self.engine_steps_mean, 1e-9)

    @property
    def cost_rel_err(self) -> float:
        return abs(self.gym_cost_mean - self.engine_cost_mean) \
            / max(self.engine_cost_mean, 1e-9)

    @property
    def completion_gap(self) -> float:
        return abs(self.gym_completion - self.engine_completion)

    def failures(self, tol: Optional[Dict[str, float]] = None) -> List[str]:
        tol = tol or TOLERANCE
        out = []
        if self.steps_rel_err > tol["steps_rel"]:
            out.append(f"steps: gym {self.gym_steps_mean:.0f} vs engine "
                       f"{self.engine_steps_mean:.0f} "
                       f"(rel {self.steps_rel_err:.3f} > "
                       f"{tol['steps_rel']})")
        both_complete = min(self.gym_summary.n_completed,
                            self.engine_summary.n_completed) > 0
        if both_complete and self.cost_rel_err > tol["cost_rel"]:
            out.append(f"cost: gym ${self.gym_cost_mean:.3f} vs engine "
                       f"${self.engine_cost_mean:.3f} "
                       f"(rel {self.cost_rel_err:.3f} > {tol['cost_rel']})")
        if self.completion_gap > tol["completion_abs"]:
            out.append(f"completion: gym {self.gym_completion:.3f} vs "
                       f"engine {self.engine_completion:.3f} "
                       f"(gap {self.completion_gap:.3f} > "
                       f"{tol['completion_abs']})")
        return out

    def ok(self, tol: Optional[Dict[str, float]] = None) -> bool:
        return not self.failures(tol)


def _steps_mean(summary: Summary) -> float:
    """Mean of per-trial ``steps_done`` over ALL trials, failures included."""
    return float(np.mean([r.steps_done for r in summary.results]))


def differential_validate(trace, decision: PolicyDecision, *,
                          total_steps: int = DEFAULT_TOTAL_STEPS,
                          n_gym: int = 32, n_engine: int = 512,
                          seed: int = 0, epoch_s: float = 1800.0,
                          max_h: float = 24.0,
                          batching: str = "dynamic",
                          ledgers: Optional[Sequence[GymLedger]] = None
                          ) -> DiffReport:
    """Replay ``decision`` as a static fleet through BOTH implementations.

    Gym side: ``n_gym`` plan-only episodes (``refill=False`` — provision
    once, revoked slots stay dead, the engine's semantics), one bootstrap
    draw per seed. Engine side: ``simulate_many(..., trace=...)`` on the
    equivalent ``ClusterSpec`` in "zero" mode. Mixed decisions (built
    with ``PolicyDecision.mixed``) validate end-to-end: both sides model
    the same ``batching`` mode via the hetero layer's fleet-rate rule.
    Pass ``ledgers`` to reuse already-run gym episodes (e.g. trained
    ones from the benchmark) instead of planning fresh ones.
    """
    ctx = trace if isinstance(trace, ReplayContext) \
        else ReplayContext(trace, bootstrap="zero")
    if ledgers is None:
        ledgers = [TransientGym(ctx, StaticPolicy(decision),
                                total_steps=total_steps, epoch_s=epoch_s,
                                max_h=max_h, refill=False,
                                seed=seed + i, batching=batching).plan()
                   for i in range(n_gym)]
    gym_sum = summarize_ledgers(list(ledgers))
    gym_steps = float(np.mean([l.vsteps_done for l in ledgers]))

    spec = decision.to_spec(total_steps=total_steps, master_failover=True,
                            batching=batching)
    eng_sum = simulate_many(spec, n_runs=n_engine, seed=seed + 10_000,
                            trace=ctx)
    return DiffReport(
        trace=ctx.trace.name, label=decision.label,
        n_gym=len(ledgers), n_engine=n_engine,
        gym_summary=gym_sum, engine_summary=eng_sum,
        gym_steps_mean=gym_steps,
        engine_steps_mean=_steps_mean(eng_sum),
        gym_cost_mean=gym_sum.cost[0],
        engine_cost_mean=eng_sum.cost[0],
        gym_completion=1.0 - gym_sum.failure_rate,
        engine_completion=1.0 - eng_sum.failure_rate)


# ---------------------------------------------------------------------------
# Revocation-intensity sweep (the Table IV / Fig 5 shape, in real training)
# ---------------------------------------------------------------------------

def intensity_sweep_traces(seed: int = 0,
                           factors: Sequence[float] = (1.0, 0.02, 0.004),
                           kinds: Sequence[str] = ("K80",)) -> List:
    """Synthetic traces of increasing revocation intensity.

    ``factor`` scales every observed lifetime in the trace (smaller =
    revocations come sooner = higher intensity). The same generator seed
    is used throughout so the traces differ ONLY in lifetime scale."""
    out = []
    for f in factors:
        burst = None if f >= 1.0 else {k: [(0.0, 1.0, f)] for k in kinds}
        out.append(synthetic_trace(f"intensity-{f:g}", seed=seed,
                                   kinds=tuple(kinds), price_sigma=0.02,
                                   lifetime_burst=burst))
    return out


def accuracy_intensity_sweep(*, arch: str = "resnet32-cifar10",
                             decision: Optional[PolicyDecision] = None,
                             factors: Sequence[float] = (1.0, 0.02, 0.004),
                             train_steps: int = 96, seed: int = 0,
                             total_steps: int = DEFAULT_TOTAL_STEPS,
                             async_updates: int = 0, device="cuda"
                             ) -> List[GymLedger]:
    """Train one gym episode per intensity level; returns the ledgers.

    The monotonicity contract over the result: as the factor shrinks
    (intensity grows), ``executed_steps`` is non-increasing and
    ``accuracy`` is non-increasing within ``TOLERANCE['acc_slack']``.
    """
    decision = decision or PolicyDecision("K80", 4)
    ledgers = []
    for trace in intensity_sweep_traces(seed=seed, factors=factors):
        gym = TransientGym(trace, StaticPolicy(decision),
                           total_steps=total_steps, refill=False, seed=seed)
        ledgers.append(gym.run(arch=arch, train_steps=train_steps,
                               async_updates=async_updates, device=device))
    return ledgers


def check_monotone(ledgers: Sequence[GymLedger],
                   acc_slack: Optional[float] = None) -> List[str]:
    """Violations of the intensity-monotonicity contract (empty = ok)."""
    slack = TOLERANCE["acc_slack"] if acc_slack is None else acc_slack
    out = []
    for a, b in zip(ledgers, ledgers[1:]):
        if b.executed_steps > a.executed_steps:
            out.append(f"steps rose {a.executed_steps} -> "
                       f"{b.executed_steps} ({a.trace} -> {b.trace})")
        if b.accuracy > a.accuracy + slack:
            out.append(f"accuracy rose {a.accuracy:.3f} -> "
                       f"{b.accuracy:.3f} ({a.trace} -> {b.trace})")
    return out
