"""Transient-aware heterogeneous scheduler (C7/C8, Figs 6-8).

A copy of ``repro.core.scheduler``: the same code and the same numpy draws
in the same order, so one seed gives the same numbers in both packages.

Three responsibilities, each a direct answer to a paper finding:

1. **Proportional shard sizing** (Fig 7): in synchronous elastic DP a
   heterogeneous cluster is barrier-bound by its slowest worker unless
   shards are sized proportionally to speed. ``proportional_shards`` splits
   a global batch so every worker finishes its microstep at the same time
   (integral, exact-sum, never zero for an active worker).

2. **PS-capacity planning** (Fig 6): the paper shows one PS saturates at
   ~4 V100s and a second PS buys up to 1.75x. ``plan_ps`` sizes the PS pool
   and ``collective_schedule`` maps the same decision onto the devices'
   collectives: an all-reduce moves 2x the bytes of a reduce-scatter+
   all-gather pair with sharded optimizer state — "adding a PS" IS
   switching to the sharded schedule.

3. **Straggler mitigation + placement** (Fig 8): cross-region workers run
   at a WAN-degraded rate, so placement picks offers region-aware, and
   ``drop_stragglers`` implements drop-slowest-k barriers for sync DP.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import pricing
from repro_torch.core.simulator import (PS_RATE_STEPS_S,  # noqa: F401
                                        WAN_RATE_FACTOR, ps_capped_rate)
from repro_torch.core.transient import LIFETIMES


# ---------------------------------------------------------------------------
# 1. Proportional shard sizing
# ---------------------------------------------------------------------------

def proportional_shards(global_batch: int, rates: Sequence[float]) -> List[int]:
    """Split ``global_batch`` rows ∝ worker speed; integral and exact.

    Largest-remainder apportionment with a floor of 1 row per active
    worker, so a slow straggler still contributes (the paper keeps revoked-
    adjacent slow workers in the cluster rather than idling them).
    """
    n = len(rates)
    if n == 0:
        raise ValueError("no workers")
    if global_batch < n:
        raise ValueError(f"global batch {global_batch} < {n} workers")
    total = float(sum(rates))
    if total <= 0:
        raise ValueError("all rates are zero")
    raw = [global_batch * r / total for r in rates]
    base = [max(1, int(math.floor(x))) for x in raw]
    # fix overflow from the floor-of-1 guarantee
    while sum(base) > global_batch:
        i = max(range(n), key=lambda j: base[j])
        base[i] -= 1
    rem = global_batch - sum(base)
    order = sorted(range(n), key=lambda j: raw[j] - math.floor(raw[j]),
                   reverse=True)
    for j in range(rem):
        base[order[j % n]] += 1
    return base


def barrier_time(shards: Sequence[int], rates: Sequence[float]) -> float:
    """Sync-DP step time = slowest worker's shard time (what we minimize)."""
    return max(s / r for s, r in zip(shards, rates))


# ---------------------------------------------------------------------------
# 2. PS capacity / collective schedule
# ---------------------------------------------------------------------------

def plan_ps(worker_kinds: Sequence[str], *, target_efficiency: float = 0.9,
            max_ps: int = 8) -> int:
    """Smallest PS count keeping aggregate rate >= target x ideal (Fig 6)."""
    s = sum(pricing.SERVER_TYPES[k].steps_per_sec for k in worker_kinds)
    if len(worker_kinds) <= 1:
        return 0
    for n_ps in range(1, max_ps + 1):
        if ps_capped_rate(s, n_ps) >= target_efficiency * s:
            return n_ps
    return max_ps


@dataclasses.dataclass(frozen=True)
class CollectiveSchedule:
    """Collective mapping of the PS decision for one training step."""
    kind: str                 # "all_reduce" | "reduce_scatter_all_gather"
    grad_bytes_on_wire: int   # per device per step
    overlappable: bool        # rs/ag chunks overlap with backward compute

    @property
    def description(self) -> str:
        return {"all_reduce": "1 PS equivalent: full-gradient all-reduce",
                "reduce_scatter_all_gather":
                    "multi-PS equivalent: ZeRO-1 reduce-scatter + all-gather",
                }[self.kind]


def collective_schedule(param_bytes: int, data_parallel: int,
                        zero1: bool = True) -> CollectiveSchedule:
    """Bytes-on-wire model (ring algorithms, N = dp size):

    all-reduce:            2 * B * (N-1)/N        (not overlappable with opt)
    reduce-scatter + all-gather: same total bytes, but the optimizer update
    runs on the 1/N shard and the two phases pipeline with backward/forward
    — the latency-critical exposed bytes halve. This is the "second PS".
    """
    n = max(2, data_parallel)
    wire = int(2 * param_bytes * (n - 1) / n)
    if zero1:
        return CollectiveSchedule("reduce_scatter_all_gather", wire, True)
    return CollectiveSchedule("all_reduce", wire, False)


# ---------------------------------------------------------------------------
# 3. Offers, placement, stragglers
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Offer:
    kind: str
    region: str
    price_hr: float
    availability: float        # P(request fulfilled promptly), §II-B second
    transient: bool = True


DEFAULT_OFFERS: Tuple[Offer, ...] = tuple(
    Offer(kind, region, pricing.SERVER_TYPES[kind].transient_hr * bump, avail)
    for kind, avail in (("K80", 0.95), ("P100", 0.85), ("V100", 0.70))
    for region, bump in (("us-east1", 1.00), ("us-central1", 0.98),
                         ("us-west1", 1.03))
)


def effective_rate(offer: Offer, ps_region: str) -> float:
    r = pricing.SERVER_TYPES[offer.kind].steps_per_sec
    return r * (WAN_RATE_FACTOR if offer.region != ps_region else 1.0)


def pick_offers(n_workers: int, *, ps_region: str = "us-east1",
                offers: Sequence[Offer] = DEFAULT_OFFERS,
                budget_hr: Optional[float] = None,
                allow_cross_region: bool = False) -> List[Offer]:
    """Greedy max expected-rate-per-dollar placement.

    Cross-region offers are admitted only when allowed AND still rate-
    positive after the WAN penalty — Fig 8's result is that they rarely
    win, which this reproduces: a remote V100 at 0.35x rate loses to a
    local K80 on rate/$ under the paper's prices.
    """
    pool = [o for o in offers
            if allow_cross_region or o.region == ps_region]

    def score(o: Offer) -> float:
        return (effective_rate(o, ps_region) * o.availability) / o.price_hr

    ranked = sorted(pool, key=score, reverse=True)
    out: List[Offer] = []
    spend = 0.0
    i = 0
    # Greedy with repetition: the best offer is a server TYPE, requestable
    # many times; advance to the next-ranked type only when the budget
    # rejects the current one.
    while len(out) < n_workers and i < len(ranked):
        o = ranked[i]
        if budget_hr is not None and spend + o.price_hr > budget_hr:
            i += 1
            continue
        out.append(o)
        spend += o.price_hr
    return out


def drop_stragglers(step_times: Sequence[float], k: int) -> List[int]:
    """Indices of workers to WAIT for (drop the k slowest; their shard of
    the batch is re-owned next step by the deterministic pipeline)."""
    n = len(step_times)
    if k <= 0 or k >= n:
        return list(range(n))
    order = np.argsort(step_times)        # fastest first
    return sorted(int(i) for i in order[: n - k])


def revocation_risk_rank(kinds: Sequence[str], horizon_h: float) -> List[int]:
    """Workers ranked most-revocation-likely first — used to choose which
    slots to *voluntarily* return under the paper's selective-revocation
    proposal (§III-D: returning the most staleness-prone worker can raise
    accuracy while cutting cost)."""
    risk = [LIFETIMES[k].p_revoked_by(horizon_h * 3600) for k in kinds]
    return list(np.argsort(risk)[::-1].astype(int))


# ---------------------------------------------------------------------------
# 4. Selective revocation (the paper's §III-D PROPOSAL, implemented)
# ---------------------------------------------------------------------------
# "if cloud providers could only specify the NUMBER of servers needed ...
#  and leave the choice of WHICH servers to the cloud customer, it will
#  enable more flexibility when making tradeoffs between accuracy and
#  training performance."
# The customer-side policy: when the provider demands n servers back,
# return the workers contributing the MOST staleness (slowest per-push,
# most outdated snapshots) — the ones the paper observed were *helping*
# accuracy to lose. Validated in the reference's
# benchmarks/selective_revocation.py with
# real async-PS training.

# ---------------------------------------------------------------------------
# 5. Monte-Carlo provisioning optimizer (sweeps over the MC distributions)
# ---------------------------------------------------------------------------
# The analytic planner (core/cost.py) scores candidates with closed-form
# expectations; this optimizer re-scores them against the full revocation
# DISTRIBUTIONS via the batched engine (core/mc.py), so 1024 trials per
# configuration is the default rather than a luxury.  It sweeps server
# type x count x PS count x placement (single/cross-region) x static vs
# dynamic (sparse-mapping ramp) x transient vs on-demand, and reports the
# cost/time/accuracy Pareto frontier with 95% CIs.

def _dynamic_ramp_spec(kind: str, n: int, total_steps: int,
                       master_failover: bool) -> "ClusterSpec":
    """Fig-5-style ramp: start with 1 worker, add one every total/n steps."""
    from repro_torch.core.simulator import ClusterSpec, WorkerSpec
    workers = tuple(WorkerSpec(kind, True, join_step=i * total_steps // n)
                    for i in range(n))
    return ClusterSpec(workers=workers, n_ps=1, total_steps=total_steps,
                       master_failover=master_failover)


def _cross_region_spec(kind: str, n: int, total_steps: int,
                       master_failover: bool) -> "ClusterSpec":
    """Fig-8-style split: half the workers in a remote region."""
    from repro_torch.core.simulator import ClusterSpec, WorkerSpec
    regions = ["us-east1"] * (n - n // 2) + ["us-west1"] * (n // 2)
    workers = tuple(WorkerSpec(kind, True, region=r) for r in regions)
    return ClusterSpec(workers=workers, n_ps=1, ps_region="us-east1",
                       total_steps=total_steps,
                       master_failover=master_failover)


def sweep_configurations(*, kinds: Sequence[str] = ("K80", "P100", "V100"),
                         counts: Sequence[int] = (1, 2, 4, 8),
                         ps_counts: Sequence[int] = (1, 2),
                         include_ondemand: bool = True,
                         include_dynamic: bool = True,
                         include_cross_region: bool = True,
                         master_failover: bool = True,
                         total_steps: int = 64_000) -> List[Tuple[str, "ClusterSpec"]]:
    """Enumerate labelled candidate ``ClusterSpec``s for the optimizer."""
    from repro_torch.core.simulator import ClusterSpec
    points: List[Tuple[str, ClusterSpec]] = []
    for kind in kinds:
        for n in counts:
            base = ClusterSpec.homogeneous(kind, n, transient=True,
                                           total_steps=total_steps,
                                           master_failover=master_failover)
            for n_ps in ps_counts:
                if n == 1 and n_ps != 1:
                    continue
                if n == 1:
                    points.append((f"1x{kind}", base))
                    continue
                spec = dataclasses.replace(base, n_ps=n_ps)
                points.append((f"{n}x{kind}+{n_ps}PS", spec))
            if include_ondemand:
                od = ClusterSpec.homogeneous(kind, n, transient=False,
                                             total_steps=total_steps)
                points.append((f"{n}x{kind} on-demand", od))
            if include_dynamic and n > 1:
                points.append((f"{n}x{kind} dynamic",
                               _dynamic_ramp_spec(kind, n, total_steps,
                                                  master_failover)))
            if include_cross_region and n > 1:
                points.append((f"{n}x{kind} 2-region",
                               _cross_region_spec(kind, n, total_steps,
                                                  master_failover)))
    return points


@dataclasses.dataclass(frozen=True)
class MCPlanEstimate:
    """Monte-Carlo estimate of one provisioning candidate, with 95% CIs.

    ``time_h``/``cost_usd``/``accuracy`` are means over completed trials so
    the object plugs directly into ``cost.pareto_front``/``cost.dominates``.
    """
    label: str
    spec: "ClusterSpec"
    n_trials: int
    time_h: float
    time_ci95: float
    cost_usd: float
    cost_ci95: float
    accuracy: float
    acc_ci95: float
    failure_p: float
    speedup_vs_1k80: float

    def describe(self) -> str:
        return (f"{self.label}: {self.time_h:.2f}±{self.time_ci95:.2f} h, "
                f"${self.cost_usd:.2f}±{self.cost_ci95:.2f}, "
                f"{self.accuracy:.2f}±{self.acc_ci95:.2f}%, "
                f"fail_p={self.failure_p:.3f}")


def evaluate_configurations(points: Sequence[Tuple[str, "ClusterSpec"]],
                            *, n_trials: int = 1024,
                            seed: int = 0, trace=None) -> List[MCPlanEstimate]:
    """Score each candidate over ``n_trials`` batched Monte-Carlo trials.

    ``trace`` switches the scoring to trace-driven replay (bootstrap
    lifetimes + spot-price billing) — the same candidates ranked against a
    recorded/synthetic market instead of the closed-form mixtures."""
    from repro_torch.core.simulator import simulate_many
    out: List[MCPlanEstimate] = []
    for i, (label, spec) in enumerate(points):
        s = simulate_many(spec, n_runs=n_trials, seed=seed + i,
                          engine="batched", trace=trace)
        if s.n_completed == 0:
            continue
        # baseline = 1 on-demand K80 on the SAME workload length
        t_base_h = (spec.total_steps
                    / pricing.SERVER_TYPES["K80"].steps_per_sec / 3600.0)
        out.append(MCPlanEstimate(
            label=label, spec=spec, n_trials=n_trials,
            time_h=s.time_h[0], time_ci95=s.ci95("time_h"),
            cost_usd=s.cost[0], cost_ci95=s.ci95("cost"),
            accuracy=s.acc[0], acc_ci95=s.ci95("acc"),
            failure_p=s.failure_rate,
            speedup_vs_1k80=t_base_h / s.time_h[0]))
    return out


@dataclasses.dataclass(frozen=True)
class ProvisioningReport:
    estimates: Tuple[MCPlanEstimate, ...]     # every evaluated candidate
    frontier: Tuple[MCPlanEstimate, ...]      # (time, cost, -acc) Pareto set
    best: Optional[MCPlanEstimate]            # fastest feasible, or None


def optimize_provisioning(*, budget_usd: Optional[float] = None,
                          max_failure_p: float = 1.0,
                          min_accuracy: float = 0.0,
                          n_trials: int = 1024, seed: int = 0,
                          trace=None,
                          **sweep_kwargs) -> ProvisioningReport:
    """Sweep cluster configurations over the MC distributions (the paper's
    §III-C question, answered with distributions instead of expectations).

    Returns every scored candidate, the cost/time/accuracy Pareto frontier,
    and the fastest candidate satisfying the budget / failure / accuracy
    constraints (``best is None`` when nothing qualifies). With ``trace``
    the sweep is scored by trace replay rather than mixture sampling —
    still a *static* choice; ``core/policy.py`` is the online version.
    """
    from repro_torch.core import cost as cost_mod
    ests = evaluate_configurations(sweep_configurations(**sweep_kwargs),
                                   n_trials=n_trials, seed=seed, trace=trace)
    frontier = tuple(cost_mod.pareto_front(ests))
    feasible = [e for e in ests
                if (budget_usd is None or e.cost_usd <= budget_usd + 1e-9)
                and e.failure_p <= max_failure_p
                and e.accuracy >= min_accuracy]
    best = min(feasible, key=lambda e: e.time_h) if feasible else None
    return ProvisioningReport(estimates=tuple(ests), frontier=frontier,
                              best=best)


def choose_victims(staleness_by_worker, n: int,
                   rates: Optional[Dict[int, float]] = None) -> List[int]:
    """Pick ``n`` workers to voluntarily return.

    Rank by mean contributed staleness (higher = more damaging); break
    ties by slower step rate. Workers with no pushes yet rank by rate.
    """
    wids = list(staleness_by_worker)
    if rates:
        wids = sorted(set(wids) | set(rates))

    def score(w):
        st = staleness_by_worker.get(w, [])
        mean_st = float(np.mean(st)) if st else -1.0
        rate = -(rates or {}).get(w, 0.0)
        return (mean_st, rate)

    ranked = sorted(wids, key=score, reverse=True)
    return ranked[:n]
