"""The port's budget planner and provisioning scheduler
(``repro_torch.core.cost`` / ``scheduler``).

The first thirteen tests are ``tests/test_cost_scheduler.py``'s invariants,
run on the port. The rest hold the port to the JAX package's copies
(``repro.core.cost`` / ``scheduler``, numpy only) on the same seeds:
equal plans, frontiers, sweeps, offers and victims, and the port's
``optimize_provisioning`` against the committed golden
``tests/goldens/frontier.json`` (the reference's frontier benchmark
stats) within that file's tolerance, rtol 1e-3.
"""
import dataclasses
import json
import math
import os

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import cost as ref_cost
from repro.core import scheduler as ref_sched
from repro_torch.core import pricing
from repro_torch.core.cost import (PlanConfig, enumerate_candidates, estimate,
                                   pareto_front, plan_within_budget)
from repro_torch.core.scheduler import (barrier_time, choose_victims,
                                        collective_schedule, drop_stragglers,
                                        optimize_provisioning, pick_offers,
                                        plan_ps, proportional_shards,
                                        revocation_risk_rank,
                                        sweep_configurations)

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "frontier.json")
RTOL = 1e-3                       # tests/test_goldens.py's


# --- budget planner ---------------------------------------------------------

def test_all_plans_within_budget():
    plans = plan_within_budget(pricing.SINGLE_K80_BUDGET, max_workers=10)
    assert plans, "no feasible plan under the paper's own budget"
    assert all(p.cost_usd <= pricing.SINGLE_K80_BUDGET + 1e-9 for p in plans)
    assert plans == sorted(plans, key=lambda p: p.time_h)


def test_transient_dominates_ondemand_on_cost():
    tr = estimate(PlanConfig((("K80", 4),), transient=True))
    od = estimate(PlanConfig((("K80", 4),), transient=False))
    assert tr.cost_usd < 0.5 * od.cost_usd          # paper: 62.9% savings
    assert tr.time_h == pytest.approx(od.time_h, rel=0.25)


def test_scale_out_beats_scale_up_speed():
    """Paper §III-C: 4-K80 is ~30% faster than 1 P100 under the budget."""
    out4 = estimate(PlanConfig((("K80", 4),)))
    up_p100 = estimate(PlanConfig((("P100", 1),), n_ps=1))
    assert out4.time_h < up_p100.time_h


def test_pareto_front_nondominated():
    plans = plan_within_budget(5.0, max_workers=8)
    front = pareto_front(plans)
    assert front
    for f in front:
        assert not any(o.time_h < f.time_h and o.cost_usd <= f.cost_usd
                       and o.accuracy >= f.accuracy for o in plans)


def test_heterogeneous_enumeration():
    cands = enumerate_candidates(max_workers=3, heterogeneous=True)
    assert any(len([1 for _, c in p.workers if c]) > 1 for p in cands)


# --- proportional shards ------------------------------------------------------

@given(st.integers(1, 8), st.data())
@settings(max_examples=50, deadline=None)
def test_proportional_shards_exact_sum(n, data):
    rates = data.draw(st.lists(
        st.floats(0.5, 20.0, allow_nan=False), min_size=n, max_size=n))
    gb = data.draw(st.integers(n, 512))
    shards = proportional_shards(gb, rates)
    assert sum(shards) == gb
    assert all(s >= 1 for s in shards)
    assert shards == ref_sched.proportional_shards(gb, rates)


def test_proportional_shards_balance_barrier():
    """Speed-proportional shards beat equal shards on barrier time."""
    rates = [pricing.K80_RATE, pricing.K80_RATE, pricing.V100_RATE,
             pricing.V100_RATE]
    gb = 128
    prop = proportional_shards(gb, rates)
    equal = [gb // 4] * 4
    assert barrier_time(prop, rates) < barrier_time(equal, rates)
    # faster workers get strictly more work
    assert prop[2] > prop[0]


# --- PS capacity / collectives -----------------------------------------------

def test_plan_ps_matches_fig6():
    assert plan_ps(["K80"] * 4) == 1              # K80: 1 PS suffices
    assert plan_ps(["V100"] * 8) >= 2             # V100 x8 saturates 1 PS


def test_collective_schedule_bytes():
    pb = 1_000_000
    ar = collective_schedule(pb, 16, zero1=False)
    rs = collective_schedule(pb, 16, zero1=True)
    assert ar.kind == "all_reduce" and not ar.overlappable
    assert rs.kind == "reduce_scatter_all_gather" and rs.overlappable
    assert ar.grad_bytes_on_wire == rs.grad_bytes_on_wire  # same total wire
    assert ar.grad_bytes_on_wire == int(2 * pb * 15 / 16)


# --- placement / stragglers ---------------------------------------------------

def test_pick_offers_prefers_local():
    """Fig 8: cross-region rarely wins on rate/$ after the WAN penalty."""
    offers = pick_offers(4, ps_region="us-east1", allow_cross_region=True)
    assert len(offers) == 4
    assert all(o.region == "us-east1" for o in offers)


def test_pick_offers_budget_constrained():
    offers = pick_offers(4, budget_hr=0.6)
    assert sum(o.price_hr for o in offers) <= 0.6 + 1e-9


def test_drop_stragglers():
    times = [1.0, 5.0, 1.1, 0.9, 9.0]
    keep = drop_stragglers(times, k=2)
    assert keep == [0, 2, 3]
    assert drop_stragglers(times, k=0) == list(range(5))
    assert drop_stragglers(times, k=5) == list(range(5))


def test_revocation_risk_rank():
    order = revocation_risk_rank(["K80", "V100", "P100"], horizon_h=1.5)
    assert order[0] == 1          # V100 is by far the riskiest (Table III)


# --- against the reference, same seeds ------------------------------------------

def _plan_fields(e):
    return (e.config.workers, e.config.n_ps, e.config.transient, e.time_h,
            e.cost_usd, e.failure_p, e.exp_revocations, e.accuracy,
            e.speedup_vs_1k80)


@pytest.mark.parametrize("kw", [
    dict(budget_usd=pricing.SINGLE_K80_BUDGET, max_workers=10),
    dict(budget_usd=5.0, max_workers=8, min_accuracy=90.0,
         max_failure_p=0.3),
    dict(budget_usd=4.0, max_workers=4, heterogeneous=True)],
    ids=["paper-budget", "constrained", "heterogeneous"])
def test_plan_within_budget_and_front_equal_reference(kw):
    got = plan_within_budget(**kw)
    want = ref_cost.plan_within_budget(**kw)
    assert got and [_plan_fields(e) for e in got] == \
        [_plan_fields(e) for e in want]
    assert [_plan_fields(e) for e in pareto_front(got)] == \
        [_plan_fields(e) for e in ref_cost.pareto_front(want)]


def test_sweep_configurations_equal_reference():
    kw = dict(kinds=("K80", "V100"), counts=(1, 2, 4), ps_counts=(1, 2),
              total_steps=32_000)
    got = sweep_configurations(**kw)
    want = ref_sched.sweep_configurations(**kw)
    assert [lbl for lbl, _ in got] == [lbl for lbl, _ in want]
    # the specs are frozen dataclasses of the same fields in both packages
    assert [dataclasses.asdict(s) for _, s in got] == \
        [dataclasses.asdict(s) for _, s in want]


def _mc_fields(e):
    return (e.label, e.n_trials, e.time_h, e.time_ci95, e.cost_usd,
            e.cost_ci95, e.accuracy, e.acc_ci95, e.failure_p,
            e.speedup_vs_1k80)


def test_optimize_provisioning_equals_reference():
    """A small sweep, the same seed: the same estimates, frontier and
    best candidate."""
    kw = dict(budget_usd=3.0, max_failure_p=0.2, n_trials=128, seed=3,
              kinds=("K80", "P100"), counts=(1, 2, 4))
    got = optimize_provisioning(**kw)
    want = ref_sched.optimize_provisioning(**kw)
    assert [_mc_fields(e) for e in got.estimates] == \
        [_mc_fields(e) for e in want.estimates]
    assert [e.label for e in got.frontier] == [e.label for e in want.frontier]
    assert got.best is not None and got.best.label == want.best.label


def test_optimize_provisioning_matches_frontier_golden():
    """The port's sweep at the reference frontier benchmark's settings
    gives the stats pinned in ``tests/goldens/frontier.json``."""
    rep = optimize_provisioning(budget_usd=2.83, max_failure_p=0.10,
                                n_trials=1024, seed=0)
    stats = {"derived": {"n_configs": float(len(rep.estimates)),
                         "frontier_size": float(len(rep.frontier))}}
    for e in rep.estimates:
        stats[e.label] = {"time_h_mean": e.time_h, "cost_mean": e.cost_usd,
                          "acc_mean": e.accuracy, "failure_p": e.failure_p,
                          "speedup": e.speedup_vs_1k80}
    with open(GOLDEN) as f:
        golden = json.load(f)
    assert stats.keys() == golden.keys()
    for label, want in golden.items():
        for key, w in want.items():
            g = stats[label][key]
            assert math.isclose(g, w, rel_tol=RTOL, abs_tol=1e-9), \
                f"{label}/{key}: {g!r} != golden {w!r}"


@pytest.mark.parametrize("kw", [
    dict(n_workers=6),
    dict(n_workers=5, budget_hr=0.9, allow_cross_region=True),
    dict(n_workers=3, ps_region="us-west1", allow_cross_region=True)])
def test_pick_offers_equal_reference(kw):
    assert [dataclasses.astuple(o) for o in pick_offers(**kw)] == \
        [dataclasses.astuple(o) for o in ref_sched.pick_offers(**kw)]


def test_choose_victims_equal_reference():
    rng = np.random.default_rng(0)
    stale = {w: rng.integers(0, 6, size=rng.integers(0, 5)).tolist()
             for w in range(7)}
    rates = {w: float(r) for w, r in enumerate(rng.uniform(0.5, 3.0, 9))}
    for n in (0, 1, 3, 9):
        assert choose_victims(stale, n) == ref_sched.choose_victims(stale, n)
        assert choose_victims(stale, n, rates) == \
            ref_sched.choose_victims(stale, n, rates)
    assert drop_stragglers([3.0, 1.0, 2.0, 5.0], 1) == \
        ref_sched.drop_stragglers([3.0, 1.0, 2.0, 5.0], 1)
    assert revocation_risk_rank(["P100", "K80", "V100", "K80"], 2.0) == \
        ref_sched.revocation_risk_rank(["P100", "K80", "V100", "K80"], 2.0)
