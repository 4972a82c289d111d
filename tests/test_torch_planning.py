"""The port's planning layer against the JAX package's, exactly: the
trace schema and its files, the synthetic traces, trace replay (prices
and bootstrap lifetime draws), ``price_at(..., trace=...)``, both
Monte-Carlo engines, the online policies, the gym's plan and its
training schedule, the differential validation, and the ``obs``
emissions of the plan.

All of it is numpy on the host, copied with the same calls in the same
order, so the same seeds must give the same numbers: every comparison
here is equality (``==``, NaN equal to NaN), never a tolerance. Each
package builds its own objects from the same arguments; ``same``
compares them field by field across the two packages' classes.
"""
import dataclasses
import math

import numpy as np
import pytest

from repro import obs as jobs
from repro.core import policy as JPOL
from repro.core import pricing as JP
from repro.core import simulator as JSIM
from repro.gym import gym as JG
from repro.gym import validate as JV
from repro.traces import replay as JR
from repro.traces import schema as JS
from repro.traces import synth as JSY
from repro_torch import obs
from repro_torch.core import policy as POL
from repro_torch.core import pricing as P
from repro_torch.core import simulator as SIM
from repro_torch.gym import gym as G
from repro_torch.gym import validate as V
from repro_torch.traces import replay as R
from repro_torch.traces import schema as S
from repro_torch.traces import synth as SY


def same(a, b, path="."):
    """Structural equality across the two packages: classes by name,
    dataclasses field by field, arrays by dtype and value, floats
    exactly."""
    if dataclasses.is_dataclass(a) and not isinstance(a, type):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), \
            (path, list(a), list(b))
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif type(a).__name__ == "_LazyResults":      # the engine's results
        same(list(a), list(b), path)
    elif isinstance(a, (list, tuple)):
        assert type(a).__name__ == type(b).__name__ \
            and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, float) and math.isnan(a):
        assert isinstance(b, float) and math.isnan(b), path
    else:
        assert type(a).__name__ == type(b).__name__ and a == b, \
            (path, a, b)


def suites(seed):
    return JSY.default_trace_suite(seed), SY.default_trace_suite(seed)


# ---------------------------------------------------------------------------
# traces: schema, files, synthesis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["jsonl", "npz"])
def test_trace_files_round_trip_across_packages(fmt, tmp_path):
    kw = dict(seed=7, revocations_per_kind=32, price_interval_s=3600.0)
    jt, pt = JSY.synthetic_trace("rt", **kw), SY.synthetic_trace("rt", **kw)
    same(pt, jt)
    pj, pp = tmp_path / f"j.{fmt}", tmp_path / f"p.{fmt}"
    getattr(jt, f"to_{fmt}")(str(pj))
    getattr(pt, f"to_{fmt}")(str(pp))
    load_p, load_j = getattr(S.Trace, f"from_{fmt}"), \
        getattr(JS.Trace, f"from_{fmt}")
    assert load_p(str(pp)) == pt and load_j(str(pj)) == jt
    same(load_p(str(pj)), jt)            # each reads the other's file
    same(load_j(str(pp)), pt)
    # adversarial doubles survive the port's JSONL exactly
    vals = [0.1, 1 / 3, float(np.nextafter(1.0, 2.0)), 1e-300,
            12345.678901234567]
    evs = tuple(S.TraceEvent(float(i), "price", "K80", "z", v)
                for i, v in enumerate(vals))
    tr = S.Trace("f", 10.0, evs)
    tr.to_jsonl(str(tmp_path / "f.jsonl"))
    assert [e.value for e in S.Trace.from_jsonl(
        str(tmp_path / "f.jsonl")).events] == vals


@pytest.mark.parametrize("seed", [0, 3])
def test_synthetic_traces_match_the_reference(seed):
    jsuite, psuite = suites(seed)
    same(psuite, jsuite)
    for jt, pt in zip(jsuite, psuite):
        for kind in jt.kinds:
            same(pt.lifetimes(kind), jt.lifetimes(kind))
            same(pt.price_series(kind), jt.price_series(kind))
        same(pt.window(3600.0, 7200.0), jt.window(3600.0, 7200.0))
    same(SY.trace_from_model(seed=seed, events_per_kind=512),
         JSY.trace_from_model(seed=seed, events_per_kind=512))
    same(V.intensity_sweep_traces(seed), JV.intensity_sweep_traces(seed))


def test_trace_validation_matches_the_reference():
    for args in [(0.0, "nonsense", "K80", "us-east1", 1.0),
                 (-1.0, "price", "K80", "us-east1", 1.0),
                 (0.0, "price", "K80", "us-east1", 0.0),
                 (0.0, "revoke", "K80", "us-east1", -5.0)]:
        with pytest.raises(ValueError):
            JS.TraceEvent(*args)
        with pytest.raises(ValueError):
            S.TraceEvent(*args)
    from repro_torch.traces import load_trace
    from repro.traces import load_trace as jload
    same(load_trace("volatile", seed=2), jload("volatile", seed=2))
    with pytest.raises(ValueError, match="unknown trace"):
        load_trace("nonsense")


# ---------------------------------------------------------------------------
# replay and price_at(..., trace=...)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("which", [0, 1, 2])
def test_replay_prices_and_bootstrap_draws_match(which):
    jt, pt = suites(0)[0][which], suites(0)[1][which]
    jc, pc = JR.ReplayContext(jt), R.ReplayContext(pt)
    ts = np.linspace(0.0, 1.2 * jt.horizon_s, 97)
    for kind in JP.SERVER_TYPES:
        same(pc.price_at(kind, ts), jc.price_at(kind, ts))
        same(pc.cost_usd(kind, ts[:-1], ts[1:]),
             jc.cost_usd(kind, ts[:-1], ts[1:]))
        assert pc.has_prices(kind) == jc.has_prices(kind)
        for t in ts[::8]:
            assert P.price_at(kind, float(t), trace=pt) == \
                JP.price_at(kind, float(t), trace=jt)
            assert P.price_at(kind, float(t), trace=pc) == \
                JP.price_at(kind, float(t), trace=jc)
            assert P.price_at(kind, float(t), trace=pt, transient=False) \
                == JP.SERVER_TYPES[kind].ondemand_hr
    for kind in ("K80", "P100", "V100"):
        for t in (0.0, 1800.0, 5e4):
            assert pc.revocation_intensity(kind, t) == \
                jc.revocation_intensity(kind, t)
            assert pc.p_revoked_by(kind, t) == jc.p_revoked_by(kind, t)
    for mode in ("windows", "zero"):
        jr, pr = np.random.default_rng(5), np.random.default_rng(5)
        jb, pb = jc.bind(64, jr, bootstrap=mode), pc.bind(64, pr,
                                                          bootstrap=mode)
        same(pb.offset_s, jb.offset_s)
        idx = np.arange(64)
        for kind in ("K80", "P100", "V100"):
            at = np.linspace(0.0, 4e4, 64)
            same(pb.lifetimes(kind, idx, at, pr),
                 jb.lifetimes(kind, idx, at, jr))
            same(pb.cost_usd(kind, at, at + 900.0),
                 jb.cost_usd(kind, at, at + 900.0))
    tail_j, tail_p = jc.tail(7200.0), pc.tail(7200.0)
    same(tail_p.price_at("K80", ts), tail_j.price_at("K80", ts))


# ---------------------------------------------------------------------------
# the Monte-Carlo engines
# ---------------------------------------------------------------------------

def specs(mod):
    C = mod.ClusterSpec
    return [C.homogeneous("K80", 1), C.homogeneous("K80", 4),
            C.homogeneous("P100", 8, master_failover=True),
            C.mixed({"K80": 2, "V100": 2}),
            C.mixed({"P100": 3, "K80": 1}, batching="uniform",
                    master_failover=True),
            dataclasses.replace(C.homogeneous("K80", 4), ps_transient=True),
            C(workers=(mod.WorkerSpec("K80"),
                       mod.WorkerSpec("K80", join_step=16_000),
                       mod.WorkerSpec("V100", region="europe-west4",
                                      join_step=32_000)), n_ps=1)]


@pytest.mark.parametrize("engine", ["batched", "legacy"])
@pytest.mark.parametrize("seed", [0, 11])
def test_simulate_many_matches_the_reference(engine, seed):
    for i, (js, ps) in enumerate(zip(specs(JSIM), specs(SIM))):
        n = 24 if engine == "legacy" else 96
        jsum = JSIM.simulate_many(js, n_runs=n, seed=seed + i, engine=engine)
        psum = SIM.simulate_many(ps, n_runs=n, seed=seed + i, engine=engine)
        same(psum, jsum, f"spec {i}")
        assert psum.to_dict() == jsum.to_dict()


@pytest.mark.parametrize("which", [0, 1, 2])
def test_simulate_many_with_a_trace_matches(which):
    jt, pt = suites(1)[0][which], suites(1)[1][which]
    for i, (js, ps) in enumerate(zip(specs(JSIM)[:5], specs(SIM)[:5])):
        same(SIM.simulate_many(ps, n_runs=64, seed=i, trace=pt),
             JSIM.simulate_many(js, n_runs=64, seed=i, trace=jt),
             f"spec {i}")
    # a "zero"-bootstrap context, shared across calls
    jc = JR.ReplayContext(jt, bootstrap="zero")
    pc = R.ReplayContext(pt, bootstrap="zero")
    same(SIM.simulate_many(specs(SIM)[1], n_runs=64, seed=3, trace=pc),
         JSIM.simulate_many(specs(JSIM)[1], n_runs=64, seed=3, trace=jc))


# ---------------------------------------------------------------------------
# policies
# ---------------------------------------------------------------------------

def policies(mod):
    D = mod.PolicyDecision
    return [mod.StaticPolicy(D("K80", 4)),
            mod.StaticPolicy(D.mixed({"K80": 2, "P100": 2})),
            mod.GreedyCheapest(n_workers=4),
            mod.GreedyCheapest(n_workers=2, kinds=("K80", "V100")),
            mod.LookaheadMC(candidates=[D("K80", 4), D("P100", 2),
                                        D("V100", 2)],
                            n_plan_trials=16, seed=1)]


@pytest.mark.parametrize("which", [0, 1, 2])
def test_policy_act_sequences_match(which):
    """The online interface, epoch by epoch, on the replayed trace: the
    same observations, decisions, scores and decision logs."""
    jt, pt = suites(0)[0][which], suites(0)[1][which]
    jc, pc = JR.ReplayContext(jt), R.ReplayContext(pt)
    for jpol, ppol in zip(policies(JPOL), policies(POL)):
        jpol.reset(np.random.default_rng(0))
        ppol.reset(np.random.default_rng(0))
        for k in range(8):
            t = k * 1800.0
            kw = dict(t_s=t, steps_done=4000.0 * k, total_steps=64_000,
                      fleet_by_kind={"K80": k % 3})
            jo = JPOL.make_observation(jc, **kw)
            po = POL.make_observation(pc, **kw)
            same(po, jo)
            same(ppol.act(po, pc), jpol.act(jo, jc), f"{jpol.name} {k}")
            same(ppol.last_scores, jpol.last_scores)
        same(ppol.decision_log, jpol.decision_log)
        assert ppol.switches == jpol.switches and ppol.name == jpol.name


@pytest.mark.parametrize("which", [0, 1, 2])
def test_evaluate_policy_matches_the_reference(which):
    jt, pt = suites(0)[0][which], suites(0)[1][which]
    jpols = policies(JPOL) + [JPOL.OraclePolicy(
        candidates=[JPOL.PolicyDecision("K80", 4),
                    JPOL.PolicyDecision("V100", 2)])]
    ppols = policies(POL) + [POL.OraclePolicy(
        candidates=[POL.PolicyDecision("K80", 4),
                    POL.PolicyDecision("V100", 2)])]
    for jpol, ppol in zip(jpols, ppols):
        n = 16 if isinstance(jpol, JPOL.LookaheadMC) else 64
        jo = JPOL.evaluate_policy(jpol, jt, n_trials=n, seed=which)
        po = POL.evaluate_policy(ppol, pt, n_trials=n, seed=which)
        same(po, jo, jpol.name)
        assert po.mean_ci("cost_usd") == jo.mean_ci("cost_usd")


# ---------------------------------------------------------------------------
# the gym's plan, its training schedule, the differential validation
# ---------------------------------------------------------------------------

PLANS = [  # (trace, policy index in policies(), refill, batching, seed)
    ("calm", 0, False, "dynamic", 0),
    ("volatile", 2, True, "dynamic", 0),
    ("volatile", 1, False, "uniform", 4),
    ("bursty", 3, True, "dynamic", 1),
    ("bursty", 4, True, "dynamic", 2),
    ("intensity", 0, False, "dynamic", 0),
]


def plan_pair(name, pol, refill, batching, seed, **kw):
    if name == "intensity":
        jt, pt = JV.intensity_sweep_traces(0)[1], V.intensity_sweep_traces(0)[1]
    else:
        names = ["calm", "volatile", "bursty"]
        jt, pt = (s[names.index(name)] for s in suites(0))
    j = JG.TransientGym(jt, policies(JPOL)[pol], refill=refill, seed=seed,
                        batching=batching, **kw).plan()
    p = G.TransientGym(pt, policies(POL)[pol], refill=refill, seed=seed,
                       batching=batching, **kw).plan()
    return j, p


@pytest.mark.parametrize("case", PLANS, ids=lambda c: f"{c[0]}-{c[1]}")
def test_plan_ledgers_match_the_reference(case):
    jl, pl = plan_pair(*case)
    same(pl.to_dict(), jl.to_dict())
    same(pl.epochs, jl.epochs)
    same(pl.schedule, jl.schedule)
    assert pl.completed == jl.completed and pl.failure == jl.failure
    same(pl.summary(), jl.summary())
    for steps in (8, 16, 64, 96):
        same(G.training_schedule(pl, steps), JG.training_schedule(jl, steps))


def test_summaries_and_validation_match_the_reference():
    jls, pls = zip(*(plan_pair("volatile", 0, False, "dynamic", s)
                     for s in range(6)))
    same(G.summarize_ledgers(list(pls)), JG.summarize_ledgers(list(jls)))
    jt, pt = suites(0)[0][2], suites(0)[1][2]
    for jd, pd in ((JPOL.PolicyDecision("K80", 4),
                    POL.PolicyDecision("K80", 4)),
                   (JPOL.PolicyDecision.mixed({"K80": 2, "V100": 2}),
                    POL.PolicyDecision.mixed({"K80": 2, "V100": 2}))):
        jr = JV.differential_validate(jt, jd, n_gym=4, n_engine=48, seed=2)
        pr = V.differential_validate(pt, pd, n_gym=4, n_engine=48, seed=2)
        same(pr, jr)
        assert pr.failures() == jr.failures() and pr.ok() == jr.ok()
    assert V.TOLERANCE == JV.TOLERANCE
    a, b = plan_pair("calm", 0, False, "dynamic", 0)
    assert V.check_monotone([b, b]) == JV.check_monotone([a, a]) == []


# ---------------------------------------------------------------------------
# obs: the same emissions in both packages
# ---------------------------------------------------------------------------

def event_view(events):
    """Every field of every event but the host clock."""
    return [(e.name, e.ph, e.cat, e.track, e.t_sim, e.dur_sim, e.args,
             e.trace_id, e.span_id, e.parent_id) for e in events]


def test_plan_emissions_match_the_reference(tmp_path):
    """A recorded plan (replan spans, slot joins/releases/revocations,
    constant-rate segments, the episode) and recorded MC and policy
    runs: the same event names, categories, sim-clock times, arguments
    and metric series."""
    jrec, prec = jobs.Recorder(deterministic=True), \
        obs.Recorder(deterministic=True)
    for name, pol, refill in (("volatile", 2, True), ("bursty", 4, True),
                              ("intensity", 0, False)):
        if name == "intensity":
            jt, pt = JV.intensity_sweep_traces(0)[1], \
                V.intensity_sweep_traces(0)[1]
        else:
            names = ["calm", "volatile", "bursty"]
            jt, pt = (s[names.index(name)] for s in suites(0))
        JG.TransientGym(jt, policies(JPOL)[pol], refill=refill,
                        recorder=jrec).plan()
        G.TransientGym(pt, policies(POL)[pol], refill=refill,
                       recorder=prec).plan()
    jt, pt = suites(0)[0][1], suites(0)[1][1]
    JSIM.simulate_many(specs(JSIM)[1], n_runs=32, seed=0, trace=jt,
                       recorder=jrec)
    SIM.simulate_many(specs(SIM)[1], n_runs=32, seed=0, trace=pt,
                      recorder=prec)
    JPOL.evaluate_policy(policies(JPOL)[2], jt, n_trials=16, recorder=jrec)
    POL.evaluate_policy(policies(POL)[2], pt, n_trials=16, recorder=prec)
    assert len(prec.events) > 50
    assert event_view(prec.events) == event_view(jrec.events)
    assert prec.metrics.to_dict() == jrec.metrics.to_dict()
    assert prec.metrics.to_stats() == jrec.metrics.to_stats()
    # the port's event log is the reference's file format
    prec.flush(str(tmp_path / "p.jsonl"))
    jrec.flush(str(tmp_path / "j.jsonl"))
    assert event_view(jobs.load_events(str(tmp_path / "p.jsonl"))) == \
        event_view(obs.load_events(str(tmp_path / "j.jsonl"))) == \
        event_view(prec.events)
    assert obs.load_header(str(tmp_path / "p.jsonl"))["metrics"] == \
        jobs.load_header(str(tmp_path / "j.jsonl"))["metrics"]
    assert obs.TAXONOMY == jobs.TAXONOMY
    assert not obs.NULL.enabled and obs.NULL.span("x", cat="y") is \
        obs.NULL.span("z", cat="w")
