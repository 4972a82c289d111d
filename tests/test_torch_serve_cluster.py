"""The port's serving fleet against the reference's on the same weights
(reduced configs, float32, nonzero gammas and biases) and the same
``RequestTrace``, on a virtual clock: ``ServeCluster`` routing, a
provider warning (page shipping), a fired revocation, ``scale_to`` and
the ``ReplicaAutoscaler``, with the ``SLOMonitor``, the time-series
sampler, the ops report and a deterministic recorder attached. Every
outcome must be equal in both packages: each request's tokens and
revocation counters, the fleet's counters and replica-seconds, the
autoscaler's decision log, the monitor's alerts (``Alert.to_json``), the
sampled series, the rendered report (HTML and text) and the event
stream (names, tracks and trace links, in order).

Also mirrors of ``tests/test_serve_autoscale.py`` and the cluster halves
of ``tests/test_serve_drain.py`` and ``tests/test_obs_live.py``."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.config import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.builder import build_model as jax_build  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro.obs import timeseries as jts  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeCluster as JCluster  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.serving import SLOQueue as JSLOQueue  # noqa: E402
from repro.serving import autoscale as jauto  # noqa: E402
from repro.traces.requests import synthetic_request_trace as jtrace  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.obs import report, slo, timeseries  # noqa: E402
from repro_torch.serving import (Request, ServeCluster, ServeEngine,  # noqa: E402
                                 SLOQueue, autoscale)
from repro_torch.traces.requests import synthetic_request_trace  # noqa: E402

RANDOMISED = ("gamma", "bq", "bk", "bv", "ln_x", "w0")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run many tiny ops: one intra-op thread is faster than
    a pool, most of all beside other test workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomise(tree, rng):
    for key, val in tree.items():
        if isinstance(val, dict):
            _randomise(val, rng)
        elif key in RANDOMISED:
            tree[key] = (val + rng.normal(0.0, 0.2, val.shape)).astype(
                np.float32)
    return tree


@pytest.fixture(scope="module", params=["starcoder2-3b", "rwkv6-7b"])
def sides(request):
    arch = request.param
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32")
    jm = jax_build(jcfg)
    tree = _randomise(jax.tree.map(
        np.asarray, JL.unbox(jax.jit(jm.init)(jax.random.key(0)))),
        np.random.default_rng(0))
    cfg = get_config(arch, reduced=True).replace(
        dtype="float32", attn_impl="torch", ssm_impl="torch",
        rwkv_impl="torch")
    model = build_model(cfg, "cpu")
    params = params_from_numpy(tree, cfg, "cpu")
    jparams = jax.tree.map(jax.numpy.asarray, tree)
    return {
        "jax": SimpleNamespace(
            Engine=lambda **kw: JEngine(jm, jparams, **kw), Request=JRequest,
            Cluster=JCluster, SLOQueue=JSLOQueue, obs=jobs, slo=jslo,
            ts=jts, report=jreport, auto=jauto, trace=jtrace,
            vocab=jcfg.vocab_size),
        "torch": SimpleNamespace(
            Engine=lambda **kw: ServeEngine(model, params, **kw),
            Request=Request, Cluster=ServeCluster, SLOQueue=SLOQueue,
            obs=obs, slo=slo, ts=timeseries, report=report, auto=autoscale,
            trace=synthetic_request_trace, vocab=cfg.vocab_size)}


STEP_S = 0.1                 # virtual seconds per fleet step


def _fleet(side):
    """One bursty trace through a 2-replica paged fleet: a warning at 40%
    of the horizon, a fired revocation at 70%, a forced ``scale_to(3)``
    at 55%, the autoscaler every second, monitor and sampler every
    tick. Returns everything a run produces, as plain data."""
    trace = side.trace("serve-bursty", seed=3, horizon_s=24.0,
                       base_rate_per_s=0.6, bursts=((0.3, 0.6, 3.0),),
                       max_prompt_len=20, max_new_tokens=14)
    clock = {"t": 0.0}
    rec = side.obs.Recorder(deterministic=True)
    monitor = side.slo.SLOMonitor(side.slo.SLOSpec(
        attainment_target=0.9, ttft_target_s=0.6, long_window_s=8.0,
        short_window_s=2.0, min_requests=3, storm_revocations=2,
        storm_window_s=20.0, pool_util_threshold=0.7, pool_window_s=2.0,
        cooldown_s=3.0), recorder=rec)
    scaler = side.auto.ReplicaAutoscaler(min_replicas=1, max_replicas=3)
    fns = {}

    def make():
        eng = side.Engine(max_batch=2, max_len=48, cache_impl="paged",
                          page_size=4, num_pages=16, prefill_block=4,
                          queue=side.SLOQueue(capacity=6),
                          clock=lambda: clock["t"],
                          shared_fns=fns.get("fns"))
        fns.setdefault("fns", eng.shared_fns)
        return eng

    cluster = side.Cluster(make, n_replicas=2, clock=lambda: clock["t"],
                           recorder=rec, monitor=monitor)
    sampler = side.ts.TimeSeriesSampler(interval_s=0.5)
    side.ts.attach_serve_cluster(sampler, cluster)
    rng = np.random.default_rng(9)
    reqs, done = [], set()
    last_scale = [-math.inf]

    def tick():
        t = clock["t"]
        live = [i for i, e in enumerate(cluster.replicas) if not e.draining]
        busy = [i for i in live
                if any(r is not None and len(r.generated) >= 1
                       for r in cluster.replicas[i].slots)]
        if "warn" not in done and t >= 0.4 * trace.horizon_s \
                and len(live) >= 2 and busy:
            cluster.warn(busy[0], grace_tokens=2)
            done.add("warn")
        if "scale" not in done and t >= 0.55 * trace.horizon_s:
            cluster.scale_to(3)
            done.add("scale")
        if "revoke" not in done and t >= 0.7 * trace.horizon_s \
                and len(live) >= 2 and busy:
            cluster.revoke(busy[0])
            done.add("revoke")
        sampler.maybe_sample(t)
        monitor.evaluate(now=t)
        if t - last_scale[0] >= 1.0:
            last_scale[0] = t
            n_live = sum(1 for e in cluster.replicas if not e.draining)
            dec = scaler.act(side.auto.ServeLoad(
                t_s=t, utilization=cluster.load,
                queue_depth=cluster.queue_depth, n_replicas=n_live,
                slots_per_replica=2,
                alerts=monitor.recent_alerts(now=t)))
            if dec.n_replicas != n_live:
                cluster.scale_to(dec.n_replicas)

    for ev in trace.events:
        while clock["t"] < ev.t_s and cluster.has_work():
            cluster.step()
            clock["t"] += STEP_S
            tick()
        clock["t"] = max(clock["t"], ev.t_s)
        tick()
        req = side.Request(rid=ev.rid, prompt=rng.integers(
            1, side.vocab, size=(ev.prompt_len,)).tolist(),
            max_new_tokens=ev.max_new_tokens, arrival_s=ev.t_s,
            priority=ev.priority, deadline_s=ev.t_s + ev.deadline_rel_s,
            slo=ev.slo)
        reqs.append(req)
        cluster.submit(req)
    while cluster.has_work():
        cluster.step()
        clock["t"] += STEP_S
        tick()
    sampler.sample(clock["t"])
    series = sampler.series()
    summary = {"requests": len(reqs), "tokens": cluster.tokens_decoded}
    return {
        "done": sorted(done),
        "requests": [(r.rid, r.done, r.dropped, r.generated,
                      r.timing.tokens_lost, r.timing.tokens_replayed,
                      r.timing.n_migrations, r.timing.n_restarts,
                      r.timing.t_first_token, r.timing.t_complete)
                     for r in reqs],
        "fleet": (cluster.tokens_decoded, cluster.tokens_lost,
                  cluster.tokens_replayed, cluster.requests_rejected,
                  cluster.pages_shipped, cluster.requests_imported,
                  cluster._next_rid, cluster.replica_seconds),
        "replicas": cluster.replica_summaries(),
        "decisions": [(t, d.n_replicas) for t, d in scaler.decision_log],
        "alerts": [a.to_json() for a in monitor.alerts],
        "series": sampler.to_rows(),
        "html": side.report.render_report(
            series=series, alerts=monitor.alerts,
            replicas=cluster.replica_summaries(), summary=summary,
            title="fleet"),
        "text": side.report.render_text(series=series,
                                        alerts=monitor.alerts,
                                        replicas=cluster.replica_summaries(),
                                        summary=summary),
        "events": [(e.name, e.cat, e.track, e.t_sim, e.trace_id, e.span_id,
                    e.parent_id, sorted(e.args)) for e in rec.events],
        "metrics": rec.metrics.to_stats(),
    }


@pytest.fixture(scope="module")
def fleets(sides):
    return {name: _fleet(side) for name, side in sides.items()}


@pytest.mark.parametrize("part", ["done", "requests", "fleet", "replicas",
                                  "decisions", "alerts", "series", "html",
                                  "text", "events", "metrics"])
def test_fleet_outcome_matches_reference(fleets, part):
    assert fleets["torch"][part] == fleets["jax"][part]


def test_fleet_exercised_every_path(fleets):
    """The scenario is not vacuous: the warning shipped pages, the fired
    revocation lost tokens, the autoscaler moved, alerts fired, and every
    request completed or was counted as rejected."""
    f = fleets["torch"]
    assert f["done"] == ["revoke", "scale", "warn"]
    tokens, lost, replayed, rejected, shipped, imported, spawned, rs = \
        f["fleet"]
    assert lost > 0 and shipped > 0 and imported > 0 and spawned >= 3
    assert rs > 0 and len({n for _, n in f["decisions"]}) > 1
    assert {a["kind"] for a in f["alerts"]} >= {"revocation_storm"}
    assert all(done or dropped for _, done, dropped, *_ in f["requests"])
    assert rejected == sum(dropped for _, _, dropped, *_ in f["requests"])
    jreport.validate_report(f["html"], min_series=5,
                            min_alerts=len(f["alerts"]))


# -- the autoscaler (tests/test_serve_autoscale.py) --------------------------

LOADS = [(1.0, 12, 2), (0.0, 0, 4), (0.1, 0, 4), (1.0, 1000, 2),
         (0.5, 3, 3), (1.0, 4, 1), (1.0, 7, 4), (1.0, 26, 4), (0.0, 0, 1)]


@pytest.mark.parametrize("kw", [{}, {"min_replicas": 2, "max_replicas": 4},
                                {"deadband": 1, "max_replicas": 8},
                                {"target_util": 0.5}])
def test_autoscaler_decisions_match_reference(kw):
    mine, ref = autoscale.ReplicaAutoscaler(**kw), \
        jauto.ReplicaAutoscaler(**kw)
    for i, (util, queue, n) in enumerate(LOADS):
        args = dict(t_s=float(i), utilization=util, queue_depth=queue,
                    n_replicas=n, slots_per_replica=4,
                    alerts=("slo_burn",) if i == 5 else ())
        assert mine.decide(autoscale.ServeLoad(**args)).n_replicas == \
            ref.decide(jauto.ServeLoad(**args)).n_replicas
        assert mine.act(autoscale.ServeLoad(**args)).n_replicas == \
            ref.act(jauto.ServeLoad(**args)).n_replicas
        assert mine.last_scores == ref.last_scores
    assert [(t, d.n_replicas) for t, d in mine.decision_log] == \
        [(t, d.n_replicas) for t, d in ref.decision_log]
    assert (mine.switches, mine.name) == (ref.switches, ref.name)
    mine.reset(np.random.default_rng(0))
    assert mine.decision_log == [] and mine.switches == 0


def test_autoscaler_validation():
    with pytest.raises(ValueError, match="target_util"):
        autoscale.ReplicaAutoscaler(target_util=0.0)
    with pytest.raises(ValueError, match="min_replicas"):
        autoscale.ReplicaAutoscaler(min_replicas=3, max_replicas=2)
    assert autoscale.ReplicaDecision(3).label == "3r"


# -- cluster warn / revoke / scale_to (tests/test_serve_drain.py) ------------

def _requests(side, n, seed, max_new=8, plen=5):
    rng = np.random.default_rng(seed)
    return [side.Request(rid=i, prompt=rng.integers(
        1, side.vocab, size=(plen,)).tolist(), max_new_tokens=max_new)
        for i in range(n)]


def _solo(side, req):
    eng = side.Engine(max_batch=1, max_len=32)
    eng.submit(req)
    eng.run_to_completion()
    return req.generated


@pytest.mark.parametrize("action", ["warn", "revoke"])
@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_cluster_migration_matches_solo_and_reference(sides, action,
                                                      cache_impl):
    outs = []
    for name in ("torch", "jax"):
        side = sides[name]
        clock = {"t": 0.0}
        kw = {"page_size": 4} if cache_impl == "paged" else {}
        cl = side.Cluster(lambda: side.Engine(
            max_batch=2, max_len=32, cache_impl=cache_impl,
            clock=lambda: clock["t"], **kw), n_replicas=2,
            clock=lambda: clock["t"])
        reqs = _requests(side, 3, seed=18)
        for r in reqs:
            cl.submit(r)
        while not all(r.generated for r in reqs):
            cl.step()
            clock["t"] += 0.1
        victim = next(i for i, e in enumerate(cl.replicas) if e.n_active)
        moved = cl.warn(victim, grace_tokens=0) if action == "warn" \
            else cl.revoke(victim)
        cl.run_to_completion()
        outs.append(([r.generated for r in reqs], moved, cl.tokens_lost,
                     cl.tokens_replayed, cl.pages_shipped,
                     cl.replica_seconds, len(cl.replicas), len(cl.retired)))
    assert outs[0] == outs[1]
    side = sides["torch"]
    assert outs[0][0] == [_solo(side, r) for r in _requests(side, 3, 18)]
    if action == "revoke":
        assert outs[0][2] > 0
    elif cache_impl == "paged":
        assert outs[0][4] > 0          # shipped (one falls back: no slot)
    else:
        assert outs[0][3] > 0 and outs[0][2] == 0


def test_cluster_scale_to_and_voluntary_drains(sides):
    side = sides["torch"]
    monitor = slo.SLOMonitor(slo.SLOSpec(storm_revocations=3,
                                         storm_window_s=60.0))
    cl = side.Cluster(lambda: side.Engine(max_batch=2, max_len=32),
                      n_replicas=1, monitor=monitor)
    assert cl.scale_to(4) == 3 and cl.n_replicas == 4
    assert cl.scale_to(1) == -3                  # graceful: drains
    cl.reap()
    assert len([e for e in cl.replicas if not e.draining]) == 1
    assert len(monitor._revocations) == 0        # not a provider revocation
    cl.scale_to(2)
    cl.warn(0, grace_tokens=0)
    assert len(monitor._revocations) == 1
    with pytest.raises(ValueError):
        cl.scale_to(0)
    assert [r["replica"] for r in cl.replica_summaries()] == \
        sorted(r["replica"] for r in cl.replica_summaries())


def test_monitor_and_recorder_never_change_tokens(sides):
    side = sides["torch"]

    def run(**kw):
        eng = side.Engine(max_batch=2, max_len=32, cache_impl="paged",
                          page_size=4, **kw)
        reqs = _requests(side, 4, seed=6, max_new=6, plen=4)
        for r in reqs:
            eng.submit(r)
        eng.run_to_completion()
        return [r.generated for r in reqs]

    assert run() == run(monitor=slo.SLOMonitor(),
                        recorder=obs.Recorder(deterministic=True))
