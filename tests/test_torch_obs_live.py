"""The port's observability layer against the reference's: fed the same
event streams, observations and samples, ``to_chrome_trace``,
``write_events_csv``, ``metrics_stats``, ``perf_entry``, the
``TimeSeriesSampler``, the ``SLOMonitor`` and the ops report (HTML and
text, as strings) give equal outputs, and so do the export and report
CLIs. Then the drivers: ``launch.serve`` in trace mode with a 2-replica
paged fleet, the autoscaler, the monitor, a warning and a revocation
gives the reference's summary (every key but the wall-clock ones) and
its event chain (names, tracks, sim times and trace links, in order);
``launch.train --events`` records the reference's event chain;
``--profile`` writes the profiler trace, ``events.jsonl`` and a valid
``timeline.trace.json``, and a profiler that cannot start raises.
Mirrors ``tests/test_obs.py``, ``tests/test_obs_live.py`` and
``tests/test_serve_tracing.py``."""
import io
import json
import os
import sys
import types
from contextlib import redirect_stdout

import pytest

torch = pytest.importorskip("torch")

from repro import obs as jobs  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.launch import train as jtrain  # noqa: E402
from repro.obs import export as jexport  # noqa: E402
from repro.obs import report as jreport  # noqa: E402
from repro.obs import slo as jslo  # noqa: E402
from repro.obs import timeseries as jts  # noqa: E402
from repro.traces.requests import synthetic_request_trace  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.launch import obs_args  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.obs import export, profiling, report, slo  # noqa: E402
from repro_torch.obs import timeseries as ts  # noqa: E402

PKGS = {"jax": types.SimpleNamespace(obs=jobs, export=jexport, slo=jslo,
                                     ts=jts, report=jreport),
        "torch": types.SimpleNamespace(obs=obs, export=export, slo=slo,
                                       ts=ts, report=report)}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """These tests run many tiny ops: one intra-op thread is faster than
    a pool, most of all beside other test workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _recorded(pkg):
    """The same calls on a deterministic recorder: instants and spans on
    several tracks, a cross-track trace chain, a sim-less instant and
    labelled metrics."""
    o = pkg.obs
    rec = o.Recorder(deterministic=True, meta={"run": "x"})
    rec.instant(o.EV_ENQUEUE, cat=o.CAT_SERVE, track="req0", sim_t=0.5,
                trace_id="t0", span_id="t0.0", parent_id=None, n=1)
    rec.span_at(o.EV_PREFILL, cat=o.CAT_SERVE, track="r0/req0", t_wall=0.0,
                dur_wall=0.0, sim_t=0.5, dur_sim=1.0, trace_id="t0",
                span_id="t0.1", parent_id="t0.0", tokens=5)
    rec.instant(o.EV_MIGRATE, cat=o.CAT_SERVE, track="r1/req0", sim_t=2.0,
                trace_id="t0", span_id="t0.2", parent_id="t0.1",
                mode="ship")
    rec.sim_span(o.EV_EPISODE, cat=o.CAT_GYM, t0=0.0, t1=3.0, steps=4)
    with rec.span(o.EV_STEP, cat=o.CAT_TRAIN, track="w0", sim_t=1.0) as a:
        a["loss"] = 1.5
    rec.instant("kernel.dispatch", cat=o.CAT_KERNEL)        # no sim_t
    rec.metrics.counter("requests_total").inc(3)
    rec.metrics.counter("requests_rejected", reason="pages").inc()
    rec.metrics.gauge("replicas_live").set(2.0)
    for v in (1.0, 3.0, 250.0):
        rec.metrics.histogram("ttft_ms").observe(v)
    return rec


@pytest.mark.parametrize("clock", ["sim", "wall"])
def test_chrome_trace_csv_and_stats_match_reference(clock, tmp_path):
    out = {}
    for name, pkg in PKGS.items():
        rec = _recorded(pkg)
        trace = pkg.export.to_chrome_trace(rec.events, clock=clock,
                                           meta=rec.meta)
        csv = pkg.export.write_events_csv(rec.events,
                                          str(tmp_path / f"{name}.csv"))
        log = rec.flush(str(tmp_path / f"{name}.jsonl"))
        out[name] = (trace, pkg.export.validate_chrome_trace(trace),
                     open(csv).read(),
                     pkg.export.metrics_stats(rec.metrics),
                     pkg.export.perf_entry(0.002, 0.001, flops=1e6,
                                           bottleneck="memory"),
                     [e.to_json() for e in pkg.obs.load_events(log)])
    assert out["torch"] == out["jax"]
    with pytest.raises(ValueError, match="dur"):
        export.validate_chrome_trace({"traceEvents": [
            {"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0}]})


def test_export_cli_matches_reference(tmp_path):
    log = _recorded(PKGS["torch"]).flush(str(tmp_path / "e.jsonl"))
    outs = []
    for name, pkg in PKGS.items():
        path = str(tmp_path / f"{name}.trace.json")
        buf = io.StringIO()
        with redirect_stdout(buf):
            pkg.export.main([log, path, "--clock", "sim"])
        printed = json.loads(buf.getvalue())
        printed.pop("out")
        outs.append((printed, json.load(open(path))))
    assert outs[0] == outs[1]


def _sampled(pkg):
    s = pkg.ts.TimeSeriesSampler(interval_s=1.0, capacity=6)
    state = {"total": 0.0, "replicas": [0]}
    s.register("gauge", lambda now: now * 2.0)
    s.register_rate("rate", lambda now: state["total"])
    s.register_many(lambda now: [("per_r", {"replica": r}, float(r))
                                 for r in state["replicas"]])
    for i, t in enumerate([0.0, 0.5, 1.5, 2.0, 3.2, 4.0, 5.5, 6.1, 9.0]):
        state["total"] += 7.0 * i
        if i == 3:
            state["replicas"] = [0, 1]
        s.maybe_sample(t)
    return s


def _monitored(pkg):
    m = pkg.slo.SLOMonitor(pkg.slo.SLOSpec(
        attainment_target=0.9, ttft_target_s=0.5, long_window_s=20.0,
        short_window_s=5.0, min_requests=4, cooldown_s=6.0,
        storm_revocations=2, storm_window_s=10.0, pool_util_threshold=0.8,
        pool_window_s=3.0))

    def outcome(t, deadline, ttft):
        return types.SimpleNamespace(
            timing=types.SimpleNamespace(
                t_complete=t, ttft_s=ttft, t_first_token=t - 0.5,
                tpot_s=lambda n: 0.05), generated=[1, 2, 3],
            deadline_s=deadline, slo="interactive")

    quantiles = []
    for i in range(30):
        t = float(i)
        if i % 3:
            m.observe_completion(outcome(t, t + (1 if i % 5 else -1),
                                         0.1 * i), now=t)
        else:
            m.observe_drop(outcome(t, t, None), now=t, reason="admission")
        if i in (7, 9, 20):
            m.observe_revocation(now=t, replica=i % 2)
        m.observe_pool(0.5 + 0.02 * i, now=t)
        m.evaluate(now=t)
        quantiles.append((m.attainment(now=t), m.burn_rate(5.0, now=t),
                          m.ttft_quantile(0.95, now=t),
                          m.tpot_quantile(0.5, now=t)))
    return m, quantiles


def test_sampler_monitor_and_report_match_reference(tmp_path):
    out = {}
    for name, pkg in PKGS.items():
        s = _sampled(pkg)
        m, quantiles = _monitored(pkg)
        series = s.series()
        replicas = [{"replica": 0, "state": "live", "tokens_decoded": 9},
                    {"replica": 1, "state": "retired", "tokens_decoded": 3}]
        path = s.write_jsonl(str(tmp_path / f"{name}.jsonl"))
        s.write_csv(str(tmp_path / f"{name}.csv"))
        out[name] = {
            "rows": s.to_rows(), "jsonl": open(path).read(),
            "csv": open(str(tmp_path / f"{name}.csv")).read(),
            "alerts": [a.to_json() for a in m.alerts],
            "labels": [a.label for a in m.alerts],
            "recent": [a.to_json() for a in m.recent_alerts(now=29.0)],
            "counts": (m.n_outcomes, m.n_misses), "quantiles": quantiles,
            "html": pkg.report.render_report(
                series=series, alerts=m.alerts, replicas=replicas,
                summary={"requests": 30}, title="ops"),
            "text": pkg.report.render_text(series=series, alerts=m.alerts,
                                           replicas=replicas, title="ops"),
            "loaded": {k: (v.times, v.values) for k, v in
                       pkg.ts.load_series_jsonl(path).items()}}
    for key in out["jax"]:
        assert out["torch"][key] == out["jax"][key], key
    assert {a["kind"] for a in out["torch"]["alerts"]} >= {
        slo.ALERT_SLO_BURN, slo.ALERT_REVOCATION_STORM}
    report.validate_report(out["torch"]["html"], min_series=3,
                           min_alerts=len(out["torch"]["alerts"]))


def test_report_cli_matches_reference(tmp_path):
    s = _sampled(PKGS["torch"])
    m, _ = _monitored(PKGS["torch"])
    series = s.write_jsonl(str(tmp_path / "s.jsonl"))
    alerts = str(tmp_path / "a.json")
    json.dump([a.to_json() for a in m.alerts], open(alerts, "w"))
    docs = []
    for name, pkg in PKGS.items():
        html = str(tmp_path / f"{name}.html")
        buf = io.StringIO()
        with redirect_stdout(buf):
            pkg.report.main([series, "--alerts", alerts, "--out", html,
                             "--text"])
        docs.append((open(html).read(), buf.getvalue().replace(html, "")))
    assert docs[0] == docs[1]


# -- the drivers -------------------------------------------------------------

WALL_KEYS = {"wall_s", "tokens_per_s"}
PATH_KEYS = {"events", "series", "report", "profile_dir", "timeline",
             "device_trace"}
PORT_KEYS = {"reduced", "device", "attn_impl", "ssm_impl", "rwkv_impl"}


def _run_reference(main, argv):
    old = sys.argv
    sys.argv = ["prog", *argv]
    buf = io.StringIO()
    try:
        with redirect_stdout(buf):
            main()
    finally:
        sys.argv = old
    text = buf.getvalue()
    return json.loads(text[text.index("{"):])


def _chain(path):
    """The comparable part of an event log: each event's name, category,
    track, sim time, trace links and argument names, in order (wall
    times and loss values differ between runs)."""
    return [(e.name, e.cat, e.track, e.t_sim, e.dur_sim, e.trace_id,
             e.span_id, e.parent_id, sorted(e.args))
            for e in obs.load_events(path)]


@pytest.fixture(scope="module")
def fleet_trace(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("trace") / "bursty.jsonl")
    synthetic_request_trace("serve-bursty", seed=0, horizon_s=60.0,
                            bursts=((0.4, 0.55, 3.0),)).to_jsonl(path)
    return path


def _serve_argv(trace, out):
    return ["--trace", trace, "--queue", "slo", "--cache-impl", "paged",
            "--replicas", "2", "--autoscale", "--min-replicas", "2",
            "--max-replicas", "3", "--monitor", "--warn-at", "0.4",
            "--revoke-at", "0.7", "--max-batch", "4", "--max-len", "64",
            "--events", str(out / "events.jsonl"),
            "--series-out", str(out / "series.jsonl"),
            "--report", str(out / "report.html")]


def test_serve_driver_matches_reference(fleet_trace, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    want = _run_reference(jserve.main,
                          _serve_argv(fleet_trace, tmp_path / "jax"))
    buf = io.StringIO()
    with redirect_stdout(buf):
        got = serve.main(["--device", "cpu",
                          *_serve_argv(fleet_trace, tmp_path / "torch")])
    assert json.loads(buf.getvalue()) == got
    assert set(got) == set(want) | PORT_KEYS
    for key in set(want) - WALL_KEYS - PATH_KEYS:
        assert got[key] == want[key], key
    assert got["tokens_lost"] > 0 and got["pages_shipped"] > 0
    assert got["completed"] + got["rejected"] == got["requests"]
    assert _chain(got["events"]) == _chain(want["events"])
    names = {e.name for e in obs.load_events(got["events"])}
    assert {obs.EV_REVOKE_WARN, obs.EV_REVOKE_FIRE, obs.EV_MIGRATE,
            obs.EV_DRAIN} <= names
    assert open(got["series"]).read() == open(want["series"]).read()
    assert open(got["report"]).read() == open(want["report"]).read()


def test_serve_driver_single_engine_matches_reference(fleet_trace):
    argv = ["--trace", fleet_trace, "--prefill-mode", "token", "--warn-at",
            "0.3", "--revoke-at", "0.6", "--max-len", "64"]
    want = _run_reference(jserve.main, argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        got = serve.main(["--device", "cpu", *argv])
    for key in set(want) - WALL_KEYS:
        assert got[key] == want[key], key
    assert got["tokens_lost"] > 0 and got["tokens_replayed"] > 0


def test_serve_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--trace", "serve-bursty"])


TRAIN_ARGV = ["--elastic", "--slots", "2", "--initial-workers", "1",
              "--join-every", "1", "--revoke-at", "2", "--steps", "3",
              "--global-batch", "4", "--seq-len", "16"]


def test_train_driver_events_match_reference(tmp_path):
    want = _run_reference(jtrain.main, [*TRAIN_ARGV, "--events",
                                        str(tmp_path / "jax.jsonl")])
    got = train.main(["--device", "cpu", *TRAIN_ARGV, "--events",
                      str(tmp_path / "torch.jsonl")])
    for key in ("arch", "steps", "elastic", "final_step"):
        assert got[key] == want[key], key
    assert set(want) - {"wall_s"} <= set(got)
    assert _chain(got["events"]) == _chain(want["events"])
    assert {obs.EV_STEP, obs.EV_REVOKE_WARN} <= {
        e.name for e in obs.load_events(got["events"])}


def test_profile_writes_trace_log_and_timeline(fleet_trace, tmp_path):
    prof = str(tmp_path / "prof")
    buf = io.StringIO()
    with redirect_stdout(buf):
        out = serve.main(["--device", "cpu", "--trace", fleet_trace,
                          "--replicas", "2", "--cache-impl", "paged",
                          "--profile", prof])
    assert out["profile_dir"] == prof
    assert out["events"] == os.path.join(prof, "events.jsonl")
    assert out["device_trace"] == os.path.join(prof, "device.trace.json")
    device = json.load(open(out["device_trace"]))
    assert any(e.get("name", "").startswith("aten::")
               for e in device["traceEvents"])
    timeline = json.load(open(out["timeline"]))
    assert export.validate_chrome_trace(timeline) > 0
    assert obs.load_events(out["events"])
    assert profiling._ACTIVE is None                # stopped and cleared


def test_profiler_that_cannot_start_raises(monkeypatch, tmp_path):
    def refuse(self):
        raise RuntimeError("profiler unavailable")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    args = types.SimpleNamespace(events=None, profile=str(tmp_path / "p"))
    with pytest.raises(RuntimeError, match="profiler unavailable"):
        obs_args.recorder_from_args(args)
    assert profiling._ACTIVE is None


def test_trace_context_and_step_bound(tmp_path):
    rec = obs.Recorder(deterministic=True)
    assert profiling.start_trace(str(tmp_path), max_steps=2)
    with pytest.raises(RuntimeError, match="already running"):
        profiling.start_trace(str(tmp_path))
    with profiling.TraceContext(rec, "region", track="t", n=1) as live:
        live["m"] = 2
        torch.ones(3).sum()
    profiling.step()
    assert profiling._ACTIVE.running
    profiling.step()                                # bound reached
    assert not profiling._ACTIVE.running
    path = profiling.stop_trace()
    names = {e.get("name") for e in json.load(open(path))["traceEvents"]}
    assert "region" in names
    assert [(e.name, e.track, e.args) for e in rec.events] == \
        [("region", "t", {"n": 1, "m": 2})]
    assert profiling.stop_trace() is None
