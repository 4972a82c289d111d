"""The port's gym execution against the JAX package's, on the CPU in
float32: ``execute_masked`` (the masked and the hetero elastic runtime,
with a revocation's fast save), ``execute_async_ps``, the runtime's
recorder emissions, and ``launch.train --gym``.

Both packages start from the same weights: the reference's initial
params (its ``init_state`` with ``jax.random.key(seed)``, and the async
PS's ``jax.random.normal`` linear model) are handed to the port by
monkeypatching its ``init_state`` and ``_linear_init`` in
``repro_torch.gym.gym``; both packages' configs are switched to float32
the same way. The plan is numpy in both and equal
(``tests/test_torch_planning.py``).

Tolerances, those of ``tests/test_torch_elastic.py``: per-step losses
1e-4 relative; the held-out accuracy within one image of the 512 (an
argmax may flip on float32 noise); executed steps, fast saves, active
counts and staleness histograms exact; the async PS's params within
1e-5 x max|param| after 64 pushes.
"""
import json
import math
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro import config as JC  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.core import checkpoint as JCK  # noqa: E402
from repro.core import elastic as JE  # noqa: E402
from repro.core import staleness as JS  # noqa: E402
from repro.core.policy import (GreedyCheapest as JGreedy,  # noqa: E402
                               PolicyDecision as JDec,
                               StaticPolicy as JStatic)
from repro.gym import gym as JG  # noqa: E402
from repro.gym import validate as JV  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.traces import load_trace as jload_trace  # noqa: E402
from repro.train import step as JTS  # noqa: E402
from repro_torch import config as C  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import CheckpointManager  # noqa: E402
from repro_torch.core.policy import (GreedyCheapest,  # noqa: E402
                                     PolicyDecision, StaticPolicy)
from repro_torch.gym import gym as G  # noqa: E402
from repro_torch.gym import validate as V  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.traces import load_trace  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


@pytest.fixture
def float32(monkeypatch):
    """Both packages' gym configs in float32 (the reference attending
    through "xla"), and the reference's initial params handed to the
    port: returns the dict the reference's params land in."""
    jget, get = JC.get_config, C.get_config
    monkeypatch.setattr(JC, "get_config", lambda a, reduced=False: jget(
        a, reduced=reduced).replace(dtype="float32", attn_impl="xla"))
    monkeypatch.setattr(G, "get_config", lambda a, reduced=False: get(
        a, reduced=reduced).replace(dtype="float32"))
    got = {}
    jinit = JTS.init_state

    def capture(*a, **kw):
        st = jinit(*a, **kw)
        got["params"] = jax.tree.map(np.asarray, st.params)
        return st

    monkeypatch.setattr(JTS, "init_state", capture)
    monkeypatch.setattr(G, "init_state", lambda model, tcfg: TS.init_state(
        model, tcfg, params=params_from_numpy(got["params"], model.cfg,
                                              model.device,
                                              dtype=torch.float32)))
    return got


CASES = {  # name: (arch, plan of each package, steps, with a checkpoint)
    "resnet8-hetero": ("resnet32-cifar10", lambda mod, dec, trace: (
        mod[0](trace("volatile"), mod[1](n_workers=4), refill=True,
               seed=0)), 12, False),
    "resnet8-revoked": ("resnet32-cifar10", lambda mod, dec, trace: (
        mod[0](dec[0](0)[1], mod[2](dec[1]("K80", 4)), seed=0)), 16, True),
    "starcoder2-masked": ("starcoder2-3b", lambda mod, dec, trace: (
        mod[0](trace("calm"), mod[2](dec[1]("K80", 2)), seed=1)), 8, True),
}


def plans(name):
    make = CASES[name][1]
    jgym = make((JG.TransientGym, JGreedy, JStatic),
                (JV.intensity_sweep_traces, JDec), jload_trace)
    gym = make((G.TransientGym, GreedyCheapest, StaticPolicy),
               (V.intensity_sweep_traces, PolicyDecision), load_trace)
    return jgym.plan(), gym.plan()


@pytest.mark.parametrize("name", list(CASES))
def test_execute_masked_matches_the_reference(name, float32, tmp_path,
                                              monkeypatch):
    arch, _, steps, with_ckpt = CASES[name]
    jled, led = plans(name)
    logs = {}

    class Runtime(JE.ElasticRuntime):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            logs["rt"] = self

    monkeypatch.setattr(JE, "ElasticRuntime", Runtime)
    jrec, rec = jobs.Recorder(deterministic=True), \
        obs.Recorder(deterministic=True)
    jck = JCK.CheckpointManager(str(tmp_path / "jax")) if with_ckpt else None
    ck = CheckpointManager(str(tmp_path / "torch")) if with_ckpt else None
    JG.execute_masked(jled, arch=arch, train_steps=steps, seed=0, ckpt=jck,
                      recorder=jrec, seq_len=16)
    G.execute_masked(led, arch=arch, train_steps=steps, seed=0, ckpt=ck,
                     recorder=rec, seq_len=16, device="cpu")
    want = logs["rt"].metrics_log
    assert led.executed_steps == jled.executed_steps == len(led.losses) > 0
    assert led.fast_saves == jled.fast_saves
    if name == "resnet8-revoked":
        assert led.fast_saves >= 1
        got = ck.restore_latest("cpu")
        assert got[2]["reason"] == "revocation_warning"
    if name == "resnet8-hetero":
        assert logs["rt"].allocator is not None       # the mixed fleet
    for i, r in enumerate(want):
        assert rel(led.losses[i], r["loss"]) < 1e-4, i
    assert rel(led.final_loss, jled.final_loss) < 1e-4
    assert len(led.step_s) == led.executed_steps
    assert abs(led.accuracy - jled.accuracy) <= 1 / 512 + 1e-9
    # the runtime's emissions: the same membership instants and step
    # spans on the step-index clock, the same series (step latency is
    # wall time: only its count is compared)
    view = [(e.name, e.ph, e.cat, e.track, e.t_sim, e.dur_sim,
             {k: v for k, v in e.args.items() if k != "loss"})
            for e in rec.events]
    assert view == [(e.name, e.ph, e.cat, e.track, e.t_sim, e.dur_sim,
                     {k: v for k, v in e.args.items() if k != "loss"})
                    for e in jrec.events]
    names = {e.name for e in rec.events}
    assert {obs.EV_STEP} <= names
    m, jm = rec.metrics.to_dict(), jrec.metrics.to_dict()
    assert m.keys() == jm.keys()
    for key in m:
        if key.startswith("step_latency_ms"):
            assert m[key]["count"] == jm[key]["count"] == led.executed_steps
        else:
            assert m[key] == jm[key], key


def test_execute_async_ps_matches_the_reference(monkeypatch):
    """The same membership timeline in update space, from the reference's
    linear-model weights: the same histogram, close params."""
    got = {}

    class Sim(JS.AsyncPSSimulator):
        def __init__(self, loss, params, *a, **kw):
            got["init"] = jax.tree.map(np.asarray, params)
            super().__init__(loss, params, *a, **kw)

        def run(self, *a, **kw):
            got["res"] = super().run(*a, **kw)
            return got["res"]

    monkeypatch.setattr(JS, "AsyncPSSimulator", Sim)
    monkeypatch.setattr(G, "_linear_init", lambda dim, n, seed, dev: {
        k: torch.from_numpy(v.copy()).to(dev) for k, v in got["init"].items()})
    jled, led = plans("resnet8-hetero")
    jrec, rec = jobs.Recorder(deterministic=True), \
        obs.Recorder(deterministic=True)
    JG.execute_async_ps(jled, updates=64, seed=0, recorder=jrec)
    G.execute_async_ps(led, updates=64, seed=0, recorder=rec, device="cpu")
    assert led.staleness_hist == jled.staleness_hist
    assert sum(led.staleness_hist.values()) == 64
    assert led.mean_staleness == jled.mean_staleness > 0.5
    want = got["res"].params
    big = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    err = max(float((led.ps_params[k] - torch.from_numpy(np.array(v)))
                    .abs().max()) for k, v in want.items())
    assert err <= 1e-5 * big
    assert rec.metrics.to_dict() == jrec.metrics.to_dict()
    assert led.to_dict() == jled.to_dict()


def test_accuracy_intensity_sweep_executes_the_reference_schedules():
    """One trained episode per revocation intensity: the executed steps
    are the reference plans' schedules, and they never rise with the
    intensity."""
    ledgers = V.accuracy_intensity_sweep(train_steps=4, device="cpu")
    plans = [JG.TransientGym(t, JStatic(JDec("K80", 4)), refill=False,
                             seed=0).plan()
             for t in JV.intensity_sweep_traces(0)]
    assert [led.executed_steps for led in ledgers] == \
        [JG.training_schedule(p, 4).executed_steps for p in plans]
    assert [led.trace for led in ledgers] == [p.trace for p in plans]
    assert all(0.0 <= led.accuracy <= 1.0 for led in ledgers)
    assert not [v for v in V.check_monotone(ledgers) if "steps" in v]


def test_linear_init_draws_on_the_cpu_from_the_seed():
    a = G._linear_init(12, 3, 7, torch.device("cpu"))
    b = G._linear_init(12, 3, 7, torch.device("cpu"))
    assert torch.equal(a["w"], b["w"]) and not a["b"].any()
    assert 0.005 < float(a["w"].std()) < 0.02
    assert not torch.equal(a["w"], G._linear_init(12, 3, 8, "cpu")["w"])


GYM_FLAGS = ["--gym", "--trace", "volatile", "--policy", "greedy",
             "--initial-workers", "4", "--arch", "resnet32-cifar10",
             "--steps", "6", "--gym-async-updates", "32", "--seed", "0"]
PLAN_KEYS = ("trace", "policy", "total_steps", "completed", "failure",
             "time_h", "cost_usd", "vsteps_done", "avg_active_workers",
             "revocations", "max_slots", "cost_by_kind", "batching",
             "executed_steps", "fast_saves", "n_epochs", "n_events",
             "mean_staleness", "staleness_hist")


def test_launch_train_gym_matches_the_reference(monkeypatch, capsys):
    """``launch.train --gym`` in both packages with the same flags: the
    reference's summary keys, equal on the plan side (the trained loss
    and accuracy start from each package's own initial weights)."""
    monkeypatch.setattr(sys, "argv", ["train", *GYM_FLAGS])
    jlaunch.main()
    want = json.loads(capsys.readouterr().out)
    out = launch.main(["--device", "cpu", *GYM_FLAGS])
    printed = json.loads(capsys.readouterr().out)
    assert printed == json.loads(json.dumps(out))
    assert set(want) <= set(out)
    for key in PLAN_KEYS:
        assert out[key] == want[key], key
    assert out["device"] == "cpu" and out["reduced"] is True
    assert out["executed_steps"] == 6 == len(out["losses"]) \
        == len(out["step_s"])
    assert all(math.isfinite(x) for x in out["losses"])
    assert out["loss_first"] == out["losses"][0]
    assert out["loss_last"] == out["losses"][-1] == out["final_loss"]
    assert out["async_pushes"] == 32 and out["async_pushes_per_s"] > 0
    assert min(out["plan_s"], out["train_s"], out["async_s"]) >= 0


def test_launch_train_gym_full_trains_the_published_widths(monkeypatch):
    """``--gym --full`` builds ResNet-32 (the reference's gym always
    trains the reduced config: a deliberate difference), and the gym
    runs on the card unless asked for the CPU."""
    built = []
    real = G.build_model
    monkeypatch.setattr(G, "build_model", lambda cfg, device: (
        built.append(cfg), real(cfg, device))[1])
    flags = ["--device", "cpu", "--gym", "--trace", "calm", "--arch",
             "resnet32-cifar10", "--steps", "1", "--initial-workers", "1"]
    out = launch.main([*flags, "--full"])
    assert out["reduced"] is False and out["executed_steps"] == 1
    assert {(c.resnet_n, c.image_size) for c in built} == {(5, 32)}
    built.clear()
    assert launch.main(flags)["reduced"] is True
    assert {(c.resnet_n, c.image_size) for c in built} == {(1, 16)}
    args = launch.parse_args(["--gym"])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            launch.main(["--gym", "--steps", "1"])
        with pytest.raises(RuntimeError, match="CUDA"):
            G.TransientGym(load_trace("calm")).run(train_steps=1)


@pytest.mark.parametrize("flag,item", [("--events", "item 4"),
                                       ("--profile", "item 7")])
def test_launch_train_obs_flags_are_not_ported(flag, item, tmp_path):
    """The flags that raised until ROADMAP Queue 1 {item} was ported now
    record the gym's run: ``--events`` its event log, ``--profile`` a
    profiler trace with the log and the timeline beside it."""
    path = str(tmp_path / ("events.jsonl" if flag == "--events" else "prof"))
    out = launch.main(["--device", "cpu", "--gym", "--steps", "2", flag,
                       path])
    assert out["executed_steps"] == 2
    events = obs.load_events(out["events"])
    assert {e.name for e in events} >= {obs.EV_EPISODE, obs.EV_STEP}
    if flag == "--profile":
        assert out["profile_dir"] == path
        for name in ("device.trace.json", "events.jsonl",
                     "timeline.trace.json"):
            assert os.path.getsize(os.path.join(path, name)) > 0
    else:
        assert out["events"] == path and "profile_dir" not in out


def test_trainer_emissions_match_the_reference():
    """The static ``Trainer``'s step spans and series."""
    from repro.data import pipeline as JD
    from repro.models.builder import build_model as jbuild
    from repro.train import trainer as JTR
    from repro_torch.data import pipeline as D
    from repro_torch.models.builder import build_model
    from repro_torch.train import trainer as TR
    jcfg = JC.get_config("starcoder2-3b", reduced=True).replace(
        dtype="float32", attn_impl="xla")
    cfg = C.get_config("starcoder2-3b", reduced=True).replace(
        dtype="float32", attn_impl="torch")
    tcfg = (JC.TrainConfig(), C.TrainConfig())
    jm, m = jbuild(jcfg), build_model(cfg, "cpu")
    jstate = JTS.init_state(jm, tcfg[0], jax.random.key(0))
    tree = jax.tree.map(np.asarray, jstate.params)
    jrec, rec = jobs.Recorder(deterministic=True), \
        obs.Recorder(deterministic=True)
    jtr = JTR.Trainer(jm, tcfg[0], JD.ShardedDataset(jcfg, global_batch=2,
                                                     seq_len=8),
                      recorder=jrec)
    tr = TR.Trainer(m, tcfg[1], D.ShardedDataset(cfg, global_batch=2,
                                                 seq_len=8, device="cpu"),
                    recorder=rec)
    jtr.fit(jstate, 3)
    tr.fit(TS.init_state(m, tcfg[1], params=params_from_numpy(
        tree, cfg, "cpu", dtype=torch.float32)), 3)
    assert [(e.name, e.cat, e.t_sim, e.dur_sim, e.args["mode"])
            for e in rec.events] == \
        [(e.name, e.cat, e.t_sim, e.dur_sim, e.args["mode"])
         for e in jrec.events] and len(rec.events) == 3
    for a, b in zip(rec.events, jrec.events):
        assert rel(a.args["loss"], b.args["loss"]) < 1e-4
    assert rec.metrics.to_dict()["steps_total{mode=static}"] == \
        jrec.metrics.to_dict()["steps_total{mode=static}"] == 3.0
    assert rec.metrics.to_dict()["step_latency_ms"]["count"] == 3
