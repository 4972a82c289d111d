"""The port's elastic runtime against the JAX package's, on the CPU in
float32: the masked and hetero training steps, ``slot_batch``, the
``ElasticRuntime`` over join/warn/revoke traces (with its fast and
periodic saves), restart equivalence, and ``launch.train --elastic``
against ``repro.launch.train`` for the same flags and seed.

Both packages start from one state: the reference's initial weights
(biases and gammas given seeded nonzero values) bridged into the port as
float32 masters. The port trains through its plain attention, the
reference through ``"xla"``.

Tolerances (float32; the packages differ in summation order only), as
``test_torch_train.py`` states them for the static step: loss and ``lr``
1e-5 relative, ``grad_norm`` 1e-4 relative; after three AdamW steps every
parameter within 1e-5 relative + 3e-5 absolute, ``m`` 1e-5 + 1e-7 and
``v`` 1e-5 + 1e-9. The launcher comparisons run eight steps: losses and
LRs 1e-4 relative; the seven-step runtime comparison holds parameters to
1e-5 relative + 1e-4 absolute. Active counts and fast-save counts are
exact.
"""
import math
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as JC  # noqa: E402
from repro import hetero as JH  # noqa: E402
from repro.core import checkpoint as JCK  # noqa: E402
from repro.core import cluster as JCL  # noqa: E402
from repro.core import elastic as JE  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.launch import train as jlaunch  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.builder import build_model as jax_build  # noqa: E402
from repro.train import step as JTS  # noqa: E402
from repro_torch import config as C  # noqa: E402
from repro_torch import hetero as H  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import (CheckpointManager, ElasticRuntime,  # noqa: E402
                              RevocationEvent, SparseCluster)
from repro_torch.core import elastic as E  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.launch import train as launch  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

GB, SEQ = 8, 16


def randomise_zero_inits(tree, rng):
    """Seeded nonzero biases and gammas, in place."""
    for key, val in tree.items():
        if isinstance(val, dict):
            randomise_zero_inits(val, rng)
        elif key in ("gamma", "bq", "bk", "bv"):
            tree[key] = (val + rng.normal(0.0, 0.2, val.shape)).astype(
                np.float32)
    return tree


@pytest.fixture(scope="module")
def pair():
    """(reference model, port model, numpy weights): never stepped, so
    each test builds its own states from the weights."""
    jcfg = JC.get_config("starcoder2-3b", reduced=True).replace(
        dtype="float32", attn_impl="xla")
    cfg = C.get_config("starcoder2-3b", reduced=True).replace(
        dtype="float32", attn_impl="torch")
    jm = jax_build(jcfg)
    tree = jax.tree.map(np.asarray, JL.unbox(jm.init(jax.random.key(0))))
    return jm, build_model(cfg, "cpu"), randomise_zero_inits(
        tree, np.random.default_rng(0))


def tcfgs(adaptive=True, checkpoint_every=0, base_workers=2):
    opt = dict(name="adamw", lr=1e-3, weight_decay=1e-4, grad_clip=1.0,
               adaptive_lr=adaptive, base_workers=base_workers)
    sched = dict(kind="cosine", warmup_steps=2, total_steps=10)
    kw = dict(checkpoint_every=checkpoint_every)
    return (JC.TrainConfig(optimizer=JC.OptimizerConfig(**opt),
                           schedule=JC.ScheduleConfig(**sched), **kw),
            C.TrainConfig(optimizer=C.OptimizerConfig(**opt),
                          schedule=C.ScheduleConfig(**sched), **kw))


def states(pair, jt, tc):
    jm, model, tree = pair
    jstate = JTS.init_state(jm, jt, jax.random.key(0),
                            jax.tree.map(jnp.asarray, tree))
    state = TS.init_state(model, tc, params=params_from_numpy(
        tree, model.cfg, "cpu", dtype=torch.float32))
    return jstate, state


def datasets(pair):
    jm, model, _ = pair
    return (JD.ShardedDataset(jm.cfg, global_batch=GB, seq_len=SEQ, seed=1),
            D.ShardedDataset(model.cfg, global_batch=GB, seq_len=SEQ, seed=1,
                             device="cpu"))


def clusters(active, slots=4, kinds=None):
    out = []
    for mod in (JCL, E):
        c = mod.SparseCluster(slots)
        for s in active:
            c.fill_and_activate(s, 0, kind=(kinds or {}).get(s, "K80"))
        out.append(c)
    return out


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def assert_tree_close(got, want, rtol, atol):
    want = dict(tree_leaves(jax.tree.map(np.asarray, want)))
    got = dict(tree_leaves(got))
    assert got.keys() == want.keys()
    for path, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), want[path], rtol=rtol,
                                   atol=atol, err_msg=path)


def assert_states_close(state, jstate):
    assert state.step == int(jstate.step)
    assert_tree_close(state.params, jstate.params, 1e-5, 3e-5)
    assert_tree_close(state.opt["m"], jstate.opt["m"], 1e-5, 1e-7)
    assert_tree_close(state.opt["v"], jstate.opt["v"], 1e-5, 1e-9)
    assert state.opt["count"] == int(jstate.opt["count"])


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "naive"])
@pytest.mark.parametrize("active", [(0, 2), (0, 1, 2, 3)],
                         ids=["mask1010", "mask1111"])
def test_masked_steps_match_the_reference(pair, active, adaptive):
    jm, model, _ = pair
    jt, tc = tcfgs(adaptive)
    jstate, state = states(pair, jt, tc)
    jds, ds = datasets(pair)
    jc, c = clusters(active)
    jstep = jax.jit(JE.make_masked_train_step(jm, jt))
    step = E.make_masked_train_step(model, tc)
    for i in range(3):
        jbatch, jmask = JE.slot_batch(jm.cfg, jds, i, jc)
        batch, mask = E.slot_batch(model.cfg, ds, i, c)
        np.testing.assert_array_equal(mask, np.asarray(jmask))
        for key in ("tokens", "labels"):
            assert tuple(batch[key].shape) == (4, GB // 4, SEQ)
            np.testing.assert_array_equal(batch[key].numpy(),
                                          np.asarray(jbatch[key]))
        jstate, jm_ = jstep(jstate, jbatch, jmask)
        state, m = step(state, batch, mask)
        assert rel(m["loss"], jm_["loss"]) < 1e-5, (i, "loss")
        assert rel(m["grad_norm"], jm_["grad_norm"]) < 1e-4, (i, "grad_norm")
        assert rel(m["lr"], jm_["lr"]) < 1e-5, (i, "lr")
        assert m["active"] == float(jm_["active"]) == len(active)
    assert_states_close(state, jstate)


@pytest.mark.parametrize("adaptive", [True, False], ids=["adaptive", "naive"])
def test_hetero_steps_match_the_reference(pair, adaptive):
    """Counts [3, 0, 2, 1] of the per-slot capacity 4 (the rows past each
    count masked), an aggregate-throughput ratio of 1.7."""
    jm, model, _ = pair
    jt, tc = tcfgs(adaptive)
    jstate, state = states(pair, jt, tc)
    jds = JD.ShardedDataset(jm.cfg, global_batch=16, seq_len=SEQ, seed=2)
    ds = D.ShardedDataset(model.cfg, global_batch=16, seq_len=SEQ, seed=2,
                          device="cpu")
    jc, c = clusters((0, 2, 3))
    counts, ratio = [3.0, 0.0, 2.0, 1.0], 1.7
    jstep = jax.jit(JE.make_hetero_train_step(jm, jt))
    step = E.make_hetero_train_step(model, tc)
    for i in range(3):
        jbatch, _ = JE.slot_batch(jm.cfg, jds, i, jc)
        batch, _ = E.slot_batch(model.cfg, ds, i, c)
        jstate, jm_ = jstep(jstate, jbatch, jnp.asarray(counts, jnp.float32),
                            jnp.float32(ratio))
        state, m = step(state, batch, counts, ratio)
        assert rel(m["loss"], jm_["loss"]) < 1e-5, (i, "loss")
        assert rel(m["grad_norm"], jm_["grad_norm"]) < 1e-4, (i, "grad_norm")
        assert rel(m["lr"], jm_["lr"]) < 1e-5, (i, "lr")
        assert m["active"] == int(jm_["active"]) == 3
        assert m["examples"] == float(jm_["examples"]) == 6.0
    assert_states_close(state, jstate)


def test_inactive_rows_do_not_affect_the_update(pair):
    """Poisoning an inactive slot's data (masked) or the rows past a
    slot's count (hetero) changes neither the loss nor the update."""
    jm, model, tree = pair
    _, tc = tcfgs()
    _, ds = datasets(pair)
    _, c = clusters((0, 1))
    batch, mask = E.slot_batch(model.cfg, ds, 0, c)

    def poison(rows):
        out = {k: v.clone() for k, v in batch.items()}
        for slot, first in rows:
            for v in out.values():
                v[slot, first:] = 0
        return out

    cases = [(E.make_masked_train_step, (mask,), [(2, 0), (3, 0)]),
             (E.make_hetero_train_step, ([2.0, 1.0, 0.0, 0.0], 2.0),
              [(1, 1), (2, 0), (3, 0)])]
    for make, args, rows in cases:
        outs = []
        for b in (batch, poison(rows)):
            st = TS.init_state(model, tc, params=params_from_numpy(
                tree, model.cfg, "cpu", dtype=torch.float32))
            outs.append(make(model, tc)(st, b, *args))
        (s1, m1), (s2, m2) = outs
        assert float(m1["loss"]) == float(m2["loss"])
        for (_, x), (_, y) in zip(tree_leaves(s1.params),
                                  tree_leaves(s2.params)):
            assert torch.equal(x, y)


def test_hetero_collapses_to_masked(pair):
    """counts = per_slot x mask and lr_ratio = n_active / base reproduce
    the masked step exactly."""
    jm, model, tree = pair
    _, tc = tcfgs()
    _, ds = datasets(pair)
    _, c = clusters((0, 2))
    batch, mask = E.slot_batch(model.cfg, ds, 0, c)
    per = batch["tokens"].shape[1]
    outs = []
    for fn, args in ((E.make_masked_train_step(model, tc), (mask,)),
                     (E.make_hetero_train_step(model, tc),
                      (mask * per, 2.0 / tc.optimizer.base_workers))):
        st = TS.init_state(model, tc, params=params_from_numpy(
            tree, model.cfg, "cpu", dtype=torch.float32))
        outs.append(fn(st, batch, *args))
    (sm, mm), (sh, mh) = outs
    assert float(mm["loss"]) == float(mh["loss"]) and mm["lr"] == mh["lr"]
    for (_, a), (_, b) in zip(tree_leaves(sm.params), tree_leaves(sh.params)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

TRACE = [("join", 1, 1), ("join", 2, 2), ("warn", 3, 0), ("revoke", 4, 0),
         ("join", 5, 0), ("warn", 5, 1), ("revoke", 6, 1)]


@pytest.mark.parametrize("mode", ["masked", "hetero"])
def test_runtime_matches_the_reference(pair, mode, tmp_path):
    """Seven steps over joins, warnings (fast saves) and revocations, with
    a periodic save every 4 steps: the same ``metrics_log``, fast saves
    and newest checkpoint step; in hetero mode over a K80/V100 fleet with
    the dynamic batch allocator."""
    jm, model, _ = pair
    jt, tc = tcfgs(checkpoint_every=4)
    jstate, state = states(pair, jt, tc)
    jds = JD.ShardedDataset(jm.cfg, global_batch=16, seq_len=SEQ, seed=3)
    ds = D.ShardedDataset(model.cfg, global_batch=16, seq_len=SEQ, seed=3,
                          device="cpu")
    jc, c = clusters((0,))
    kinds = {1: "V100", 2: "K80", 0: "V100"}
    events = [(k, st, sl, kinds.get(sl, "K80")) for k, st, sl in TRACE]
    jck = JCK.CheckpointManager(str(tmp_path / "jax"))
    ck = CheckpointManager(str(tmp_path / "torch"))
    if mode == "hetero":
        akw = dict(global_batch=13, cap_per_slot=4, base_workers=1,
                   base_kind="K80")
        jalloc = JH.DynamicBatchAllocator(jc, **akw)
        alloc = H.DynamicBatchAllocator(c, **akw)
    else:
        jalloc = alloc = None
    jrt = JE.ElasticRuntime(jm, jt, jds, jc, jck, allocator=jalloc)
    rt = ElasticRuntime(model, tc, ds, c, ck, allocator=alloc)
    jrt.add_events([JE.RevocationEvent(step=st, slot=sl, kind=k,
                                       server_kind=sk)
                    for k, st, sl, sk in events])
    rt.add_events([RevocationEvent(step=st, slot=sl, kind=k, server_kind=sk)
                   for k, st, sl, sk in events])
    jstate = jrt.run(jstate, 7)
    state = rt.run(state, 7)
    assert len(rt.metrics_log) == len(jrt.metrics_log) == 7
    for got, want in zip(rt.metrics_log, jrt.metrics_log):
        assert set(got) == set(want)
        assert (got["step"], got["active"]) == (want["step"], want["active"])
        assert rel(got["loss"], want["loss"]) < 1e-5, got["step"]
        assert rel(got["lr"], want["lr"]) < 1e-5, got["step"]
    assert [r["active"] for r in rt.metrics_log] == [1, 2, 3, 3, 2, 3, 2]
    assert rt.fast_saves == jrt.fast_saves == 2
    assert [r["step"] for r in rt.fast_save_log] == [3, 5]
    assert [r["slot"] for r in rt.fast_save_log] == [0, 1]
    assert len(rt.step_seconds) == 7
    assert ck.latest_step() == jck.latest_step() == 5
    # seven AdamW steps at LR scales up to 3: where a gradient is ~1e-8,
    # float32 noise moves m / (sqrt(v) + eps) by percents (see
    # test_torch_train.py), so a weight may differ by up to 1e-4
    # (observed: 4.1e-5, one entry of embed/tok, hetero mode)
    assert state.step == int(jstate.step) == 7
    assert_tree_close(state.params, jstate.params, 1e-5, 1e-4)
    if mode == "hetero":
        np.testing.assert_array_equal(alloc.allocation().counts,
                                      jalloc.allocation().counts)
        assert alloc.solve_count == jalloc.solve_count


def test_no_workers_raises_and_recorder_is_not_ported(pair):
    _, model, _ = pair
    _, tc = tcfgs()
    _, ds = datasets(pair)
    c = SparseCluster(2)
    c.fill_and_activate(0, 0)
    rt = ElasticRuntime(model, tc, ds, c)
    rt.add_events([RevocationEvent(step=1, slot=0, kind="revoke")])
    with pytest.raises(RuntimeError, match="no active workers"):
        rt.run(TS.init_state(model, tc), 3)
    with pytest.raises(NotImplementedError, match="Queue 1 item 4"):
        ElasticRuntime(model, tc, ds, c, recorder=object())


def test_remesh_cache_builds_once_per_size():
    built = []
    cache = E.RemeshCache(build=lambda n: built.append(n) or (lambda: n))
    for n in (4, 3, 4, 2, 3, 4):
        assert cache.step_for(n)() == n
    assert built == [4, 3, 2] and cache.compile_count == 3


def test_restart_equivalence(pair, tmp_path):
    """Checkpoint + restore replays to an identical final state (C3):
    the deterministic pipeline + step-in-payload make restarts lossless.
    Each run starts from its own ``init_state``: the optimizers update
    the masters in place."""
    _, model, _ = pair
    _, tcfg = tcfgs(checkpoint_every=3)
    _, ds = datasets(pair)

    def fresh():
        return TS.init_state(model, tcfg, model.generator(1))

    def cluster():
        c = SparseCluster(2)
        c.fill_and_activate(0, 0)
        c.fill_and_activate(1, 0)
        return c

    ref = ElasticRuntime(model, tcfg, ds, cluster()).run(fresh(), 6)

    # interrupted run: 4 steps (ckpt lands at step 3), "crash", restore
    ck = CheckpointManager(str(tmp_path))
    c2 = cluster()
    ElasticRuntime(model, tcfg, ds, c2, ck).run(fresh(), 4)
    step, restored, _ = ck.restore_latest("cpu")
    assert step == 3 and restored.step == 3
    final = ElasticRuntime(model, tcfg, ds, c2).run(restored, 3, start_step=3)
    assert final.step == ref.step == 6
    diffs = [float((a - b).abs().max()) for (_, a), (_, b) in zip(
        tree_leaves(ref.params), tree_leaves(final.params))]
    assert max(diffs) < 1e-5


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

CLI = {
    "schedule": ["--slots", "4", "--initial-workers", "1", "--join-every",
                 "2", "--revoke-at", "5"],
    "monte-carlo": ["--slots", "2", "--initial-workers", "2",
                    "--monte-carlo", "--server-kind", "V100",
                    "--steps-per-sec", "1e-3"],
}


@pytest.mark.parametrize("arch,trace", [
    ("starcoder2-3b", "schedule"), ("starcoder2-3b", "monte-carlo"),
    ("resnet32-cifar10", "schedule")])
def test_launch_train_elastic_matches_the_reference(arch, trace, tmp_path,
                                                    monkeypatch, capsys):
    """``launch.train --elastic`` in both packages with the same flags and
    seed, in float32, the port from the reference's initial weights: the
    same per-step losses, LRs and active counts, and the same fast
    saves."""
    flags = ["--arch", arch, "--elastic", "--steps", "8", "--global-batch",
             "8", "--seq-len", "16", "--seed", "3", *CLI[trace]]
    monkeypatch.setattr(jlaunch, "get_config", lambda a, reduced: JC.get_config(
        a, reduced=reduced).replace(dtype="float32", attn_impl="xla"))
    monkeypatch.setattr(launch, "get_config", lambda a, reduced: C.get_config(
        a, reduced=reduced).replace(dtype="float32"))
    got = {}

    class Runtime(JE.ElasticRuntime):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            got["rt"] = self

    def jinit(*a, **kw):
        st = JTS.init_state(*a, **kw)
        got["params"] = jax.tree.map(np.asarray, st.params)
        return st

    monkeypatch.setattr(jlaunch, "ElasticRuntime", Runtime)
    monkeypatch.setattr(jlaunch, "init_state", jinit)
    monkeypatch.setattr(sys, "argv", ["train", *flags, "--ckpt-dir",
                                      str(tmp_path / "jax")])
    jlaunch.main()
    want = got["rt"].metrics_log
    monkeypatch.setattr(launch, "init_state", lambda model, tcfg: TS.init_state(
        model, tcfg, params=params_from_numpy(got["params"], model.cfg, "cpu",
                                              dtype=torch.float32)))
    capsys.readouterr()
    out = launch.main(["--device", "cpu", *flags, "--ckpt-dir",
                       str(tmp_path / "torch")])
    assert '"fast_saves"' in capsys.readouterr().out
    assert {"arch", "steps", "wall_s", "loss_first", "loss_last", "elastic",
            "final_step"} <= set(out)
    assert out["elastic"] is True and out["final_step"] == 8
    assert out["active"] == [r["active"] for r in want]
    assert len(out["losses"]) == len(out["grad_norms"]) == 8
    for i, r in enumerate(want):
        assert rel(out["losses"][i], r["loss"]) < 1e-4, i
        assert rel(out["lr"][i], r["lr"]) < 1e-4, i
    assert all(math.isfinite(x) for x in out["grad_norms"])
    assert out["fast_saves"] == got["rt"].fast_saves >= 1
    assert len(out["fast_save_s"]) == len(out["fast_save_bytes"]) == \
        out["fast_saves"]
    if trace == "schedule":
        assert out["active"] == [1, 1, 2, 2, 3, 2, 3, 3]


def test_launch_train_static_checkpoints_and_resumes(tmp_path):
    """``--ckpt-dir`` on the static path: periodic saves, and a second
    run restores the newest and trains on from it."""
    flags = ["--device", "cpu", "--global-batch", "4", "--seq-len", "16",
             "--ckpt-dir", str(tmp_path), "--checkpoint-every", "2"]
    out = launch.main([*flags, "--steps", "4"])
    assert out["final_step"] == 4
    ck = CheckpointManager(str(tmp_path))
    assert ck.latest_step() == 4
    again = launch.main([*flags, "--steps", "2"])
    assert again["final_step"] == 6 and ck.latest_step() == 6
    with pytest.raises(NotImplementedError, match="Queue 1 item 2e"):
        launch.main(["--device", "cpu", "--gym"])
