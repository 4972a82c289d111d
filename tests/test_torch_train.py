"""The port's training path against the JAX package's, on the CPU in
float32: data, schedules, optimizers, loss, three training steps, the
Trainer loop, evaluation and the training CLI.

Both packages start from one state: the reference's initial weights
(with seeded nonzero biases and gammas) bridged into the port as float32
masters, zero optimizer moments, and the same numpy token batches. The
port trains through its plain attention (``attn_impl="torch"``), the
reference through ``"xla"``: neither flash kernel has a gradient.

Tolerances (float32; the two differ in summation order and in where
rounding falls, nothing else):
- data: bit-equal;
- schedules: 1e-6 relative (the reference computes in float32, the port
  in float64);
- one optimizer update: 1e-6 relative + 1e-7 absolute;
- cross-entropy: 1e-6 relative;
- three training steps: loss and ``lr`` 1e-5 relative, ``grad_norm``
  1e-4 relative; the moments 1e-5 relative + 1e-7 (``m``) or 1e-9
  (``v``) absolute, which pins every gradient; every parameter 1e-5
  relative + 3e-5 absolute. The three steps move a weight by up to
  ~1e-3 in all (lr 1e-3 under warmup and a 0.5 worker scale), by
  m / (sqrt(v) + eps) a step: where a gradient is ~1e-8, float32
  cancellation noise in it changes that ratio by a few percent, so such
  a weight may differ by a few percent of its movement (observed: at
  most 1.3e-5, one entry in 32768, embedding and MLP leaves).
"""
import dataclasses
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.builder import build_model as jax_build  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro.optim import schedules as JS  # noqa: E402
from repro.train import step as JTS  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch import config as C  # noqa: E402
from repro_torch.bridge import opt_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.optim import optimizers as O  # noqa: E402
from repro_torch.optim import schedules as S  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

B, SEQ = 4, 16


def randomise_zero_inits(tree, rng):
    """Give biases and gammas (and the recurrent families' zero- or
    one-initialised leaves) seeded nonzero values, in place."""
    for key, val in tree.items():
        if isinstance(val, dict):
            randomise_zero_inits(val, rng)
        elif key in ("gamma", "bq", "bk", "bv", "norm", "ln_x", "conv_b",
                     "A_log", "dt_bias", "D", "w0"):
            tree[key] = (val + rng.normal(0.0, 0.2, val.shape)).astype(
                np.float32)
    return tree


def models(arch):
    jcfg = JC.get_config(arch, reduced=True).replace(dtype="float32",
                                                     attn_impl="xla")
    cfg = C.get_config(arch, reduced=True).replace(
        dtype="float32", attn_impl="torch", ssm_impl="torch",
        rwkv_impl="torch")
    jm = jax_build(jcfg)
    tree = jax.tree.map(np.asarray, JL.unbox(jm.init(jax.random.key(0))))
    return jm, build_model(cfg, "cpu"), randomise_zero_inits(
        tree, np.random.default_rng(0))


def tcfgs(microbatches=1, optimizer="adamw"):
    kw = dict(microbatches=microbatches, remat="full")
    opt = dict(name=optimizer, lr=1e-3, weight_decay=1e-4, grad_clip=1.0)
    sched = dict(kind="cosine", warmup_steps=2, total_steps=10)
    return (JC.TrainConfig(optimizer=JC.OptimizerConfig(**opt),
                           schedule=JC.ScheduleConfig(**sched), **kw),
            C.TrainConfig(optimizer=C.OptimizerConfig(**opt),
                          schedule=C.ScheduleConfig(**sched), **kw))


def assert_tree_close(got, want, rtol, atol):
    want = dict(tree_leaves(jax.tree.map(np.asarray, want)))
    got = dict(tree_leaves(got))
    assert got.keys() == want.keys()
    for path, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), want[path], rtol=rtol,
                                   atol=atol, err_msg=path)


def rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-27b"])
def test_batches_are_bit_equal_to_the_reference(arch):
    jcfg, cfg = JC.get_config(arch, True), C.get_config(arch, True)
    got = D.make_batch(cfg, 3, 24, seed=7, step=11, device="cpu")
    want = JD.make_batch(jcfg, 3, 24, seed=7, step=11)
    assert D.lm_batch_keys(cfg) == JD.lm_batch_keys(jcfg) == tuple(got)
    jds = JD.ShardedDataset(jcfg, global_batch=8, seq_len=12, seed=5)
    ds = D.ShardedDataset(cfg, global_batch=8, seq_len=12, seed=5,
                          device="cpu")
    pairs = [(got, want), (ds.global_batch_at(3), jds.global_batch_at(3)),
             (ds.shard_batch(3, 1, 4), jds.shard_batch(3, 1, 4))]
    for g, w in pairs:
        for key in ("tokens", "labels"):
            assert g[key].dtype == torch.int64
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
    with pytest.raises(ValueError):
        ds.shard_batch(0, 0, 3)


def test_unported_batch_families_raise():
    """The resnet batches are ported (tests/test_torch_resnet.py); the
    multimodal and encoder-decoder ones are not."""
    for family in ("vlm", "encdec"):
        cfg = C.get_config("starcoder2-3b", True).replace(family=family)
        with pytest.raises(NotImplementedError, match="Queue 1 item 6"):
            D.make_batch(cfg, 2, 8, device="cpu")


# ---------------------------------------------------------------------------
# schedules and optimizers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["constant", "cosine", "step"])
def test_schedule_values(kind):
    kw = dict(kind=kind, warmup_steps=20, total_steps=200,
              step_boundaries=(50, 120), step_factors=(0.1, 0.01))
    got = S.make_schedule(C.ScheduleConfig(**kw))
    want = JS.make_schedule(JC.ScheduleConfig(**kw))
    for step in (0, 1, 10, 19, 20, 21, 49, 50, 51, 119, 120, 199, 250):
        assert math.isclose(got(step), float(want(step)), rel_tol=1e-6,
                            abs_tol=1e-9), step
    for active, adaptive in ((3, True), (3, False)):
        assert S.adaptive_lr_scale(active, 2, adaptive, 8) == float(
            JS.adaptive_lr_scale(active, 2, adaptive, 8))


def _random_tree(rng):
    return {"a": rng.normal(size=(3, 40)).astype(np.float32),
            "b": {"c": rng.normal(size=(17,)).astype(np.float32),
                  "d": rng.normal(size=(2, 5, 7)).astype(np.float32)}}


@pytest.mark.parametrize("chunk", [O.CHUNK, 7])
@pytest.mark.parametrize("name", ["adamw", "momentum", "nesterov"])
def test_one_optimizer_update(name, chunk, monkeypatch):
    """One update from a nonzero state on a random tree; ``chunk=7``
    splits every leaf into several in-place chunks."""
    monkeypatch.setattr(O, "CHUNK", chunk)
    rng = np.random.default_rng(4)
    params, grads = _random_tree(rng), _random_tree(rng)
    if name == "adamw":
        jopt, opt = JO.adamw(weight_decay=0.1), O.adamw(weight_decay=0.1)
        state = {"m": _random_tree(rng),
                 "v": jax.tree.map(np.abs, _random_tree(rng)), "count": 3}
    else:
        nest = name == "nesterov"
        jopt = JO.sgd_momentum(0.9, 0.1, nesterov=nest)
        opt = O.sgd_momentum(0.9, 0.1, nesterov=nest)
        state = {"mu": _random_tree(rng)}
    lr = 0.01
    jstate = jax.tree.map(jnp.asarray, state)
    upd, jnew = jopt.update(jax.tree.map(jnp.asarray, grads), jstate,
                            jax.tree.map(jnp.asarray, params), lr)
    want_p = jax.tree.map(lambda p, u: p + u, params, upd)

    t = lambda tree: jax.tree.map(torch.tensor, tree)  # noqa: E731
    tp, tstate = t(params), dict(state)
    for key in ("m", "v", "mu"):
        if key in tstate:
            tstate[key] = t(state[key])
    new = opt.update(t(grads), tstate, tp, lr)
    assert_tree_close(tp, want_p, 1e-6, 1e-7)
    for key in ("m", "v", "mu"):
        if key in new:
            assert_tree_close(new[key], jnew[key], 1e-6, 1e-7)
    if name == "adamw":
        assert new["count"] == int(jnew["count"]) == 4


def test_global_norm_and_clip():
    rng = np.random.default_rng(5)
    grads = _random_tree(rng)
    want, jnorm = JO.clip_by_global_norm(jax.tree.map(jnp.asarray, grads),
                                         2.0)
    got, norm = O.clip_by_global_norm(jax.tree.map(torch.tensor, grads),
                                      2.0)
    assert rel(norm, jnorm) < 1e-6
    assert_tree_close(got, want, 1e-6, 1e-8)
    assert rel(O.global_norm(got), 2.0) < 1e-5


def test_make_optimizer():
    assert O.make_optimizer(C.OptimizerConfig(name="adamw")).init(
        {"w": torch.zeros(2)})["count"] == 0
    with pytest.raises(ValueError):
        O.make_optimizer(C.OptimizerConfig(name="lion"))


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------

def test_cross_entropy_with_and_without_weights():
    rng = np.random.default_rng(6)
    logits = rng.normal(0, 3, size=(3, 5, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=(3, 5))
    w = (rng.random((1, 5)) > 0.4).astype(np.float32)
    for weights in (None, w, np.zeros_like(w)):
        got = TS.cross_entropy(torch.tensor(logits), torch.tensor(labels),
                               None if weights is None
                               else torch.tensor(weights))
        want = JTS.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if weights is None
                                 else jnp.asarray(weights))
        assert math.isclose(float(got), float(want), rel_tol=1e-6,
                            abs_tol=1e-7)


# ---------------------------------------------------------------------------
# the training step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch,microbatches", [
    ("starcoder2-3b", 1), ("qwen2.5-14b", 1), ("gemma3-27b", 1),
    ("starcoder2-3b", 2), ("rwkv6-7b", 1)])
def test_three_train_steps_match_the_reference(arch, microbatches):
    jm, model, tree = models(arch)
    jt, tc = tcfgs(microbatches)
    jstate = JTS.init_state(jm, jt, jax.random.key(0),
                            jax.tree.map(jnp.asarray, tree))
    jstep = jax.jit(JTS.make_train_step(jm, jt))
    state = TS.init_state(model, tc, params=params_from_numpy(
        tree, model.cfg, "cpu", dtype=torch.float32))
    step = TS.make_train_step(model, tc)
    jds = JD.ShardedDataset(jm.cfg, global_batch=B, seq_len=SEQ, seed=1)
    ds = D.ShardedDataset(model.cfg, global_batch=B, seq_len=SEQ, seed=1,
                          device="cpu")
    for i in range(3):
        jstate, jm_ = jstep(jstate, jds.global_batch_at(i), jnp.float32(0.5))
        state, m = step(state, ds.global_batch_at(i), 0.5)
        assert rel(m["loss"], jm_["loss"]) < 1e-5, (i, "loss")
        assert rel(m["grad_norm"], jm_["grad_norm"]) < 1e-4, (i, "grad_norm")
        assert rel(m["lr"], jm_["lr"]) < 1e-5, (i, "lr")
        assert float(m["aux"]) == float(jm_["aux"]) == 0
    assert state.step == int(jstate.step) == 3
    assert_tree_close(state.params, jstate.params, 1e-5, 3e-5)
    assert_tree_close(state.opt["m"], jstate.opt["m"], 1e-5, 1e-7)
    assert_tree_close(state.opt["v"], jstate.opt["v"], 1e-5, 1e-9)
    assert state.opt["count"] == int(jstate.opt["count"])
    for _, p in tree_leaves(state.params):
        assert p.dtype == torch.float32 and not p.requires_grad


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_three_recurrent_train_steps_match_the_reference(arch):
    """Three SGD-momentum steps of the recurrent families through the
    plain paths (the chunked SSD form, the sequential WKV scan). The
    momentum update is linear in the gradient, so ``mu`` pins every
    gradient of every step. Tolerances: loss, ``grad_norm`` and ``lr`` as
    above; parameters 1e-5 relative + 1e-7 absolute; ``mu`` within 3e-5 x
    the leaf's largest |mu|: the gradients of these models carry float32
    noise of up to ~1e-5 of a leaf's largest gradient in both packages
    (``test_recurrent_gradients_float32_noise``). With AdamW, an early
    gradient near zero makes m / (sqrt(v) + eps) amplify that noise, and
    zamba2's parameters then miss the AdamW test's 3e-5 + 1e-5 x |p| on
    single entries while ``m`` and ``v`` agree; rwkv6-7b passes the AdamW
    test and is one of its cases."""
    jm, model, tree = models(arch)
    jt, tc = tcfgs(optimizer="momentum")
    jstate = JTS.init_state(jm, jt, jax.random.key(0),
                            jax.tree.map(jnp.asarray, tree))
    jstep = jax.jit(JTS.make_train_step(jm, jt))
    state = TS.init_state(model, tc, params=params_from_numpy(
        tree, model.cfg, "cpu", dtype=torch.float32))
    step = TS.make_train_step(model, tc)
    jds = JD.ShardedDataset(jm.cfg, global_batch=B, seq_len=SEQ, seed=1)
    ds = D.ShardedDataset(model.cfg, global_batch=B, seq_len=SEQ, seed=1,
                          device="cpu")
    for i in range(3):
        jstate, jm_ = jstep(jstate, jds.global_batch_at(i), jnp.float32(0.5))
        state, m = step(state, ds.global_batch_at(i), 0.5)
        assert rel(m["loss"], jm_["loss"]) < 1e-5, (i, "loss")
        assert rel(m["grad_norm"], jm_["grad_norm"]) < 1e-4, (i, "grad_norm")
        assert rel(m["lr"], jm_["lr"]) < 1e-5, (i, "lr")
    assert state.step == int(jstate.step) == 3
    assert_tree_close(state.params, jstate.params, 1e-5, 1e-7)
    want = dict(tree_leaves(jax.tree.map(np.asarray, jstate.opt["mu"])))
    for path, t in tree_leaves(state.opt["mu"]):
        err = np.abs(t.numpy() - want[path]).max()
        assert err <= 3e-5 * np.abs(want[path]).max(), (path, err)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_recurrent_gradients_float32_noise(arch, monkeypatch):
    """The float32 gradients of one batch, in both packages, against the
    port's float64 gradients of the same loss: each leaf within 3e-5 of
    its largest float64 gradient (observed: at most 6.4e-6 in the port and
    6.0e-6 in the reference), the noise floor the momentum test's ``mu``
    tolerance rests on."""
    from repro_torch.models import layers as TL
    from repro_torch.tree import tree_map
    monkeypatch.setitem(TL.DTYPES, "float64", torch.float64)
    jm, model, tree = models(arch)
    jbatch = JD.make_batch(jm.cfg, B, SEQ, seed=1)
    batch = D.make_batch(model.cfg, B, SEQ, seed=1, device="cpu")
    jgrads = jax.grad(lambda p: JTS.cross_entropy(
        jm.apply(p, jbatch)[0], jbatch["labels"]))(
            jax.tree.map(jnp.asarray, tree))

    def grads(dtype):
        m = build_model(model.cfg.replace(dtype=str(dtype).split(".")[-1]),
                        "cpu")
        p = tree_map(lambda a: torch.tensor(np.asarray(a, np.float64)).to(
            dtype).requires_grad_(), tree)
        loss = TS.cross_entropy(m.apply(p, batch, remat=False)[0],
                                batch["labels"])
        g = torch.autograd.grad(loss, [t for _, t in tree_leaves(p)])
        return {k: t.double().numpy()
                for (k, _), t in zip(tree_leaves(p), g)}

    g64, g32 = grads(torch.float64), grads(torch.float32)
    ref = dict(tree_leaves(jax.tree.map(np.asarray, jgrads)))
    for path, want in g64.items():
        scale = np.abs(want).max()
        assert np.abs(g32[path] - want).max() <= 3e-5 * scale, path
        assert np.abs(ref[path] - want).max() <= 3e-5 * scale, path


def test_momentum_step_from_a_bridged_state():
    """SGD-momentum from a nonzero momentum handed over by the bridge."""
    jm, model, tree = models("granite-20b")
    jt, tc = tcfgs(optimizer="momentum")
    rng = np.random.default_rng(9)
    mu = jax.tree.map(lambda x: rng.normal(0, 0.01, x.shape).astype(
        np.float32), tree)
    jstate = JTS.TrainState(params=jax.tree.map(jnp.asarray, tree),
                            opt={"mu": jax.tree.map(jnp.asarray, mu)},
                            step=jnp.int32(4))
    state = TS.TrainState(
        params=params_from_numpy(tree, model.cfg, "cpu", dtype=torch.float32),
        opt=opt_state_from_numpy({"mu": mu}, model.cfg, "cpu"), step=4)
    batch_j = JD.make_batch(jm.cfg, B, SEQ, seed=2)
    batch = D.make_batch(model.cfg, B, SEQ, seed=2, device="cpu")
    jstate, jm_ = jax.jit(JTS.make_train_step(jm, jt))(jstate, batch_j)
    state, m = TS.make_train_step(model, tc)(state, batch)
    assert rel(m["loss"], jm_["loss"]) < 1e-5
    assert_tree_close(state.params, jstate.params, 1e-5, 1e-7)
    assert_tree_close(state.opt["mu"], jstate.opt["mu"], 1e-5, 1e-7)


def test_bridge_loads_adamw_state():
    _, model, tree = models("starcoder2-3b")
    zeros = jax.tree.map(np.zeros_like, tree)
    st = opt_state_from_numpy({"m": zeros, "v": zeros,
                               "count": np.int32(7)}, model.cfg, "cpu")
    assert st["count"] == 7
    assert [p for p, _ in tree_leaves(st["m"])] == \
        [p for p, _ in tree_leaves(model.init(model.generator(0)))]
    with pytest.raises(ValueError):
        opt_state_from_numpy({"nu": zeros}, model.cfg, "cpu")


def test_unported_step_options_raise():
    _, model, _ = models("starcoder2-3b")
    _, tc = tcfgs()
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        TS.make_train_step(model, tc, param_shardings={})
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        TS.make_train_step(model, dataclasses.replace(
            tc, grad_dtype="bfloat16"))


def test_init_state_holds_float32_masters():
    cfg = C.get_config("starcoder2-3b", reduced=True)      # bf16 compute
    model = build_model(cfg, "cpu")
    state = TS.init_state(model, tcfgs()[1])
    assert state.params["layers"]["attn"]["wq"].dtype == torch.float32
    served = model.init(model.generator(0))
    assert served["layers"]["attn"]["wq"].dtype == torch.bfloat16
    # the same float32 draws, stored before and after the cast
    assert torch.equal(state.params["layers"]["attn"]["wq"].bfloat16(),
                       served["layers"]["attn"]["wq"])


# ---------------------------------------------------------------------------
# Trainer, evaluation, CLI
# ---------------------------------------------------------------------------

def test_trainer_fit_and_evaluate_accuracy():
    jm, model, tree = models("gemma3-27b")
    jt, tc = tcfgs()
    jds = JD.ShardedDataset(jm.cfg, global_batch=B, seq_len=SEQ, seed=3)
    ds = D.ShardedDataset(model.cfg, global_batch=B, seq_len=SEQ, seed=3,
                          device="cpu")
    jtr = JTR.Trainer(jm, jt, jds, log_every=2)
    tr = TR.Trainer(model, tc, ds, log_every=2)
    jstate = jtr.fit(JTS.init_state(jm, jt, jax.random.key(0),
                                    jax.tree.map(jnp.asarray, tree)), 5)
    state = tr.fit(TS.init_state(model, tc, params=params_from_numpy(
        tree, model.cfg, "cpu", dtype=torch.float32)), 5)
    assert [r["step"] for r in tr.metrics_log] == \
        [r["step"] for r in jtr.metrics_log] == [0, 1, 3]
    for got, want in zip(tr.metrics_log, jtr.metrics_log):
        assert set(got) == set(want)
        for key in ("loss", "lr"):
            assert rel(got[key], want[key]) < 1e-5, key
        assert rel(got["grad_norm"], want["grad_norm"]) < 1e-4
    # next-token accuracy of the trained weights on a held-out batch: the
    # logits agree to ~1e-5, so at most one argmax near a tie may differ
    jb = JD.make_batch(jm.cfg, B, SEQ, seed=99)
    tb = D.make_batch(model.cfg, B, SEQ, seed=99, device="cpu")
    want = JTR.evaluate_accuracy(jm, jstate.params, jb)
    got = TR.evaluate_accuracy(model, state.params, tb)
    assert abs(got - want) <= 1 / (B * SEQ) + 1e-9
    assert 0.0 <= got <= 1.0


def test_trainer_refuses_checkpointing():
    """Checkpointing is ported (tests/test_torch_checkpoint.py): the
    Trainer refuses a ``ckpt`` that is not a ``CheckpointManager``. Its
    ``obs`` recorder is ported (tests/test_torch_gym.py): ``None`` means
    ``obs.NULL``."""
    _, model, _ = models("starcoder2-3b")
    ds = D.ShardedDataset(model.cfg, global_batch=B, seq_len=SEQ,
                          device="cpu")
    with pytest.raises(TypeError, match="CheckpointManager"):
        TR.Trainer(model, tcfgs()[1], ds, ckpt=object())
    from repro_torch import obs
    assert TR.Trainer(model, tcfgs()[1], ds).rec is obs.NULL
    rec = obs.Recorder()
    assert TR.Trainer(model, tcfgs()[1], ds, recorder=rec).rec is rec


def test_launch_train_cli_on_cpu(capsys, tmp_path):
    out = launch_train.main(["--device", "cpu", "--steps", "3",
                             "--global-batch", "4", "--seq-len", "16"])
    assert {"arch", "steps", "wall_s", "loss_first", "loss_last", "elastic",
            "final_step"} <= set(out)
    assert out["final_step"] == 3 and out["device"] == "cpu"
    assert out["attn_impl"] == "torch"
    assert len(out["losses"]) == len(out["grad_norms"]) == 3
    assert all(math.isfinite(x) for x in out["losses"] + out["grad_norms"])
    # random weights: the first loss is near ln(V) = ln(512)
    assert abs(out["loss_first"] - math.log(512)) < 1.0
    assert '"final_step": 3' in capsys.readouterr().out
    # --elastic, --ckpt-dir (tests/test_torch_elastic.py) and --gym
    # (tests/test_torch_gym.py) are ported, and so are the obs flags:
    # --profile writes the profiler trace, the event log and the timeline
    prof = str(tmp_path / "prof")
    out = launch_train.main(["--device", "cpu", "--steps", "1", "--profile",
                             prof, "--global-batch", "4", "--seq-len", "16"])
    assert out["profile_dir"] == prof and out["final_step"] == 1
    for key in ("device_trace", "events", "timeline"):
        assert os.path.getsize(out[key]) > 0 and out[key].startswith(prof)
