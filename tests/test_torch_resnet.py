"""The port's ResNet-(6n+2) against the JAX package's, on the CPU in
float32: the parameter layout (lists in the tree, HWIO -> OIHW in the
bridge), XLA's "SAME" padding, GroupNorm, the logits and gradients of
ResNet-8 (reduced) and of ResNet-32 at its published size (its stride-2
stages on 32x32 images), the static training step, evaluation, and the
CIFAR batches.

Both packages run the reference's initial weights (GroupNorm scales and
shifts given seeded values), handed to the port as numpy arrays.
Tolerances (float32; the packages differ in summation order only):
logits 1e-5 relative + 1e-5 x max|logit| absolute; gradients 1e-4
relative + 1e-5 x the leaf's largest |gradient| absolute; three momentum
steps: loss 1e-5 relative, parameters 1e-5 relative + 1e-6 x the leaf's
largest |value| absolute, momentum 1e-4 + 1e-5 x its largest; batches
bit-equal.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import resnet as JR  # noqa: E402
from repro.models.builder import build_model as jax_build  # noqa: E402
from repro.train import step as JTS  # noqa: E402
from repro.train import trainer as JTR  # noqa: E402
from repro_torch import config as C  # noqa: E402
from repro_torch.bridge import opt_state_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.models import resnet as R  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.train import trainer as TR  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCH = "resnet32-cifar10"


def models(reduced):
    jcfg = JC.get_config(ARCH, reduced=reduced).replace(dtype="float32")
    cfg = C.get_config(ARCH, reduced=reduced).replace(dtype="float32")
    jm = jax_build(jcfg)
    tree = jax.tree.map(np.asarray, JL.unbox(jm.init(jax.random.key(0))))
    rng = np.random.default_rng(0)
    tree = jax.tree.map(lambda a: (a + rng.normal(0, 0.2, a.shape)).astype(
        np.float32) if a.ndim == 1 else a, tree)          # GN, fc_b
    return jm, build_model(cfg, "cpu"), tree


def to_reference_layout(path, a):
    """The port's OIHW conv leaves back in the reference's HWIO."""
    return np.transpose(a, (2, 3, 1, 0)) if a.ndim == 4 else a


def close_trees(got, want, rtol, frac, msg=""):
    want = dict(tree_leaves(jax.tree.map(np.asarray, want)))
    got = dict(tree_leaves(got))
    assert got.keys() == want.keys()
    for path, t in got.items():
        w = want[path]
        np.testing.assert_allclose(
            to_reference_layout(path, t.detach().numpy()), w, rtol=rtol,
            atol=frac * float(np.abs(w).max()), err_msg=f"{msg}{path}")


# ---------------------------------------------------------------------------
# layout, padding, GroupNorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [True, False])
def test_parameter_layout(reduced):
    """The reference's paths (lists of lists of blocks) with conv leaves
    transposed HWIO -> OIHW; the bridge refuses a wrong shape."""
    jm, model, tree = models(reduced)
    want = {p: v.shape for p, v in tree_leaves(tree)}
    got = {p: tuple(t.shape) for p, t in tree_leaves(
        model.init(model.generator(0)))}
    assert got.keys() == want.keys()
    assert "stages/1/0/proj" in got and "stages/2/0/conv1" in got
    for p, shape in got.items():
        w = want[p]
        assert shape == (tuple(w[i] for i in (3, 2, 0, 1))
                         if len(w) == 4 else tuple(w)), p
    params = params_from_numpy(tree, model.cfg, "cpu")
    np.testing.assert_array_equal(
        params["stages"][1][0]["conv1"].numpy(),
        np.transpose(tree["stages"][1][0]["conv1"], (3, 2, 0, 1)))
    assert params["stages"][1][0]["conv1"].is_contiguous()
    bad = jax.tree.map(lambda a: a, tree)
    bad["stages"][0][0]["conv1"] = bad["stages"][0][0]["conv1"][:, :, :1]
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(bad, model.cfg, "cpu")


def test_init_statistics():
    """Port-drawn weights follow the reference's scales: He init for 3x3
    convs, 1.0 for the 1x1 projections (the reference's fan-in rule on a
    (1, 1, cin, cout) leaf), 1/sqrt(64) for the head; GN ones and zeros."""
    cfg = C.get_config(ARCH)
    model = build_model(cfg, "cpu")
    p = model.init(model.generator(0), dtype=torch.float32)
    w = p["stages"][2][1]["conv2"]
    assert abs(w.std().item() / (2.0 / (9 * 64)) ** 0.5 - 1) < 0.05
    assert abs(p["stages"][2][0]["proj"].std().item() - 1) < 0.1
    assert abs(p["fc_w"].std().item() * 8 - 1) < 0.15
    assert torch.all(p["stem_gn"]["gamma"] == 1)
    assert torch.all(p["stem_gn"]["beta"] == 0) and torch.all(p["fc_b"] == 0)
    n = sum(t.numel() for _, t in tree_leaves(p))
    jn = sum(np.prod(b.value.shape) for b in jax.tree.leaves(
        jax_build(JC.get_config(ARCH)).abstract_params(),
        is_leaf=JL.is_boxed))
    assert n == jn


@pytest.mark.parametrize("size,k,stride", [
    (32, 3, 2), (16, 3, 2), (7, 3, 2), (9, 3, 1), (8, 1, 2), (7, 1, 2)])
def test_conv_same_padding_matches_xla(size, k, stride):
    """XLA pads (0, 1) at stride 2 on an even map; the port works the
    padding out per layer."""
    rng = np.random.default_rng(size + k + stride)
    x = rng.normal(size=(2, size, size, 5)).astype(np.float32)
    w = rng.normal(size=(k, k, 5, 6)).astype(np.float32)
    want = np.asarray(JR.conv2d(jnp.asarray(x), jnp.asarray(w), stride))
    got = R.conv2d(torch.tensor(x).permute(0, 3, 1, 2),
                   torch.tensor(w).permute(3, 2, 0, 1), stride)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


def test_identity_shortcut_matches_the_reference():
    """The reference's stride-2 identity (a 1x1 conv with ``eye``)."""
    x = np.random.default_rng(1).normal(size=(2, 7, 8, 4)).astype(np.float32)
    want = np.asarray(JR.conv2d(jnp.asarray(x), jnp.eye(4)[None, None], 2))
    got = torch.tensor(x).permute(0, 3, 1, 2)[:, :, ::2, ::2]
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


@pytest.mark.parametrize("channels", [16, 64, 12, 6])
def test_group_norm_matches_the_reference(channels):
    """Group c // (C // g), population variance, eps 1e-5, and the
    decrement loop when C is not a multiple of 8 (12 -> 6 groups)."""
    rng = np.random.default_rng(channels)
    x = (rng.normal(size=(3, 5, 4, channels)) * 3 + 1).astype(np.float32)
    g = rng.normal(size=(channels,)).astype(np.float32)
    b = rng.normal(size=(channels,)).astype(np.float32)
    want = np.asarray(JR.group_norm(jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(b)))
    got = R.group_norm(torch.tensor(x).permute(0, 3, 1, 2), torch.tensor(g),
                       torch.tensor(b))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# forward and gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reduced", [True, False], ids=["resnet8", "resnet32"])
def test_logits_and_gradients_match_the_reference(reduced):
    jm, model, tree = models(reduced)
    jbatch = JD.make_batch(jm.cfg, 3, 0, seed=4)
    batch = D.make_batch(model.cfg, 3, 0, seed=4, device="cpu")
    jp = jax.tree.map(jnp.asarray, tree)
    params = params_from_numpy(tree, model.cfg, "cpu", dtype=torch.float32)
    want, _ = jm.apply(jp, jbatch)
    got, aux = model.apply(params, batch)
    want = np.asarray(want)
    assert got.shape == (3, 10) and float(aux) == 0.0
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())

    jgrads = jax.grad(lambda p: JTS.cross_entropy(
        jm.apply(p, jbatch)[0], jbatch["labels"]))(jp)
    grads, _ = TS.value_and_grad(lambda p: (TS.cross_entropy(
        model.apply(p, batch)[0], batch["labels"]), {}), params)
    close_trees(grads, jgrads, 1e-4, 1e-5, "grad ")


def test_three_momentum_steps_match_the_reference():
    """The static training step (``loss_fn``'s per-image cross-entropy),
    SGD with momentum as in the paper, from a nonzero momentum."""
    jm, model, tree = models(True)
    kw = dict(remat="none")
    opt = dict(name="momentum", lr=0.05, weight_decay=1e-4, grad_clip=1.0)
    sched = dict(kind="cosine", warmup_steps=2, total_steps=10)
    jt = JC.TrainConfig(optimizer=JC.OptimizerConfig(**opt),
                        schedule=JC.ScheduleConfig(**sched), **kw)
    tc = C.TrainConfig(optimizer=C.OptimizerConfig(**opt),
                       schedule=C.ScheduleConfig(**sched), **kw)
    rng = np.random.default_rng(2)
    mu = jax.tree.map(lambda a: rng.normal(0, 0.01, a.shape).astype(
        np.float32), tree)
    jstate = JTS.TrainState(params=jax.tree.map(jnp.asarray, tree),
                            opt={"mu": jax.tree.map(jnp.asarray, mu)},
                            step=jnp.int32(0))
    state = TS.TrainState(
        params=params_from_numpy(tree, model.cfg, "cpu", dtype=torch.float32),
        opt=opt_state_from_numpy({"mu": mu}, model.cfg, "cpu"), step=0)
    jstep = jax.jit(JTS.make_train_step(jm, jt))
    step = TS.make_train_step(model, tc)
    jds = JD.ShardedDataset(jm.cfg, global_batch=6, seq_len=0, seed=5)
    ds = D.ShardedDataset(model.cfg, global_batch=6, seq_len=0, seed=5,
                          device="cpu")
    for i in range(3):
        jstate, jm_ = jstep(jstate, jds.global_batch_at(i), jnp.float32(2.0))
        state, m = step(state, ds.global_batch_at(i), 2.0)
        assert abs(float(m["loss"]) / float(jm_["loss"]) - 1) < 1e-5, i
        assert abs(m["lr"] / float(jm_["lr"]) - 1) < 1e-5, i
    close_trees(state.params, jstate.params, 1e-5, 1e-6)
    close_trees(state.opt["mu"], jstate.opt["mu"], 1e-4, 1e-5)


def test_evaluate_accuracy_matches_the_reference():
    jm, model, tree = models(True)
    jb = JD.Cifar10Like(image_size=16, color_signal=1.0, seed=3).eval_batch(64)
    tb = D.Cifar10Like(image_size=16, color_signal=1.0, seed=3,
                       device="cpu").eval_batch(64)
    want = JTR.evaluate_accuracy(jm, jax.tree.map(jnp.asarray, tree), jb)
    got = TR.evaluate_accuracy(model, params_from_numpy(
        tree, model.cfg, "cpu", dtype=torch.float32), tb)
    assert abs(got - want) <= 1 / 64 + 1e-9


# ---------------------------------------------------------------------------
# batches
# ---------------------------------------------------------------------------

def test_resnet_batches_are_bit_equal():
    for reduced in (True, False):
        jcfg, cfg = JC.get_config(ARCH, reduced), C.get_config(ARCH, reduced)
        want = JD.make_batch(jcfg, 5, 0, seed=7, step=3)
        got = D.make_batch(cfg, 5, 0, seed=7, step=3, device="cpu")
        assert D.lm_batch_keys(cfg) == JD.lm_batch_keys(jcfg) == tuple(got)
        assert got["images"].dtype == torch.float32
        assert got["labels"].dtype == torch.int64
        for key in got:
            np.testing.assert_array_equal(got[key].numpy(),
                                          np.asarray(want[key]))
    ds = D.ShardedDataset(cfg, global_batch=8, seq_len=0, seed=2,
                          device="cpu")
    jds = JD.ShardedDataset(jcfg, global_batch=8, seq_len=0, seed=2)
    np.testing.assert_array_equal(ds.shard_batch(4, 1, 2)["images"].numpy(),
                                  np.asarray(jds.shard_batch(4, 1, 2)["images"]))


@pytest.mark.parametrize("color", [0.0, 1.5])
def test_cifar10_like_is_bit_equal(color):
    kw = dict(num_classes=10, image_size=32, signal=3.0, seed=4,
              color_signal=color)
    got = D.Cifar10Like(device="cpu", **kw)
    want = JD.Cifar10Like(**kw)
    for g, w in ((got.batch(6, 16, shard=1, num_shards=2),
                  want.batch(6, 16, shard=1, num_shards=2)),
                 (got.eval_batch(32), want.eval_batch(32))):
        for key in ("images", "labels"):
            np.testing.assert_array_equal(g[key].numpy(), np.asarray(w[key]))
    assert got.batch(0, 4)["images"].shape == (4, 32, 32, 3)


def test_resnet_has_no_decode_cache_and_trees_keep_lists():
    model = build_model(C.get_config(ARCH, reduced=True), "cpu")
    with pytest.raises(ValueError, match="no transformer stack"):
        model.init_cache(2, 8)
    p = model.init(model.generator(0))
    shapes = tree_map(lambda t: tuple(t.shape), p)
    assert type(shapes["stages"]) is list and \
        type(shapes["stages"][0]) is list
    assert shapes["stages"][1][0]["proj"] == (32, 16, 1, 1)
    other = tree_map(lambda t: t, p)
    other["stages"] = other["stages"][:2]
    with pytest.raises(ValueError, match="structures differ"):
        tree_map(lambda a, b: a, p, other)
