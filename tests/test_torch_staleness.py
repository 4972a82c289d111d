"""The port's async-PS simulator and gradient compression against the JAX
package's, on the CPU, from the same weights.

``AsyncPSSimulator``: the event order is host-side numpy in both, so the
staleness arrays, the per-worker staleness and the active-worker curve
are held exactly; the LR history to 1e-6 relative (the reference's
schedule computes in float32, the port's in Python floats); the params
are held to float32 noise,
max|diff| <= 1e-5 x max|param| after 48 pushes (the reference's
XLA-compiled push and the port's eager one differ in summation order
only, and stale pushes at these LRs amplify that noise as they go).

The snapshot alias: the port's optimizers update the PS params in place,
so a worker's snapshot must be a clone. A run whose snapshots are forced
to the PS params themselves must give other params than the real run
(its recorded staleness would still look right), and no snapshot may
share storage with a PS param.

Compression: top-k with error feedback draws nothing and is held
exactly, ties at the threshold included. TernGrad draws its mask from a
``torch.Generator`` in the port and from ``jax.random`` in the
reference: given the reference's uniform draws, the port's leaf
transform gives the reference's result exactly; alone, the port's is
unbiased and takes values in {-s, 0, +s}.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.core import staleness as JS  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.optim import compression as JCMP  # noqa: E402
from repro.train import step as JTS  # noqa: E402
from repro_torch import config as C  # noqa: E402
from repro_torch.core import staleness as S  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.optim import compression as CMP  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

SIZE, PUSHES = 8, 48
DIM, NCLS = SIZE * SIZE * 3, 10
JTASK = JD.Cifar10Like(image_size=SIZE, seed=2)
TASK = D.Cifar10Like(image_size=SIZE, seed=2, device="cpu")


def init_numpy(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": (rng.normal(size=(DIM, NCLS)) * 0.05).astype(np.float32),
            "b": (rng.normal(size=(NCLS,)) * 0.05).astype(np.float32)}


def jloss(p, batch):
    x = batch["images"].reshape(batch["images"].shape[0], -1)
    return JTS.cross_entropy(x @ p["w"] + p["b"], batch["labels"])


def loss(p, batch):
    x = batch["images"].reshape(batch["images"].shape[0], -1)
    return TS.cross_entropy(x @ p["w"] + p["b"], batch["labels"])


def workers(mod):
    """Three workers of three kinds: one revoked mid-run, one joining."""
    return [mod.AsyncWorker(0, kind="K80"),
            mod.AsyncWorker(1, kind="P100", revoke_t=1.0),
            mod.AsyncWorker(2, kind="V100", join_t=0.4)]


def configs(mod, clip, total=1000):
    return (mod.OptimizerConfig(name="momentum", lr=0.05, base_workers=1,
                                grad_clip=clip),
            mod.ScheduleConfig(kind="cosine", warmup_steps=4,
                               total_steps=total))


def sims(clip=0.0):
    tree = init_numpy()
    jsim = JS.AsyncPSSimulator(jloss, {k: jnp.asarray(v)
                                       for k, v in tree.items()},
                               *configs(JC, clip))
    sim = S.AsyncPSSimulator(loss, {k: torch.from_numpy(v)
                                    for k, v in tree.items()},
                             *configs(C, clip))
    return jsim, sim


def max_rel(got, want):
    big = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    return max(float(np.abs(got[k].numpy() - np.asarray(v)).max())
               for k, v in want.items()) / big


@pytest.mark.parametrize("clip,adaptive,jitter", [
    (0.0, True, 0.05), (1.0, True, 0.05), (0.0, False, 0.05),
    (0.0, True, 0.0)])
def test_async_ps_matches_the_reference(clip, adaptive, jitter):
    jsim, sim = sims(clip)
    kw = dict(seed=3, jitter=jitter, adaptive_lr=adaptive,
              configured_workers=4, eval_every=16)
    jres = jsim.run(workers(JS), lambda u, w: JTASK.batch(u * 64 + w, 32),
                    PUSHES, eval_fn=lambda p: jloss(p, JTASK.eval_batch(64)),
                    **kw)
    res = sim.run(workers(S), lambda u, w: TASK.batch(u * 64 + w, 32),
                  PUSHES, eval_fn=lambda p: loss(p, TASK.eval_batch(64)),
                  **kw)
    assert res.updates_applied == jres.updates_applied == PUSHES
    np.testing.assert_array_equal(res.staleness, jres.staleness)
    assert res.staleness.dtype == jres.staleness.dtype
    assert res.staleness_by_worker == jres.staleness_by_worker
    assert res.active_worker_curve == jres.active_worker_curve
    assert len(res.lr_history) == len(jres.lr_history)
    for a, b in zip(res.lr_history, jres.lr_history):
        assert abs(a - b) <= 1e-6 * b          # a float32 schedule there
    assert res.staleness_histogram() == jres.staleness_histogram()
    assert res.mean_staleness == jres.mean_staleness
    if jitter:
        assert res.mean_staleness > 0.5           # really stale
        assert min(n for _, n in res.active_worker_curve[1:]) < \
            max(n for _, n in res.active_worker_curve)   # the revocation
    assert [u for u, _ in res.loss_curve] == [u for u, _ in jres.loss_curve]
    for (_, a), (_, b) in zip(res.loss_curve, jres.loss_curve):
        assert abs(a - b) <= 1e-5 * abs(b)
    assert max_rel(res.params, jres.params) <= 1e-5
    assert all(t.dtype == torch.float32 and t.device.type == "cpu"
               for _, t in tree_leaves(res.params))


def test_sync_baseline_matches_the_reference():
    tree = init_numpy(1)
    want = JS.sync_baseline(jloss, {k: jnp.asarray(v)
                                    for k, v in tree.items()},
                            *configs(JC, 1.0),
                            lambda u, w: JTASK.batch(u, 32), 32)
    got = S.sync_baseline(loss, {k: torch.from_numpy(v)
                                 for k, v in tree.items()},
                          *configs(C, 1.0), lambda u, w: TASK.batch(u, 32),
                          32)
    assert max_rel(got, want) <= 1e-5


def test_snapshots_are_clones_not_aliases(monkeypatch):
    """With the in-place optimizers an aliased snapshot follows every
    push: the gradient is then taken at the current params and staleness
    does nothing, while the recorded staleness is unchanged."""
    tree = init_numpy()
    given = {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    sim = S.AsyncPSSimulator(loss, given, *configs(C, 0.0))
    ws = workers(S)
    res = sim.run(ws, lambda u, w: TASK.batch(u * 64 + w, 32), PUSHES,
                  seed=3)
    ps = {t.data_ptr() for _, t in tree_leaves(sim.params)}
    for w in ws:
        assert not ps & {t.data_ptr() for _, t in tree_leaves(w.snapshot)}
    # the caller's tensors are the initial weights still
    for k, v in tree.items():
        np.testing.assert_array_equal(given[k].numpy(), v)

    monkeypatch.setattr(S, "_snapshot", lambda params: params)
    aliased_sim = S.AsyncPSSimulator(
        loss, {k: torch.from_numpy(v.copy()) for k, v in tree.items()},
        *configs(C, 0.0))
    aliased = aliased_sim.run(workers(S),
                              lambda u, w: TASK.batch(u * 64 + w, 32),
                              PUSHES, seed=3)
    np.testing.assert_array_equal(aliased.staleness, res.staleness)
    assert res.mean_staleness > 0.5
    # the aliased run is a different (staleness-free) computation
    diff = max(float((res.params[k] - aliased.params[k]).abs().max())
               for k in tree)
    big = max(float(t.abs().max()) for t in res.params.values())
    assert diff > 1e-3 * big


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------

def grads_numpy(seed, ties=False):
    rng = np.random.default_rng(seed)
    g = {"a": rng.normal(size=(16, 8)), "b": rng.normal(size=(40,)),
         "c": {"d": rng.normal(size=(3, 5, 2))}}
    if ties:           # one decimal: many equal magnitudes at the threshold
        g = {"a": np.round(g["a"], 1), "b": np.round(g["b"], 1),
             "c": {"d": np.round(g["c"]["d"], 1)}}
    return jax.tree.map(lambda x: x.astype(np.float32), g)


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.37])
@pytest.mark.parametrize("ties", [False, True])
def test_topk_with_error_feedback_is_exact(ratio, ties):
    jst = JCMP.init_state(jax.tree.map(jnp.asarray, grads_numpy(0)))
    st = CMP.init_state(jax.tree.map(torch.from_numpy, grads_numpy(0)))
    for step in range(6):
        g = grads_numpy(step, ties)
        jkept, jst = JCMP.topk_compress(jax.tree.map(jnp.asarray, g), jst,
                                        ratio)
        kept, st = CMP.topk_compress(jax.tree.map(torch.from_numpy, g), st,
                                     ratio)
        for (path, t), (_, e) in zip(tree_leaves(kept),
                                     tree_leaves(st.error)):
            keys = path.split("/")
            want_k, want_e = jkept, jst.error
            for k in keys:
                want_k, want_e = want_k[k], want_e[k]
            np.testing.assert_array_equal(t.numpy(), np.asarray(want_k))
            np.testing.assert_array_equal(e.numpy(), np.asarray(want_e))
    assert CMP.topk_decompress(kept) is kept
    for scheme in ("none", "topk", "ternary"):
        assert CMP.compression_bytes_ratio(scheme, 0.05) == \
            JCMP.compression_bytes_ratio(scheme, 0.05)
    with pytest.raises(ValueError):
        CMP.compression_bytes_ratio("bogus")


def test_ternary_leaf_with_the_reference_draws_is_exact():
    g = grads_numpy(4)
    key = jax.random.key(11)
    want = JCMP.ternary_compress(jax.tree.map(jnp.asarray, g), key)
    leaves, treedef = jax.tree.flatten(g)
    keys = jax.random.split(key, len(leaves))
    got = [CMP._ternary_leaf(torch.from_numpy(x), torch.from_numpy(
        np.array(jax.random.uniform(k, x.shape, jnp.float32))))
        for x, k in zip(leaves, keys)]
    for a, b in zip(got, jax.tree.leaves(want)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # zero gradient: zero out, no NaN
    z = CMP._ternary_leaf(torch.zeros(5), torch.rand(5))
    assert torch.equal(z, torch.zeros(5))


def test_ternary_is_unbiased_and_ternary():
    gen = torch.Generator().manual_seed(0)
    g = {"a": torch.full((4096,), 0.3), "b": torch.linspace(-1, 1, 64)}
    acc = {k: torch.zeros_like(v) for k, v in g.items()}
    n = 200
    for _ in range(n):
        t = CMP.ternary_decompress(CMP.ternary_compress(g, gen))
        for k in g:
            s = float(g[k].abs().max())
            vals = set(np.round(t[k].numpy() / s, 6).tolist())
            assert vals <= {-1.0, 0.0, 1.0}
            acc[k] += t[k]
    assert abs(float((acc["a"] / n).mean()) - 0.3) < 0.02
    assert float((acc["b"] / n - g["b"]).abs().mean()) < 0.1
    # the draws follow the generator: the same seed, the same mask
    a = CMP.ternary_compress(g, torch.Generator().manual_seed(5))
    b = CMP.ternary_compress(g, torch.Generator().manual_seed(5))
    assert all(torch.equal(a[k], b[k]) for k in g)
