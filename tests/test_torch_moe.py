"""The port's MoE family (``repro_torch.models.ffn.apply_moe`` and the
``moe`` branches of ``models/transformer.py``) against the JAX package's,
on reduced moonshot-v1-16b-a3b (a dense first layer, shared experts) and
arctic-480b (a dense residual branch) in float32, from the reference's
own initial weights bridged into the port (``params_from_numpy``) with
seeded nonzero RMS gammas.

Held: ``apply_moe``'s output and aux; the same with a zero router, where
every probability ties, experts 0..k-1 take every token's assignments
and half of them are dropped (the dropped set must be the reference's);
``Model.apply`` logits and aux against the reference's attention through
``xla`` and ``pallas`` (interpret); dense and paged decode logits; greedy
tokens through ``ServeEngine`` (dense and paged, a drain onto a second
engine) against the reference's engine; ``loss_fn``'s total
= CE + ``router_aux_coef`` x aux; one ``Trainer`` step's and one elastic
masked step's gradients.

Tolerances (float32; summation order only): ``apply_moe`` 1e-5 relative
to max|out| (aux 1e-5 relative); logits 1e-4 absolute + 1e-5 relative;
the steps as ``tests/test_torch_train.py`` holds them (loss 1e-5, grad
norm 1e-4 relative; the first AdamW moment, which is 0.1 x the clipped
gradient, 1e-5 relative + 1e-7 absolute). Greedy tokens are equal.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.core import cluster as JCL  # noqa: E402
from repro.core import elastic as JE  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import ffn as JF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.builder import build_model as jax_build  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.train import step as JTS  # noqa: E402
from repro_torch import config as C  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.core import cluster as CL  # noqa: E402
from repro_torch.core import elastic as E  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.models import ffn as F  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = ("moonshot-v1-16b-a3b", "arctic-480b")
B, S = 2, 32
MAX_LEN, PAGE = 40, 8


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread is faster than a pool, most of
    all beside other test workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomise(tree, rng):
    for key, val in tree.items():
        if isinstance(val, dict):
            _randomise(val, rng)
        elif key == "gamma":
            tree[key] = rng.normal(0.0, 0.2, val.shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """(reference config, reference model, port model, numpy weights)."""
    arch = request.param
    jcfg = JC.get_config(arch, reduced=True).replace(dtype="float32",
                                                     attn_impl="xla")
    jm = jax_build(jcfg)
    tree = _randomise(jax.tree.map(
        np.asarray, JL.unbox(jax.jit(jm.init)(jax.random.key(0)))),
        np.random.default_rng(0))
    cfg = C.get_config(arch, reduced=True).replace(dtype="float32",
                                                   attn_impl="torch")
    return SimpleNamespace(jcfg=jcfg, jm=jm, model=build_model(cfg, "cpu"),
                           tree=tree, arch=arch)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _tokens(vocab, shape, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=shape)


def _layer0(tree):
    """The first MoE layer's ``moe`` parameters."""
    return jax.tree.map(lambda a: a[0], tree["layers"]["moe"])


# ---------------------------------------------------------------------------
# apply_moe
# ---------------------------------------------------------------------------

def _both_moe(pair, moe, x):
    jout, jaux = jax.jit(lambda p, v: JF.apply_moe(p, v, pair.jcfg))(
        _j(moe), jnp.asarray(x))
    tp = tree_map(torch.tensor, moe)
    with torch.no_grad():
        out, aux = F.apply_moe(tp, torch.tensor(x), pair.model.cfg)
    return out.numpy(), float(aux), np.asarray(jout), float(jaux)


def test_apply_moe_matches_reference(pair):
    moe = _layer0(pair.tree)
    x = np.random.default_rng(2).normal(size=(B, S, pair.jcfg.d_model)) \
        .astype(np.float32)
    out, aux, jout, jaux = _both_moe(pair, moe, x)
    assert out.shape == jout.shape == x.shape
    scale = np.abs(jout).max()
    np.testing.assert_allclose(out, jout, rtol=0, atol=1e-5 * scale)
    assert aux > 0 and abs(aux - jaux) <= 1e-5 * abs(jaux)


def test_zero_router_drops_the_reference_set(pair):
    """A zero router: every probability is 1/E, so every token's top-k is
    experts 0..k-1 in that order (ties pick the lower expert, as
    ``jax.lax.top_k`` does), each of them takes S = 32 assignments against
    C = 16 and the second half of each is dropped."""
    cfg = pair.model.cfg
    moe = _layer0(pair.tree)
    moe["router"] = np.zeros_like(moe["router"])
    x = np.random.default_rng(3).normal(size=(B, S, cfg.d_model)) \
        .astype(np.float32)
    C_ = F.moe_capacity(S, cfg)
    assert C_ == 16 and C_ == JF.moe_capacity(S, pair.jcfg)

    probs = np.full((B, S, cfg.num_experts), 1.0 / cfg.num_experts,
                    np.float32)
    jbuf, jslot, jkeep, jw = jax.vmap(
        lambda xr, pr: JF._route_row(xr, pr, pair.jcfg, C_))(
            jnp.asarray(x), jnp.asarray(probs))
    buf, slot, keep, w = F._route(torch.tensor(x), torch.tensor(probs), cfg,
                                  C_)
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    k = cfg.top_k
    # token t's assignments are (t, expert j) for j < k: position t in j
    tok = np.repeat(np.arange(S), k)
    assert (keep.numpy() == (tok < C_)[None]).all()
    assert int(keep.sum()) == B * k * C_ == B * S * k // 2

    out, aux, jout, jaux = _both_moe(pair, moe, x)
    np.testing.assert_allclose(out, jout, rtol=0,
                               atol=1e-5 * np.abs(jout).max())
    # every argmax is expert 0, every mean probability 1/E: aux = 1/E
    assert abs(aux - jaux) <= 1e-6
    assert aux == pytest.approx(1.0 / cfg.num_experts, rel=1e-6)


# ---------------------------------------------------------------------------
# the stack: forward, decode, serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_apply_matches_reference_forward(pair, ref_impl):
    jcfg = pair.jcfg.replace(attn_impl=ref_impl)
    tok = _tokens(jcfg.vocab_size, (B, S))
    jlogits, jaux = jax.jit(lambda p, t: JT.forward(p, jcfg, {"tokens": t}))(
        _j(pair.tree), jnp.asarray(tok, jnp.int32))
    params = params_from_numpy(pair.tree, pair.model.cfg, "cpu",
                               dtype=torch.float32)
    with torch.no_grad():
        logits, aux = pair.model.apply(params, {"tokens": torch.tensor(tok)})
    assert logits.shape == (B, S, jcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-4)
    assert aux.dtype == torch.float32 and aux.shape == ()
    assert float(aux) > 0
    assert abs(float(aux) - float(jaux)) <= 1e-5 * float(jaux)


def _decode_both(pair, paged):
    """Six decode steps of three rows at staggered positions in both
    packages (the reference's decode kernel in interpret mode), dense or
    through a shuffled page table; returns [(port, reference) logits]."""
    jcfg = pair.jcfg.replace(attn_impl="pallas")
    jm = jax_build(jcfg)
    model = pair.model
    params = params_from_numpy(pair.tree, model.cfg, "cpu")
    pos0 = np.array([0, 9, 17], np.int32)
    nb = 3
    if paged:
        per_row = -(-MAX_LEN // PAGE)
        table = np.random.default_rng(4).permutation(
            nb * per_row).reshape(nb, per_row).astype(np.int32)
        kw = dict(page_size=PAGE, num_pages=nb * per_row)
        jcache = jm.init_paged_cache(nb, MAX_LEN, **kw)
        jcache["page_table"] = jnp.asarray(table)
        cache = model.init_paged_cache(nb, MAX_LEN, **kw)
        cache["page_table"] = torch.tensor(table)
        jstep = jax.jit(lambda p, c, t: jm.decode_paged(p, c, {"tokens": t}))
        step = model.decode_paged
    else:
        jcache = jm.init_cache(nb, MAX_LEN)
        cache = model.init_cache(nb, MAX_LEN)
        jstep = jax.jit(lambda p, c, t: jm.decode(p, c, {"tokens": t}))
        step = model.decode
    if model.cfg.first_dense_layers:
        assert "kv_dense" in cache and "kv_dense" in jcache
    jcache["pos"] = jnp.asarray(pos0)
    cache["pos"] = torch.tensor(pos0)
    rng = np.random.default_rng(1)
    out = []
    jparams = _j(pair.tree)
    for _ in range(6):
        tok = rng.integers(0, model.cfg.vocab_size, size=(nb, 1))
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32))
        with torch.no_grad():
            logits, cache = step(params, cache, {"tokens": torch.tensor(tok)})
        out.append((logits.numpy(), np.asarray(jlogits)))
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    return out


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_logits_match(pair, paged):
    for got, want in _decode_both(pair, paged):
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_cache_axes_match_reference(pair):
    """The dense and paged caches' batch axes (``kv_dense`` and the page
    pools' sentinel included) are the reference's."""
    from repro.models.builder import cache_batch_axes as jax_axes
    from repro.models.builder import paged_cache_axes as jax_paged_axes
    from repro_torch.models.builder import (cache_batch_axes,
                                            paged_cache_axes)
    assert cache_batch_axes(pair.model, 8) == jax_axes(pair.jm, 8)
    assert paged_cache_axes(pair.model, 8) == jax_paged_axes(pair.jm, 8)


def _engines(pair, cache_impl):
    model = pair.model
    params = params_from_numpy(pair.tree, model.cfg, "cpu")
    kw = dict(max_batch=3, max_len=MAX_LEN, prefill_block=4,
              cache_impl=cache_impl)
    if cache_impl == "paged":
        kw["page_size"] = PAGE
    return (SimpleNamespace(
                make=lambda: ServeEngine(model, params, **kw),
                Request=Request),
            SimpleNamespace(
                make=lambda: JEngine(pair.jm, _j(pair.tree), **kw),
                Request=JRequest))


def _requests(side, vocab, plens=(5, 13, 9, 3, 7), max_new=8):
    rng = np.random.default_rng(0)
    return [side.Request(rid=i, prompt=rng.integers(1, vocab, size=(n,))
                         .tolist(), max_new_tokens=max_new)
            for i, n in enumerate(plens)]


def _serve(side, vocab, drain):
    """Five requests on three slots; with ``drain``, the first engine is
    warned mid-decode and its longer requests finish on a second one."""
    eng = side.make()
    reqs = _requests(side, vocab)
    for r in reqs:
        assert eng.submit(r)
    if drain:
        while not any(r is not None and len(r.generated) >= 2
                      for r in eng.slots):
            eng.step()
        migrated = eng.begin_drain(grace_tokens=1)
        assert migrated
        second = side.make()
        for r in migrated:
            assert second.submit(r)
        eng.run_to_completion()
        second.run_to_completion()
        moved = (second.pages_shipped, second.tokens_replayed)
    else:
        eng.run_to_completion()
        moved = None
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs], moved


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_greedy_tokens_match_reference_engine(pair, cache_impl):
    """Greedy tokens token for token: the port's engine against the
    reference's, undisturbed and through a drain onto a second engine
    (pages shipped on the paged cache, the prefix replayed on the dense
    one), all equal to the undisturbed run's."""
    vocab = pair.model.cfg.vocab_size
    port, ref = _engines(pair, cache_impl)
    want, _ = _serve(ref, vocab, drain=False)
    got, _ = _serve(port, vocab, drain=False)
    assert got == want
    assert all(len(t) == 8 for t in got)
    got_d, moved = _serve(port, vocab, drain=True)
    want_d, jmoved = _serve(ref, vocab, drain=True)
    assert got_d == want_d == want
    assert moved == jmoved
    if cache_impl == "paged":
        assert moved[0] > 0 and moved[1] == 0


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _tcfgs():
    opt = dict(name="adamw", lr=1e-3, weight_decay=1e-4, grad_clip=1.0)
    sched = dict(kind="cosine", warmup_steps=2, total_steps=10)
    return (JC.TrainConfig(optimizer=JC.OptimizerConfig(**opt),
                           schedule=JC.ScheduleConfig(**sched)),
            C.TrainConfig(optimizer=C.OptimizerConfig(**opt),
                          schedule=C.ScheduleConfig(**sched)))


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _assert_tree_close(got, want, rtol, atol):
    want = dict(tree_leaves(jax.tree.map(np.asarray, want)))
    got = dict(tree_leaves(got))
    assert got.keys() == want.keys()
    for path, t in got.items():
        np.testing.assert_allclose(t.detach().numpy(), want[path], rtol=rtol,
                                   atol=atol, err_msg=path)


def test_loss_fn_adds_router_aux(pair):
    jt, tc = _tcfgs()
    jds = JD.ShardedDataset(pair.jcfg, global_batch=4, seq_len=16, seed=1)
    ds = D.ShardedDataset(pair.model.cfg, global_batch=4, seq_len=16, seed=1,
                          device="cpu")
    jtotal, jmet = JTS.loss_fn(pair.jm, _j(pair.tree), jds.global_batch_at(0),
                               jt)
    params = params_from_numpy(pair.tree, pair.model.cfg, "cpu",
                               dtype=torch.float32)
    with torch.no_grad():
        total, met = TS.loss_fn(pair.model, params, ds.global_batch_at(0),
                                tc)
    assert float(met["aux"]) > 0
    assert pair.model.cfg.router_aux_coef == 0.001
    assert float(total) == pytest.approx(
        float(met["loss"]) + 0.001 * float(met["aux"]), rel=1e-7)
    assert _rel(total, jtotal) < 1e-5
    assert _rel(met["loss"], jmet["loss"]) < 1e-5
    assert _rel(met["aux"], jmet["aux"]) < 1e-5


def _states(pair, jt, tc):
    jstate = JTS.init_state(pair.jm, jt, jax.random.key(0), _j(pair.tree))
    state = TS.init_state(pair.model, tc, params=params_from_numpy(
        pair.tree, pair.model.cfg, "cpu", dtype=torch.float32))
    return jstate, state


def test_trainer_step_gradients_match(pair):
    """One train step: loss, aux and gradient norm, and the first AdamW
    moment (0.1 x the clipped gradient: every gradient)."""
    jt, tc = _tcfgs()
    jstate, state = _states(pair, jt, tc)
    jds = JD.ShardedDataset(pair.jcfg, global_batch=4, seq_len=16, seed=1)
    ds = D.ShardedDataset(pair.model.cfg, global_batch=4, seq_len=16, seed=1,
                          device="cpu")
    jstate, jm_ = jax.jit(JTS.make_train_step(pair.jm, jt))(
        jstate, jds.global_batch_at(0), jnp.float32(1.0))
    state, m = TS.make_train_step(pair.model, tc)(state, ds.global_batch_at(0),
                                                  1.0)
    assert float(m["aux"]) > 0
    assert _rel(m["loss"], jm_["loss"]) < 1e-5
    assert _rel(m["aux"], jm_["aux"]) < 1e-5
    assert _rel(m["grad_norm"], jm_["grad_norm"]) < 1e-4
    _assert_tree_close(state.opt["m"], jstate.opt["m"], 1e-5, 1e-7)
    # the router is trained through the aux term and the top-k weights
    assert float(state.opt["m"]["layers"]["moe"]["router"].abs().max()) > 0


def test_elastic_masked_step_gradients_match(pair):
    """One masked elastic step with slots 0 and 2 of 4 active: the aux
    covers the whole flat batch, masked rows included, as in the
    reference."""
    jt, tc = _tcfgs()
    jstate, state = _states(pair, jt, tc)
    jds = JD.ShardedDataset(pair.jcfg, global_batch=8, seq_len=16, seed=1)
    ds = D.ShardedDataset(pair.model.cfg, global_batch=8, seq_len=16, seed=1,
                          device="cpu")
    clusters = []
    for mod in (JCL, CL):
        c = mod.SparseCluster(4)
        for s in (0, 2):
            c.fill_and_activate(s, 0, kind="K80")
        clusters.append(c)
    jbatch, jmask = JE.slot_batch(pair.jcfg, jds, 0, clusters[0])
    batch, mask = E.slot_batch(pair.model.cfg, ds, 0, clusters[1])
    jstate, jm_ = jax.jit(JE.make_masked_train_step(pair.jm, jt))(
        jstate, jbatch, jmask)
    state, m = E.make_masked_train_step(pair.model, tc)(state, batch, mask)
    assert float(m["aux"]) > 0
    assert _rel(m["loss"], jm_["loss"]) < 1e-5
    assert _rel(m["aux"], jm_["aux"]) < 1e-5
    assert _rel(m["grad_norm"], jm_["grad_norm"]) < 1e-4
    _assert_tree_close(state.opt["m"], jstate.opt["m"], 1e-5, 1e-7)
