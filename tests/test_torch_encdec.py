"""The port's encoder-decoder family (seamless-m4t-large-v2: a
bidirectional encoder over frame embeddings, a causal decoder with
cross-attention, a decode cell over fixed cross caches) against the JAX
package's, on the reduced config (2 + 2 layers, d_model 64, D = 16) in
float32, from the reference's own initial weights bridged into the port
(``params_from_numpy``: ``enc_layers``, ``enc_norm``, ``lnx``,
``xattn``) with seeded nonzero RMS gammas.

Held: ``make_batch`` (bit-equal arrays); ``Model.apply`` against the
reference's attention through ``xla`` and ``pallas`` (interpret);
one AdamW step's loss and gradients; ``encode_for_decode`` plus four
``make_serve_step`` steps (greedy tokens equal, logits close) through
both reference attentions; the cache layout; the refusals (the paged
cache, the serving engine, ``launch.serve``'s message, the reference's
own); ``launch.train`` on the CPU; the full-width parameter count. Two
reference behaviours are pinned: the cross-attention ignores any
``xattn`` bias, and the encoder is bidirectional.

Tolerances (float32; summation order only): logits 1e-4 absolute +
1e-5 relative (``test_torch_forward``'s); the step as
``tests/test_torch_train.py`` holds it (loss 1e-5 and gradient norm 1e-4
relative; the first AdamW moment 1e-5 relative + 1e-7 absolute).
Batches and greedy tokens are equal.
"""
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.builder import build_model as jax_build  # noqa: E402
from repro.train import step as JTS  # noqa: E402
from repro_torch import config as C  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.builder import (build_model,  # noqa: E402
                                        cache_batch_axes, paged_cache_axes)
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "seamless-m4t-large-v2"
B, S = 2, 32                  # 16 encoder frames + 16 decoder tokens
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
REFUSAL = ("serve driver targets decoder-only families; seamless decode "
           "is exercised by the dry-run")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread is faster than a pool, most of
    all beside other test workers. Restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _randomise(tree, rng, keys=("gamma",)):
    for key, val in tree.items():
        if isinstance(val, dict):
            _randomise(val, rng, keys)
        elif key in keys:
            tree[key] = rng.normal(0.0, 0.2, val.shape).astype(np.float32)
    return tree


def _pair(**kw):
    jcfg = JC.get_config(ARCH, reduced=True).replace(dtype="float32",
                                                     attn_impl="xla", **kw)
    jm = jax_build(jcfg)
    tree = _randomise(jax.tree.map(
        np.asarray, JL.unbox(jax.jit(jm.init)(jax.random.key(0)))),
        np.random.default_rng(0), ("gamma", "bq", "bk", "bv"))
    cfg = C.get_config(ARCH, reduced=True).replace(dtype="float32",
                                                   attn_impl="torch", **kw)
    return SimpleNamespace(jcfg=jcfg, jm=jm, model=build_model(cfg, "cpu"),
                           tree=tree)


@pytest.fixture(scope="module")
def pair():
    """(reference config, reference model, port model, numpy weights)."""
    return _pair()


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x)


def _batch(pair, seed=1):
    return (D.make_batch(pair.model.cfg, B, S, seed=seed, device="cpu"),
            JD.make_batch(pair.jcfg, B, S, seed=seed))


def _forward_both(pair, ref_impl="xla", tree=None):
    tree = pair.tree if tree is None else tree
    jcfg = pair.jcfg.replace(attn_impl=ref_impl)
    batch, jbatch = _batch(pair)
    jlogits, jaux = jax.jit(lambda p, b: JT.forward(p, jcfg, b))(
        _j(tree), jbatch)
    params = params_from_numpy(tree, pair.model.cfg, "cpu",
                               dtype=torch.float32)
    with torch.no_grad():
        logits, aux = pair.model.apply(params, batch)
    return logits, aux, np.asarray(jlogits), float(jaux)


# ---------------------------------------------------------------------------
# data, the forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batches_are_the_reference_arrays(dtype):
    """The same numpy draws in the same order: frame embeddings (x 0.02,
    cast to ``cfg.dtype``), decoder tokens, labels. Single batches, the
    global batch and a shard."""
    jcfg = JC.get_config(ARCH, True).replace(dtype=dtype)
    cfg = C.get_config(ARCH, True).replace(dtype=dtype)
    pairs = [(D.make_batch(cfg, 3, 41, seed=7, step=11, device="cpu"),
              JD.make_batch(jcfg, 3, 41, seed=7, step=11))]
    ds = D.ShardedDataset(cfg, global_batch=4, seq_len=24, seed=5,
                          device="cpu")
    jds = JD.ShardedDataset(jcfg, global_batch=4, seq_len=24, seed=5)
    pairs += [(ds.global_batch_at(3), jds.global_batch_at(3)),
              (ds.shard_batch(3, 1, 2), jds.shard_batch(3, 1, 2))]
    assert D.lm_batch_keys(cfg) == JD.lm_batch_keys(jcfg) == tuple(pairs[0][0])
    for got, want in pairs:
        assert got.keys() == want.keys()
        for key in got:
            assert tuple(got[key].shape) == want[key].shape, key
            np.testing.assert_array_equal(
                _np(got[key]), np.asarray(jnp.asarray(want[key],
                                                      jnp.float32)),
                err_msg=key)
        assert got["frame_embeds"].dtype == (torch.bfloat16 if dtype ==
                                             "bfloat16" else torch.float32)
    # 41 positions: 20 frames, 21 decoder tokens
    assert tuple(pairs[0][0]["frame_embeds"].shape) == (3, 20, 64)
    assert tuple(pairs[0][0]["labels"].shape) == (3, 21)


@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_apply_matches_reference_forward(pair, ref_impl):
    logits, aux, want, jaux = _forward_both(pair, ref_impl)
    assert logits.shape == (B, S // 2, pair.jcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5, atol=1e-4)
    assert float(aux) == jaux == 0


def test_cross_attention_ignores_xattn_bias():
    """Kept as in the reference: with ``qkv_bias`` the cross-attention's
    ``xattn`` biases exist but are never added. The port matches the
    reference with seeded nonzero biases, and changing only the
    ``xattn`` biases changes neither."""
    pair = _pair(qkv_bias=True)
    assert "bq" in pair.tree["layers"]["xattn"]
    logits, _, want, _ = _forward_both(pair)
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5, atol=1e-4)
    tree = jax.tree.map(lambda a: a, pair.tree)
    for key in ("bq", "bk", "bv"):
        tree["layers"]["xattn"][key] = tree["layers"]["xattn"][key] + 1.0
    moved, _, jmoved, _ = _forward_both(pair, tree=tree)
    assert torch.equal(moved, logits)
    np.testing.assert_array_equal(jmoved, want)


def test_encoder_is_bidirectional(pair):
    """The encoder attends both ways: the last frame moves the first
    frame's encoding (a causal encoder would not)."""
    params = params_from_numpy(pair.tree, pair.model.cfg, "cpu",
                               dtype=torch.float32)
    frames = D.make_batch(pair.model.cfg, B, S, device="cpu")["frame_embeds"]
    moved = frames.clone()
    moved[:, -1] += 1.0
    with torch.no_grad():
        a = T._encode(params, pair.model.cfg, frames, remat=False)
        b = T._encode(params, pair.model.cfg, moved, remat=False)
    assert not torch.allclose(a[:, 0], b[:, 0])


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


def test_train_step_gradients_match(pair):
    """One AdamW step over the decoder's positions: loss, gradient norm
    and the first moment (every gradient, the encoder's included)."""
    jt, tc = _tcfgs()
    jstate = JTS.init_state(pair.jm, jt, jax.random.key(0), _j(pair.tree))
    state = TS.init_state(pair.model, tc, params=params_from_numpy(
        pair.tree, pair.model.cfg, "cpu", dtype=torch.float32))
    jds = JD.ShardedDataset(pair.jcfg, global_batch=4, seq_len=S, seed=1)
    ds = D.ShardedDataset(pair.model.cfg, global_batch=4, seq_len=S, seed=1,
                          device="cpu")
    jstate, jm_ = jax.jit(JTS.make_train_step(pair.jm, jt))(
        jstate, jds.global_batch_at(0), jnp.float32(1.0))
    state, m = TS.make_train_step(pair.model, tc)(state, ds.global_batch_at(0),
                                                  1.0)
    assert _rel(m["loss"], jm_["loss"]) < 1e-5
    assert _rel(m["grad_norm"], jm_["grad_norm"]) < 1e-4
    want = dict(tree_leaves(jax.tree.map(np.asarray, jstate.opt["m"])))
    got = dict(tree_leaves(state.opt["m"]))
    assert got.keys() == want.keys()
    for path, t in got.items():
        np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-5,
                                   atol=1e-7, err_msg=path)
    assert float(state.opt["m"]["enc_layers"]["attn"]["wq"].abs().max()) > 0


def test_launch_train_cli_on_cpu():
    out = launch_train.main(["--device", "cpu", "--arch", ARCH, "--steps",
                             "3", "--global-batch", "4", "--seq-len", "32"])
    assert out["final_step"] == 3 and out["arch"] == ARCH
    assert len(out["losses"]) == 3
    assert all(math.isfinite(x) for x in out["losses"] + out["grad_norms"])
    assert abs(out["losses"][0] - math.log(512)) < 1.0


# ---------------------------------------------------------------------------
# encode, then decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_encode_then_decode_matches_reference(pair, ref_impl):
    """``encode_for_decode`` fills the cross caches, then four greedy
    steps of ``make_serve_step`` from a start token: the port's tokens
    are the reference's, its logits within the forward's tolerance, and
    its cross caches the reference's."""
    jcfg = pair.jcfg.replace(attn_impl=ref_impl)
    jm = jax_build(jcfg)
    model = pair.model
    params = params_from_numpy(pair.tree, model.cfg, "cpu")
    batch, jbatch = _batch(pair, seed=3)
    max_len, enc_len = 12, batch["frame_embeds"].shape[1]
    jcache = JT.encode_for_decode(_j(pair.tree), jcfg,
                                  jbatch["frame_embeds"],
                                  jm.init_cache(B, max_len, enc_len=enc_len))
    cache = model.init_cache(B, max_len, enc_len=enc_len)
    assert tuple(cache["xk"].shape) == jcache["xk"].shape \
        == (2, B, enc_len, 4, 16)
    with torch.no_grad():
        cache = T.encode_for_decode(params, model.cfg,
                                    batch["frame_embeds"], cache)
    for key in ("xk", "xv"):
        np.testing.assert_allclose(cache[key].numpy(),
                                   np.asarray(jcache[key]), rtol=1e-5,
                                   atol=1e-5)
    step = TS.make_serve_step(model)
    jstep = jax.jit(JTS.make_serve_step(jm))
    jdecode = jax.jit(lambda p, c, t: jm.decode(p, c, {"tokens": t}))
    tok = batch["tokens"][:, :1]
    jtok = jnp.asarray(tok.numpy(), jnp.int32)
    jparams = _j(pair.tree)
    for _ in range(4):
        with torch.no_grad():
            logits, _ = model.decode(params, dict(cache), {"tokens": tok})
        jlogits, _ = jdecode(jparams, jcache, jtok)
        np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                   rtol=1e-5, atol=1e-4)
        # the cell wrote this token's KV in place; the step writes it again
        tok, cache = step(params, cache, tok)
        jtok, jcache = jstep(jparams, jcache, jtok)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(cache["pos"].numpy(), [4, 4])
    np.testing.assert_array_equal(np.asarray(jcache["pos"]), [4, 4])


def test_cache_axes_match_reference(pair):
    from repro.models.builder import cache_batch_axes as jax_axes
    assert cache_batch_axes(pair.model, 8, enc_len=6) == \
        jax_axes(pair.jm, 8, enc_len=6)


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_paged_cache_raises_as_the_reference_does(pair):
    with pytest.raises(NotImplementedError) as got:
        pair.model.init_paged_cache(2, 16, page_size=4, num_pages=8)
    with pytest.raises(NotImplementedError) as want:
        pair.jm.init_paged_cache(2, 16, page_size=4, num_pages=8)
    assert str(got.value) == str(want.value)
    with pytest.raises(NotImplementedError):
        paged_cache_axes(pair.model, 8)


def test_engine_refuses_encdec(pair):
    params = params_from_numpy(pair.tree, pair.model.cfg, "cpu")
    with pytest.raises(ValueError, match="decoder-only"):
        ServeEngine(pair.model, params, max_batch=2, max_len=16)


def test_launch_serve_exits_with_the_reference_message():
    with pytest.raises(SystemExit) as got:
        launch_serve.main(["--device", "cpu", "--arch", ARCH])
    assert str(got.value) == REFUSAL
    # the reference's own driver, with its own words
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, "-m", "repro.launch.serve",
                          "--arch", ARCH], capture_output=True, text=True,
                         timeout=300, cwd=ROOT, env=env)
    assert ref.returncode == 1
    assert ref.stderr.strip().splitlines()[-1] == REFUSAL


def test_full_width_parameter_count():
    """Summing ``numel`` over a meta-device init gives the reference's
    analytic count, 1.632 B parameters (3.26 GB in bf16), which leaves
    out the 122 RMS gammas of 1024 (2 per encoder layer, 3 per decoder
    layer, ``enc_norm`` and ``final_norm``): 124,928 more."""
    leaves = list(tree_leaves(T.init_params(C.get_config(ARCH), None,
                                            torch.device("meta"))))
    weights = sum(t.numel() for p, t in leaves
                  if not p.endswith("/gamma"))
    assert weights == JC.get_config(ARCH).param_count()
    assert round(weights / 1e9, 3) == 1.632
    assert sum(t.numel() for _, t in leaves) - weights == 122 * 1024
