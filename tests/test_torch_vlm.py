"""The port's multimodal family (qwen2-vl-7b: the dense stack fed a
patch-embedding prefix, positions by M-RoPE) against the JAX package's,
on the reduced config (2 layers, d_model 64, D = 16) in float32, from the
reference's own initial weights bridged into the port
(``params_from_numpy``) with seeded nonzero RMS gammas and QKV biases.

Held: ``make_batch`` (bit-equal arrays for the same seed and step),
``mrope_positions`` and ``apply_mrope`` (also at D = 128, the 32/16/16
split); ``Model.apply`` against the reference's attention through
``xla`` and ``pallas`` (interpret); ``loss_fn`` with the image prefix
masked, and one AdamW step's gradients; greedy tokens through
``ServeEngine``, dense and paged (a drain onto a second engine), against
the reference's engine; the serve and train CLIs on the CPU; the
full-width parameter count. Two reference behaviours are pinned: text
positions start at the grid side ``g``, and the decode cell's 1-D RoPE
at the cache index equals M-RoPE at (t, t, t).

Tolerances (float32; summation order only): M-RoPE 1e-5 absolute and
relative; logits 1e-4 absolute + 1e-5 relative (``test_torch_forward``'s);
the step as ``tests/test_torch_train.py`` holds it (loss 1e-5 and
gradient norm 1e-4 relative; the first AdamW moment, 0.1 x the clipped
gradient, 1e-5 relative + 1e-7 absolute). Batches and greedy tokens are
equal.
"""
import math
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import config as JC  # noqa: E402
from repro.data import pipeline as JD  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import modality as JMOD  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.builder import build_model as jax_build  # noqa: E402
from repro.serving import Request as JRequest  # noqa: E402
from repro.serving import ServeEngine as JEngine  # noqa: E402
from repro.train import step as JTS  # noqa: E402
from repro_torch import config as C  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.data import pipeline as D  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import modality as MOD  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.train import step as TS  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCH = "qwen2-vl-7b"
B, S = 2, 32                  # 16 patches (a 4 x 4 grid) + 16 text tokens
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
        elif key in ("gamma", "bq", "bk", "bv"):
            tree[key] = rng.normal(0.0, 0.2, val.shape).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def pair():
    """(reference config, reference model, port model, numpy weights)."""
    jcfg = JC.get_config(ARCH, reduced=True).replace(dtype="float32",
                                                     attn_impl="xla")
    jm = jax_build(jcfg)
    tree = _randomise(jax.tree.map(
        np.asarray, JL.unbox(jax.jit(jm.init)(jax.random.key(0)))),
        np.random.default_rng(0))
    cfg = C.get_config(ARCH, reduced=True).replace(dtype="float32",
                                                   attn_impl="torch")
    return SimpleNamespace(jcfg=jcfg, jm=jm, model=build_model(cfg, "cpu"),
                           tree=tree)


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x)


def _jnp(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


# ---------------------------------------------------------------------------
# data and positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batches_are_the_reference_arrays(dtype):
    """The same numpy draws in the same order: tokens, patch embeddings
    (x 0.02, cast to ``cfg.dtype``), labels (B, S); the M-RoPE positions
    from ``modality``. Single batches, the global batch and a shard."""
    jcfg = JC.get_config(ARCH, True).replace(dtype=dtype)
    cfg = C.get_config(ARCH, True).replace(dtype=dtype)
    pairs = [(D.make_batch(cfg, 3, 40, seed=7, step=11, device="cpu"),
              JD.make_batch(jcfg, 3, 40, seed=7, step=11))]
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
            np.testing.assert_array_equal(_np(got[key]), _jnp(want[key]),
                                          err_msg=key)
        assert got["patch_embeds"].dtype == L.torch_dtype(dtype)
        for key in ("tokens", "mrope_positions", "labels"):
            assert got[key].dtype == torch.int64
    assert tuple(pairs[0][0]["labels"].shape) == (3, 40)


@pytest.mark.parametrize("seq_len", [2, 5, 32, 40, 100, 2048])
def test_splits_and_mrope_positions(seq_len):
    jcfg, cfg = JC.get_config(ARCH, True), C.get_config(ARCH, True)
    assert MOD.vlm_split(cfg, seq_len) == JMOD.vlm_split(jcfg, seq_len)
    assert MOD.encdec_split(cfg, seq_len) == JMOD.encdec_split(jcfg, seq_len)
    got = MOD.mrope_positions(cfg, 3, seq_len)
    assert got.dtype == torch.int64 and tuple(got.shape) == (3, seq_len, 3)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JMOD.mrope_positions(jcfg, 3, seq_len)))


def test_text_positions_start_at_the_grid_side():
    """Kept as in the reference: the text's (t, t, t) positions start at
    the grid side ``g``, not at the number of patches (B = 4, S = 2048:
    a 22 x 22 grid, text from 22)."""
    cfg = C.get_config(ARCH)
    n_img, n_txt = MOD.vlm_split(cfg, 2048)
    assert (n_img, n_txt) == (484, 1564)
    pos = MOD.mrope_positions(cfg, 4, 2048)
    assert pos[0, :n_img, 0].eq(0).all()
    assert int(pos[0, :n_img, 1:].max()) == 21
    assert pos[0, n_img].tolist() == [22, 22, 22]
    assert pos[0, -1].tolist() == [22 + n_txt - 1] * 3


@pytest.mark.parametrize("D_,sections", [(16, (4, 2, 2)),
                                         (128, (32, 16, 16))])
def test_apply_mrope_matches_and_splits_2_1_1(D_, sections):
    """apply_mrope against the reference's on the vlm's positions, in
    float32 and in bf16 (angles float32, cast back to x's dtype); the
    frequency channels follow t, h and w in sections 2:1:1."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 40, 3, D_)).astype(np.float32)
    pos = MOD.mrope_positions(C.get_config(ARCH, True), 2, 40)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        got = L.apply_mrope(torch.tensor(x).to(dt), pos, 1e6)
        want = JL.apply_mrope(jnp.asarray(x, jdt), jnp.asarray(pos.numpy()),
                              1e6)
        assert got.dtype == dt
        np.testing.assert_allclose(_np(got), _jnp(want), atol=1e-5,
                                   rtol=1e-5)
    # a position on one axis alone turns only that axis's section
    half, starts = D_ // 2, np.cumsum((0,) + sections)
    for axis in range(3):
        thw = torch.zeros(1, 1, 3, dtype=torch.int64)
        thw[..., axis] = 5
        out = L.apply_mrope(torch.tensor(x[:1, :1]), thw, 1e6)
        moved = (out - torch.tensor(x[:1, :1])).abs().amax(dim=(0, 1, 2))
        turned = (moved[:half] > 0) | (moved[half:] > 0)
        want = torch.zeros(half, dtype=torch.bool)
        want[starts[axis]:starts[axis + 1]] = True
        assert torch.equal(turned, want), axis


def test_decode_rope_is_mrope_on_the_diagonal():
    """Kept as in the reference: the decode cell rotates text tokens by
    1-D RoPE at the cache index, which is M-RoPE at (t, t, t)."""
    x = torch.tensor(np.random.default_rng(4).normal(
        size=(3, 1, 4, 128)).astype(np.float32))
    pos = torch.tensor([[0], [22], [1563]])
    torch.testing.assert_close(
        L.apply_rope(x, pos, 1e6),
        L.apply_mrope(x, pos[..., None].expand(3, 1, 3), 1e6),
        rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the forward
# ---------------------------------------------------------------------------

def _batch(pair, seed=1):
    return (D.make_batch(pair.model.cfg, B, S, seed=seed, device="cpu"),
            JD.make_batch(pair.jcfg, B, S, seed=seed))


@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
def test_apply_matches_reference_forward(pair, ref_impl):
    jcfg = pair.jcfg.replace(attn_impl=ref_impl)
    batch, jbatch = _batch(pair)
    jlogits, jaux = jax.jit(lambda p, b: JT.forward(p, jcfg, b))(
        _j(pair.tree), jbatch)
    params = params_from_numpy(pair.tree, pair.model.cfg, "cpu",
                               dtype=torch.float32)
    with torch.no_grad():
        logits, aux = pair.model.apply(params, batch)
    assert logits.shape == (B, S, jcfg.vocab_size)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               rtol=1e-5, atol=1e-4)
    assert float(aux) == float(jaux) == 0


def test_forward_uses_mrope_not_1d_positions(pair):
    """Moving a patch's (h, w) coordinates changes the logits: the
    forward rotates by the batch's M-RoPE positions."""
    batch, _ = _batch(pair)
    params = params_from_numpy(pair.tree, pair.model.cfg, "cpu",
                               dtype=torch.float32)
    moved = dict(batch, mrope_positions=batch["mrope_positions"].clone())
    moved["mrope_positions"][:, 3, 1:] += 7
    with torch.no_grad():
        a = pair.model.apply(params, batch)[0]
        b = pair.model.apply(params, moved)[0]
    assert not torch.allclose(a, b)
    torch.testing.assert_close(a[:, :3], b[:, :3], rtol=0, atol=0)


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


def test_loss_masks_the_image_prefix(pair):
    """``loss_fn`` equals the reference's; the labels of the image prefix
    do not move it, the text's do."""
    jt, tc = _tcfgs()
    batch, jbatch = _batch(pair, seed=2)
    params = params_from_numpy(pair.tree, pair.model.cfg, "cpu",
                               dtype=torch.float32)
    jtotal, _ = JTS.loss_fn(pair.jm, _j(pair.tree), jbatch, jt)
    n_img, _ = MOD.vlm_split(pair.model.cfg, S)
    w = TS._token_weights(pair.model.cfg, batch, S)
    assert w.shape == (1, S) and w[0, :n_img].eq(0).all() \
        and w[0, n_img:].eq(1).all()
    with torch.no_grad():
        total, met = TS.loss_fn(pair.model, params, batch, tc)
        img = dict(batch, labels=batch["labels"].clone())
        img["labels"][:, :n_img] = (img["labels"][:, :n_img] + 1) % 512
        txt = dict(batch, labels=batch["labels"].clone())
        txt["labels"][:, n_img] = (txt["labels"][:, n_img] + 1) % 512
        same = TS.loss_fn(pair.model, params, img, tc)[0]
        other = TS.loss_fn(pair.model, params, txt, tc)[0]
    assert _rel(total, jtotal) < 1e-5
    assert float(same) == float(total) and float(other) != float(total)
    assert float(met["aux"]) == 0


def test_train_step_gradients_match(pair):
    """One AdamW step: loss, gradient norm and the first moment (0.1 x
    the clipped gradient: every gradient), the prefix masked."""
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


def test_launch_train_cli_on_cpu():
    out = launch_train.main(["--device", "cpu", "--arch", ARCH, "--steps",
                             "3", "--global-batch", "4", "--seq-len", "32"])
    assert out["final_step"] == 3 and out["arch"] == ARCH
    assert len(out["losses"]) == 3
    assert all(math.isfinite(x) for x in out["losses"] + out["grad_norms"])
    assert abs(out["losses"][0] - math.log(512)) < 1.0


# ---------------------------------------------------------------------------
# serving (text only, through the dense decode cell)
# ---------------------------------------------------------------------------

def _engines(pair, cache_impl):
    model = pair.model
    params = params_from_numpy(pair.tree, model.cfg, "cpu")
    kw = dict(max_batch=3, max_len=MAX_LEN, prefill_block=4,
              cache_impl=cache_impl)
    if cache_impl == "paged":
        kw["page_size"] = PAGE
    jm = jax_build(pair.jcfg.replace(attn_impl="pallas"))
    return (SimpleNamespace(make=lambda: ServeEngine(model, params, **kw),
                            Request=Request),
            SimpleNamespace(make=lambda: JEngine(jm, _j(pair.tree), **kw),
                            Request=JRequest))


def _serve(side, vocab, drain):
    """Five requests on three slots; with ``drain``, the first engine is
    warned mid-decode and its longer requests finish on a second one."""
    rng = np.random.default_rng(0)
    reqs = [side.Request(rid=i, prompt=rng.integers(1, vocab, size=(n,))
                         .tolist(), max_new_tokens=8)
            for i, n in enumerate((5, 13, 9, 3, 7))]
    eng = side.make()
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
    else:
        eng.run_to_completion()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs]


@pytest.mark.parametrize("cache_impl", ["dense", "paged"])
def test_greedy_tokens_match_reference_engine(pair, cache_impl):
    """Greedy tokens token for token: the port's engine against the
    reference's (its decode kernel in interpret mode), undisturbed and
    through a drain onto a second engine."""
    vocab = pair.model.cfg.vocab_size
    port, ref = _engines(pair, cache_impl)
    want = _serve(ref, vocab, drain=False)
    got = _serve(port, vocab, drain=False)
    assert got == want and all(len(t) == 8 for t in got)
    assert _serve(port, vocab, drain=True) == want


def test_cache_axes_match_reference(pair):
    from repro.models.builder import cache_batch_axes as jax_axes
    from repro.models.builder import paged_cache_axes as jax_paged_axes
    from repro_torch.models.builder import (cache_batch_axes,
                                            paged_cache_axes)
    assert cache_batch_axes(pair.model, 8) == jax_axes(pair.jm, 8)
    assert paged_cache_axes(pair.model, 8) == jax_paged_axes(pair.jm, 8)


def test_launch_serve_cli_on_cpu():
    out = launch_serve.main(["--device", "cpu", "--arch", ARCH,
                             "--requests", "3", "--max-batch", "2",
                             "--max-len", "32", "--max-new-tokens", "4"])
    assert out["arch"] == ARCH and out["completed"] == 3
    assert out["tokens_decoded"] == 12 and out["attn_impl"] == "torch"


def test_full_width_parameter_count():
    """Summing ``numel`` over a meta-device init gives the reference's
    analytic count, 7.615 B parameters (15.23 GB in bf16), which leaves
    out the RMS gammas and QKV biases: 333,312 more in all."""
    leaves = list(tree_leaves(T.init_params(C.get_config(ARCH), None,
                                            torch.device("meta"))))
    small = ("gamma", "bq", "bk", "bv")
    weights = sum(t.numel() for p, t in leaves
                  if p.split("/")[-1] not in small)
    assert weights == JC.get_config(ARCH).param_count() == 7_615_283_200
    assert sum(t.numel() for _, t in leaves) - weights == 333_312
