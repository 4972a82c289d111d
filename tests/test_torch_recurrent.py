"""The port's recurrent families, reduced zamba2-1.2b (hybrid: Mamba-2 SSD
backbone with a shared attention block) and rwkv6-7b (RWKV-6 WKV),
against the JAX package in float32 on the CPU:

- ``Model.apply`` logits against the reference ``forward``. The port's
  ``"torch"`` impls (the chunked SSD form, the sequential WKV scan) are
  held to the reference's ``"xla"`` path; the port's ``"cuda"`` impls,
  which on CPU tensors take the kernels' plain versions (the sequential
  recurrences), are held to the reference's ``"pallas"`` path (interpret
  mode). S=32 runs two of zamba2's 16-token chunks; S=24 is ragged, where
  the reference falls back to one chunk of S;
- several ``decode_step``s: logits and every cache leaf;
- the blocked prefill with a frozen row: every recurrent leaf of the
  frozen row is left as it was;
- ``cache_batch_axes`` against the reference's;
- engine greedy tokens through both prefill modes, ``revoke_slot``,
  ``hard_revoke`` and a drain migration, token for token.
- reduced rwkv6-7b's time-mix in bf16 (r, k and v reach the WKV
  recurrence in bf16), against the reference's in bf16 (tolerance in
  the test).

The reference's zero- and one-initialised leaves (RMS gammas, the gated
norm, ``ln_x``, ``conv_b``, ``A_log``, ``dt_bias``, ``D``, ``w0``) get
seeded nonzero values first, so that a missing ``1 + gamma`` or a
dropped bias shows.

Tolerances (float32; the two differ in summation order only): logits
2e-4 absolute + 1e-5 relative (zamba2's chunked and sequential SSD forms
sum the same terms in another order, and logits reach ~30); caches 1e-5
absolute + 1e-5 relative; greedy tokens exact.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.builder import build_model as jax_build  # noqa: E402
from repro.models.builder import cache_batch_axes as jax_axes  # noqa: E402
from repro.serving import Request as JaxRequest  # noqa: E402
from repro.serving import ServeEngine as JaxEngine  # noqa: E402
from repro.train.step import make_prefill_step as jax_prefill  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config, reference_block  # noqa: E402
from repro_torch.models.builder import build_model, cache_batch_axes  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402
from repro_torch.train.step import make_prefill_step  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ARCHS = ("zamba2-1.2b", "rwkv6-7b")
RANDOMISED = ("gamma", "norm", "ln_x", "conv_b", "A_log", "dt_bias", "D",
              "w0")
B, MAX_LEN = 3, 20


def randomise_zero_inits(tree, rng):
    for key, val in tree.items():
        if isinstance(val, dict):
            randomise_zero_inits(val, rng)
        elif key in RANDOMISED:
            tree[key] = (val + rng.normal(0.0, 0.2, val.shape)).astype(
                np.float32)
    return tree


def reference(arch, **impls):
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32", **impls)
    jm = jax_build(jcfg)
    tree = jax.tree.map(np.asarray, JL.unbox(jm.init(jax.random.key(0))))
    return jcfg, jm, randomise_zero_inits(tree, np.random.default_rng(0))


def port(arch, impl="torch"):
    cfg = get_config(arch, reduced=True).replace(
        dtype="float32", attn_impl="torch", ssm_impl=impl, rwkv_impl=impl)
    return build_model(cfg, "cpu")


def leaves(tree):
    return dict(tree_leaves(tree))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [32, 24])
@pytest.mark.parametrize("port_impl,ref_impl", [("torch", "xla"),
                                                ("cuda", "pallas")])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_reference_forward(arch, port_impl, ref_impl, S):
    jcfg, _, tree = reference(arch, attn_impl="xla", ssm_impl=ref_impl,
                              rwkv_impl=ref_impl)
    tok = np.random.default_rng(1).integers(0, jcfg.vocab_size, size=(2, S))
    jlogits, _ = jax.jit(lambda p, t: JT.forward(p, jcfg, {"tokens": t}))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(tok, jnp.int32))
    model = port(arch, port_impl)
    params = params_from_numpy(tree, model.cfg, "cpu", dtype=torch.float32)
    with torch.no_grad():
        logits, aux = model.apply(params, {"tokens": torch.tensor(tok)})
    assert logits.shape == (2, S, jcfg.vocab_size)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                               atol=2e-4, rtol=1e-5)


@pytest.mark.parametrize("port_impl,ref_impl", [("torch", "xla"),
                                                ("cuda", "pallas")])
def test_rwkv_tmix_bf16_matches_reference(port_impl, ref_impl):
    """Reduced rwkv6-7b's time-mix in bf16, r, k and v handed to the WKV
    recurrence in bf16 (the port widens them inside it, the reference
    casts them first), against the reference's ``apply_tmix`` in bf16 on
    the same bridged weights, a nonzero initial state and S = 40.

    Tolerance: the output 2^-5 x (|ref| + rms(ref)), four bf16 ulps: the
    two frameworks round the bf16 work around the recurrence (lerps, the
    decay's LoRA, the norm and the gate) at different places, which moves
    this output by up to ~0.9 of two ulps; the final state (float32) 1e-4
    x (1 + |ref|); the last token exactly."""
    from repro.models import rwkv as JR
    from repro_torch.models import rwkv as PR
    from repro_torch.tree import tree_map
    jcfg, _, tree = reference("rwkv6-7b", attn_impl="xla", ssm_impl=ref_impl,
                              rwkv_impl=ref_impl)
    jcfg = jcfg.replace(dtype="bfloat16")
    cfg = get_config("rwkv6-7b", reduced=True).replace(
        dtype="bfloat16", attn_impl="torch", ssm_impl="torch",
        rwkv_impl=port_impl)
    tmix = tree_map(lambda t: t[0], params_from_numpy(tree, cfg, "cpu")[
        "layers"]["tmix"])
    jtmix = jax.tree.map(lambda a: jnp.asarray(a[0]),
                         tree["layers"]["tmix"])
    Bt, S, d = 2, 40, jcfg.d_model
    H, Dh = d // jcfg.rwkv_head_dim, jcfg.rwkv_head_dim
    rng = np.random.default_rng(3)
    x = rng.standard_normal((Bt, S, d)).astype(np.float32)
    s0 = rng.standard_normal((Bt, H, Dh, Dh)).astype(np.float32)
    jout, jlast, jstate = JR.apply_tmix(
        jtmix, jnp.asarray(x, jnp.bfloat16), jcfg,
        jnp.zeros((Bt, 1, d), jnp.bfloat16), jnp.asarray(s0))
    with torch.no_grad():
        out, last, state = PR.apply_tmix(
            tmix, torch.tensor(x).bfloat16(), cfg,
            torch.zeros(Bt, 1, d, dtype=torch.bfloat16), torch.tensor(s0))
    assert out.dtype == torch.bfloat16 and state.dtype == torch.float32
    want = np.asarray(jout.astype(jnp.float32))
    ref = np.abs(want)
    bound = 2 ** -5 * (ref + np.sqrt(np.mean(want ** 2)))
    assert (np.abs(out.float().numpy() - want) <= bound).all()
    np.testing.assert_array_equal(last.float().numpy(),
                                  np.asarray(jlast.astype(jnp.float32)))
    want_s = np.asarray(jstate)
    assert (np.abs(state.numpy() - want_s)
            <= 1e-4 * (1 + np.abs(want_s))).all()


@pytest.mark.parametrize("arch", ARCHS)
def test_full_width_parameter_and_cache_layout(arch):
    """At the published widths the port's parameter tree has the
    reference's keys and shapes, and its decode cache the reference's
    keys, shapes and dtypes (all built without allocating); rwkv6-7b
    with the reference's block (``reference_block``: no Finch leaves)."""
    from repro_torch.models import transformer as T
    jm = jax_build(jax_config(arch))
    want = {p: tuple(b.value.shape) for p, b in tree_leaves(
        jax.tree.map(lambda b: b, jm.abstract_params(), is_leaf=JL.is_boxed))}
    got = T.init_params(reference_block(get_config(arch)), None,
                        torch.device("meta"))
    assert {p: tuple(x.shape) for p, x in tree_leaves(got)} == want
    jcache = jax.eval_shape(lambda: jm.init_cache(4, 512))
    cache = build_model(get_config(arch), "cpu").init_cache(
        4, 512, device=torch.device("meta"))
    assert {p: (tuple(x.shape), str(x.dtype).split(".")[-1])
            for p, x in tree_leaves(cache)} == \
        {p: (tuple(x.shape), str(x.dtype)) for p, x in tree_leaves(jcache)}


def test_serving_weights_store_recurrent_leaves_in_float32():
    """Weights stored in bf16 for serving, except the leaves the reference
    reads in float32."""
    f32 = {"A_log", "dt_bias", "norm", "gamma", "mix_r", "mix_k", "mix_v",
           "mix_g", "mix_w", "w0", "u", "ln_x"}
    for arch in ARCHS:
        model = build_model(get_config(arch, reduced=True), "cpu")
        for path, t in tree_leaves(model.init(model.generator(0))):
            want = torch.float32 if path.split("/")[-1] in f32 \
                else torch.bfloat16
            assert t.dtype == want, path


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

POS0 = np.array([0, 5, 11], np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def traces(request):
    arch = request.param
    jcfg, jm, tree = reference(arch, attn_impl="pallas")
    model = port(arch)
    params = params_from_numpy(tree, model.cfg, "cpu")
    jstep = jax.jit(lambda p, c, t: JT.decode_step(p, jcfg, c,
                                                   {"tokens": t}))
    jparams = jax.tree.map(jnp.asarray, tree)
    jcache = jm.init_cache(B, MAX_LEN)
    jcache["pos"] = jnp.asarray(POS0)
    cache = model.init_cache(B, MAX_LEN)
    cache["pos"] = torch.tensor(POS0)
    rng = np.random.default_rng(3)
    out = []
    for _ in range(5):
        tok = rng.integers(0, jcfg.vocab_size, size=(B, 1))
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32))
        with torch.no_grad():
            logits, cache = model.decode(params, cache,
                                         {"tokens": torch.tensor(tok)})
        out.append((logits.numpy(), np.asarray(jlogits)))
    return model, out, cache, jcache


def test_decode_logits_match(traces):
    _, steps, _, _ = traces
    for got, want in steps:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)


def test_decode_caches_match(traces):
    model, _, cache, jcache = traces
    got, want = leaves(cache), leaves(jax.tree.map(np.asarray, jcache))
    assert got.keys() == want.keys()
    for path, t in got.items():
        np.testing.assert_allclose(t.float().numpy(), want[path], atol=1e-5,
                                   rtol=1e-5, err_msg=path)
    assert any(np.abs(want[p]).max() > 0 for p in want if p != "pos")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax_and_freezes_rows(arch):
    """Blocked prefill with ragged ``n_valid`` (a frozen row, a row that
    stops mid-block, a full row) from a cache with nonzero state, against
    the reference's ``make_prefill_step`` (a per-leaf select after each
    cell): the same cache, and every leaf of the frozen row bit for bit
    as it was."""
    jcfg, jm, tree = reference(arch, attn_impl="xla")
    model = port(arch)
    params = params_from_numpy(tree, model.cfg, "cpu")
    rng = np.random.default_rng(2)
    start = jax.tree.map(
        lambda x: rng.normal(size=x.shape).astype(np.float32)
        if x.dtype != jnp.int32 else np.array([4, 0, 2], np.int32),
        jax.eval_shape(lambda: jm.init_cache(B, MAX_LEN)))
    tokens = rng.integers(0, jcfg.vocab_size, size=(B, 4))
    n_valid = np.array([0, 2, 4])
    jcache = jax.jit(jax_prefill(jm, jax_axes(jm, MAX_LEN)))(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, start),
        jnp.asarray(tokens, jnp.int32), jnp.asarray(n_valid))
    cache = jax.tree.map(torch.tensor, start)
    cache = make_prefill_step(model)(params, cache, torch.tensor(tokens),
                                     n_valid)
    axes = cache_batch_axes(model)
    got, want = leaves(cache), leaves(jax.tree.map(np.asarray, jcache))
    for path, ax in leaves(axes).items():
        np.testing.assert_allclose(got[path].numpy(), want[path], atol=1e-5,
                                   rtol=1e-5, err_msg=path)
        frozen = np.take(got[path].numpy(), 0, axis=ax)
        np.testing.assert_array_equal(frozen, np.take(leaves(start)[path], 0,
                                                      axis=ax), path)


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_batch_axes_match_reference(arch):
    _, jm, _ = reference(arch)
    model = port(arch)
    want = leaves(jax_axes(jm, max_len=8))
    assert leaves(cache_batch_axes(model, max_len=8)) == want
    if arch == "zamba2-1.2b":
        # (n_blocks, cadence, B, ...): batch is axis 2
        assert want["blocks/state"] == want["blocks/conv"] == 2


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=ARCHS)
def sides(request):
    arch = request.param
    jcfg, jm, tree = reference(arch, attn_impl="xla")
    jparams = jax.tree.map(jnp.asarray, tree)
    compiled = {}

    def make_jax(prefill="block"):
        eng = JaxEngine(jm, jparams, max_batch=3, max_len=MAX_LEN,
                        prefill=prefill, prefill_block=4,
                        shared_fns=compiled.get(prefill))
        compiled.setdefault(prefill, eng.shared_fns)
        return eng

    model = port(arch)
    params = params_from_numpy(tree, model.cfg, "cpu")

    def make_torch(prefill="block"):
        return ServeEngine(model, params, max_batch=3, max_len=MAX_LEN,
                           prefill=prefill, prefill_block=4)

    return {"jax": SimpleNamespace(make=make_jax, Request=JaxRequest),
            "torch": SimpleNamespace(make=make_torch, Request=Request)}


def _requests(side, plens, max_new, seed):
    rng = np.random.default_rng(seed)
    return [side.Request(rid=i, prompt=rng.integers(1, 512, size=(n,)).tolist(),
                         max_new_tokens=max_new)
            for i, n in enumerate(plens)]


def _waves(side, prefill):
    """More requests than slots: later prompts prefill while other rows
    decode, so the frozen rows' recurrent state must survive."""
    eng = side.make(prefill)
    reqs = _requests(side, [5, 3, 7, 6, 4], max_new=5, seed=0)
    for r in reqs:
        eng.submit(r)
    eng.run_to_completion()
    assert all(r.done for r in reqs)
    return [r.generated for r in reqs]


def _revocations(side):
    """``revoke_slot`` mid-decode (the row's state is reset for the
    restart), then a drain whose migrated requests finish on a second
    engine, then ``hard_revoke`` of a third."""
    eng = side.make()
    reqs = _requests(side, [5, 6, 4], max_new=6, seed=7)
    for r in reqs:
        eng.submit(r)
    while not all(len(r.generated) >= 2 for r in reqs):
        eng.step()
    lost = eng.revoke_slot(0)
    eng.step()
    migrated = eng.begin_drain(grace_tokens=0)
    dst = side.make()
    for r in migrated:
        assert dst.submit(r)
    eng.run_to_completion()
    dst.run_to_completion()
    third = side.make()
    extra = _requests(side, [4, 5], max_new=4, seed=11)
    for r in extra:
        third.submit(r)
    while not all(r is not None and r.generated for r in third.slots[:2]):
        third.step()
    displaced = third.hard_revoke()
    return ([r.generated for r in reqs], lost.rid, sorted(
        r.rid for r in migrated), eng.tokens_replayed, dst.tokens_replayed,
        sorted(r.rid for r in displaced), third.tokens_lost)


def test_block_and_token_prefill_match_jax(sides):
    want = _waves(sides["jax"], "block")
    assert _waves(sides["torch"], "block") == want
    assert _waves(sides["torch"], "token") == want
    assert _waves(sides["jax"], "token") == want


def test_revoke_drain_and_hard_revoke_match_jax(sides):
    got = _revocations(sides["torch"])
    assert got == _revocations(sides["jax"])
    undisturbed = sides["torch"].make()
    reqs = _requests(sides["torch"], [5, 6, 4], max_new=6, seed=7)
    for r in reqs:
        undisturbed.submit(r)
    undisturbed.run_to_completion()
    assert got[0] == [r.generated for r in reqs]
