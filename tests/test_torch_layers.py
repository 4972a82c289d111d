"""Building blocks of the PyTorch port against the JAX package's, on the
same numpy inputs: norms, rotary embeddings, MLPs, embeddings,
projections, the cache write, configs and parameter layout.

Tolerance: float32 1e-5 absolute and relative (the same arithmetic in
another library's kernels; results agree to a few ulps)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as jax_config  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import ffn as JF  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.builder import build_model as jax_build  # noqa: E402
from repro.models.builder import cache_batch_axes as jax_axes  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import (PORT_ONLY_FIELDS, ModelConfig,  # noqa: E402
                                get_config, list_archs, reference_block)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import ffn as F  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.builder import build_model, cache_batch_axes  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

TOL = dict(atol=1e-5, rtol=1e-5)
ARCHS = ("starcoder2-3b", "qwen2.5-14b", "granite-20b", "gemma3-27b",
         "moonshot-v1-16b-a3b", "arctic-480b", "zamba2-1.2b", "rwkv6-7b",
         "qwen2-vl-7b", "seamless-m4t-large-v2", "resnet32-cifar10")
# implementation selectors: the port's are "cuda" | "torch", the
# reference's "xla" | "pallas"
IMPLS = ("attn_impl", "ssm_impl", "rwkv_impl")
RNG = np.random.default_rng(0)


def _n(*shape, scale=1.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


def test_rms_norm_nonzero_gamma():
    x, g = _n(2, 3, 64, scale=3.0), _n(64, scale=0.5)
    _close(L.rms_norm(torch.tensor(x), torch.tensor(g), 1e-5),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5))


@pytest.mark.parametrize("theta", [1e4, 1e6])
def test_apply_rope(theta):
    x = _n(2, 5, 4, 16)
    pos = np.array([[3], [11]], np.int32)              # decode: (B, 1)
    xs = _n(2, 1, 4, 16)
    _close(L.apply_rope(torch.tensor(xs), torch.tensor(pos), theta),
           JL.apply_rope(jnp.asarray(xs), jnp.asarray(pos), theta))
    seq = np.arange(5)[None, :]                        # prefill: (1, S)
    _close(L.apply_rope(torch.tensor(x), torch.tensor(seq), theta),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(seq), theta))


@pytest.mark.parametrize("gated", [False, True])
def test_apply_mlp(gated):
    p = {"wi": _n(64, 256, scale=0.2), "wo": _n(256, 64, scale=0.1)}
    if gated:
        p["wg"] = _n(64, 256, scale=0.2)
    x = _n(3, 1, 64)
    _close(F.apply_mlp({k: torch.tensor(v) for k, v in p.items()},
                       torch.tensor(x)),
           JF.apply_mlp({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x)))


@pytest.mark.parametrize("tie", [False, True])
def test_embed_unembed(tie):
    p = {"tok": _n(50, 32)}
    if not tie:
        p["out"] = _n(32, 50, scale=0.2)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tok = np.array([[1], [49], [7]])
    _close(L.embed(tp, torch.tensor(tok)),
           JL.embed(jp, jnp.asarray(tok), jnp.float32))
    x = _n(3, 1, 32)
    _close(L.unembed(tp, torch.tensor(x), tie),
           JL.unembed(jp, jnp.asarray(x), tie))


def test_project_qkv_with_bias_and_out_proj():
    jcfg = jax_config("qwen2.5-14b", reduced=True).replace(dtype="float32")
    cfg = get_config("qwen2.5-14b", reduced=True).replace(dtype="float32")
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": _n(d, H, Dh, scale=0.1), "wk": _n(d, KV, Dh, scale=0.1),
         "wv": _n(d, KV, Dh, scale=0.1), "wo": _n(H, Dh, d, scale=0.1),
         "bq": _n(H, Dh), "bk": _n(KV, Dh), "bv": _n(KV, Dh)}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    x = _n(3, 1, d)
    pos = np.array([[0], [5], [17]], np.int32)
    got = A.project_qkv(tp, torch.tensor(x), cfg, positions=torch.tensor(pos))
    want = JA.project_qkv(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w)
    att = _n(3, 1, H, Dh)
    _close(A.out_proj(tp, torch.tensor(att)),
           JA.out_proj(jp, jnp.asarray(att)))


def test_update_cache_drops_rows_past_the_cache():
    """A row at pos >= Smax writes nothing, as JAX's scatter drops it;
    in particular position Smax-1 keeps its value."""
    B, S, KV, D = 4, 6, 2, 8
    kc, vc = _n(B, S, KV, D), _n(B, S, KV, D)
    kn, vn = _n(B, 1, KV, D), _n(B, 1, KV, D)
    pos = np.array([0, 5, 6, 9], np.int32)
    tk, tv = torch.tensor(kc), torch.tensor(vc)
    A.update_cache(tk, tv, torch.tensor(kn), torch.tensor(vn),
                   torch.tensor(pos))
    jk, jv = JA.update_cache(jnp.asarray(kc), jnp.asarray(vc),
                             jnp.asarray(kn), jnp.asarray(vn),
                             jnp.asarray(pos))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tk[2:].numpy(), kc[2:])


@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch, reduced):
    """Every field the port keeps means the same as in repro.config; the
    port's own fields (rwkv6-7b's Finch time mix) are at their defaults,
    the reference's block, except in full-width rwkv6-7b."""
    port = get_config(arch, reduced)
    cfg, ref = reference_block(port), jax_config(arch, reduced)
    for f in dataclasses.fields(ModelConfig):
        if f.name not in IMPLS + PORT_ONLY_FIELDS:
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert (port == cfg) is (reduced or arch != "rwkv6-7b")
    assert cfg.kv_groups == ref.kv_groups
    assert cfg.ssm_d_inner == ref.ssm_d_inner
    assert [cfg.is_global_layer(i) for i in range(cfg.num_layers)] == \
        [ref.is_global_layer(i) for i in range(ref.num_layers)]
    assert set(ARCHS) == set(list_archs())


def test_full_width_parameter_layout():
    """The port's parameter tree for full-width starcoder2-3b (the model
    the card serves) has the reference's keys and shapes (both built
    without allocating)."""
    arch = "starcoder2-3b"
    ref = jax_build(jax_config(arch)).abstract_params()
    want = {p: tuple(b.value.shape) for p, b in tree_leaves(
        jax.tree.map(lambda b: b, ref, is_leaf=JL.is_boxed))}
    got = T.init_params(get_config(arch), None, torch.device("meta"))
    assert {p: tuple(x.shape) for p, x in tree_leaves(got)} == want


@pytest.mark.parametrize("arch", [a for a in ARCHS if a not in (
    "starcoder2-3b", "resnet32-cifar10")])
def test_full_width_parameter_layout_of_every_family(arch):
    """The other transformer configs' full-width trees, moonshot's
    ``dense_layers`` and ``moe`` leaves included, have the reference's
    keys and shapes (both built without allocating); rwkv6-7b's with
    the reference's block (``reference_block``: no Finch time mix)."""
    ref = jax_build(jax_config(arch)).abstract_params()
    want = {p: tuple(b.value.shape) for p, b in tree_leaves(
        jax.tree.map(lambda b: b, ref, is_leaf=JL.is_boxed))}
    got = T.init_params(reference_block(get_config(arch)), None,
                        torch.device("meta"))
    assert {p: tuple(x.shape) for p, x in tree_leaves(got)} == want


def _stack_by_list(init_fn, n):
    """The stacking ``transformer._stack`` replaced: every layer drawn
    into a list, then each leaf ``torch.stack``ed."""
    return tree_map(lambda *xs: torch.stack(xs),
                    *[init_fn() for _ in range(n)])


@pytest.mark.parametrize("arch", [a for a in ARCHS
                                  if a != "resnet32-cifar10"])
def test_preallocated_stack_gives_the_listed_stack(arch, monkeypatch):
    """Seed 0 gives bit for bit the parameters it gave when every layer
    was drawn into a list and stacked: the same draws in the same order,
    in cfg.dtype and in float32."""
    cfg = get_config(arch, reduced=True)
    for dtype in (None, torch.float32):
        gen = torch.Generator().manual_seed(0)
        new = T.init_params(cfg, gen, torch.device("cpu"), dtype)
        with monkeypatch.context() as m:
            m.setattr(T, "_stack", _stack_by_list)
            gen = torch.Generator().manual_seed(0)
            old = T.init_params(cfg, gen, torch.device("cpu"), dtype)
        got, want = dict(tree_leaves(new)), dict(tree_leaves(old))
        assert got.keys() == want.keys()
        for path, t in want.items():
            assert got[path].dtype == t.dtype and got[path].is_contiguous()
            assert torch.equal(got[path], t), path


def test_port_init_statistics_and_dtypes():
    cfg = get_config("starcoder2-3b", reduced=True)
    model = build_model(cfg, "cpu")
    p = model.init(model.generator(0))
    assert p["layers"]["attn"]["wq"].dtype == torch.bfloat16
    assert p["layers"]["ln1"]["gamma"].dtype == torch.float32
    assert torch.all(p["layers"]["ln1"]["gamma"] == 0)
    assert torch.all(p["layers"]["attn"]["bq"] == 0)
    assert abs(p["embed"]["tok"].float().std().item() - 1.0) < 0.05
    wi = p["layers"]["mlp"]["wi"].float()
    assert abs(wi.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.05
    again = model.init(model.generator(0))
    assert torch.equal(again["embed"]["out"], p["embed"]["out"])


def test_bridge_casts_and_checks_the_tree():
    """Weights land in cfg.dtype (rounded as jnp rounds them), gammas in
    float32; a tree of the wrong structure is refused. The decode parity
    tests bridge the reference's own initialised trees."""
    cfg = get_config("gemma3-27b", reduced=True)
    like = T.init_params(cfg, None, torch.device("meta"))
    tree = {}
    for path, x in tree_leaves(like):
        *parents, leaf = path.split("/")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = _n(*x.shape)
    p = params_from_numpy(tree, cfg, "cpu")
    np.testing.assert_array_equal(
        p["embed"]["tok"].float().numpy(),
        np.asarray(jnp.asarray(tree["embed"]["tok"], jnp.bfloat16),
                   np.float32))
    np.testing.assert_array_equal(p["final_norm"]["gamma"].numpy(),
                                  tree["final_norm"]["gamma"])
    del tree["final_norm"]
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(tree, cfg, "cpu")
    tree["final_norm"] = {"gamma": _n(cfg.d_model + 1)}
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(tree, cfg, "cpu")


def test_cache_batch_axes_match_the_reference():
    cfg = get_config("gemma3-27b", reduced=True)
    jm = jax_build(jax_config("gemma3-27b", reduced=True))
    assert cache_batch_axes(build_model(cfg, "cpu"), 8) == jax_axes(jm, 8)
