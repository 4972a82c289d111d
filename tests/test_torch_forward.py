"""The port's full-sequence forward, ``Model.apply``, against the JAX
package's ``forward`` on the four reduced dense configs in float32, with
the reference's attention both ``"xla"`` (its q-chunked path) and
``"pallas"`` (the flash kernel in interpret mode). The port runs its
plain path (``attn_impl="torch"``); the CUDA kernel needs the card.

The reference's initial weights, with seeded nonzero biases and RMS
gammas (zero at init in both packages, which would hide a bias or
``1 + gamma`` bug), are bridged into the port as float32 masters. Tokens
are drawn with numpy. ``attn_chunk=16`` makes the chunk loop run twice
at S=32; gemma3's reduced window of 16 masks its local layers.

Tolerance: logits 1e-4 absolute + 1e-5 relative (float32; summation
order only).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.config import get_config as jax_config  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.models.builder import build_model as jax_build  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

ARCHS = ("starcoder2-3b", "qwen2.5-14b", "granite-20b", "gemma3-27b")
B, S = 2, 32


def randomise_zero_inits(tree, rng):
    """Give biases and gammas seeded nonzero values, in place."""
    for key, val in tree.items():
        if isinstance(val, dict):
            randomise_zero_inits(val, rng)
        elif key in ("gamma", "bq", "bk", "bv"):
            tree[key] = rng.normal(0.0, 0.2, val.shape).astype(np.float32)
    return tree


def reference_tree(arch, seed=0):
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32")
    tree = jax.tree.map(np.asarray,
                        JL.unbox(jax_build(jcfg).init(jax.random.key(seed))))
    return randomise_zero_inits(tree, np.random.default_rng(seed))


def port_model(arch, **kw):
    cfg = get_config(arch, reduced=True).replace(dtype="float32",
                                                 attn_impl="torch", **kw)
    return build_model(cfg, "cpu")


def tokens(vocab, seed=1):
    return np.random.default_rng(seed).integers(0, vocab, size=(B, S))


@pytest.mark.parametrize("chunk", [1024, 16])
@pytest.mark.parametrize("ref_impl", ["xla", "pallas"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_matches_reference_forward(arch, ref_impl, chunk):
    tree = reference_tree(arch)
    jcfg = jax_config(arch, reduced=True).replace(
        dtype="float32", attn_impl=ref_impl, attn_chunk=chunk)
    tok = tokens(jcfg.vocab_size)
    jlogits, jaux = jax.jit(
        lambda p, t: JT.forward(p, jcfg, {"tokens": t}))(
            jax.tree.map(jnp.asarray, tree), jnp.asarray(tok, jnp.int32))

    model = port_model(arch, attn_chunk=chunk)
    params = params_from_numpy(tree, model.cfg, "cpu", dtype=torch.float32)
    with torch.no_grad():
        logits, aux = model.apply(params, {"tokens": torch.tensor(tok)})
    want = np.asarray(jlogits)
    assert logits.shape == want.shape == (B, S, model.cfg.vocab_size)
    assert logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want, rtol=1e-5, atol=1e-4)
    assert aux.dtype == torch.float32 and aux.shape == () and float(aux) == 0
    assert float(jaux) == 0


@pytest.mark.parametrize("arch", ["starcoder2-3b", "gemma3-27b"])
def test_remat_on_and_off_agree(arch):
    """Recomputing each layer in the backward changes nothing: the same
    logits and the same gradients."""
    model = port_model(arch, attn_chunk=16)
    params = params_from_numpy(reference_tree(arch), model.cfg, "cpu",
                               dtype=torch.float32)
    batch = {"tokens": torch.tensor(tokens(model.cfg.vocab_size))}
    outs = []
    for remat in (True, False):
        tree = tree_map(lambda t: t.detach().requires_grad_(), params)
        logits, _ = model.apply(tree, batch, remat=remat)
        grads = torch.autograd.grad(logits.square().mean(),
                                    [t for _, t in tree_leaves(tree)])
        outs.append((logits.detach(), grads))
    (l1, g1), (l2, g2) = outs
    assert torch.equal(l1, l2)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_bf16_serving_weights_and_fp32_masters_agree():
    """Weights cast at use: float32 masters with bf16 activations give the
    logits of the same weights stored in bf16 (the serving layout)."""
    arch = "qwen2.5-14b"
    tree = reference_tree(arch)
    cfg = get_config(arch, reduced=True).replace(attn_impl="torch")
    model = build_model(cfg, "cpu")
    tok = {"tokens": torch.tensor(tokens(cfg.vocab_size))}
    with torch.no_grad():
        stored = model.apply(params_from_numpy(tree, cfg, "cpu"), tok)[0]
        masters = model.apply(params_from_numpy(tree, cfg, "cpu",
                                                dtype=torch.float32), tok)[0]
    assert stored.dtype == masters.dtype == torch.bfloat16
    assert torch.equal(stored, masters)


@pytest.mark.parametrize("family", ["audio", "diffusion"])
def test_apply_refuses_families_not_ported(family):
    """Every family of the reference is ported; a family it does not know
    raises ValueError, as its ``init_params`` does."""
    cfg = get_config("starcoder2-3b", reduced=True).replace(family=family)
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg, "cpu")
