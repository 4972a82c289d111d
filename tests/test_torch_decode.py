"""The port's decode cell against the JAX package's ``decode_step`` with
``attn_impl="pallas"`` (the decode kernel in interpret mode), on the
reference's own initial weights bridged into the port, for the four
reduced dense configs in float32.

Biases and RMS gammas are overwritten with seeded nonzero values first:
the reference initialises them to zero, which would hide a bias or
``1 + gamma`` bug. Rows start at staggered positions so that one row is
driven past ``max_len`` (its cache writes must be dropped, not clamped)
and gemma3's sliding window is exercised.

Tolerance: logits 1e-4 absolute + 1e-5 relative, caches 1e-5 (float32;
observed differences are ~2e-6 on logits of magnitude up to ~30)."""
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

ARCHS = ("starcoder2-3b", "qwen2.5-14b", "granite-20b", "gemma3-27b")
B, MAX_LEN, STEPS = 3, 20, 6
POS0 = np.array([0, 9, 17], np.int32)      # row 2 passes MAX_LEN at step 3


def randomise_zero_inits(tree, rng):
    """Give biases and gammas (zero at init in both packages) seeded
    nonzero values, in place on a numpy tree."""
    for key, val in tree.items():
        if isinstance(val, dict):
            randomise_zero_inits(val, rng)
        elif key in ("gamma", "bq", "bk", "bv"):
            tree[key] = rng.normal(0.0, 0.2, val.shape).astype(np.float32)
    return tree


def reference_tree(arch, seed=0):
    """The JAX package's initial parameters for ``arch`` (reduced,
    float32) as numpy, with nonzero biases and gammas."""
    jcfg = jax_config(arch, reduced=True).replace(dtype="float32",
                                                  attn_impl="pallas")
    jm = jax_build(jcfg)
    tree = jax.tree.map(np.asarray, JL.unbox(jm.init(jax.random.key(seed))))
    return jcfg, jm, randomise_zero_inits(tree, np.random.default_rng(seed))


@pytest.fixture(scope="module", params=ARCHS)
def traces(request):
    """Logits and caches of both packages over STEPS decode steps."""
    arch = request.param
    jcfg, jm, tree = reference_tree(arch)
    cfg = get_config(arch, reduced=True).replace(dtype="float32",
                                                 attn_impl="torch")
    model = build_model(cfg, "cpu")
    params = params_from_numpy(tree, cfg, "cpu")

    jparams = jax.tree.map(jnp.asarray, tree)
    jcache = jm.init_cache(B, MAX_LEN)
    jcache["pos"] = jnp.asarray(POS0)
    jstep = jax.jit(lambda p, c, t: JT.decode_step(p, jcfg, c,
                                                   {"tokens": t}))
    cache = model.init_cache(B, MAX_LEN)
    cache["pos"] = torch.tensor(POS0)

    rng = np.random.default_rng(1)
    out = []
    for _ in range(STEPS):
        tok = rng.integers(0, cfg.vocab_size, size=(B, 1))
        jlogits, jcache = jstep(jparams, jcache, jnp.asarray(tok, jnp.int32))
        with torch.no_grad():
            logits, cache = model.decode(params, cache,
                                         {"tokens": torch.tensor(tok)})
        out.append((logits.numpy(), np.asarray(jlogits)))
    return out, cache, jcache


def test_decode_logits_match(traces):
    steps, _, _ = traces
    for got, want in steps:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-5)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_prefill_step_matches_jax_and_freezes_rows():
    """The blocked prefill with ragged ``n_valid`` (a frozen decode row, a
    row that stops mid-block, a full row) against the reference's
    ``make_prefill_step`` (per-leaf select after the cell): the same
    cache, and the frozen row's cache left bit for bit as it was."""
    from repro.models.builder import cache_batch_axes as jax_axes
    from repro.train.step import make_prefill_step as jax_prefill
    from repro_torch.train.step import make_prefill_step

    arch = "starcoder2-3b"
    jcfg, jm, tree = reference_tree(arch)
    cfg = get_config(arch, reduced=True).replace(dtype="float32",
                                                 attn_impl="torch")
    model = build_model(cfg, "cpu")
    params = params_from_numpy(tree, cfg, "cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, cfg.vocab_size, size=(B, 4))
    n_valid = np.array([0, 2, 4])
    pos0 = np.array([5, 0, 3], np.int32)
    kv0 = rng.normal(size=(2, cfg.num_layers, B, MAX_LEN, cfg.num_kv_heads,
                           cfg.head_dim)).astype(np.float32)

    jcache = {"kv": {"k": jnp.asarray(kv0[0]), "v": jnp.asarray(kv0[1])},
              "pos": jnp.asarray(pos0)}
    jstep = jax.jit(jax_prefill(jm, jax_axes(jm, MAX_LEN)))
    jcache = jstep(jax.tree.map(jnp.asarray, tree), jcache,
                   jnp.asarray(tokens, jnp.int32), jnp.asarray(n_valid))

    cache = {"kv": {"k": torch.tensor(kv0[0]), "v": torch.tensor(kv0[1])},
             "pos": torch.tensor(pos0)}
    cache = make_prefill_step(model)(params, cache, torch.tensor(tokens),
                                     n_valid)
    np.testing.assert_array_equal(cache["pos"].numpy(), pos0 + n_valid)
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for i, leaf in enumerate(("k", "v")):
        got = cache["kv"][leaf].numpy()
        np.testing.assert_array_equal(got[:, 0], kv0[i][:, 0])
        np.testing.assert_allclose(got, np.asarray(jcache["kv"][leaf]),
                                   atol=1e-5, rtol=1e-5)


def test_decode_caches_match(traces):
    _, cache, jcache = traces
    np.testing.assert_array_equal(cache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert cache["pos"][2] > MAX_LEN              # driven past the cache
    for leaf in ("k", "v"):
        np.testing.assert_allclose(cache["kv"][leaf].numpy(),
                                   np.asarray(jcache["kv"][leaf]),
                                   atol=1e-5, rtol=1e-5)
