"""The port's RWKV-6 Finch time mix (``rwkv_mix_rank`` > 0: the
data-dependent token shift, the per-head GroupNorm ``ln_x``; the decay
LoRA at its own rank) on the CPU at a small size, and the reference's
block it leaves as it was at the defaults. No JAX: the JAX package has
no Finch block.

- A prefill over a prefix, then decode token by token through
  ``decode_tmix`` and ``decode_cmix`` (the block's state carried), gives
  the full sequence's time mix and channel mix; at the model's level, the
  blocked prefill and then ``Model.decode`` give the forward's logits.
- At the defaults the time mix is bit for bit the reference's block as
  the port computed it before the Finch fields existed (static sigmoid
  lerps, a rank-64 decay LoRA, an RMS ``ln_x``), and its tree holds the
  same leaves in the same order.
- The data-dependent lerps equal Finch's batched form (one LoRA output of
  5 x rank, each fifth through its own W2 by ``bmm``) in float64, and
  the per-head ``ln_x`` equals ``F.group_norm`` (its weight and bias as
  published).
- On the card (marked ``gpu``, skips without one): the ``rwkv_impl``
  "cuda" Finch forward (the WKV kernel) against "torch".

Tolerances: float32 paths that differ in summation order only, 1e-5
absolute + 1e-5 relative (logits 1e-4 absolute); float64 forms 1e-12.
"""
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch.config import get_config  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import rwkv as R  # noqa: E402
from repro_torch.models.builder import build_model  # noqa: E402
from repro_torch.train.step import make_prefill_step  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

FINCH = dict(rwkv_mix_rank=4, rwkv_decay_rank=8)
# leaves drawn at zero or around one: seeded nonzero, so that a missing
# bias, gain or decay term shows
RANDOMISED = ("gamma", "ln_x", "ln_x_bias", "w0")


def _cfg(impl="torch", dtype="float32", **kw):
    return get_config("rwkv6-7b", reduced=True).replace(
        dtype=dtype, attn_impl="torch", ssm_impl="torch", rwkv_impl=impl,
        **kw)


def _params(model, seed=0):
    params = model.init(model.generator(seed))
    g = torch.Generator().manual_seed(seed + 1)

    def bump(path, t):
        if path.split("/")[-1] in RANDOMISED:
            return t + 0.3 * torch.randn(t.shape, generator=g).to(t.dtype)
        return t
    flat = {p: bump(p, t) for p, t in tree_leaves(params)}
    return tree_map(lambda p: flat[p], _paths(params))


def _paths(tree, prefix=""):
    return {k: _paths(v, f"{prefix}{k}/") if isinstance(v, dict)
            else f"{prefix}{k}" for k, v in tree.items()}


def _close(got, want, atol=1e-5, rtol=1e-5):
    torch.testing.assert_close(got, want, atol=atol, rtol=rtol)


def _layer0(params):
    return tree_map(lambda t: t[0], params["layers"])


@pytest.mark.parametrize("P", [0, 5])
def test_prefill_then_decode_gives_the_block_forward(P):
    cfg = _cfg(**FINCH)
    model = build_model(cfg, "cpu")
    lp = _layer0(_params(model))
    Bt, S, d = 2, 12, cfg.d_model
    x = torch.randn(Bt, S, d, generator=torch.Generator().manual_seed(7))
    zero = torch.zeros(Bt, 1, d)
    with torch.no_grad():
        want_t, last_t, want_s = R.apply_tmix(lp["tmix"], x, cfg, zero, None)
        want_c, last_c = R.apply_cmix(lp["cmix"], x, cfg, zero)
        st = R.init_rwkv_state(cfg, Bt, torch.float32, "cpu")
        outs_t, outs_c = [], []
        if P:
            o, tok, wkv = R.apply_tmix(lp["tmix"], x[:, :P], cfg, zero, None)
            c, tok_c = R.apply_cmix(lp["cmix"], x[:, :P], cfg, zero)
            st = {"wkv": wkv, "tok_t": tok, "tok_c": tok_c}
            outs_t.append(o)
            outs_c.append(c)
        for t in range(P, S):
            o, st = R.decode_tmix(lp["tmix"], x[:, t:t + 1], cfg, st)
            c, st = R.decode_cmix(lp["cmix"], x[:, t:t + 1], cfg, st)
            outs_t.append(o)
            outs_c.append(c)
    _close(torch.cat(outs_t, 1), want_t)
    _close(torch.cat(outs_c, 1), want_c)
    _close(st["wkv"], want_s)
    assert torch.equal(st["tok_t"], last_t) and torch.equal(st["tok_c"],
                                                            last_c)


def test_blocked_prefill_then_decode_gives_the_forward_logits():
    cfg = _cfg(**FINCH)
    model = build_model(cfg, "cpu")
    params = _params(model)
    Bt, S, P = 2, 10, 6
    tok = torch.randint(0, cfg.vocab_size, (Bt, S),
                        generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        want, _ = model.apply(params, {"tokens": tok})
        cache = model.init_cache(Bt, 16)
        cache = make_prefill_step(model)(params, cache, tok[:, :P],
                                         torch.tensor([P, P]))
        got = []
        for t in range(P, S):
            logits, cache = model.decode(params, cache,
                                         {"tokens": tok[:, t:t + 1]})
            got.append(logits)
    _close(torch.cat(got, 1), want[:, P:], atol=1e-4)


def _former_tmix(p, x, cfg, prev_tok, state):
    """The time mix as the port computed it before the Finch fields (no
    tensor parallelism): static lerps, the decay, the sequential scan,
    the RMS ``ln_x`` times the gate, ``wo``."""
    B, S, _ = x.shape
    Dh = cfg.rwkv_head_dim
    H = p["u"].shape[0]
    xs = R._shift(x, prev_tok)
    xr, xk, xv, xg, xw = (R._lerp(x, xs, p[f"mix_{c}"]) for c in "rkvgw")
    dt = x.dtype
    r = (xr @ p["wr"].to(dt)).reshape(B, S, H, Dh)
    k = (xk @ p["wk"].to(dt)).reshape(B, S, H, Dh)
    v = (xv @ p["wv"].to(dt)).reshape(B, S, H, Dh)
    g = F.silu(xg @ p["wg"].to(dt))
    w = R.rwkv_decay(p, xw).reshape(B, S, H, Dh)
    o, state = R._wkv_scan(r, k, v, w, p["u"].to(torch.float32), state)
    o = o.reshape(B, S, H * Dh).to(dt)
    o = L.rms_norm(o, p["ln_x"], cfg.norm_eps) * g
    return o @ p["wo"].to(dt), x[:, -1:], state


FORMER_LEAVES = ["mix_r", "mix_k", "mix_v", "mix_g", "mix_w", "wr", "wk",
                 "wv", "wg", "wo", "w0", "w_lora_a", "w_lora_b", "u", "ln_x"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_defaults_are_the_former_block_bit_for_bit(dtype):
    cfg = _cfg(dtype=dtype)
    assert (cfg.rwkv_mix_rank, cfg.rwkv_decay_rank) == (0, 64)
    model = build_model(cfg, "cpu")
    params = _params(model)
    tmix = _layer0(params)["tmix"]
    assert list(tmix) == FORMER_LEAVES
    assert tmix["w_lora_a"].shape == (cfg.d_model, 64)
    Bt, S, d = 2, 9, cfg.d_model
    g = torch.Generator().manual_seed(5)
    x = torch.randn(Bt, S, d, generator=g).to(tmix["wr"].dtype)
    prev = torch.randn(Bt, 1, d, generator=g).to(x.dtype)
    s0 = torch.randn(Bt, d // cfg.rwkv_head_dim, cfg.rwkv_head_dim,
                     cfg.rwkv_head_dim, generator=g)
    with torch.no_grad():
        got = R.apply_tmix(tmix, x, cfg, prev, s0)
        want = _former_tmix(tmix, x, cfg, prev, s0)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_finch_leaves_and_their_dtypes():
    cfg = _cfg(dtype="bfloat16", **FINCH)
    tmix = _layer0(build_model(cfg, "cpu").init(
        build_model(cfg, "cpu").generator(0)))["tmix"]
    d, r = cfg.d_model, cfg.rwkv_mix_rank
    assert list(tmix)[:len(FORMER_LEAVES)] == FORMER_LEAVES
    assert tmix["w_lora_a"].shape == (d, 8)
    assert tmix["w_lora_b"].shape == (8, d)
    assert tmix["mix_lora_a"].shape == (d, 5 * r)
    for c in "wkvrg":
        assert tmix[f"mix_lora_b_{c}"].shape == (r, d)
        assert tmix[f"mix_lora_b_{c}"].dtype == torch.bfloat16
    for name in ("mix_x", "ln_x", "ln_x_bias", "w0", "u"):
        assert tmix[name].dtype == torch.float32, name


def test_ddlerp_is_finchs_batched_form():
    g = torch.Generator().manual_seed(11)
    Bt, S, d, r = 2, 6, 16, 3
    f64 = dict(dtype=torch.float64)
    p = {"mix_x": torch.randn(d, generator=g, **f64),
         "mix_lora_a": torch.randn(d, 5 * r, generator=g, **f64),
         **{f"mix_{c}": torch.randn(d, generator=g, **f64) for c in "wkvrg"},
         **{f"mix_lora_b_{c}": torch.randn(r, d, generator=g, **f64)
            for c in "wkvrg"}}
    x = torch.randn(Bt, S, d, generator=g, **f64)
    xs = R._shift(x, torch.zeros(Bt, 1, d, **f64))
    got = R._ddlerp(p, x, xs)
    # RWKV-LM v6: tanh(xxx @ W1).view(B*T, 5, -1).transpose(0, 1), bmm
    # with W2 (5, r, d), unbind as w, k, v, r, g
    xx = xs - x
    xxx = torch.tanh((x + xx * p["mix_x"]) @ p["mix_lora_a"])
    xxx = xxx.view(Bt * S, 5, -1).transpose(0, 1)
    w2 = torch.stack([p[f"mix_lora_b_{c}"] for c in "wkvrg"])
    m = torch.bmm(xxx, w2).view(5, Bt, S, d)
    for i, c in enumerate("wkvrg"):
        want = x + xx * (p[f"mix_{c}"] + m[i])
        torch.testing.assert_close(got[c], want, atol=1e-12, rtol=1e-12)


def test_group_ln_x_is_a_group_norm_per_head():
    g = torch.Generator().manual_seed(4)
    Bt, S, H, Dh = 2, 5, 4, 8
    o = 3.0 * torch.randn(Bt, S, H * Dh, generator=g) + 1.0
    w = 0.3 * torch.randn(H * Dh, generator=g)
    b = 0.3 * torch.randn(H * Dh, generator=g)
    got = R._group_norm(o, w, b, H, 6.4e-4)
    want = F.group_norm(o.reshape(-1, H * Dh), H, w, b,
                        6.4e-4).reshape(Bt, S, H * Dh)
    _close(got, want)


def test_full_width_finch_layout_and_axes():
    """Full-width rwkv6-7b is Finch: its time mix's leaves at the
    published shapes (built without allocating), each with logical axes;
    ``reference_block`` gives back the reference's tree."""
    from repro_torch.config import reference_block
    from repro_torch.models import transformer as T
    from repro_torch.models.axes import param_axes
    cfg = get_config("rwkv6-7b")
    assert (cfg.rwkv_mix_rank, cfg.rwkv_decay_rank) == (64, 128)
    assert R.LN_X_EPS == pytest.approx(6.4e-4)
    shapes = {p: tuple(t.shape) for p, t in tree_leaves(
        T.init_params(cfg, None, torch.device("meta")))}
    tm = "layers/tmix/"
    assert shapes[tm + "mix_lora_a"] == (32, 4096, 320)
    assert all(shapes[f"{tm}mix_lora_b_{c}"] == (32, 64, 4096)
               for c in "wkvrg")
    assert shapes[tm + "w_lora_a"] == (32, 4096, 128)
    assert shapes[tm + "mix_x"] == shapes[tm + "ln_x_bias"] == (32, 4096)
    axes = dict(tree_leaves(param_axes(cfg)))
    assert axes.keys() == shapes.keys()
    old = {p for p, _ in tree_leaves(T.init_params(
        reference_block(cfg), None, torch.device("meta")))}
    assert old == {p for p in shapes if "mix_lora" not in p
                   and not p.endswith(("mix_x", "ln_x_bias"))}


@pytest.mark.parametrize("rank", [0, 4])
def test_mix_rank_chooses_ln_x(rank):
    """The token-shift LoRA's rank also chooses ``ln_x``: at 0 one RMS
    norm whose gain is stored around zero; above 0 Finch's GroupNorm per
    head, its weight stored as published (made at one) with a bias."""
    cfg = _cfg(rwkv_mix_rank=rank)
    model = build_model(cfg, "cpu")
    tmix = _layer0(model.init(model.generator(0)))["tmix"]
    assert ("ln_x_bias" in tmix) == bool(rank)
    assert torch.equal(tmix["ln_x"], torch.full_like(tmix["ln_x"],
                                                      float(bool(rank))))
    g = torch.Generator().manual_seed(2)
    x = torch.randn(2, 5, cfg.d_model, generator=g)
    with torch.no_grad():
        o = R.apply_tmix(tmix, x, cfg, torch.zeros(2, 1, cfg.d_model),
                         None)[0]
    assert o.shape == x.shape and torch.isfinite(o).all()
    if rank:
        tmix = dict(tmix, ln_x=torch.zeros_like(tmix["ln_x"]),
                    ln_x_bias=torch.zeros_like(tmix["ln_x_bias"]))
        with torch.no_grad():
            o = R.apply_tmix(tmix, x, cfg, torch.zeros(2, 1, cfg.d_model),
                             None)[0]
        # a GroupNorm of zero weight and bias passes nothing on
        assert torch.equal(o, torch.zeros_like(o))


@pytest.mark.gpu
def test_cuda_finch_forward_matches_torch():
    """The Finch forward through the WKV kernel against the sequential
    scan, float32, at 4 heads of 64 and 96 tokens."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run with -m gpu on the card)")
    kw = dict(FINCH, d_model=256, num_heads=4, num_kv_heads=4, head_dim=64,
              rwkv_head_dim=64, d_ff=512)
    tok = torch.randint(0, 512, (2, 96),
                        generator=torch.Generator().manual_seed(1))
    out = {}
    for impl in ("cuda", "torch"):
        model = build_model(_cfg(impl, **kw), "cuda")
        params = tree_map(lambda t: t.cuda(), _params(
            build_model(_cfg(impl, **kw), "cpu")))
        with torch.no_grad():
            out[impl], _ = model.apply(params, {"tokens": tok.cuda()})
    _close(out["cuda"], out["torch"], atol=1e-4, rtol=1e-4)
