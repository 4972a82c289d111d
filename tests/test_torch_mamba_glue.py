"""The Mamba-2 mixer's glue kernels (``repro_torch.kernels.mamba_glue``)
on the CPU, where the CUDA kernels cannot run:

- each wrapper on CPU tensors takes its plain version, bit for bit, with
  its inputs as strided column slices of one projection;
- ``apply_mamba2`` with ``ssm_impl="cuda"`` calls both wrappers once and
  matches ``ssm_impl="torch"`` on reduced zamba2-1.2b, for S < 4 (the
  conv's window starts in the zero padding) and S not a multiple of any
  tile; the two differ only in the scan's form (sequential against
  chunked), so the tolerance is the SSD tests' own, float32 2e-5 x
  max(1, max|ref|);
- both wrappers refuse inputs that need a gradient;
- the plain versions, moved out of ``models/ssm.py``, leave the
  ``"torch"`` forward and its gradients equal to the bit to a copy of the
  inline glue they replaced (kept below), in float32 and bfloat16;
- the vector width the wrappers would launch with: 16 bytes on zamba2's
  column slices, narrower (never refused) where a slice's offset or a
  stride is not a multiple of 16 bytes.

The kernels themselves need the card (``tests/test_torch_kernels_gpu.py``,
``chip_smoke.py``'s glue-vs-plain phase).
"""
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from repro_torch import sharding as SH  # noqa: E402
from repro_torch.config import get_config  # noqa: E402
from repro_torch.kernels.mamba_glue import (conv_silu_dt,  # noqa: E402
                                            conv_silu_dt_plain,
                                            gated_rms_norm,
                                            gated_rms_norm_plain)
from repro_torch.kernels.mamba_glue import kernel as K  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm as M  # noqa: E402
from repro_torch.obs.profiling import SSM_MIXER, annotate_span  # noqa: E402

# B, S, H, P, N: reduced zamba2's widths, S < 4, a ragged S, and widths
# whose column slices are not 16-byte aligned
CASES = [(2, 1, 8, 16, 16), (2, 3, 8, 16, 16), (3, 37, 8, 16, 16),
         (2, 5, 3, 12, 4), (1, 7, 5, 6, 5)]
DTYPES = [torch.float32, torch.bfloat16]


def _glue_inputs(case, dtype, seed=0, lead=0):
    """(z, u = [x, B, C], dt) as column slices of one (B, S, 2 d_in + 2N
    + H) projection (``lead`` more columns before z), the conv's and the
    norm's parameters, and y."""
    B, S, H, P, N = case
    d_in = H * P
    g = torch.Generator().manual_seed(seed)
    proj = torch.randn(B, S, lead + 2 * d_in + 2 * N + H,
                       generator=g).to(dtype)[..., lead:]
    z, u, dt = (proj[..., :d_in], proj[..., d_in:2 * d_in + 2 * N],
                proj[..., 2 * d_in + 2 * N:])
    C = d_in + 2 * N
    params = {
        "conv_w": (0.5 * torch.randn(4, C, generator=g)).to(dtype),
        "conv_b": (0.1 * torch.randn(C, generator=g)).to(dtype),
        "dt_bias": 0.5 * torch.randn(H, generator=g),
        "A_log": 0.5 * torch.randn(H, generator=g),
        "D": (1 + 0.1 * torch.randn(H, generator=g)).to(dtype),
        "norm": 0.1 * torch.randn(d_in, generator=g),
    }
    y = torch.randn(B, S, H, P, generator=g).to(dtype)
    return z, u, dt, params, y


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CASES)
def test_wrappers_on_cpu_equal_plain(case, dtype):
    H, P = case[2], case[3]
    z, u, dt, p, y = _glue_inputs(case, dtype)
    args = (u, p["conv_w"], p["conv_b"], dt, p["dt_bias"], p["A_log"], P)
    got, want = conv_silu_dt(*args), conv_silu_dt_plain(*args)
    for g_, w_ in zip(got, want):
        assert g_.dtype == w_.dtype and torch.equal(g_, w_)
    conv_out, dA, xdt = got
    assert conv_out.dtype == dtype and dA.dtype == torch.float32
    assert tuple(xdt.shape) == (*u.shape[:2], H, P)
    xh = conv_out[..., :H * P].unflatten(-1, (H, P))
    norm = (y, xh, z, p["D"], p["norm"], 1e-5)
    out = gated_rms_norm(*norm)
    assert out.dtype == dtype and torch.equal(out, gated_rms_norm_plain(*norm))


def _model(S, impl, dtype=torch.float32, seed=0):
    cfg = get_config("zamba2-1.2b", reduced=True).replace(
        dtype="float32" if dtype == torch.float32 else "bfloat16",
        ssm_impl=impl)
    g = torch.Generator().manual_seed(seed)
    p = M.init_mamba2(g, cfg, dtype=dtype, device="cpu")
    # the zero- and one-initialised leaves seeded nonzero, so that a
    # dropped bias, skip or 1 + gamma shows
    for k in ("conv_b", "A_log", "dt_bias", "D", "norm"):
        p[k] = (p[k].float() + 0.3 * torch.randn(p[k].shape, generator=g)
                ).to(p[k].dtype)
    x = torch.randn(2, S, cfg.d_model, generator=g).to(dtype)
    return cfg, p, x


@pytest.mark.parametrize("S", [1, 3, 37])
def test_cuda_impl_on_cpu_matches_torch_impl(S, monkeypatch):
    calls = []
    for name in ("conv_silu_dt", "gated_rms_norm"):
        fn = getattr(M, name)
        monkeypatch.setattr(M, name, lambda *a, _fn=fn, _n=name:
                            calls.append(_n) or _fn(*a))
    cfg, p, x = _model(S, "cuda")
    with torch.no_grad():
        got = M.apply_mamba2(p, x, cfg)
        assert calls == ["conv_silu_dt", "gated_rms_norm"]
        want = M.apply_mamba2(p, x, cfg.replace(ssm_impl="torch"))
    assert calls == ["conv_silu_dt", "gated_rms_norm"]
    scale = max(1.0, float(want.abs().max()))
    torch.testing.assert_close(got, want, atol=2e-5 * scale, rtol=0)


@pytest.mark.parametrize("which", ["conv_silu_dt", "gated_rms_norm"])
def test_wrappers_refuse_inputs_that_need_a_gradient(which):
    case = CASES[1]
    H, P = case[2], case[3]
    z, u, dt, p, y = _glue_inputs(case, torch.float32)
    xh = u[..., :H * P].unflatten(-1, (H, P))
    if which == "conv_silu_dt":
        def call(w):
            return conv_silu_dt(u, w, p["conv_b"], dt, p["dt_bias"],
                                p["A_log"], P)
        leaf = p["conv_w"]
    else:
        def call(w):
            return gated_rms_norm(y, xh, z, p["D"], w, 1e-5)
        leaf = p["norm"]
    w = leaf.clone().requires_grad_()
    with pytest.raises(RuntimeError, match="has no backward"):
        call(w)
    with torch.no_grad():
        call(w)


# --- the inline glue the plain versions replaced, as it stood -----------------

def _old_causal_conv(p, u):
    w = p["conv_w"].to(u.dtype)
    pad = F.pad(u, (0, 0, 4 - 1, 0))
    out = sum(w[i] * pad[:, i:i + u.shape[1]] for i in range(4))
    return F.silu(out + p["conv_b"].to(u.dtype))


def _old_gated_out(p, y, xh, z, cfg, split):
    y = y + p["D"].to(y.dtype)[:, None] * xh
    y = y.flatten(-2)
    y = L.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps, split)
    y = y @ p["out_proj"].to(y.dtype)
    return SH.reduce_from(y, *split)


def _old_apply_mamba2(p, x, cfg):
    with annotate_span(SSM_MIXER):
        p, split = M._local(p, cfg)
        x = SH.copy_to(x, *split)
        B, S, _ = x.shape
        d_in, H = p["norm"].shape[0], p["A_log"].shape[0]
        P, N = cfg.ssm_head_dim, cfg.ssm_state
        f32 = torch.float32
        z, xbc, dt = M._split_proj(p, x, N)
        conv_out = _old_causal_conv(p, xbc)
        xin, Bc, Cc = conv_out.split([d_in, N, N], dim=-1)
        xh = xin.unflatten(-1, (H, P))
        dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))
        a = -torch.exp(p["A_log"].to(f32))
        dA = dt * a
        xdt = xh * dt.to(xh.dtype)[..., None]
        Q = min(cfg.ssm_chunk, S)
        if S % Q != 0:
            Q = S
        y = M._ssd_chunked(xdt, Bc, Cc, dA, Q)
        return _old_gated_out(p, y, xh, z, cfg, split)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S", [3, 37])
def test_torch_impl_equals_the_old_inline_glue(S, dtype):
    cfg, p, x = _model(S, "torch", dtype=dtype, seed=1)
    outs, grads = [], []
    for fn in (M.apply_mamba2, _old_apply_mamba2):
        leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
        xi = x.clone().requires_grad_()
        out = fn(leaves, xi, cfg)
        out.float().square().sum().backward()
        outs.append(out.detach())
        grads.append([xi.grad] + [leaves[k].grad for k in sorted(leaves)])
    assert torch.equal(outs[0], outs[1])
    for a, b in zip(*grads):
        assert a is not None and torch.equal(a, b)


# --- the vector width of the launch -------------------------------------------

# H, P, N, dtype, columns before the projection's z, the conv's width,
# the norm's width: zamba2-1.2b's widths and reduced ones take 16 bytes;
# where a slice's offset or a stride is not a multiple of 16 bytes, or
# C or P not one of the vector, narrower
WIDTHS = [
    (64, 64, 64, torch.bfloat16, 0, 8, 8),
    (64, 64, 64, torch.float32, 0, 4, 4),
    (8, 16, 16, torch.bfloat16, 0, 8, 8),
    (64, 64, 64, torch.bfloat16, 2, 2, 2),  # every slice 4 bytes off
    (2, 6, 1, torch.bfloat16, 0, 2, 2),     # u at 24 bytes, P = 6
    (4, 4, 4, torch.bfloat16, 0, 4, 4),     # P = 4
    (2, 8, 3, torch.float32, 0, 2, 2),      # C = 22, xh's row stride 22
    (3, 12, 4, torch.bfloat16, 0, 1, 1),    # the row stride (83) is odd
]


@pytest.mark.parametrize("case", WIDTHS)
def test_vector_width(case):
    H, P, N, dtype, lead, want_conv, want_norm = case
    z, u, dt, p, y = _glue_inputs((1, 3, H, P, N), dtype, lead=lead)
    d_in, e = H * P, u.element_size()
    conv_out = torch.empty(*u.shape, dtype=dtype)
    xdt = torch.empty(*u.shape[:2], H, P, dtype=dtype)
    assert K.vector_width(e, (u.shape[-1], P),
                          (u, p["conv_w"], p["conv_b"], conv_out,
                           xdt)) == want_conv
    xh = conv_out[..., :d_in].unflatten(-1, (H, P))
    out = torch.empty(*z.shape, dtype=dtype)
    assert K.vector_width(e, (d_in, P), (y, xh, z, out)) == want_norm
