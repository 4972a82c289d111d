"""Mamba-2 (SSD) block, the zamba2 backbone layer (counterpart of
``repro.models.ssm``).

The full-sequence path runs the SSD scan: ``cfg.ssm_impl == "cuda"`` the
hand-written kernel (``repro_torch.kernels.ssd_scan``, which picks its own
chunk length and takes any S), ``"torch"`` the reference's chunked form
(intra-chunk quadratic term plus an inter-chunk state recurrence, in
chunks of ``cfg.ssm_chunk``, or one chunk when S is not a multiple of it).
Decode is the O(1) single-step state update. Decay accumulations run in
float32.

Single B/C group (G=1), conv width 4, Mamba-2 gated-RMSNorm output.
``A_log``, ``dt_bias`` and the gated norm's ``norm`` are stored in
float32 always: the reference reads them in float32.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.models import layers as L

CONV_W = 4
Tree = Dict[str, torch.Tensor]


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    d_in = cfg.ssm_d_inner
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    assert H * P == d_in, (H, P, d_in)
    return d_in, H, P, N


def init_mamba2(gen, cfg: ModelConfig, *, dtype, device) -> Tree:
    d = cfg.d_model
    d_in, H, P, N = _dims(cfg)
    conv_dim = d_in + 2 * N
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": L.param(gen, (d, 2 * d_in + 2 * N + H), **kw),
        "conv_w": L.param(gen, (CONV_W, conv_dim), scale=0.5, **kw),
        "conv_b": L.param(gen, (conv_dim,), init="zeros", **kw),
        "A_log": L.param(gen, (H,), init="zeros", **f32),
        "D": L.param(gen, (H,), init="ones", **kw),
        "dt_bias": L.param(gen, (H,), init="zeros", **f32),
        "norm": L.param(gen, (d_in,), init="zeros", **f32),
        "out_proj": L.param(gen, (d_in, d), **kw),
    }


def _split_proj(p: Tree, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(z, the conv input [x, B, C], dt): the reference's five-way split,
    with x, B and C kept as the one column slice of the projection that
    the reference concatenates back for the convolution."""
    d_in, H, P, N = _dims(cfg)
    zxbcdt = x @ p["in_proj"].to(x.dtype)
    return (zxbcdt[..., :d_in], zxbcdt[..., d_in:2 * d_in + 2 * N],
            zxbcdt[..., 2 * d_in + 2 * N:])


def _causal_conv(p: Tree, u: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv width-4 over (B, S, C), then SiLU."""
    w = p["conv_w"].to(u.dtype)
    pad = F.pad(u, (0, 0, CONV_W - 1, 0))
    out = sum(w[i] * pad[:, i:i + u.shape[1]] for i in range(CONV_W))
    return F.silu(out + p["conv_b"].to(u.dtype))


def _gated_out(p: Tree, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """Skip term, gated RMS norm and the output projection; y, xh
    (..., H, P), z (..., d_in)."""
    y = y + p["D"].to(y.dtype)[:, None] * xh
    y = y.flatten(-2)
    y = L.rms_norm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["out_proj"].to(y.dtype)


def _ssd_chunked(xdt: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                 dA: torch.Tensor, Q: int) -> torch.Tensor:
    """The reference's XLA form of the SSD scan in chunks of Q (S % Q ==
    0): float32 decays and states, the intra-chunk term cast to xdt's
    dtype before its product with xdt (as the reference does). The upper
    triangle of the decay is masked before the exponential rather than
    after it: the same values, and no inf (exp of a positive log-decay)
    whose gradient would be NaN."""
    B, S, H, P = xdt.shape
    N = Bc.shape[-1]
    nc = S // Q
    f32 = torch.float32
    xdt_c = xdt.reshape(B, nc, Q, H, P)
    Bc_c = Bc.reshape(B, nc, Q, N).to(f32)
    Cc_c = Cc.reshape(B, nc, Q, N).to(f32)
    cum = torch.cumsum(dA.reshape(B, nc, Q, H), dim=2)              # (B,nc,Q,H)

    # intra-chunk: att[b,c,i,j,h] = (C_i . B_j) exp(cum_i - cum_j), j<=i
    logdec = cum[:, :, :, None, :] - cum[:, :, None, :, :]          # (B,nc,Q,Q,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xdt.device))
    dec = torch.exp(logdec.masked_fill(~tri[:, :, None], float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cc_c, Bc_c)
    att = cb[..., None] * dec
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att.to(xdt.dtype), xdt_c)

    # chunk states: S_c = sum_j exp(cum_last - cum_j) B_j (x) xdt_j
    last = cum[:, :, -1:, :]                                        # (B,nc,1,H)
    sdec = torch.exp(last - cum)                                    # (B,nc,Q,H)
    states = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc_c, sdec,
                          xdt_c.to(f32))

    # inter-chunk recurrence: the state *before* each chunk
    chunk_decay = torch.exp(last[:, :, 0, :])                       # (B,nc,H)
    s = torch.zeros((B, H, N, P), dtype=f32, device=xdt.device)
    prev = []
    for c in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                          # (B,nc,H,N,P)

    y_inter = torch.einsum("bcin,bcih,bchnp->bcihp", Cc_c, torch.exp(cum),
                           prev_states).to(xdt.dtype)
    return (y_intra + y_inter).reshape(B, S, H, P)


def apply_mamba2(p: Tree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence SSD. x: (B, S, d_model) -> (B, S, d_model)."""
    B, S, _ = x.shape
    d_in, H, P, N = _dims(cfg)
    f32 = torch.float32

    z, xbc, dt = _split_proj(p, x, cfg)
    conv_out = _causal_conv(p, xbc)
    xin, Bc, Cc = conv_out.split([d_in, N, N], dim=-1)   # column views

    xh = xin.unflatten(-1, (H, P))
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))             # (B,S,H)
    a = -torch.exp(p["A_log"].to(f32))                              # (H,)
    dA = dt * a                                                     # <= 0
    xdt = xh * dt.to(xh.dtype)[..., None]

    if cfg.ssm_impl == "cuda":
        y = ssd_scan(xdt, Bc, Cc, dA)
    elif cfg.ssm_impl == "torch":
        Q = min(cfg.ssm_chunk, S)
        if S % Q != 0:
            Q = S
        y = _ssd_chunked(xdt, Bc, Cc, dA, Q)
    else:
        raise ValueError(f"unknown ssm_impl {cfg.ssm_impl!r}")
    return _gated_out(p, y, xh, z, cfg)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype,
                      device) -> Tree:
    d_in, H, P, N = _dims(cfg)
    conv_dim = d_in + 2 * N
    return {
        "state": torch.zeros((batch, H, N, P), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((batch, CONV_W - 1, conv_dim), dtype=dtype,
                            device=device),
    }


def decode_mamba2(p: Tree, x: torch.Tensor, cache: Tree, cfg: ModelConfig
                  ) -> Tuple[torch.Tensor, Tree]:
    """x: (B, 1, d_model); O(1) state update. Returns (out, new cache);
    the given cache is not modified."""
    B = x.shape[0]
    d_in, H, P, N = _dims(cfg)
    f32 = torch.float32

    z, xbc, dt = _split_proj(p, x, cfg)
    cur = xbc[:, 0]                                                 # (B,conv_dim)
    w = p["conv_w"].to(cur.dtype)
    hist = cache["conv"]
    conv = sum(w[i] * hist[:, i] for i in range(CONV_W - 1)) + w[-1] * cur
    conv = F.silu(conv + p["conv_b"].to(cur.dtype))
    xin, Bc, Cc = conv.split([d_in, N, N], dim=-1)

    xh = xin.reshape(B, H, P)
    dt = F.softplus(dt[:, 0].to(f32) + p["dt_bias"].to(f32))        # (B,H)
    a = -torch.exp(p["A_log"].to(f32))
    dA = torch.exp(dt * a)                                          # (B,H)
    state = cache["state"] * dA[:, :, None, None] + torch.einsum(
        "bn,bh,bhp->bhnp", Bc.to(f32), dt, xh.to(f32))
    y = torch.einsum("bn,bhnp->bhp", Cc.to(f32), state).to(xh.dtype)
    out = _gated_out(p, y[:, None], xh[:, None], z, cfg)
    new_cache = {
        "state": state,
        "conv": torch.cat([hist[:, 1:], cur[:, None]], dim=1),
    }
    return out, new_cache
