"""Plain float32 reference of the hybrid family (zamba2-1.2b): a Mamba-2
backbone in blocks of ``shared_attn_every`` layers, each block followed
by one attention + MLP block whose weights all blocks share, the
leftover layers after the last block, a final norm and the unembedding
by the transposed (tied) embedding.

A Mamba-2 layer, on rms(x): one input projection to [z, x, B, C, dt]; a
depthwise causal convolution of width 4 over [x, B, C] with its bias,
then SiLU; dt = softplus(dt + dt_bias), A = -exp(A_log); the SSD
recurrence per head, state h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t^T,
output y_t = C_t h_t, over one B/C group; the skip y + D x; a gated RMS
norm of y * SiLU(z); the output projection; the residual. The recurrence
is computed in chunks of ``CHUNK`` tokens (the quadratic form inside a
chunk, the state carried between chunks); :func:`ssd_sequential` is the
token-by-token form that the tests hold it to.

Departures from the published Zamba2-1.2B (hf Zyphra/Zamba2-1.2B,
arXiv:2411.15242), which the program makes and the reference follows:
the shared block reads the residual stream alone (d_model wide, 32
heads of 64) where the published block reads it concatenated with the
input embedding (2 x d_model, heads of 128), has no per-invocation LoRA
adapters, and gates its MLP with SiLU where the published model uses
GeLU; the shared block follows every sixth Mamba layer.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from bench_port.reference import common as C

STACKED = ("blocks", "tail")   # subtrees whose leaves stack on axis 0

CONV_W = 4
CHUNK = 64


def ssd_sequential(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   Bm: torch.Tensor, Cm: torch.Tensor) -> torch.Tensor:
    """x (b, S, H, P), dt (b, S, H), A (H,), Bm/Cm (b, S, N) -> y (b, S,
    H, P), one token at a time."""
    b, S, H, P = x.shape
    h = torch.zeros(b, H, Bm.shape[-1], P, dtype=x.dtype, device=x.device)
    ys = []
    for t in range(S):
        decay = torch.exp(dt[:, t] * A)                          # (b, H)
        h = h * decay[:, :, None, None] + torch.einsum(
            "bn,bh,bhp->bhnp", Bm[:, t], dt[:, t], x[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1)


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                Bm: torch.Tensor, Cm: torch.Tensor, chunk: int = CHUNK
                ) -> torch.Tensor:
    """The same recurrence in chunks of ``chunk`` tokens (S padded with
    zero steps, which neither decay nor add to the state)."""
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    pad = -S % chunk
    if pad:
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        Bm, Cm = F.pad(Bm, (0, 0, 0, pad)), F.pad(Cm, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xs = (x * dt[..., None]).reshape(b, nc, chunk, H, P)
    la = (dt * A).reshape(b, nc, chunk, H)
    Bc, Cc = Bm.reshape(b, nc, chunk, N), Cm.reshape(b, nc, chunk, N)
    cum = la.cumsum(dim=2)                                      # (b,c,Q,H)
    # inside a chunk: y_i = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) xs_j
    seg = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (b,c,i,j,H)
    low = torch.ones(chunk, chunk, dtype=torch.bool,
                     device=x.device).tril()[None, None, :, :, None]
    w = torch.exp(seg.masked_fill(~low, float("-inf")))
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)
    y = torch.einsum("bcij,bcijh,bcjhp->bcihp", cb, w, xs)
    # the state each chunk adds, decayed to the chunk's end
    tail = torch.exp(cum[:, :, -1:, :] - cum)                   # (b,c,Q,H)
    add = torch.einsum("bcjn,bcjh,bcjhp->bchnp", Bc, tail, xs)
    whole = torch.exp(cum[:, :, -1, :])                         # (b,c,H)
    h = torch.zeros(b, H, N, P, dtype=x.dtype, device=x.device)
    before = []
    for c in range(nc):
        before.append(h)
        h = h * whole[:, c, :, None, None] + add[:, c]
    before = torch.stack(before, dim=1)                         # (b,c,H,N,P)
    y = y + torch.einsum("bcin,bcih,bchnp->bcihp", Cc, torch.exp(cum),
                         before)
    return y.reshape(b, nc * chunk, H, P)[:, :S]


def mamba_layer(lp: Mapping, x: torch.Tensor, m: Mapping, prec: str
                ) -> torch.Tensor:
    """x + Mamba-2 of rms(x) (module docstring)."""
    b, S, d = x.shape
    p = lp["mamba"]
    d_in = m["ssm_expand"] * d
    H, P, N = m["ssm_heads"], m["ssm_head_dim"], m["ssm_state"]
    h = C.rms_norm(x, lp["ln"]["gamma"], m["norm_eps"])
    zxbcdt = C.linear(h, p["in_proj"], prec)
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * N]
    dt = zxbcdt[..., 2 * d_in + 2 * N:]
    padded = F.pad(xbc, (0, 0, CONV_W - 1, 0))
    conv = sum(p["conv_w"][i] * padded[:, i:i + S] for i in range(CONV_W))
    conv = F.silu(conv + p["conv_b"])
    xin, Bm, Cm = conv.split([d_in, N, N], dim=-1)
    dt = F.softplus(dt + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(b, S, H, P)
    y = ssd_chunked(xh, dt, A, Bm, Cm)
    y = (y + p["D"][:, None] * xh).reshape(b, S, d_in)
    y = C.rms_norm(y * F.silu(z), p["norm"], m["norm_eps"])
    return x + C.linear(y, p["out_proj"], prec)


def _shared(sp: Mapping, x: torch.Tensor, m: Mapping, prec: str
            ) -> torch.Tensor:
    x = C.attention_block(sp, x, m, 0, prec)
    return C.mlp_block(sp, x, m, prec)


def _block(bp: Mapping, sp: Mapping, x: torch.Tensor, m: Mapping,
           prec: str) -> torch.Tensor:
    for lp in C.stacked(bp, 1):
        x = mamba_layer(lp, x, m, prec)
    return _shared(sp, x, m, prec)


def forward(params: Mapping, m: Mapping, tokens: torch.Tensor,
            prec: str = "float32", remat: bool = False) -> torch.Tensor:
    """Logits (B, S, V) in float32 of tokens (B, S)."""
    x = params["embed"]["tok"][tokens]
    sp = params["shared"]
    for bp in C.stacked(params["blocks"], 1):
        x = C.checkpointed(_block, bp, sp, x, m, prec, remat=remat)
    if "tail" in params:
        for lp in C.stacked(params["tail"], 1):
            x = C.checkpointed(mamba_layer, lp, x, m, prec, remat=remat)
    return C.logits(params, x, m, prec)
