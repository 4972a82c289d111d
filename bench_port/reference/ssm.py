"""Plain float32 reference of the ssm family (rwkv6-7b, RWKV-6 "Finch"):
token embedding, ``num_layers`` pre-norm layers of a time mix and a
channel mix, each added to the residual stream, then a final norm and the
unembedding (untied).

The time mix, on h = rms(x) (``ln1``), with xx = h_{t-1} - h_t (h_{-1} =
0):

- the data-dependent token shift: xxx = h + xx maa_x, m = tanh(xxx @ W1)
  split into five of ``rwkv_mix_rank`` (w, k, v, r, g in that order),
  m_c = m[c] @ W2_c, and x_c = h + xx (maa_c + m_c);
- r, k, v = x_r @ W_r, x_k @ W_k, x_v @ W_v in heads of
  ``rwkv_head_dim``; g = SiLU(x_g @ W_g);
- the decay w_t = exp(-exp(w0 + tanh(x_w @ A) @ B)), per channel;
- the WKV recurrence per head, state S (Dk x Dv) from zero:
  o_t = r_t (S_{t-1} + diag(u) k_t^T v_t), S_t = diag(w_t) S_{t-1} +
  k_t^T v_t;
- ``ln_x``, a GroupNorm with one group a head, weight and bias, at
  eps 1e-5 x head_size_divisor^2 (``LN_X_EPS``); the output
  (ln_x(o) g) @ W_o.

The channel mix, on h = rms(x) (``ln2``): x_c = h + xx mu_c for c in k, r;
k = ReLU(x_k @ W_k)^2; out = sigmoid(x_r @ W_r) (k @ W_v).

The recurrence is computed in chunks of ``CHUNK`` tokens, exactly: inside
a chunk the decay from token b to token a is exp of the difference of
the chunk's cumulative log-decays, summed in float64 (it is at most 1
and never overflows), and the state is carried from chunk to chunk;
:func:`wkv_sequential` is the token-by-token form that the tests hold it
to.

Departures from the published Finch 7B (hf RWKV/v6-Finch-7B-HF,
arXiv:2404.05892), which the program makes and the reference follows:
RMS norms with a gain of 1 + gamma and no bias for ``ln1``, ``ln2`` and
the final norm, where the published model has LayerNorm with a bias; no
``ln0`` on the embeddings; the log-decay w0 + tanh(x_w A) B clamped to
[-8, 4] before its exp. The program also stores the RMS gains around
zero (scaled by 1 + gamma) and the channel mix's static coefficients as
logits (mu_c = sigmoid(mix_c)); ``ln_x``'s weight and bias as published.
The reference reads them so.
"""
from __future__ import annotations

from typing import Mapping

import torch
import torch.nn.functional as F

from bench_port.reference import common as C

STACKED = ("layers",)   # subtrees whose leaves stack the layers on axis 0

MIX = "wkvrg"           # the token shift's LoRA outputs, in Finch's order
CHUNK = 32
LOG_DECAY = (-8.0, 4.0)
LN_X_EPS = 6.4e-4       # 1e-5 x head_size_divisor^2, head_size_divisor 8


def wkv_sequential(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   logw: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """r, k, v (b, S, H, D), logw (b, S, H, D) the log of each step's
    decay, u (H, D) -> o (b, S, H, D), one token at a time."""
    b, S, H, D = r.shape
    s = torch.zeros(b, H, D, D, dtype=r.dtype, device=r.device)
    out = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        out.append(torch.einsum("bhi,bhij->bhj", r[:, t],
                                s + u[None, :, :, None] * kv))
        s = torch.exp(logw[:, t])[..., None] * s + kv
    return torch.stack(out, dim=1)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                logw: torch.Tensor, u: torch.Tensor, chunk: int = CHUNK,
                group: int = 16) -> torch.Tensor:
    """The same recurrence in chunks of ``chunk`` tokens (S padded with
    steps that neither decay nor add to the state), the chunks' own
    terms ``group`` chunks at a time."""
    b, S, H, D = r.shape
    pad = -S % chunk
    if pad:
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
    nc = r.shape[1] // chunk
    r, k, v = (t.reshape(b, nc, chunk, H, D) for t in (r, k, v))
    cum = logw.double().reshape(b, nc, chunk, H, D).cumsum(dim=2)
    before = cum - logw.double().reshape(b, nc, chunk, H, D)  # up to a-1
    # inside a chunk: o_a = sum_{b<a} (r_a . k_b exp(before_a - cum_b)) v_b
    #                       + (r_a . u k_a) v_a
    lower = torch.ones(chunk, chunk, dtype=torch.bool,
                       device=r.device).tril(-1)[:, :, None, None]
    own = []
    for g0 in range(0, nc, group):
        sl = slice(g0, min(nc, g0 + group))
        gap = before[:, sl, :, None] - cum[:, sl, None, :]    # (b,c,a,b',H,D)
        decay = torch.exp(gap.masked_fill(~lower, float("-inf"))).to(r.dtype)
        att = torch.einsum("bcahd,bcjhd,bcajhd->bcajh", r[:, sl], k[:, sl],
                           decay)
        own.append(torch.einsum("bcajh,bcjhe->bcahe", att, v[:, sl]))
        del gap, decay, att
    o = torch.cat(own, dim=1) + torch.einsum(
        "bcahd,hd,bcahd->bcah", r, u, k)[..., None] * v
    # across chunks: the state before each chunk, decayed to each token
    to_end = torch.exp(cum[:, :, -1:] - cum).to(r.dtype)     # (b,c,Q,H,D)
    whole = torch.exp(cum[:, :, -1]).to(r.dtype)              # (b,c,H,D)
    reach = torch.exp(before).to(r.dtype)
    s = torch.zeros(b, H, D, D, dtype=r.dtype, device=r.device)
    for c in range(nc):
        o[:, c] += torch.einsum("bahd,bhde->bahe", r[:, c] * reach[:, c], s)
        s = whole[:, c, :, :, None] * s + torch.einsum(
            "bjhd,bjhe->bhde", k[:, c] * to_end[:, c], v[:, c])
    return o.reshape(b, nc * chunk, H, D)[:, :S]


def _shift(h: torch.Tensor) -> torch.Tensor:
    """h_{t-1} - h_t, with zero before the first token."""
    return F.pad(h, (0, 0, 1, 0))[:, :-1] - h


def time_mix(p: Mapping, h: torch.Tensor, m: Mapping, prec: str
             ) -> torch.Tensor:
    """The time mix of h = ln1(x) (module docstring)."""
    b, S, d = h.shape
    Dh = m["rwkv_head_dim"]
    H = d // Dh
    xx = _shift(h)
    lo = torch.tanh(C.linear(h + xx * p["mix_x"], p["mix_lora_a"], prec))
    lo = lo.chunk(len(MIX), dim=-1)
    x = {c: h + xx * (p[f"mix_{c}"]
                      + C.linear(lo[i], p[f"mix_lora_b_{c}"], prec))
         for i, c in enumerate(MIX)}
    r, k, v = (C.linear(x[c], p[f"w{c}"], prec).reshape(b, S, H, Dh)
               for c in "rkv")
    g = F.silu(C.linear(x["g"], p["wg"], prec))
    logw = p["w0"] + C.linear(torch.tanh(C.linear(x["w"], p["w_lora_a"],
                                                  prec)),
                              p["w_lora_b"], prec)
    logw = -torch.exp(logw.clamp(*LOG_DECAY)).reshape(b, S, H, Dh)
    o = wkv_chunked(r, k, v, logw, p["u"])
    var, mean = torch.var_mean(o, dim=-1, keepdim=True, correction=0)
    o = ((o - mean) * torch.rsqrt(var + LN_X_EPS)).reshape(b, S, d)
    o = o * p["ln_x"] + p["ln_x_bias"]
    return C.linear(o * g, p["wo"], prec)


def channel_mix(p: Mapping, h: torch.Tensor, prec: str) -> torch.Tensor:
    """The channel mix of h = ln2(x) (module docstring)."""
    xx = _shift(h)
    xk = h + xx * torch.sigmoid(p["mix_k"])
    xr = h + xx * torch.sigmoid(p["mix_r"])
    kk = torch.relu(C.linear(xk, p["wk"], prec)).square()
    return torch.sigmoid(C.linear(xr, p["wr"], prec)) \
        * C.linear(kk, p["wv"], prec)


def _layer(lp: Mapping, x: torch.Tensor, m: Mapping, prec: str
           ) -> torch.Tensor:
    x = x + time_mix(lp["tmix"], C.rms_norm(x, lp["ln1"]["gamma"],
                                            m["norm_eps"]), m, prec)
    return x + channel_mix(lp["cmix"], C.rms_norm(x, lp["ln2"]["gamma"],
                                                  m["norm_eps"]), prec)


def forward(params: Mapping, m: Mapping, tokens: torch.Tensor,
            prec: str = "float32", remat: bool = False) -> torch.Tensor:
    """Logits (B, S, V) in float32 of tokens (B, S), TF32 off."""
    with C.strict_fp32():
        x = params["embed"]["tok"][tokens]
        for lp in C.stacked(params["layers"], 1):
            x = C.checkpointed(_layer, lp, x, m, prec, remat=remat)
        return C.logits(params, x, m, prec)
