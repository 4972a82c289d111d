"""RWKV-6 (Finch): attention-free time-mix with data-dependent decay
(counterpart of ``repro.models.rwkv``).

Recurrence per head (state S in R^{Dk x Dv}, decay w_t per k-channel):

    o_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

The data-dependent decay ``w_t = exp(-exp(w0 + lora(x_t)))`` is kept
exactly, its LoRA of rank ``cfg.rwkv_decay_rank``. Channel-mix uses
squared-ReLU with static token-shift lerps.

The time mix comes in two forms, chosen by ``cfg.rwkv_mix_rank``
(``repro_torch.config``; the default is the reference's):

- 0, the reference's block: static lerps
  ``x + (x_{t-1} - x) sigmoid(mix_c)`` for r/k/v/g/w, and ``ln_x`` one
  RMS norm over all the channels, its gain stored around zero
  (``1 + ln_x``).
- Above 0, Finch's block: the data-dependent lerp ("ddlerp"): with
  ``xx = x_{t-1} - x`` and ``xxx = x + xx mix_x``,
  ``m = tanh(xxx @ mix_lora_a)`` (rank ``r`` for each of w, k, v, r and
  g, in that order), ``m_c = m[c] @ mix_lora_b_c``, and
  ``x_c = x + xx (mix_c + m_c)``, with no sigmoid; and ``ln_x`` Finch's
  GroupNorm, one group a head, with its weight ``ln_x`` and bias
  ``ln_x_bias`` stored as published (the weight is not stored around
  zero), at Finch's eps, 1e-5 x head_size_divisor^2 (``LN_X_EPS``).

The Finch leaves are drawn after the reference's, and only when asked
for, so the defaults give the reference's tree and draws bit for bit.

Spans (``repro_torch.obs.profiling``): ``rwkv.tmix`` the whole time mix,
inside it ``rwkv.shift`` (token shift and lerps), ``rwkv.proj`` (the
r/k/v/g products, then ``wo``) and ``rwkv.scan`` (the WKV recurrence);
``rwkv.cmix`` the whole channel mix.

A full sequence (S > 1) with ``cfg.rwkv_impl == "cuda"`` runs the
hand-written WKV kernel (``repro_torch.kernels.rwkv6``); ``"torch"``, and
every single-token decode step, run the sequential scan, as the
reference's XLA path does. The ``mix_*`` vectors, ``w0``, ``u`` and the
``ln_x`` gamma (and bias) are stored in float32 always: the reference
reads them in float32.

Tensor parallelism: the leaves may come as ``sharding.Sharded`` leaves.
Where ``u``'s spec splits the heads over model ranks (the ``tp``
layout), the time mix runs on the rank's heads: the lerps on the whole
d, then r, k, v and g column-parallel, the decay on the rank's channels
(``tanh(xw @ w_lora_a)`` whole, then the rank's columns of ``w_lora_b``
and ``w0``), the WKV scan on the rank's heads, ``ln_x`` over the
channels of every rank (its mean of squares summed over them), and
``wo`` row-parallel with its output summed. Where ``wk``/``wv`` split on
``ff`` and ``wr`` on its output channels, the channel mix sums
``kk @ wv`` over the ranks into each rank's block of channels
(reduce-scatter), gates it by the rank's columns of ``xr @ wr`` and
gathers the blocks. The leaves every rank holds whole and reads in
that compute (the ``mix_*`` vectors and LoRA, ``w_lora_a``, and the
slices of ``w_lora_b``, ``w0`` and ``ln_x``) have their gradients summed
over the ranks; a per-head ``ln_x`` needs no sum. Where the heads do not
split (a block would cut a head), the time mix computes on whole leaves,
and so does the channel mix where ``ff`` or the channels do not split.
The ``wkv`` state of the decode cache is then the rank's heads; the
token shifts stay whole. The Finch leaves' split is untested: the tp
tests run the reference's block.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding as SH
from repro_torch.config import ModelConfig
from repro_torch.kernels.rwkv6 import rwkv6_plain, rwkv6_scan
from repro_torch.models import layers as L
from repro_torch.obs.profiling import (RWKV_CMIX, RWKV_PROJ, RWKV_SCAN,
                                       RWKV_SHIFT, RWKV_TMIX, annotate_span)

MIX = "wkvrg"                 # the ddlerp LoRA's outputs, in Finch's order
LN_X_EPS = 6.4e-4             # the GroupNorm's: 1e-5 x head_size_divisor^2 (8)
Tree = Dict[str, torch.Tensor]

# The sequential WKV recurrence (B, S, H, Dh) -> (o, final state): the
# kernel's plain version is exactly the reference's ``_wkv_scan``.
_wkv_scan = rwkv6_plain


def _dims(cfg: ModelConfig) -> Tuple[int, int]:
    Dh = cfg.rwkv_head_dim
    return cfg.d_model // Dh, Dh


def init_rwkv_tmix(gen, cfg: ModelConfig, *, dtype, device) -> Tree:
    d = cfg.d_model
    H, Dh = _dims(cfg)
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    p = {f"mix_{c}": L.param(gen, (d,), scale=0.5, **f32) for c in "rkvgw"}
    for name in ("wr", "wk", "wv", "wg", "wo"):
        p[name] = L.param(gen, (d, d), **kw)
    p["w0"] = L.param(gen, (d,), init="zeros", **f32)
    rd = cfg.rwkv_decay_rank
    p["w_lora_a"] = L.param(gen, (d, rd), scale=0.01, **kw)
    p["w_lora_b"] = L.param(gen, (rd, d), scale=0.01, **kw)
    p["u"] = L.param(gen, (H, Dh), scale=0.5, **f32)
    r = cfg.rwkv_mix_rank
    p["ln_x"] = L.param(gen, (d,), init="ones" if r else "zeros", **f32)
    if r:
        p["mix_x"] = L.param(gen, (d,), scale=0.5, **f32)
        p["mix_lora_a"] = L.param(gen, (d, len(MIX) * r), scale=0.01, **kw)
        for c in MIX:
            p[f"mix_lora_b_{c}"] = L.param(gen, (r, d), scale=0.01, **kw)
        p["ln_x_bias"] = L.param(gen, (d,), init="zeros", **f32)
    return p


def init_rwkv_cmix(gen, cfg: ModelConfig, *, dtype, device) -> Tree:
    d, f = cfg.d_model, cfg.d_ff
    kw = dict(dtype=dtype, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "mix_k": L.param(gen, (d,), scale=0.5, **f32),
        "mix_r": L.param(gen, (d,), scale=0.5, **f32),
        "wk": L.param(gen, (d, f), **kw),
        "wv": L.param(gen, (f, d), **kw),
        "wr": L.param(gen, (d, d), **kw),
    }


def _shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """Token shift: x_{t-1} with ``prev`` (B,1,D) as the t=0 predecessor."""
    return torch.cat([prev, x[:, :-1]], dim=1)


def _lerp(x: torch.Tensor, xs: torch.Tensor, mix: torch.Tensor
          ) -> torch.Tensor:
    m = torch.sigmoid(mix.to(torch.float32)).to(x.dtype)
    return x + (xs - x) * m


def _ddlerp(p: Tree, x: torch.Tensor, xs: torch.Tensor
            ) -> Dict[str, torch.Tensor]:
    """Finch's data-dependent lerps x_c for c in w, k, v, r, g (module
    docstring), in x's dtype."""
    dt = x.dtype
    xx = xs - x
    xxx = x + xx * p["mix_x"].to(dt)
    m = torch.tanh(xxx @ p["mix_lora_a"].to(dt)).chunk(len(MIX), dim=-1)
    return {c: x + xx * (p[f"mix_{c}"].to(dt)
                         + m[i] @ p[f"mix_lora_b_{c}"].to(dt))
            for i, c in enumerate(MIX)}


def _group_norm(o: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                H: int, eps: float) -> torch.Tensor:
    """Finch's ``ln_x``: o (B, S, H * Dh) normalised over each head's
    channels in float32, scaled by ``weight`` and shifted by ``bias`` (of
    the rank's heads and channels under tensor parallelism)."""
    x32 = o.float().unflatten(-1, (H, -1))
    var, mean = torch.var_mean(x32, dim=-1, keepdim=True, correction=0)
    y = ((x32 - mean) * torch.rsqrt(var + eps)).flatten(-2)
    return (y * weight.float() + bias.float()).to(o.dtype)


def rwkv_decay(p: Tree, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent decay w_t in (0,1): exp(-exp(w0 + lora(x))) (of the
    channels of ``w0`` and ``w_lora_b``'s columns)."""
    lo = torch.tanh(xw @ p["w_lora_a"].to(xw.dtype)) \
        @ p["w_lora_b"].to(xw.dtype)
    logw = p["w0"].to(torch.float32) + lo.to(torch.float32)
    return torch.exp(-torch.exp(torch.clamp(logw, -8.0, 4.0)))


Split = Tuple[Optional[SH.Mesh], Tuple[str, ...]]


def _blocks(mesh: SH.Mesh, axes, size: int):
    """Rank i's block of ``size`` rows over the ranks of ``axes``, as the
    ranges ``sharding.take_ranges`` reads."""
    step = size // mesh.group_size(axes)
    return lambda i: [(i * step, (i + 1) * step)]


def _tmix_local(p: Tree, cfg: ModelConfig) -> Tuple[Tree, Split]:
    """(the time mix's leaves the rank computes with, the split of its
    heads): module docstring."""
    mesh, axes = SH.split_group(p["u"])
    if not axes:
        return SH.whole_tree(p), (None, ())
    H, _ = _dims(cfg)
    chans, heads = _blocks(mesh, axes, cfg.d_model), _blocks(mesh, axes, H)
    out = {k: SH.whole_in(p[k], mesh, axes)
           for k in [k for k in p if k.startswith("mix_")] + ["w_lora_a"]}
    for name, dim in (("wr", 1), ("wk", 1), ("wv", 1), ("wg", 1),
                      ("wo", 0), ("w0", 0), ("ln_x", 0), ("ln_x_bias", 0),
                      ("w_lora_b", 1)):
        if name in p:
            out[name] = SH.take_ranges(p[name], dim, chans, mesh, axes)
    out["u"] = SH.take_ranges(p["u"], 0, heads, mesh, axes)
    return out, (mesh, axes)


def _cmix_local(p: Tree, cfg: ModelConfig) -> Tuple[Tree, Split]:
    """(the channel mix's leaves the rank computes with, the split):
    ``wk`` and ``wv`` on the rank's block of ``ff``, ``wr`` on its block
    of channels, where all three split over the same ranks."""
    mesh, axes = SH.split_group(p["wk"])
    if not axes or SH.split_axes(p["wr"]) != axes \
            or SH.split_axes(p["wv"]) != axes:
        return SH.whole_tree(p), (None, ())
    ff, chans = (_blocks(mesh, axes, cfg.d_ff),
                 _blocks(mesh, axes, cfg.d_model))
    return ({"mix_k": SH.whole_in(p["mix_k"], mesh, axes),
             "mix_r": SH.whole_in(p["mix_r"], mesh, axes),
             "wk": SH.take_ranges(p["wk"], 1, ff, mesh, axes),
             "wv": SH.take_ranges(p["wv"], 0, ff, mesh, axes),
             "wr": SH.take_ranges(p["wr"], 1, chans, mesh, axes)},
            (mesh, axes))


def apply_tmix(p: Tree, x: torch.Tensor, cfg: ModelConfig,
               prev_tok: torch.Tensor, state: Optional[torch.Tensor]
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Time-mix over a full sequence. ``state`` (B, H, Dh, Dh) float32, or
    None for zeros (the rank's heads under tensor parallelism). Returns
    (out, last_tok, new_state)."""
    with annotate_span(RWKV_TMIX):
        p, split = _tmix_local(p, cfg)
        x = SH.copy_to(x, *split)
        B, S, _ = x.shape
        Dh = cfg.rwkv_head_dim
        H = p["u"].shape[0]
        with annotate_span(RWKV_SHIFT):
            xs = _shift(x, prev_tok)
            if cfg.rwkv_mix_rank:
                xc = _ddlerp(p, x, xs)
            else:
                xc = {c: _lerp(x, xs, p[f"mix_{c}"]) for c in "rkvgw"}

        dt = x.dtype
        # r, k and v stay in the projections' dtype: the kernel and the
        # plain scan widen them to float32 themselves, and return o in
        # their dtype
        with annotate_span(RWKV_PROJ):
            r = (xc["r"] @ p["wr"].to(dt)).reshape(B, S, H, Dh)
            k = (xc["k"] @ p["wk"].to(dt)).reshape(B, S, H, Dh)
            v = (xc["v"] @ p["wv"].to(dt)).reshape(B, S, H, Dh)
            g = xc["g"] @ p["wg"].to(dt)
        g = F.silu(g)
        w = rwkv_decay(p, xc["w"]).reshape(B, S, H, Dh)        # float32
        u = p["u"].to(torch.float32)

        with annotate_span(RWKV_SCAN):
            if cfg.rwkv_impl == "cuda" and S > 1:
                o, state = rwkv6_scan(r, k, v, w, u, state)
            elif cfg.rwkv_impl in ("cuda", "torch"):
                o, state = _wkv_scan(r, k, v, w, u, state)
            else:
                raise ValueError(f"unknown rwkv_impl {cfg.rwkv_impl!r}")
        o = o.reshape(B, S, H * Dh).to(dt)
        if cfg.rwkv_mix_rank:
            o = _group_norm(o, p["ln_x"], p["ln_x_bias"], H, LN_X_EPS)
        else:
            o = L.rms_norm(o, p["ln_x"], cfg.norm_eps, split)
        with annotate_span(RWKV_PROJ):
            y = (o * g) @ p["wo"].to(dt)
        return SH.reduce_from(y, *split), x[:, -1:], state


def apply_cmix(p: Tree, x: torch.Tensor, cfg: ModelConfig,
               prev_tok: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    with annotate_span(RWKV_CMIX):
        p, split = _cmix_local(p, cfg)
        x = SH.copy_to(x, *split)
        xs = _shift(x, prev_tok)
        xk = _lerp(x, xs, p["mix_k"])
        xr = _lerp(x, xs, p["mix_r"])
        dt = x.dtype
        kk = torch.square(torch.relu(xk @ p["wk"].to(dt)))
        y = SH.reduce_scatter(kk @ p["wv"].to(dt), *split, dim=-1)
        out = torch.sigmoid(xr @ p["wr"].to(dt)) * y
        return SH.gather_alike(out, *split, dim=-1), x[:, -1:]


def init_rwkv_state(cfg: ModelConfig, batch: int, dtype, device,
                    split: int = 1) -> Tree:
    """One layer's decode state; ``split`` > 1: a rank's block when the
    heads split over that many ranks (its heads' ``wkv``; the token
    shifts whole)."""
    H, Dh = _dims(cfg)
    return {
        "wkv": torch.zeros((batch, H // split, Dh, Dh), dtype=torch.float32,
                           device=device),
        "tok_t": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                             device=device),
        "tok_c": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                             device=device),
    }


def decode_tmix(p: Tree, x: torch.Tensor, cfg: ModelConfig, st: Tree
                ) -> Tuple[torch.Tensor, Tree]:
    """x: (B,1,d). One-step time-mix against carried state."""
    out, last, wkv = apply_tmix(p, x, cfg, st["tok_t"], st["wkv"])
    return out, {**st, "tok_t": last, "wkv": wkv}


def decode_cmix(p: Tree, x: torch.Tensor, cfg: ModelConfig, st: Tree
                ) -> Tuple[torch.Tensor, Tree]:
    out, last = apply_cmix(p, x, cfg, st["tok_c"])
    return out, {**st, "tok_c": last}
