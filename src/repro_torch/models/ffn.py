"""Feed-forward layers (counterpart of ``repro.models.ffn``): dense
(SwiGLU when gated, tanh-GeLU 4x otherwise) and mixture-of-experts.

``jax.nn.gelu`` defaults to the tanh approximation, which the reference
uses, so the port asks for ``approximate="tanh"``.

The MoE uses the reference's *row-local capacity dispatch*: top-k routing,
each batch row's tokens packed into per-expert capacity buffers of its
own, over-capacity assignments dropped (Switch-style, capacity factor
1.25; the residual connection passes them through). A row's result
never depends on another row's tokens. The reference's expert-parallel
forms need a device mesh, which the port does not have; they and their
selector field wait for ROADMAP.md Queue 1 item 7.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

CAPACITY_FACTOR = 1.25


# ---------------------------------------------------------------------------
# Dense MLP
# ---------------------------------------------------------------------------

def init_mlp(gen, d_model: int, d_ff: int, gated: bool, *, dtype,
             device) -> Dict[str, torch.Tensor]:
    kw = dict(dtype=dtype, device=device)
    p = {
        "wi": L.param(gen, (d_model, d_ff), **kw),
        "wo": L.param(gen, (d_ff, d_model), **kw),
    }
    if gated:
        p["wg"] = L.param(gen, (d_model, d_ff), **kw)
    return p


def apply_mlp(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if "wg" in p:
        h = F.silu(x @ p["wg"].to(dt)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# Mixture of experts
# ---------------------------------------------------------------------------

def moe_capacity(seq_len: int, cfg: ModelConfig) -> int:
    c = math.ceil(seq_len * cfg.top_k / cfg.num_experts * CAPACITY_FACTOR)
    return max(8, -(-c // 8) * 8)  # round up to a multiple of 8


def init_moe(gen, cfg: ModelConfig, *, dtype,
             device) -> Dict[str, torch.Tensor]:
    """Router (d, E), experts ``wi``/``wg`` (E, d, f) and ``wo`` (E, f, d),
    then the shared experts' and the dense residual branch's MLPs. As in
    the reference, an expert weight's fan-in is its first axis, E."""
    d, f, E = cfg.d_model, cfg.d_ff, cfg.num_experts
    kw = dict(dtype=dtype, device=device)
    p = {
        "router": L.param(gen, (d, E), scale=0.02, **kw),
        "wi": L.param(gen, (E, d, f), **kw),
        "wg": L.param(gen, (E, d, f), **kw),
        "wo": L.param(gen, (E, f, d), **kw),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(gen, d, cfg.num_shared_experts * f, True,
                               **kw)
    if cfg.dense_ff and not cfg.first_dense_layers:
        # arctic-style dense residual branch, parallel to the routed experts
        p["dense"] = init_mlp(gen, d, cfg.dense_ff, True, **kw)
    return p


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest probabilities and their experts, largest first;
    among equal values the lower expert first, as ``jax.lax.top_k``
    orders them (``torch.topk`` promises no order for ties). The order
    fixes each assignment's position in its expert, and so the drops."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x: torch.Tensor, probs: torch.Tensor, cfg: ModelConfig,
           capacity: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor]:
    """Row-local dispatch of every batch row at once (the reference's
    ``_route_row`` under ``vmap``). x: (B, S, D); probs: (B, S, E).

    Returns (buffer (B, E*C, D), slot (B, S*k), keep (B, S*k), weight
    (B, S*k)). An assignment's position in its expert counts the earlier
    assignments to that expert in token-major order; those at or past
    the capacity C are dropped (slot 0, a zero contribution)."""
    B, S, D = x.shape
    E, k, C = cfg.num_experts, cfg.top_k, capacity
    topw, topi = _top_k(probs, k)                              # (B, S, k)
    topw = topw / torch.clamp(topw.sum(-1, keepdim=True), min=1e-9)
    flat_e = topi.reshape(B, S * k)
    flat_w = topw.reshape(B, S * k)
    # the one-hot is laid out (B, E, S*k), so that the cumsum runs along
    # the innermost axis: along an outer axis it took ~3.7 ms a layer on an
    # H100 at B=4, S*k=12288, E=64
    experts = torch.arange(E, device=x.device)
    onehot = experts[:, None] == flat_e[:, None, :]            # (B, E, S*k)
    pos = onehot.cumsum(dim=2, dtype=torch.int32).gather(
        1, flat_e[:, None, :])[:, 0].long() - 1
    keep = pos < C
    slot = torch.where(keep, flat_e * C + pos, torch.zeros_like(pos))
    contrib = torch.where(keep[..., None], x.repeat_interleave(k, dim=1),
                          torch.zeros((), dtype=x.dtype, device=x.device))
    base = (torch.arange(B, device=x.device) * (E * C))[:, None]
    buf = torch.zeros((B * E * C, D), dtype=x.dtype, device=x.device)
    buf.index_add_(0, (base + slot).reshape(-1), contrib.reshape(-1, D))
    return buf.view(B, E * C, D), slot, keep, flat_w


def apply_moe(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out in x's dtype, aux loss float32 scalar).

    The router runs in x's dtype, its logits in float32; the experts'
    three einsums run over every expert's (C, D) buffer of every row, as
    the reference computes them (at S = 1, C = 8, so a decode step reads
    every expert's weights). The aux term is the Switch load-balance
    loss, E x mean_e(fraction of tokens whose argmax is e x mean
    probability of e)."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    C = moe_capacity(S, cfg)
    dt = x.dtype

    logits = (x @ p["router"].to(dt)).float()                  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    buf, slot, keep, flat_w = _route(x, probs, cfg, C)
    ebuf = buf.view(B, E, C, D)

    h = torch.einsum("becd,edf->becf", ebuf, p["wi"].to(dt))
    g = torch.einsum("becd,edf->becf", ebuf, p["wg"].to(dt))
    y = torch.einsum("becf,efd->becd", F.silu(g) * h, p["wo"].to(dt))
    y = y.reshape(B, E * C, D)

    # gather back to token order; weight and sum over the k assignments
    y_ent = y.gather(1, slot[..., None].expand(B, S * k, D))   # (B, S*k, D)
    y_ent = y_ent * (keep * flat_w).to(dt)[..., None]
    out = y_ent.view(B, S, k, D).sum(dim=2)

    if "shared" in p:
        out = out + apply_mlp(p["shared"], x)
    if "dense" in p:
        out = out + apply_mlp(p["dense"], x)

    # one-hot by comparison: F.one_hot checks its range on the host
    sel = (logits.argmax(-1)[..., None]
           == torch.arange(E, device=x.device)).float()
    aux = E * torch.mean(sel.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))
    return out, aux
