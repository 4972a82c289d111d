"""Feed-forward layers (counterpart of ``repro.models.ffn``): dense
(SwiGLU when gated, tanh-GeLU 4x otherwise) and mixture-of-experts.

``jax.nn.gelu`` defaults to the tanh approximation, which the reference
uses, so the port asks for ``approximate="tanh"``.

The MoE uses the reference's *row-local capacity dispatch*: top-k routing,
each batch row's tokens packed into per-expert capacity buffers of its
own, over-capacity assignments dropped (Switch-style, capacity factor
1.25; the residual connection passes them through). A row's result
never depends on another row's tokens.

Under a device mesh (``repro_torch.sharding.use_mesh``) ``cfg.moe_impl``
selects the reference's expert-parallel forms, which run on the rank's
own rows with the mesh's process groups:

- ``"ep"`` (layout ``tp``, S > 1): routing replicated over ``model``, each
  rank runs its E/M experts, one all-reduce of the (B, S, D) partial
  outputs over ``model``;
- ``"a2a"`` (layouts ``fsdp``, ``zero1``, ``moe_serve``; S = 1 too): the
  rank's tokens routed together with capacity ``cap`` per (source rank,
  expert), shipped to their experts' owners with one all-to-all and back
  with another; the aux loss averaged over every rank.

Where a route does not apply (no mesh, another layout, E not divisible)
the row-local path runs, as in the reference. ``moe_routes`` counts the
route each call took. The expert-parallel routes take the expert weights
either whole (they slice the rank's experts) or as the rank's
``(E/M, ...)`` block; the row-local path needs them whole.
"""
from __future__ import annotations

import collections
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.config import ModelConfig
from repro_torch.models import layers as L

CAPACITY_FACTOR = 1.25

# calls of apply_moe by the route they took: "gspmd" (row-local), "ep",
# "a2a"; a caller that sets it to zero and reads it knows what ran
moe_routes: collections.Counter = collections.Counter()


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


def _experts(wi: torch.Tensor, wg: torch.Tensor, wo: torch.Tensor,
             ebuf: torch.Tensor) -> torch.Tensor:
    """SwiGLU experts over capacity buffers ([B,] e, C, D), e the leading
    axis of the weights."""
    dt = ebuf.dtype
    b = "b" if ebuf.dim() == 4 else ""
    h = torch.einsum(f"{b}ecd,edf->{b}ecf", ebuf, wi.to(dt))
    g = torch.einsum(f"{b}ecd,edf->{b}ecf", ebuf, wg.to(dt))
    return torch.einsum(f"{b}ecf,efd->{b}ecd", F.silu(g) * h, wo.to(dt))


def _aux(logits: torch.Tensor, probs: torch.Tensor, E: int) -> torch.Tensor:
    """Switch load-balance aux over every token of (B, S, E): E x
    mean_e(fraction of tokens whose argmax is e x mean probability of e).
    The one-hot is by comparison: F.one_hot checks its range on the
    host."""
    sel = (logits.argmax(-1)[..., None]
           == torch.arange(E, device=logits.device)).float()
    return E * torch.mean(sel.mean(dim=(0, 1)) * probs.mean(dim=(0, 1)))


def _dense_branches(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x)
    if "dense" in p:
        out = out + apply_mlp(p["dense"], x)
    return out


def _rows(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
          capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of x (B, S, D) by row-local dispatch at
    ``capacity``: (output without the dense branches, aux)."""
    B, S, D = x.shape
    E, k, C = cfg.num_experts, cfg.top_k, capacity
    dt = x.dtype
    if p["wi"].shape[0] != E:
        raise ValueError(f"the row-local MoE path needs all {E} experts' "
                         f"weights, got a block of {p['wi'].shape[0]}: "
                         f"expert-sharded weights run under moe_impl "
                         f"'ep' or 'a2a' in a mesh")
    logits = (x @ p["router"].to(dt)).float()                  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    buf, slot, keep, flat_w = _route(x, probs, cfg, C)
    y = _experts(p["wi"], p["wg"], p["wo"], buf.view(B, E, C, D))
    y = y.reshape(B, E * C, D)

    # gather back to token order; weight and sum over the k assignments
    y_ent = y.gather(1, slot[..., None].expand(B, S * k, D))   # (B, S*k, D)
    y_ent = y_ent * (keep * flat_w).to(dt)[..., None]
    return y_ent.view(B, S, k, D).sum(dim=2), _aux(logits, probs, E)


def apply_moe(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out in x's dtype, aux loss float32 scalar).

    The row-local path: the router runs in x's dtype, its logits in
    float32; the experts' three einsums run over every expert's (C, D)
    buffer of every row, as the reference computes them (at S = 1, C = 8,
    so a decode step reads every expert's weights). The aux term is the
    Switch load-balance loss. Under a mesh, ``cfg.moe_impl`` may pick an
    expert-parallel route instead (module docstring)."""
    if cfg.moe_impl == "ep" and x.shape[1] > 1:
        out, aux = _apply_moe_ep(p, x, cfg)
        if out is not None:
            return out, aux
    if cfg.moe_impl == "a2a":          # S == 1 decode included
        out, aux = _apply_moe_a2a(p, x, cfg)
        if out is not None:
            return out, aux
    moe_routes["gspmd"] += 1
    out, aux = _rows(p, x, cfg, moe_capacity(x.shape[1], cfg))
    return _dense_branches(p, x, out), aux


# ---------------------------------------------------------------------------
# Expert-parallel MoE over the mesh's process groups
# ---------------------------------------------------------------------------

def _local_experts(w: torch.Tensor, E: int, e_loc: int, index: int
                   ) -> torch.Tensor:
    """The rank's ``e_loc`` experts of an expert weight given whole (E,
    ...) or as the rank's block already (e_loc, ...)."""
    if w.shape[0] == e_loc:
        return w
    if w.shape[0] == E:
        return w[index * e_loc:(index + 1) * e_loc]
    raise ValueError(f"expert weight of {w.shape[0]} experts is neither all "
                     f"{E} nor this rank's {e_loc}")


def _ep_local(x: torch.Tensor, router: torch.Tensor, wi: torch.Tensor,
              wg: torch.Tensor, wo: torch.Tensor, *, cfg: ModelConfig,
              capacity: int, e_loc: int, e_index: int, mesh
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's MoE body: x (B, S, D) the rank's rows, the same on every
    rank of its ``model`` group; wi/wg/wo the rank's (e_loc, ...)
    experts, ``e_index`` its block. Routing and dispatch are computed on
    every rank alike; each rank runs its own experts and combines their
    outputs into a partial (B, S, D), and one all-reduce over ``model``
    sums the partials."""
    B, S, D = x.shape
    E, k, C = cfg.num_experts, cfg.top_k, capacity
    dt = x.dtype

    logits = (x @ router.to(dt)).float()
    probs = torch.softmax(logits, dim=-1)
    buf, slot, keep, flat_w = _route(x, probs, cfg, C)
    # this rank's experts' slots of the (E*C, D) buffer
    e0 = e_index * e_loc
    ebuf = buf[:, e0 * C:(e0 + e_loc) * C].reshape(B, e_loc, C, D)
    y = _experts(wi, wg, wo, ebuf).reshape(B, e_loc * C, D)

    # combine: the assignments that landed in this rank's experts
    local_slot = slot - e0 * C
    local_keep = keep & (local_slot >= 0) & (local_slot < e_loc * C)
    y_ent = y.gather(1, local_slot.clamp(0, e_loc * C - 1)[..., None]
                     .expand(B, S * k, D))
    y_ent = y_ent * (local_keep * flat_w).to(dt)[..., None]
    out = y_ent.view(B, S, k, D).sum(dim=2)
    out = sharding.all_reduce(out, mesh, ("model",))       # ONE combine
    return out, _aux(logits, probs, E)


def _apply_moe_ep(p: Dict[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig
                  ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Expert-parallel MoE over ``model`` under the ``tp`` layout. Returns
    (None, 0) when inapplicable (no mesh, another layout, E not divisible
    by the model axis) so the caller falls back. The aux loss is the mean
    over the data ranks of each rank's aux over its rows."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mesh = sharding.current_mesh()
    if (mesh is None or sharding.current_layout() != "tp"
            or "model" not in mesh.axis_names):
        return None, zero
    M = mesh.shape["model"]
    if cfg.num_experts % M:
        return None, zero
    E, e_loc = cfg.num_experts, cfg.num_experts // M
    index = mesh.index(("model",))
    w = [_local_experts(p[n], E, e_loc, index) for n in ("wi", "wg", "wo")]
    moe_routes["ep"] += 1
    out, aux = _ep_local(x, p["router"], *w, cfg=cfg,
                         capacity=moe_capacity(x.shape[1], cfg), e_loc=e_loc,
                         e_index=index, mesh=mesh)
    dax = sharding.data_axes(mesh)
    aux = sharding.all_reduce(aux, mesh, dax) / mesh.group_size(dax)
    return _dense_branches(p, x, out), aux


def a2a_capacity(tokens: int, cfg: ModelConfig) -> int:
    """The a2a route's capacity per (source rank, expert) for a rank's
    ``tokens`` (the reference's ``cap`` from ``T_loc``): the capacity
    factor over the rank's tokens, at least 8, rounded up to 8. It is
    not ``moe_capacity`` of a row, so the two routes drop differently."""
    cap = math.ceil(tokens * cfg.top_k / cfg.num_experts * CAPACITY_FACTOR)
    return max(8, -(-cap // 8) * 8)


def _a2a_local(x: torch.Tensor, router: torch.Tensor, wi: torch.Tensor,
               wg: torch.Tensor, wo: torch.Tensor, *, cfg: ModelConfig,
               cap: int, e_loc: int, M: int, ep_axes: Tuple[str, ...], mesh
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D): tokens unique to this rank. wi/wg/wo: this rank's
    (e_loc, ...) experts. The rank's B*S tokens are routed together at
    capacity ``cap`` per expert into one (E*cap, D) buffer whose M blocks
    of e_loc experts go to the M ranks of ``ep_axes`` (expert e = m*e_loc
    + j lives on rank m); each rank runs its experts over the M sources'
    blocks and sends the results back."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.top_k
    dt = x.dtype
    T = B * S
    xf = x.reshape(1, T, D)

    logits = (xf @ router.to(dt)).float()                      # (1, T, E)
    probs = torch.softmax(logits, dim=-1)
    # slot = e * cap + pos = m * (e_loc * cap) + j * cap + pos
    buf, slot, keep, flat_w = _route(xf, probs, cfg, cap)

    # ship token slabs to their experts' owners and back
    recv = sharding.all_to_all(buf.view(M, e_loc * cap, D), mesh, ep_axes)
    ebuf = recv.view(M, e_loc, cap, D).transpose(0, 1).reshape(
        e_loc, M * cap, D)
    y = _experts(wi, wg, wo, ebuf)
    y = y.view(e_loc, M, cap, D).transpose(0, 1).reshape(M, e_loc * cap, D)
    back = sharding.all_to_all(y, mesh, ep_axes).view(1, E * cap, D)

    y_ent = back.gather(1, slot[..., None].expand(1, T * k, D))
    y_ent = y_ent * (keep * flat_w).to(dt)[..., None]
    out = y_ent.view(T, k, D).sum(dim=1).view(B, S, D)
    return out, _aux(logits, probs, E)


def _apply_moe_a2a(p: Dict[str, torch.Tensor], x: torch.Tensor,
                   cfg: ModelConfig
                   ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Token-unique all-to-all EP under the fsdp/zero1/moe_serve layouts
    (x is the rank's own rows). EP over every mesh axis when E divides the
    mesh, else over ``model``. Returns (None, 0) when inapplicable."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mesh = sharding.current_mesh()
    if (mesh is None
            or sharding.current_layout() not in ("fsdp", "zero1", "moe_serve")
            or "model" not in mesh.axis_names):
        return None, zero
    all_axes = tuple(mesh.axis_names)
    E = cfg.num_experts
    if E % mesh.size == 0:
        ep_axes, M = all_axes, mesh.size
    elif E % mesh.shape["model"] == 0:
        ep_axes, M = ("model",), mesh.shape["model"]
    else:
        return None, zero
    e_loc = E // M
    index = mesh.index(ep_axes)
    w = [_local_experts(p[n], E, e_loc, index) for n in ("wi", "wg", "wo")]
    moe_routes["a2a"] += 1
    B, S, _ = x.shape
    out, aux = _a2a_local(x, p["router"], *w, cfg=cfg,
                          cap=a2a_capacity(B * S, cfg), e_loc=e_loc, M=M,
                          ep_axes=ep_axes, mesh=mesh)
    aux = sharding.all_reduce(aux, mesh, all_axes) / mesh.size
    return _dense_branches(p, x, out), aux
