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
``(E/M, ...)`` block.

The weights may be ``sharding.Sharded`` leaves, gathered here where they
are used: the router whole; the experts as the rank's block where the
spec splits them over ``model``, on every route (the row-local path's
too: under ``tp`` it runs the rank's experts, or its block of ``ff``
where E does not divide the model axis, and one all-reduce over
``model`` sums the partial outputs, at S = 1 as well); and the dense
MLPs (moonshot's shared experts, arctic's dense branch, every dense
layer's MLP) tensor-parallel under ``tp``: ``wi``/``wg`` column-parallel
on ``ff``, ``wo`` row-parallel, one all-reduce after it.
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
    xi = sharding.copy_to(x, *sharding.split_group(p["wi"]))
    h = xi @ sharding.take(p["wi"]).to(dt)
    if "wg" in p:
        h = F.silu(xi @ sharding.take(p["wg"]).to(dt)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    return sharding.reduce_from(h @ sharding.take(p["wo"]).to(dt),
                                *sharding.split_group(p["wo"]))


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


def _aux_over(logits: torch.Tensor, probs: torch.Tensor, E: int, mesh,
              axes: Tuple[str, ...]) -> torch.Tensor:
    """:func:`_aux` over every token of the ranks of ``axes`` (which hold
    distinct rows): one differentiable all-reduce of each expert's argmax
    count and probability sum, as the reference's aux over its global
    batch is under GSPMD."""
    sel = (logits.argmax(-1)[..., None]
           == torch.arange(E, device=logits.device)).float()
    stats = torch.cat([sel.sum(dim=(0, 1)), probs.sum(dim=(0, 1))])
    stats = sharding.all_reduce(stats, mesh, axes)
    n = logits.shape[0] * logits.shape[1] * mesh.group_size(axes)
    return E * torch.mean((stats[:E] / n) * (stats[E:] / n))


def _dense_branches(p: Dict[str, torch.Tensor], x: torch.Tensor,
                    out: torch.Tensor) -> torch.Tensor:
    if "shared" in p:
        out = out + apply_mlp(p["shared"], x)
    if "dense" in p:
        out = out + apply_mlp(p["dense"], x)
    return out


def _rows(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
          capacity: int, aux_axes: Tuple[str, ...] = (), *,
          e_index: int = 0, group=None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of x (B, S, D) by row-local dispatch at
    ``capacity``: (output without the dense branches, aux); the aux over
    the rows of the current mesh's ``aux_axes`` too when given.

    ``p["router"]`` is whole. The experts ``wi``/``wg``/``wo`` are all E
    experts whole, or block ``e_index`` of e_loc experts, or every
    expert's block of ``ff``. With ``group`` (mesh, axes), the ranks of
    ``axes`` hold the same x and each computes the partial output of its
    experts (or of its ``ff`` block), summed over them where it leaves
    (``sharding.reduce_from``); their gradients of the dispatched tokens
    and of the combine weights are partial and summed where they enter
    (``sharding.copy_to``). Routing and dispatch run on every rank
    alike."""
    B, S, D = x.shape
    E, k, C = cfg.num_experts, cfg.top_k, capacity
    dt = x.dtype
    e_loc = p["wi"].shape[0]
    if group is None and e_loc != E:
        raise ValueError(f"the row-local MoE path needs all {E} experts' "
                         f"weights or a group to sum a block of them over, "
                         f"got a block of {e_loc}")
    logits = (x @ p["router"].to(dt)).float()                  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    xe = x if group is None else sharding.copy_to(x, *group)
    buf, slot, keep, flat_w = _route(xe, probs, cfg, C)
    if group is not None:
        flat_w = sharding.copy_to(flat_w, *group)
    if e_loc != E:
        # this rank's experts' slots of the (E*C, D) buffer
        e0 = e_index * e_loc
        buf = buf[:, e0 * C:(e0 + e_loc) * C]
        slot = slot - e0 * C
        keep = keep & (slot >= 0) & (slot < e_loc * C)
        slot = slot.clamp(0, e_loc * C - 1)
    y = _experts(p["wi"], p["wg"], p["wo"], buf.reshape(B, e_loc, C, D))
    y = y.reshape(B, e_loc * C, D)

    # gather back to token order; weight and sum over the k assignments
    y_ent = y.gather(1, slot[..., None].expand(B, S * k, D))   # (B, S*k, D)
    y_ent = y_ent * (keep * flat_w).to(dt)[..., None]
    out = y_ent.view(B, S, k, D).sum(dim=2)
    if group is not None:
        out = sharding.reduce_from(out, *group)       # ONE combine
    if aux_axes:
        aux = _aux_over(logits, probs, E, sharding.current_mesh(), aux_axes)
    else:
        aux = _aux(logits, probs, E)
    return out, aux


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
    w = {n: sharding.take(p[n]) for n in ("wi", "wg", "wo")}
    w["router"] = sharding.whole(p["router"])
    # under tp the experts' spec splits ``experts`` over ``model`` (or
    # ``ff``, where E does not divide it): run on the rank's block
    split, axes = {}, sharding.split_axes(p["wi"])
    if axes:
        if any(sharding.split_axes(p[n]) != axes for n in ("wg", "wo")):
            raise ValueError("the experts' wi, wg and wo split over "
                             "different axes")
        split = dict(group=(p["wi"].mesh, axes), e_index=(
            sharding.split_index(p["wi"])
            if w["wi"].shape[0] != cfg.num_experts else 0))
    out, aux = _rows(w, x, cfg, moe_capacity(x.shape[1], cfg),
                     _sharded_rows(p["router"]), **split)
    return _dense_branches(p, x, out), aux


def _sharded_rows(router) -> Tuple[str, ...]:
    """The data axes of a sharded step (its leaves come as
    ``sharding.Sharded``), over which the row-local aux is taken, when a
    gradient is wanted (a forward without one, as a decode step, reads
    no aux); ``()`` otherwise."""
    mesh = sharding.current_mesh()
    if (not isinstance(router, sharding.Sharded) or mesh is None
            or not torch.is_grad_enabled()):
        return ()
    axes = sharding.data_axes(mesh, sharding.current_layout())
    return axes if mesh.group_size(axes) > 1 else ()


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
    w = [_local_experts(sharding.take(p[n], ("model",)), E, e_loc, index)
         for n in ("wi", "wg", "wo")]
    moe_routes["ep"] += 1
    w = dict(zip(("wi", "wg", "wo"), w), router=sharding.whole(p["router"]))
    out, aux = _rows(w, x, cfg, moe_capacity(x.shape[1], cfg),
                     e_index=index, group=(mesh, ("model",)))
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
    w = [_local_experts(sharding.take(p[n], ep_axes), E, e_loc, index)
         for n in ("wi", "wg", "wo")]
    moe_routes["a2a"] += 1
    B, S, _ = x.shape
    out, aux = _a2a_local(x, sharding.whole(p["router"]), *w, cfg=cfg,
                          cap=a2a_capacity(B * S, cfg), e_loc=e_loc, M=M,
                          ep_axes=ep_axes, mesh=mesh)
    aux = sharding.all_reduce(aux, mesh, all_axes) / mesh.size
    return _dense_branches(p, x, out), aux
