"""Logical-axis -> mesh-axis mapping and the collectives that execute it
(counterpart of ``repro.sharding``).

Params carry logical axis names (``repro_torch.models.axes.param_axes``);
this module turns them into partition specs for a mesh. A spec is a plain
tuple with one entry per dimension: ``None`` (replicated), an axis name,
or a tuple of axis names (the dimension split over all of them, in
row-major order of the listed axes) -- the entries of the reference's
``PartitionSpec``. The baseline layout is:

- **TP over ``model``**: heads / kv_heads / ff / experts / vocab / ssm dims.
- **FSDP over ``data``**: the ``embed`` dim of every >=2D weight.
- **DP over ``pod``+``data``**: activation batch dim; the ``pod`` axis is the
  transient/revocation domain.

The spec rules read only axis names and sizes, so they run on a
:class:`MeshView` (built from a ``MeshConfig``) with no process group, as
well as on a :class:`Mesh` from ``repro_torch.launch.mesh``. The mesh has
one process per device (``torch.distributed``); each process holds its
own rows of the batch and its own blocks of the sharded state, and the
collectives here (differentiable ``gather``, ``all_reduce``,
``all_to_all``) move blocks between them. Each collective, forward and
backward, reports itself to the recorders of
``repro_torch.roofline.record_collectives``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import MeshConfig, ModelConfig
from repro_torch.roofline import Collective
from repro_torch.tree import tree_map

Spec = Tuple[Any, ...]

_ctx = threading.local()

# Layouts (same physical mesh, different logical assignment of
# parallelism):
#   "tp"    Megatron-style: TP over 'model' (heads/ff/experts/vocab) +
#           FSDP over the data axes. The paper-faithful baseline.
#   "fsdp"  pure data parallelism: params fully sharded over ALL mesh axes,
#           batch flattened over all axes, zero TP.
#   "zero1" same parameter/optimizer sharding as "fsdp", but the train step
#           gathers the compute copy ONCE per step, except the expert
#           weights, which stay expert-parallel.
#   "moe_serve"  giant-MoE serving: experts EP-resident, non-expert weights
#           TP-resident, tokens flattened over all axes.
LAYOUTS = ("tp", "fsdp", "zero1", "moe_serve")


@dataclasses.dataclass(frozen=True)
class MeshView:
    """A mesh's axis names and sizes, all the spec rules read."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @classmethod
    def from_config(cls, cfg: MeshConfig) -> "MeshView":
        return cls(tuple(cfg.axis_names), tuple(cfg.shape))

    @classmethod
    def from_device_mesh(cls, dm) -> "MeshView":
        return cls(tuple(dm.mesh_dim_names), tuple(dm.mesh.shape))


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh(MeshView):
    """A mesh over the initialised process group (one rank per device),
    built by ``repro_torch.launch.mesh``: the ``DeviceMesh``, this rank's
    coordinate on each axis, and its process group over every subset of
    the axes (keyed by the subset, in mesh order)."""
    device_mesh: Any = None
    coords: Tuple[int, ...] = ()
    groups: Dict[Tuple[str, ...], Any] = dataclasses.field(
        default_factory=dict)
    device: torch.device = torch.device("cpu")

    def group(self, axes: Sequence[str]):
        return self.groups[_in_mesh_order(self, axes)]

    def group_size(self, axes: Sequence[str]) -> int:
        return math.prod(self.shape[a] for a in axes)

    def index(self, axes: Sequence[str]) -> int:
        """This rank's block index over ``axes``: its row-major coordinate
        over them, which is also its rank in ``group(axes)``."""
        coord = dict(zip(self.axis_names, self.coords))
        i = 0
        for a in _in_mesh_order(self, axes):
            i = i * self.shape[a] + coord[a]
        return i


def _in_mesh_order(mesh: MeshView, axes: Sequence[str]) -> Tuple[str, ...]:
    axes = tuple(axes)
    if tuple(a for a in mesh.axis_names if a in axes) != axes:
        raise ValueError(f"axes {axes} are not in the mesh's order "
                         f"{mesh.axis_names}")
    return axes


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes a spec entry names: ``()`` for ``None``."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def spec_axes(spec: Spec) -> Tuple[str, ...]:
    """Every mesh axis a spec names."""
    return tuple(a for e in spec for a in entry_axes(e))


def current_mesh() -> Optional[MeshView]:
    return getattr(_ctx, "mesh", None)


def current_layout() -> str:
    return getattr(_ctx, "layout", "tp")


@contextlib.contextmanager
def use_mesh(mesh: Optional[MeshView], layout: str = "tp"):
    assert layout in LAYOUTS, layout
    prev = current_mesh()
    prev_layout = current_layout()
    _ctx.mesh = mesh
    _ctx.layout = layout
    try:
        yield
    finally:
        _ctx.mesh = prev
        _ctx.layout = prev_layout


def data_axes(mesh: MeshView, layout: str = "tp") -> Tuple[str, ...]:
    if layout in ("fsdp", "zero1", "moe_serve"):
        return tuple(mesh.axis_names)          # batch over everything
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def data_size(mesh: MeshView, layout: str = "tp") -> int:
    n = 1
    for a in data_axes(mesh, layout):
        n *= mesh.shape[a]
    return n


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def _model_ok(dim: int, mesh: MeshView) -> bool:
    # Non-divisible model dims (e.g. 40 heads on a 16-way model axis) fall
    # back to replication + FSDP on the embed dim, as the reference's jit
    # argument shardings require exact divisibility.
    return dim > 1 and dim % mesh.shape["model"] == 0


def param_spec(axes: Sequence[Optional[str]], cfg: ModelConfig,
               mesh: MeshView, shape: Sequence[int], fsdp: bool = True,
               layout: str = "tp") -> Spec:
    """Map one parameter's logical axes to a partition spec."""
    ndims = len(axes)
    entries: list = [None] * ndims

    if layout == "moe_serve" and "experts" not in axes:
        # non-expert weights: TP-resident (no FSDP)
        return param_spec(axes, cfg, mesh, shape, fsdp=False, layout="tp")

    if layout in ("fsdp", "zero1", "moe_serve"):
        all_axes = tuple(mesh.axis_names)
        total = mesh.size
        cands = sorted(range(ndims), key=lambda i: -shape[i])
        # Expert weights keep expert parallelism over 'model' (the a2a MoE
        # path owns that axis) and FSDP the largest other dim over the
        # remaining axes.
        if "experts" in axes and "model" in mesh.axis_names:
            ei = axes.index("experts")
            if shape[ei] > 1 and shape[ei] % mesh.size == 0:
                # one expert (group) per device: full-mesh EP
                entries[ei] = all_axes if len(all_axes) > 1 else all_axes[0]
                return tuple(entries)
            if shape[ei] % mesh.shape["model"] == 0 and shape[ei] > 1:
                entries[ei] = "model"
                rest = tuple(a for a in mesh.axis_names if a != "model")
                rsz = 1
                for a in rest:
                    rsz *= mesh.shape[a]
                for i in cands:
                    if i == ei or axes[i] in ("layers", "blocks"):
                        continue
                    if shape[i] > 1 and shape[i] % rsz == 0:
                        entries[i] = rest if len(rest) > 1 else rest[0]
                        break
                return tuple(entries)
        # Fully shard the largest non-layer-stacked dim over ALL mesh axes
        # (ZeRO-3-style); fall back to the data axes, else replicate.
        for i in cands:
            if axes[i] in ("layers", "blocks") or shape[i] <= 1:
                continue
            if shape[i] % total == 0:
                entries[i] = all_axes if len(all_axes) > 1 else all_axes[0]
                return tuple(entries)
        if fsdp and ndims >= 2:
            dax = data_axes(mesh)
            dsz = data_size(mesh)
            for i in cands:
                if axes[i] in ("layers", "blocks"):
                    continue
                if shape[i] > 1 and shape[i] % dsz == 0:
                    entries[i] = dax if len(dax) > 1 else dax[0]
                    break
        return tuple(entries)

    model_axes = {"heads", "kv_heads", "ff", "experts", "vocab",
                  "ssm_inner", "ssm_heads", "heads_flat", "embed_out"}
    used_model = False
    for i, ax in enumerate(axes):
        dim = shape[i]
        if ax in model_axes and not used_model and _model_ok(dim, mesh):
            entries[i] = "model"
            used_model = True
    # FSDP: shard the (first) embed axis over data -- only for >=2D weights
    if fsdp and ndims >= 2:
        dax = data_axes(mesh)
        dsz = data_size(mesh)
        for i, ax in enumerate(axes):
            if ax == "embed" and entries[i] is None and shape[i] % dsz == 0:
                entries[i] = dax if len(dax) > 1 else dax[0]
                break
    return tuple(entries)


@dataclasses.dataclass(frozen=True, eq=False)
class NamedSharding:
    """One leaf's placement: the mesh, its spec and its logical axes (the
    train step reads the axes to keep expert weights expert-parallel)."""
    mesh: MeshView
    spec: Spec
    axes: Tuple[Optional[str], ...]


_HWIO = (2, 3, 1, 0)        # the OIHW dims of H, W, I, O
_OIHW = (3, 2, 0, 1)        # the HWIO dims of O, I, H, W


def param_shardings(axes_tree, cfg: ModelConfig, mesh: MeshView,
                    fsdp: bool = True, layout: str = "tp"):
    """``param_axes(cfg)`` -> matching tree of :class:`NamedSharding`; the
    shapes come from ``cfg``'s parameter tree, built on ``meta``. A resnet
    conv weight (OIHW here, HWIO in the reference) gets the spec the
    rules give its HWIO form, permuted: the rules break ties between
    equal dims by their order."""
    from repro_torch.models.axes import param_shapes

    def one(axes, shape):
        if cfg.family == "resnet" and len(shape) == 4:
            spec = param_spec(tuple(axes[i] for i in _HWIO), cfg, mesh,
                              tuple(shape[i] for i in _HWIO), fsdp=fsdp,
                              layout=layout)
            spec = tuple(spec[i] for i in _OIHW)
        else:
            spec = param_spec(axes, cfg, mesh, shape, fsdp=fsdp,
                              layout=layout)
        return NamedSharding(mesh, spec, tuple(axes))
    return tree_map(one, axes_tree, param_shapes(cfg))


def opt_state_spec(axes: Sequence[Optional[str]], cfg: ModelConfig,
                   mesh: MeshView, shape: Sequence[int],
                   zero1: bool = True) -> Spec:
    """Optimizer-state sharding -- same as params (ZeRO-1 comes free with
    FSDP params; kept as a separate hook so non-FSDP layouts can still
    shard optimizer state)."""
    return param_spec(axes, cfg, mesh, shape, fsdp=zero1)


# ---------------------------------------------------------------------------
# Activation specs
# ---------------------------------------------------------------------------

_ACT_MAP = {
    "batch": "DATA",       # resolved to ("pod","data") / ("data",)
    "heads": "model",
    "kv_heads": "model",
    "ff": "model",
    "experts": "model",
    "vocab": "model",
    "ssm_inner": "model",
    "kv_seq": "DATA",      # long-context decode: shard the cache over data
}


def act_spec(axes: Sequence[Optional[str]], mesh: MeshView,
             shape: Optional[Sequence[int]] = None,
             layout: str = "tp") -> Spec:
    """Activation spec; skips axes whose size doesn't divide the mesh
    extent (e.g. batch=1 long-context decode)."""
    entries = []
    for i, ax in enumerate(axes):
        tgt = _ACT_MAP.get(ax)
        if tgt == "DATA":
            dax = data_axes(mesh, layout)
            if shape is not None and shape[i] % data_size(mesh, layout) != 0:
                entries.append(None)
            else:
                entries.append(dax if len(dax) > 1 else dax[0])
        elif tgt is not None:
            if layout in ("fsdp", "zero1", "moe_serve"):
                entries.append(None)       # no TP: model-ish dims replicate
            elif shape is not None and shape[i] % mesh.shape["model"] != 0:
                entries.append(None)
            else:
                entries.append(tgt)
        else:
            entries.append(None)
    return tuple(entries)


def shard_act(x: torch.Tensor, axes: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """No-op. The reference pins an activation's sharding for GSPMD; here
    each process computes on its own rows, and the model-sharded compute
    (``Sharded`` leaves, :func:`copy_to`, :func:`reduce_from`) places the
    collectives those pins imply explicitly, so there is nothing left to
    pin."""
    return x


# ---------------------------------------------------------------------------
# Execution: blocks and differentiable collectives
# ---------------------------------------------------------------------------

# The open recorders of ``repro_torch.roofline.record_collectives``: each
# collective below appends its record to every one. Empty, the check
# costs one read.
recorders: list = []


def _record(kind: str, out: torch.Tensor, group) -> None:
    c = Collective(kind, out.numel() * out.element_size(),
                   dist.get_world_size(group))
    for r in recorders:
        r.append(c)


def _all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    # torch 2.13 renames all_gather_into_tensor (the name 2.11 has)
    fn = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    fn(out, x, group=group)
    if recorders:
        _record("all-gather", out, group)


def _reduce_scatter(out: torch.Tensor, x: torch.Tensor, group) -> None:
    fn = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    fn(out, x, op=dist.ReduceOp.SUM, group=group)
    if recorders:
        _record("reduce-scatter", out, group)


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    dist.all_reduce(x, op=op, group=group)
    if recorders:
        _record("all-reduce", x, group)


def _all_to_all(out: torch.Tensor, x: torch.Tensor, group,
                out_splits: Optional[Sequence[int]] = None,
                in_splits: Optional[Sequence[int]] = None) -> None:
    """All-to-all along dim 0, equal blocks, or ``in_splits[t]`` rows to
    group rank t and ``out_splits[s]`` from rank s (recorded by the rows
    this rank receives)."""
    dist.all_to_all_single(out, x, out_splits, in_splits, group=group)
    if recorders:
        _record("all-to-all", out, group)


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` in group-rank order; the backward
    reduce-scatters the gradient (a sum over the group) at its own
    dtype. With ``index`` (this rank's place in the group) the backward
    instead keeps the rank's own block of the gradient and moves
    nothing: for a group whose ranks hold the same rows and compute the
    same gradient (the model ranks of the ``tp`` layout, when a leaf
    stored sharded over them is used whole)."""

    @staticmethod
    def forward(ctx, x, dim, group, n, index=None):
        ctx.dim, ctx.group, ctx.n, ctx.index = dim, group, n, index
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + src.shape[1:])
        _all_gather(out, src, group)
        return out.movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, grad):
        if ctx.index is not None:
            step = grad.shape[ctx.dim] // ctx.n
            return (grad.narrow(ctx.dim, ctx.index * step, step),
                    None, None, None, None)
        src = grad.movedim(ctx.dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // ctx.n,) + src.shape[1:])
        _reduce_scatter(out, src, ctx.group)
        return out.movedim(0, ctx.dim), None, None, None, None


class _AllReduce(torch.autograd.Function):
    """Sum over the group. Every rank's loss reads the sum, so the
    backward sums the gradients over the group too."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        _all_reduce(out, ctx.group)
        return out, None


class _TpIn(torch.autograd.Function):
    """Identity forward, sum over the group backward: where a tensor that
    every rank of a tensor-parallel group holds alike enters that group's
    sharded compute, each rank's gradient of it is a partial sum."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        out = grad.contiguous().clone()
        _all_reduce(out, ctx.group)
        return out, None


class _TpOut(torch.autograd.Function):
    """Sum over the group forward, identity backward: after a row-parallel
    product, each rank's partial output summed into the value every rank
    of the group then holds alike (and each rank's gradient of the sum is
    already the whole one)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        _all_reduce(out, group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _AllToAll(torch.autograd.Function):
    """Equal-split all-to-all along dim 0: block i goes to group rank i,
    block j of the result came from group rank j. The backward is the
    same exchange of the gradient's blocks."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = torch.empty_like(x)
        _all_to_all(out, x.contiguous(), group)
        return out

    @staticmethod
    def backward(ctx, grad):
        out = torch.empty_like(grad)
        _all_to_all(out, grad.contiguous(), ctx.group)
        return out, None


class _ReduceScatter(torch.autograd.Function):
    """Sum over the group, then this rank's block of ``dim`` (group-rank
    order); the backward all-gathers the gradient's blocks."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + src.shape[1:])
        _reduce_scatter(out, src, group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        src = grad.movedim(ctx.dim, 0).contiguous()
        out = src.new_empty((ctx.n * src.shape[0],) + src.shape[1:])
        _all_gather(out, src, ctx.group)
        return out.movedim(0, ctx.dim), None, None, None


Ranges = Sequence[Tuple[int, int]]


def _pieces(ranges: Ranges, lo: int, hi: int) -> list:
    """(offset from ``lo``, length) of each part of ``ranges`` inside
    [lo, hi), in order."""
    out = []
    for a, b in ranges:
        a, b = max(a, lo), min(b, hi)
        if a < b:
            out.append((a - lo, b - a))
    return out


class _Regroup(torch.autograd.Function):
    """An uneven all-to-all along ``dim``: group rank s holds the block s
    of the dim (``blk`` rows of a dim split into contiguous blocks), and
    rank t receives the rows ``wants[t]`` (sorted, disjoint global
    ranges), in order. Each rank sends only what another asks for. The
    backward is the transposed exchange: each rank's gradient of the
    rows it received goes back to their owners, which sum what several
    ranks send for one row."""

    @staticmethod
    def forward(ctx, x, dim, group, me, wants):
        blk = x.shape[dim]
        send = [_pieces(w, me * blk, (me + 1) * blk) for w in wants]
        ins = [sum(m for _, m in p) for p in send]
        outs = [sum(m for _, m in _pieces(wants[me], s * blk,
                                         (s + 1) * blk))
                for s in range(len(wants))]
        src = x.movedim(dim, 0)
        buf = torch.cat([src.narrow(0, a, m) for p in send for a, m in p])
        out = src.new_empty((sum(outs),) + src.shape[1:])
        _all_to_all(out, buf, group, outs, ins)
        ctx.dim, ctx.group, ctx.blk = dim, group, blk
        ctx.send, ctx.ins, ctx.outs = send, ins, outs
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, grad):
        g = grad.movedim(ctx.dim, 0).contiguous()
        back = g.new_empty((sum(ctx.ins),) + g.shape[1:])
        _all_to_all(back, g, ctx.group, ctx.ins, ctx.outs)
        out = g.new_zeros((ctx.blk,) + g.shape[1:])
        off = 0
        for p in ctx.send:
            for a, m in p:
                out.narrow(0, a, m).add_(back.narrow(0, off, m))
                off += m
        return out.movedim(0, ctx.dim), None, None, None, None


def all_reduce(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]
               ) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks of ``axes``."""
    return _AllReduce.apply(x, mesh.group(axes))


def all_to_all(x: torch.Tensor, mesh: Mesh, axes: Sequence[str]
               ) -> torch.Tensor:
    """Differentiable equal-split all-to-all over the ranks of ``axes``."""
    return _AllToAll.apply(x, mesh.group(axes))


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def all_reduce_(x: torch.Tensor, mesh: Mesh, axes: Sequence[str],
                op: str = "sum") -> torch.Tensor:
    """``x`` reduced over the ranks of ``axes`` by ``op`` (``"sum"``,
    ``"max"`` or ``"min"``), in place and outside autograd; returns
    ``x``."""
    _all_reduce(x, mesh.group(axes), _OPS[op])
    return x


def local_shard(full: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec``: a dim whose entry
    names axes splits into prod(sizes) contiguous blocks, in row-major
    order of the listed axes. A copy that owns its storage."""
    x = full
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = mesh.group_size(axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(full.shape)} does not "
                             f"split over {axes} ({n})")
        step = x.shape[dim] // n
        x = x.narrow(dim, mesh.index(axes) * step, step)
    return x.clone(memory_format=torch.contiguous_format)


def gather(local: torch.Tensor, spec: Spec, mesh: Mesh) -> torch.Tensor:
    """The full tensor from every rank's ``local`` block (the inverse of
    :func:`local_shard`), differentiably: the backward of each dim's
    all-gather is a reduce-scatter of the gradient over the same
    group."""
    x = local
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if axes:
            x = _Gather.apply(x, dim, mesh.group(axes), mesh.group_size(axes))
    return x


# ---------------------------------------------------------------------------
# Per-use gathers and tensor-parallel compute
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class Sharded:
    """A parameter leaf as the sharded steps hand it to the model: this
    rank's ``block`` of a leaf with ``spec`` on ``mesh``, gathered where
    the model uses it (:func:`take`), inside the layer that uses it, so
    that under remat the backward gathers it again and the full copy
    lives only while the layer runs.

    ``tp_axes`` are the mesh axes over which ranks hold the same rows
    (``model`` under the ``tp`` layout, none under ``fsdp``): a dim sharded
    over them may stay sharded in the compute (tensor parallelism), and a
    gather over them backs off to the rank's own block of the gradient,
    since those ranks compute the same one. ``unbind(0)`` takes the
    layers of a layer-stacked leaf (its first entry must be ``None``), so
    ``tree.tree_unbind`` works on trees of these."""
    block: torch.Tensor
    spec: Spec
    mesh: Mesh
    tp_axes: Tuple[str, ...] = ()

    def unbind(self, dim: int = 0):
        if dim != 0 or self.spec[0] is not None:
            raise ValueError(f"unbind a layer-stacked leaf on its unsharded "
                             f"dim 0 (spec {self.spec})")
        return tuple(Sharded(b, self.spec[1:], self.mesh, self.tp_axes)
                     for b in self.block.unbind(0))


def wrap_tree(blocks, shardings, layout: str = "tp"):
    """The rank's blocks as :class:`Sharded` leaves: the tree a sharded
    step hands to ``Model.apply`` or ``Model.decode``."""
    def one(x, s: NamedSharding):
        dax = data_axes(s.mesh, layout)
        tp = tuple(a for a in s.mesh.axis_names if a not in dax)
        return Sharded(x, s.spec, s.mesh, tp)
    return tree_map(one, blocks, shardings)


def _kept(x: Sharded, keep: Optional[Sequence[str]]) -> Spec:
    """The entries of ``x.spec`` that stay sharded under ``keep`` (default
    its ``tp_axes``): those whose axes all lie in it."""
    keep = x.tp_axes if keep is None else tuple(keep)
    return tuple(e if entry_axes(e) and set(entry_axes(e)) <= set(keep)
                 else None for e in x.spec)


def take(x, keep: Optional[Sequence[str]] = None) -> torch.Tensor:
    """The compute form of a parameter leaf: a plain tensor as it is; a
    :class:`Sharded` leaf gathered over every spec entry whose axes are
    not all in ``keep`` (default: its ``tp_axes``), differentiably. What
    stays sharded is the rank's block over ``keep``; ``keep=()`` gives
    the whole leaf."""
    if not isinstance(x, Sharded):
        return x
    out, mesh = x.block, x.mesh
    for dim, (entry, kept) in enumerate(zip(x.spec, _kept(x, keep))):
        axes = entry_axes(entry)
        if not axes or kept is not None:
            continue
        index = mesh.index(axes) if set(axes) <= set(x.tp_axes) else None
        out = _Gather.apply(out, dim, mesh.group(axes),
                            mesh.group_size(axes), index)
    return out


def whole(x) -> torch.Tensor:
    """The whole leaf (``take(x, keep=())``)."""
    return take(x, keep=())


def whole_tree(tree):
    """Every leaf of ``tree`` whole (:func:`whole`)."""
    return tree_map(whole, tree)


def split_axes(x) -> Tuple[str, ...]:
    """The mesh axes the compute form of ``x`` (:func:`take`, default
    ``keep``) stays sharded over: ``()`` for a plain tensor, or for a
    leaf used whole."""
    if not isinstance(x, Sharded):
        return ()
    return spec_axes(_kept(x, None))


def split_index(x) -> int:
    """This rank's block index over :func:`split_axes` of ``x``."""
    axes = split_axes(x)
    return x.mesh.index(axes) if axes else 0


def split_group(x) -> Tuple[Optional[Mesh], Tuple[str, ...]]:
    """(mesh, :func:`split_axes`) of ``x``: the group over which its
    compute form is split, ``(None, ())`` when it is not."""
    axes = split_axes(x)
    return (x.mesh if axes else None), axes


def copy_to(x: torch.Tensor, mesh: Optional[Mesh], axes: Sequence[str]
            ) -> torch.Tensor:
    """``x``, held alike by the ranks of ``axes``, entering their sharded
    compute: identity forward; the backward sums the ranks' partial
    gradients. ``x`` itself when ``axes`` is empty (e.g. a
    :func:`split_group` of a leaf that is not split)."""
    return _TpIn.apply(x, mesh.group(axes)) if axes else x


def reduce_from(x: torch.Tensor, mesh: Optional[Mesh], axes: Sequence[str]
                ) -> torch.Tensor:
    """The sum over the ranks of ``axes`` of their partial ``x`` (after a
    row-parallel product); the backward passes the gradient through.
    ``x`` itself when ``axes`` is empty."""
    return _TpOut.apply(x, mesh.group(axes)) if axes else x


def reduce_scatter(x: torch.Tensor, mesh: Optional[Mesh],
                   axes: Sequence[str], dim: int) -> torch.Tensor:
    """The sum over the ranks of ``axes`` of their partial ``x`` (after a
    row-parallel product), of which this rank keeps its block of
    ``dim``; the backward all-gathers the gradient. ``x`` itself when
    ``axes`` is empty."""
    if not axes:
        return x
    return _ReduceScatter.apply(x, dim, mesh.group(axes),
                                mesh.group_size(axes))


def gather_alike(x: torch.Tensor, mesh: Optional[Mesh],
                 axes: Sequence[str], dim: int) -> torch.Tensor:
    """The blocks of ``dim`` that the ranks of ``axes`` hold, put together,
    where those ranks then go on alike: the backward keeps the rank's
    block of the gradient, which each of them holds whole. ``x`` itself
    when ``axes`` is empty."""
    if not axes:
        return x
    return _Gather.apply(x, dim, mesh.group(axes), mesh.group_size(axes),
                         mesh.index(axes))


def _merged(ranges: Ranges) -> list:
    out: list = []
    for a, b in ranges:
        if out and out[-1][1] == a:
            out[-1] = (out[-1][0], b)
        elif a < b:
            out.append((a, b))
    return out


def take_ranges(x, dim: int, wants: Callable[[int], Ranges], mesh: Mesh,
                axes: Sequence[str]) -> torch.Tensor:
    """The parts of a leaf that this rank computes with, where the ranks
    of ``axes`` compute tensor-parallel: ``wants(i)`` gives the sorted,
    disjoint ``(lo, hi)`` ranges of the whole leaf's dim ``dim`` that
    block ``i`` over ``axes`` takes, and they come in that order. The
    leaf is gathered over the other axes of its spec (:func:`take`); then

    - split on ``dim`` over ``axes`` (contiguous blocks): each rank gets
      its parts from their owners in one uneven all-to-all over the
      group (none when every rank wants its own block), and in the
      backward each owner sums what the ranks send back for its block;
    - not split over ``axes``: the rank slices its parts, and the
      backward sums the ranks' gradients (:func:`copy_to`), so that each
      holds the whole leaf's."""
    axes = tuple(axes)
    n, me = mesh.group_size(axes), mesh.index(axes)
    if isinstance(x, Sharded) and entry_axes(x.spec[dim]) == axes:
        local = take(x)
        blk = local.shape[dim]
        every = [_merged(wants(t)) for t in range(n)]
        if all(w == [(t * blk, (t + 1) * blk)] for t, w in enumerate(every)):
            return local
        return _Regroup.apply(local, dim, mesh.group(axes), me, every)
    if isinstance(x, Sharded) and set(spec_axes(x.spec)) & set(axes):
        raise ValueError(f"a leaf of spec {x.spec} is split over {axes} "
                         f"on another dim than {dim}")
    full = copy_to(take(x), mesh, axes)
    parts = [full.narrow(dim, a, b - a) for a, b in _merged(wants(me))]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def whole_in(x, mesh: Optional[Mesh], axes: Sequence[str]) -> torch.Tensor:
    """A leaf used whole inside the tensor-parallel compute of the ranks
    of ``axes``, where each rank's gradient of it is a partial sum: the
    whole leaf (:func:`whole`), whose gradient is summed over them
    (:func:`copy_to`)."""
    return copy_to(whole(x), mesh, axes)


# the decode cache's sequence axis: the mesh and the axes its positions
# are split over, set by a sharded serve step for its decode cells
def kv_seq() -> Optional[Tuple[Mesh, Tuple[str, ...]]]:
    return getattr(_ctx, "kv_seq", None)


@contextlib.contextmanager
def use_kv_seq(mesh: Optional[Mesh], axes: Sequence[str] = ()):
    """Within the block, the decode cells read a KV cache whose positions
    are split over ``axes`` in contiguous blocks (``None``: whole)."""
    prev = kv_seq()
    _ctx.kv_seq = (mesh, tuple(axes)) if mesh is not None and axes else None
    try:
        yield
    finally:
        _ctx.kv_seq = prev


def local_batch(batch: Dict[str, torch.Tensor], mesh: Mesh,
                layout: str = "tp") -> Dict[str, torch.Tensor]:
    """This rank's rows of every batch leaf (batch on dim 0) over
    ``data_axes(mesh, layout)``: contiguous blocks in row-major order."""
    axes = data_axes(mesh, layout)
    n, i = mesh.group_size(axes), mesh.index(axes)
    out = {}
    for key, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"batch leaf {key!r} of {x.shape[0]} rows does "
                             f"not split over {axes} ({n} ranks)")
        rows = x.shape[0] // n
        out[key] = x[i * rows:(i + 1) * rows]
    return out


def shard_tree(tree, shardings):
    """Every leaf's :func:`local_shard` under its :class:`NamedSharding`."""
    return tree_map(lambda x, s: local_shard(x, s.spec, s.mesh), tree,
                    shardings)


@torch.no_grad()
def unshard_tree(tree, shardings):
    """The full leaves from every rank's blocks (collective)."""
    return tree_map(lambda x, s: gather(x, s.spec, s.mesh), tree, shardings)


def replication(spec: Spec, mesh: MeshView) -> int:
    """How many ranks hold each block of a leaf with ``spec``."""
    return mesh.size // math.prod(mesh.shape[a] for a in spec_axes(spec))
