"""Abstract inputs and sharding specs of every dry-run cell (counterpart
of ``repro.launch.specs``).

``input_specs(model, cfg, shape)`` gives the shapes and dtypes of the
inputs that the cell's step takes, as :class:`TensorSpec` records, with
no allocation and no draw: they come from the constructors the real
pipeline uses, ``data.pipeline.make_batch`` and ``Model.init_cache``, run
on the ``meta`` device, so the specs cannot drift from real batches.

``batch_shardings``, ``cache_shardings`` and ``token_sharding`` map those
inputs onto a mesh (a ``sharding.MeshView`` or a live ``sharding.Mesh``)
as partition specs, tuples with one entry per dimension (the entries of
the reference's ``PartitionSpec``): batch rows over the data axes; KV
caches batch-first, falling back to *sequence* sharding for long-context
decode (long_500k has B=1 -- the cache is the memory footprint, so its
512k axis shards over ``data``); SSM states shard heads over ``model``.

The cache rules are the reference's, matched on the leaf's path in the
same order. The port's cache leaves carry the reference's names (paths
``kv/k`` here, ``['kv']/['k']`` there), so each rule meets the same
leaves:

=====================================  ==================================
port leaf (shape)                      rule
=====================================  ==================================
``kv/{k,v}``, ``kv_dense/{k,v}``,      ``kv``: B over data, else the
``shared_kv/{k,v}``                    sequence over data; KV heads over
(L, B, S, KV, Dh)                      model when they divide and KV > 1
``xk``, ``xv`` (L, B, S_enc, KV, Dh)   ``kv``
``wkv`` (L, B, H, Dh, Dh)              ``kv`` (a 5-D path containing
                                       "kv" meets it first, so the
                                       reference's own ``wkv`` rule is
                                       never reached: B over data, else
                                       H; Dh over model)
``blocks/state`` (n, cad, B, H, N, P), ``state``: heads over model, B
``tail/state`` (n, B, H, N, P)         over data
``blocks/conv``, ``tail/conv``         ``conv``: channels over model
(..., B, 3, C)
``tok_t``, ``tok_c`` (L, B, 1, d)      ``tok``: B over data
``pos`` (B,)                           none: replicated, ``(None,)`` (the
                                       reference's ``pos`` rule tests
                                       ``endswith("pos")`` on a path that
                                       ends in ``']``, so its leaf takes
                                       this fall-through)
=====================================  ==================================

A rank's block of the cache, as the sharded serve step computes on it
(:func:`cache_block`, ``Model.init_cache(**block)``), is the block these
specs give, except where the ``tp`` compute needs another: the KV heads
split only under ``tp``; a ``conv`` leaf holds the rank's rows (as
``state`` does) and its channels [x, B, C] (d_inner / M + 2N of them)
where the spec gives every row and a contiguous block of
(d_inner + 2N) / M channels; a ``wkv`` leaf holds the rank's heads
(B, H / M, Dh, Dh), the reference's ``wkv`` rule, where the ``kv`` rule
that meets it first splits its Dh over ``model``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.data.pipeline import make_batch
from repro_torch.models import modality
from repro_torch.models.builder import Model
from repro_torch.sharding import (MeshView, Spec, data_axes, data_size,
                                  entry_axes, param_spec, spec_axes)
from repro_torch.tree import tree_leaves, tree_map

Tree = Any
META = torch.device("meta")


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A leaf's shape and dtype (the reference's ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _spec_of(t: torch.Tensor) -> TensorSpec:
    return TensorSpec(tuple(t.shape), t.dtype)


# ---------------------------------------------------------------------------
# Abstract inputs
# ---------------------------------------------------------------------------

def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig
                      ) -> Dict[str, TensorSpec]:
    return {k: _spec_of(v) for k, v in make_batch(
        cfg, shape.global_batch, shape.seq_len, device=META).items()}


def decode_token_specs(cfg: ModelConfig, shape: ShapeConfig) -> TensorSpec:
    """The decode step's tokens (B, 1), int64 as the engine feeds them."""
    return TensorSpec((shape.global_batch, 1), torch.int64)


def cache_specs(model: Model, cfg: ModelConfig, shape: ShapeConfig) -> Tree:
    enc_len = 0
    if cfg.family == "encdec":
        enc_len, _ = modality.encdec_split(cfg, shape.seq_len)
    return tree_map(_spec_of, model.init_cache(
        shape.global_batch, shape.seq_len, device=META, enc_len=enc_len))


def input_specs(model: Model, cfg: ModelConfig, shape: ShapeConfig) -> Dict:
    """Abstract inputs for the cell's step function.

    train/prefill -> {"batch": ...};  decode -> {"cache": ..., "tokens": ...}
    """
    if shape.kind in ("train", "prefill"):
        return {"batch": train_batch_specs(cfg, shape)}
    return {"cache": cache_specs(model, cfg, shape),
            "tokens": decode_token_specs(cfg, shape)}


# ---------------------------------------------------------------------------
# Shardings
# ---------------------------------------------------------------------------

def _dspec(mesh: MeshView, layout: str = "tp"):
    dax = data_axes(mesh, layout)
    return dax if len(dax) > 1 else dax[0]


def batch_shardings(specs: Dict[str, TensorSpec], mesh: MeshView,
                    layout: str = "tp") -> Dict[str, Spec]:
    """Batch-dim over the data-parallel axes (ALL axes for the fsdp
    layout); everything else replicated."""
    d = _dspec(mesh, layout)

    def one(s: TensorSpec) -> Spec:
        if s.shape and s.shape[0] % data_size(mesh, layout) == 0:
            return (d,) + (None,) * (len(s.shape) - 1)
        return ()
    return {k: one(v) for k, v in specs.items()}


def cache_spec(path: str, shape: Tuple[int, ...], mesh: MeshView) -> Spec:
    """The spec of the cache leaf at ``path`` (module docstring's table).
    The leading axis of every leaf is the stacked-layer dim, never
    sharded. Preference order per leaf:
      1. batch axis over data (decode_32k: B=128)
      2. sequence axis over data (long_500k: B=1, S=512k dominates memory)
      3. head-like axis over model (KV heads / SSM heads) when divisible
    """
    d = _dspec(mesh)
    dsz = data_size(mesh)
    msz = mesh.shape["model"]
    entries: list = [None] * len(shape)
    if not shape:
        return ()
    if any(t in path for t in ("kv", "xk", "xv")) and len(shape) == 5:
        _, B, S, KV, _ = shape
        if B % dsz == 0:
            entries[1] = d
        elif S % dsz == 0:
            entries[2] = d
        if KV % msz == 0 and KV > 1:
            entries[3] = "model"
        return tuple(entries)
    if "state" in path:
        # mamba2 (nb, cad, B, H, N, P) or (nl, B, H, N, P)
        h_ax = len(shape) - 3
        if shape[h_ax] % msz == 0:
            entries[h_ax] = "model"
        b_ax = h_ax - 1
        if shape[b_ax] % dsz == 0:
            entries[b_ax] = d
        return tuple(entries)
    if "conv" in path and len(shape) >= 4:
        if shape[-1] % msz == 0:
            entries[-1] = "model"
        return tuple(entries)
    if "tok" in path and len(shape) == 4:
        if shape[1] % dsz == 0:
            entries[1] = d
        return tuple(entries)
    return tuple(entries)


def attention_cache_block(cfg: ModelConfig, batch: int, max_len: int,
                          mesh: MeshView, layout: str = "tp"
                          ) -> Tuple[int, int, int]:
    """(rows, positions, KV heads) of a rank's block of the attention
    cache leaves (``kv``, ``kv_dense``, ``shared_kv``, encdec's ``kv``,
    ``xk`` and ``xv``) under :func:`cache_spec`'s rule: what
    ``Model.init_cache(rows, positions, kv_heads=)`` builds for the rank.
    The KV heads split over ``model`` only under ``tp``, the layout whose
    attention runs on the rank's heads; the others compute every head
    and hold them all. The recurrent leaves (Mamba-2 ``state`` and
    ``conv``, RWKV-6 ``wkv`` and ``tok_*``) have the same rows; their
    heads split as :func:`recurrent_split` says (:func:`cache_block`
    gives both)."""
    shape = (1, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    spec = cache_spec("kv/k", shape, mesh)
    if layout != "tp":
        spec = spec[:3] + (None, None)
    local = [n // math.prod(mesh.shape[a] for a in entry_axes(e))
             for n, e in zip(shape, spec)]
    return local[1], local[2], local[3]


def recurrent_split(cfg: ModelConfig, mesh: MeshView, layout: str = "tp"
                    ) -> int:
    """How many model ranks the Mamba-2 or RWKV-6 heads of a ``tp`` rank
    split over: the model axis's size where the heads' spec (``A_log``'s,
    ``u``'s) splits them, else 1 (no recurrent layers, heads that do not
    divide, or a layout without tensor parallelism)."""
    if layout != "tp" or cfg.family not in ("hybrid", "ssm"):
        return 1
    if cfg.family == "hybrid":
        axes, shape = ("ssm_heads",), (cfg.ssm_heads,)
    else:
        Dh = cfg.rwkv_head_dim
        axes, shape = ("heads", "head_dim"), (cfg.d_model // Dh, Dh)
    spec = param_spec(axes, cfg, mesh, shape, layout=layout)
    return math.prod(mesh.shape[a] for a in spec_axes(spec))


def cache_block(cfg: ModelConfig, batch: int, max_len: int,
                mesh: MeshView, layout: str = "tp") -> Dict[str, int]:
    """A rank's block of the decode cache, as the keyword arguments of
    ``Model.init_cache`` and ``Model.init_paged_cache``: ``batch`` and
    ``max_len`` its rows and positions and ``kv_heads`` its KV heads
    (:func:`attention_cache_block`), ``recurrent_split`` the split of its
    recurrent heads (:func:`recurrent_split`)."""
    rows, positions, kv = attention_cache_block(cfg, batch, max_len, mesh,
                                                layout)
    return {"batch": rows, "max_len": positions, "kv_heads": kv,
            "recurrent_split": recurrent_split(cfg, mesh, layout)}


def cache_shardings(cache: Tree, mesh: MeshView, cfg: ModelConfig) -> Tree:
    """Decode-cache layout: a tree like ``cache`` (of tensors or
    :class:`TensorSpec`) of specs, by :func:`cache_spec`."""
    specs = iter([cache_spec(path, tuple(leaf.shape), mesh)
                  for path, leaf in tree_leaves(cache)])
    return tree_map(lambda _: next(specs), cache)


def token_sharding(spec: TensorSpec, mesh: MeshView) -> Spec:
    if spec.shape[0] % data_size(mesh) == 0:
        return (_dspec(mesh), None)
    return ()
