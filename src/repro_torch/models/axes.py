"""Logical axes of the port's parameters: the reference's ``Boxed.axes``
(``repro.models.layers.param``), which ``repro_torch.sharding`` maps onto
mesh axes.

The port's parameters are plain tensors, so their axes live here as a
table keyed by a leaf's parent and name, and :func:`param_axes` lays
them over the tree that ``init_params`` builds (on the ``meta`` device,
without allocating). A leaf stacked over layers gains the reference's
leading ``layers`` axis (zamba2's Mamba blocks ``blocks`` and ``layers``).
The resnet conv weights are OIHW in the port and HWIO in the reference,
so their axes are permuted as ``repro_torch.bridge`` permutes the
weights.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.tree import tree_leaves, tree_map

Axes = Tuple[Optional[str], ...]

_ATTN = {
    "wq": ("embed", "heads", "head_dim"),
    "wk": ("embed", "kv_heads", "head_dim"),
    "wv": ("embed", "kv_heads", "head_dim"),
    "wo": ("heads", "head_dim", "embed"),
    "bq": ("heads", "head_dim"),
    "bk": ("kv_heads", "head_dim"),
    "bv": ("kv_heads", "head_dim"),
}
_MLP = {"wi": ("embed", "ff"), "wg": ("embed", "ff"), "wo": ("ff", "embed")}
_RULES: Dict[str, Dict[str, Axes]] = {
    "attn": _ATTN,
    "xattn": _ATTN,
    "mlp": _MLP,
    "shared": _MLP,                 # moonshot's shared experts
    "dense": _MLP,                  # arctic's dense residual branch
    "moe": {"router": ("embed", "experts"),
            "wi": ("experts", "embed", "ff"),
            "wg": ("experts", "embed", "ff"),
            "wo": ("experts", "ff", "embed")},
    "embed": {"tok": ("vocab", "embed"), "out": ("embed", "vocab")},
    "mamba": {"in_proj": ("embed", "ssm_inner"),
              "conv_w": (None, "ssm_inner"),
              "conv_b": ("ssm_inner",),
              "A_log": ("ssm_heads",),
              "D": ("ssm_heads",),
              "dt_bias": ("ssm_heads",),
              "norm": ("ssm_inner",),
              "out_proj": ("ssm_inner", "embed")},
    "tmix": {**{f"mix_{c}": ("embed",) for c in "rkvgwx"},
             "mix_lora_a": ("embed", None),
             **{f"mix_lora_b_{c}": (None, "embed") for c in "wkvrg"},
             "w0": ("embed",),
             "ln_x": ("embed",),
             "ln_x_bias": ("embed",),
             "u": ("heads", "head_dim"),
             "w_lora_a": ("embed", None),
             "w_lora_b": (None, "embed"),
             **{w: ("embed", "heads_flat") for w in ("wr", "wk", "wv", "wg")},
             "wo": ("heads_flat", "embed")},
    "cmix": {"mix_k": ("embed",), "mix_r": ("embed",),
             "wk": ("embed", "ff"), "wv": ("ff", "embed"),
             "wr": ("embed", "embed_out")},
}
_GROUP_NORMS = ("stem_gn", "gn1", "gn2")
_STACKED = {"layers": ("layers",), "dense_layers": ("layers",),
            "enc_layers": ("layers",), "tail": ("layers",),
            "blocks": ("blocks", "layers")}


def _leaf_axes(path: str) -> Axes:
    """The unstacked axes of the leaf at ``path``."""
    keys = path.split("/")
    name, parent = keys[-1], (keys[-2] if len(keys) > 1 else "")
    if name in ("stem", "conv1", "conv2", "proj"):
        return ("ff", None, None, None)    # the reference's HWIO axes, OIHW
    if parent in _GROUP_NORMS:
        return ("ff",)                                     # gamma, beta
    if name == "gamma":
        return ("embed",)                                  # RMS norms
    if name == "fc_w":
        return ("embed", "vocab")
    if name == "fc_b":
        return ("vocab",)
    try:
        return _RULES[parent][name]
    except KeyError:
        raise KeyError(f"no logical axes for parameter {path!r}") from None


@functools.lru_cache(maxsize=None)
def _shapes(cfg: ModelConfig) -> Dict[str, Any]:
    from repro_torch.models.builder import init_params
    return tree_map(lambda t: tuple(t.shape),
                    init_params(cfg, None, torch.device("meta")))


def param_shapes(cfg: ModelConfig) -> Dict[str, Any]:
    """The tree ``init_params(cfg)`` builds, each leaf replaced by its
    shape (a tuple), without allocating."""
    return tree_map(lambda s: s, _shapes(cfg))


def param_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """The tree ``init_params(cfg)`` builds, each leaf replaced by its
    tuple of logical axis names."""
    shapes = _shapes(cfg)
    axes = {}
    for path, shape in tree_leaves(shapes):
        base = _leaf_axes(path)
        extra = len(shape) - len(base)
        stack = _STACKED.get(path.split("/")[0], ())
        if extra != (len(stack) if extra else 0):
            raise ValueError(f"{path}: shape {shape} does not fit axes "
                             f"{stack + base}")
        axes[path] = (stack if extra else ()) + base
    return tree_map(lambda _p: axes[_p], _paths(shapes))


def _paths(tree: Any, prefix: str = "") -> Any:
    """``tree`` with each leaf replaced by its path."""
    if isinstance(tree, dict):
        return {k: _paths(v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_paths(v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return prefix.rstrip("/")
