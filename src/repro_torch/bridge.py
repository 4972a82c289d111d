"""Load parameters and optimizer state given as numpy arrays into the
port.

``params_from_numpy`` takes the JAX package's unboxed parameter pytree
with every leaf converted to a numpy array (nested dicts, the same keys
and shapes the port uses) and returns the port's parameters, so both
packages compute the same model. It checks the tree against the
structure and shapes ``init_params`` builds for ``cfg``.
``opt_state_from_numpy`` does the same for an optimizer state (AdamW's
``m``, ``v``, ``count``; momentum's ``mu``), so both packages can train
from one state. This module never imports jax: the caller produces the
numpy trees. The resnet family's conv weights are transposed from the
reference's HWIO to the port's OIHW.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.builder import init_params
from repro_torch.tree import tree_leaves, tree_map


def params_from_numpy(tree: Dict[str, Any], cfg: ModelConfig, device,
                      dtype: Optional[torch.dtype] = None) -> Dict[str, Any]:
    """numpy tree -> port params on ``device`` (``"cuda"`` or ``"cpu"``,
    resolved as ``build_model`` resolves it), each leaf in the dtype the
    port stores it in: ``cfg.dtype`` by default, as serving stores it, or
    ``dtype=torch.float32`` for training's masters; float32 for RMS gammas
    either way."""
    device = resolve_device(device)
    like = init_params(cfg, None, torch.device("meta"), dtype)
    tree = _port_layout(tree, cfg)
    _check_like(like, tree, cfg)
    return tree_map(
        lambda ref, arr: torch.from_numpy(
            np.array(arr, dtype=np.float32, order="C")
        ).to(device=device, dtype=ref.dtype),
        like, tree)


def opt_state_from_numpy(tree: Dict[str, Any], cfg: ModelConfig,
                         device) -> Dict[str, Any]:
    """numpy optimizer state -> the port's, on ``device``. The moments
    (``m``, ``v`` or ``mu``) are float32 trees shaped like the
    parameters; AdamW's ``count`` becomes a Python int."""
    device = resolve_device(device)
    like = init_params(cfg, None, torch.device("meta"), torch.float32)
    out: Dict[str, Any] = {}
    for key, val in tree.items():
        if key == "count":
            out[key] = int(np.asarray(val))
        elif key in ("m", "v", "mu"):
            val = _port_layout(val, cfg)
            _check_like(like, val, cfg)
            out[key] = tree_map(
                lambda ref, arr: torch.from_numpy(
                    np.array(arr, dtype=np.float32, order="C")).to(device),
                like, val)
        else:
            raise ValueError(f"unknown optimizer state entry {key!r}")
    return out


def _port_layout(tree: Dict[str, Any], cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's resnet conv weights are HWIO, the port's OIHW: every
    4-D leaf of a resnet tree is transposed. Other families' leaves are
    laid out alike in both packages."""
    if cfg.family != "resnet":
        return tree
    return tree_map(lambda a: np.transpose(a, (3, 2, 0, 1))
                    if np.ndim(a) == 4 else a, tree)


def _check_like(like: Dict[str, Any], tree: Dict[str, Any],
                cfg: ModelConfig) -> None:
    want = dict(tree_leaves(like))
    got = dict(tree_leaves(tree))
    if want.keys() != got.keys():
        raise ValueError(f"parameter tree mismatch for {cfg.name}: missing "
                         f"{sorted(want.keys() - got.keys())}, unexpected "
                         f"{sorted(got.keys() - want.keys())}")
    for path, ref in want.items():
        if tuple(np.shape(got[path])) != tuple(ref.shape):
            raise ValueError(f"{path}: shape {np.shape(got[path])}, "
                             f"expected {tuple(ref.shape)}")
