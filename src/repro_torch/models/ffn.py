"""Dense feed-forward layer (counterpart of the dense half of
``repro.models.ffn``): SwiGLU when gated, tanh-GeLU 4x otherwise.

``jax.nn.gelu`` defaults to the tanh approximation, which the reference
uses, so the port asks for ``approximate="tanh"``.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L


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
