"""Plain PyTorch version of flash attention: the CUDA kernel's oracle and
its CPU path (counterpart of ``repro.kernels.flash_attention.ref``,
taking the model's layout)."""
from __future__ import annotations

from typing import Optional

import torch


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) -> (B, Sq, H, D).

    GQA: q-head h reads kv-head h // (H // KV). Query and key positions
    both start at 0. Key j is visible to query i iff ``j <= i`` when
    ``causal`` and, when ``window > 0`` (causal or not), ``j > i - window``.
    Scale ``sm_scale`` (default D**-0.5), float32 softmax; a row with no
    visible key gives 0; output in q's dtype."""
    B, Sq, H, D = q.shape
    _, Sk, KV, _ = k.shape
    G = H // KV
    if sm_scale is None:
        sm_scale = D ** -0.5
    qg = q.float().reshape(B, Sq, KV, G, D)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg, k.float()) * sm_scale
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= j <= i
    if window > 0:
        mask &= j > i - window
    s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1).nan_to_num(nan=0.0)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, D).to(q.dtype)
