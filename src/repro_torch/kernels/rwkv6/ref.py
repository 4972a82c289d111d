"""Plain PyTorch version of the RWKV-6 WKV recurrence: the CUDA kernel's
oracle, its CPU path and the model's ``rwkv_impl="torch"`` path
(counterpart of ``repro.kernels.rwkv6.ref`` and of ``repro.models.rwkv``'s
``_wkv_scan``, taking the model's layout)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def rwkv6_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                s0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w (B, S, H, D); u (H, D); s0 (B, H, D, D) or None (zeros).

    The per-token recurrence, in float32 (every input widened to it):
    ``o_t = r_t^T (S + diag(u) k_t v_t^T)``, ``S = diag(w_t) S + k_t v_t^T``.
    Returns (o (B, S, H, D) in r's dtype, rounded once from float32,
    final state (B, H, D, D) float32)."""
    B, S, H, D = r.shape
    r32, k32, v32, w32 = (t.float() for t in (r, k, v, w))
    u32 = u.float()[None, :, :, None]                       # (1, H, D, 1)
    state = (torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
             if s0 is None else s0.float())
    outs = []
    for t in range(S):
        kv = k32[:, t, :, :, None] * v32[:, t, :, None, :]  # (B, H, Dk, Dv)
        outs.append(torch.einsum("bhk,bhkv->bhv", r32[:, t],
                                 state + u32 * kv))
        state = w32[:, t, :, :, None] * state + kv
    return torch.stack(outs, dim=1).to(r.dtype), state
