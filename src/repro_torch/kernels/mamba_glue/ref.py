"""Plain PyTorch versions of the Mamba-2 mixer's glue: the CUDA kernels'
oracles and their CPU path, and the one copy of this arithmetic that
``models/ssm.py`` runs under ``ssm_impl="torch"`` (training, the parity
tests against the reference's ``repro.models.ssm``)."""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import rms_norm

CONV_W = 4


def causal_conv_silu_plain(u: torch.Tensor, conv_w: torch.Tensor,
                           conv_b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv of width 4 over (B, S, C), then SiLU."""
    w = conv_w.to(u.dtype)
    pad = F.pad(u, (0, 0, CONV_W - 1, 0))
    out = sum(w[i] * pad[:, i:i + u.shape[1]] for i in range(CONV_W))
    return F.silu(out + conv_b.to(u.dtype))


def conv_silu_dt_plain(u: torch.Tensor, conv_w: torch.Tensor,
                       conv_b: torch.Tensor, dt: torch.Tensor,
                       dt_bias: torch.Tensor, A_log: torch.Tensor,
                       head_dim: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The conv input u = [x, B, C] (B, S, d_in + 2N), conv_w (4, C),
    conv_b (C), the raw dt (B, S, H), dt_bias and A_log (H) ->
    (conv_out (B, S, C) in u's dtype, dA (B, S, H) float32 <= 0,
    xdt (B, S, H, head_dim) = x * dt in u's dtype), x = conv_out's first
    H * head_dim channels."""
    f32 = torch.float32
    conv_out = causal_conv_silu_plain(u, conv_w, conv_b)
    H = dt.shape[-1]
    xh = conv_out[..., :H * head_dim].unflatten(-1, (H, head_dim))
    dt = F.softplus(dt.to(f32) + dt_bias.to(f32))                  # (B,S,H)
    a = -torch.exp(A_log.to(f32))                                   # (H,)
    dA = dt * a                                                     # <= 0
    xdt = xh * dt.to(xh.dtype)[..., None]
    return conv_out, dA, xdt


def gated_rms_norm_plain(y: torch.Tensor, xh: torch.Tensor,
                         z: torch.Tensor, D: torch.Tensor,
                         gamma: torch.Tensor, eps: float,
                         split=(None, ())) -> torch.Tensor:
    """The D skip, the SiLU gate and the float32 RMS norm scaled by
    ``1 + gamma``: y, xh (..., H, P), z (..., H * P) -> (..., H * P) in
    y's dtype. ``split`` as for ``layers.rms_norm``: the channels are a
    rank's block and the mean of squares is summed over the ranks."""
    y = y + D.to(y.dtype)[:, None] * xh
    return rms_norm(y.flatten(-2) * F.silu(z), gamma, eps, split)
