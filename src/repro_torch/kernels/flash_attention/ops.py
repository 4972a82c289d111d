"""Model-layout entry to full attention, with implementation selection
(counterpart of ``repro.kernels.flash_attention.ops``).

Model layout: q (B, S, H, D), k/v (B, Sk, KV, D). The reference's wrapper
transposes to head-major for its TPU kernel; the CUDA kernel reads the
model layout through strides, so no transpose is made.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_plain


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int = 0,
              sm_scale: Optional[float] = None,
              impl: str = "cuda") -> torch.Tensor:
    """q: (B, Sq, H, D); k/v: (B, Sk, KV, D) -> (B, Sq, H, D).
    ``impl="cuda"`` asks for the Hopper kernel: it refuses inputs that
    require a gradient and tensors that are not on a CUDA device;
    ``impl="torch"`` runs the plain version on any device."""
    if impl == "torch":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     sm_scale=sm_scale)
    if impl != "cuda":
        raise ValueError(f"unknown impl {impl!r}; expected 'torch' or 'cuda'")
    refuse_grad("flash_attention", "attn_impl", q, k, v)
    if not q.is_cuda:
        raise ValueError(f"impl='cuda' runs the CUDA kernel and needs CUDA "
                         f"tensors, got {q.device}; use impl='torch' on the "
                         f"CPU")
    return flash_attention(q, k, v, causal=causal, window=window,
                           sm_scale=sm_scale)
