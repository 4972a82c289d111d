"""Model-layout entry to decode attention, with implementation selection
(counterpart of ``repro.kernels.decode_attention.ops``).

Model layout: q (B, 1, H, D) one new token; cache (B, S, KV, D). The
kernel reads the cache through a transposed view: no copy is made.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.kernel import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_plain


def decode_attend(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, lengths: torch.Tensor, *,
                  window: int = 0, impl: str = "cuda", offset: int = 0,
                  return_lse: bool = False):
    """q: (B, 1, H, D); k/v cache: (B, S, KV, D); lengths (B,) int32 ->
    (B, 1, H, D). ``impl="cuda"`` asks for the Hopper kernel and raises
    on tensors that are not on a CUDA device; ``impl="torch"`` runs the
    plain version on any device. ``offset``: the position of the cache's
    first slot (a block of a cache split on its positions);
    ``return_lse``: also return the (2, B, H) float32 (m, l) partial
    (``decode_attention_plain``)."""
    qs = q[:, 0]                                   # (B, H, D)
    kt = k_cache.transpose(1, 2)                   # (B, KV, S, D) view
    vt = v_cache.transpose(1, 2)
    kw = dict(window=window, offset=offset, return_lse=return_lse)
    if impl == "torch":
        out = decode_attention_plain(qs, kt, vt, lengths, **kw)
    elif impl == "cuda":
        if not q.is_cuda:
            raise ValueError(f"impl='cuda' runs the CUDA kernel and needs "
                             f"CUDA tensors, got {q.device}; use "
                             f"impl='torch' on the CPU")
        out = decode_attention(qs, kt, vt, lengths, **kw)
    else:
        raise ValueError(f"unknown impl {impl!r}; expected 'torch' or 'cuda'")
    if return_lse:
        return out[0][:, None], out[1]
    return out[:, None]
