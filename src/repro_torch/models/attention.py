"""GQA/MQA/MHA attention for the decode path (counterpart of
``repro.models.attention``).

Layouts follow the reference at every public function: activations
(B, S, d), q (B, S, H, Dh), k/v (B, S, KV, Dh), caches (B, Smax, KV, Dh).
Sliding windows are per-layer runtime ints; ``window <= 0`` means global.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attend
from repro_torch.models import layers as L


def init_attention(gen, cfg: ModelConfig, *, dtype,
                   device) -> Dict[str, torch.Tensor]:
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": L.param(gen, (d, H, Dh), **kw),
        "wk": L.param(gen, (d, KV, Dh), **kw),
        "wv": L.param(gen, (d, KV, Dh), **kw),
        "wo": L.param(gen, (H, Dh, d), **kw),
    }
    if cfg.qkv_bias:
        p["bq"] = L.param(gen, (H, Dh), init="zeros", **kw)
        p["bk"] = L.param(gen, (KV, Dh), init="zeros", **kw)
        p["bv"] = L.param(gen, (KV, Dh), init="zeros", **kw)
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum('bsd,dhk->bshk') as one matrix product."""
    d, h, k = w.shape
    return (x @ w.reshape(d, h * k)).unflatten(-1, (h, k))


def project_qkv(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B,S,H,Dh), k/v (B,S,KV,Dh), rotary applied."""
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(p: Dict[str, torch.Tensor], attn: torch.Tensor) -> torch.Tensor:
    """attn: (B, S, H, Dh) -> (B, S, d)."""
    H, Dh, d = p["wo"].shape
    return attn.flatten(-2) @ p["wo"].reshape(H * Dh, d)


def attend_decode(q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, pos: torch.Tensor, *, window: int = 0,
                  impl: str = "cuda") -> torch.Tensor:
    """q: (B,1,H,Dh); caches: (B,Smax,KV,Dh); pos: (B,) current index.

    Attends over cache[0..pos] (inclusive: the new token is already
    written). ``impl="cuda"`` runs the Hopper kernel, ``"torch"`` its
    plain version."""
    return decode_attend(q, k_cache, v_cache, pos + 1, window=window,
                         impl=impl)


def update_cache(k_cache: torch.Tensor, v_cache: torch.Tensor,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor, advance: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write (B,1,KV,Dh) new entries at per-row positions (B,), IN PLACE.

    A row whose ``pos`` is past the cache (an empty slot that kept
    advancing), or whose ``advance`` (B,) bool is False, has its write
    dropped, as JAX's scatter drops an out-of-range write: such a row
    writes back the value already at position 0 of its own row, so no
    position changes and no index leaves the cache (clamping to
    ``Smax - 1`` would instead overwrite the last position)."""
    B, S = k_cache.shape[:2]
    rows = torch.arange(B, device=k_cache.device)
    keep = pos < S
    if advance is not None:
        keep = keep & advance
    at = torch.where(keep, pos, torch.zeros_like(pos))
    sel = keep.view(B, 1, 1)
    for cache, new in ((k_cache, k_new), (v_cache, v_new)):
        cache[rows, at] = torch.where(sel, new[:, 0].to(cache.dtype),
                                      cache[rows, at])
    return k_cache, v_cache
