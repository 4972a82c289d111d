"""GQA/MQA/MHA attention: the full-sequence path (training, evaluation)
and the decode path (counterpart of ``repro.models.attention``).

The plain full-sequence path computes attention in query chunks
(``cfg.attn_chunk``), so the score block it holds is (B, KV, G, Cq, Skv)
instead of (B, H, S, S). ``cfg.attn_impl == "cuda"`` runs the flash
kernel instead, on forwards that need no gradient.

Layouts follow the reference at every public function: activations
(B, S, d), q (B, S, H, Dh), k/v (B, S, KV, Dh), caches (B, Smax, KV, Dh).
Sliding windows are per-layer runtime ints; ``window <= 0`` means global.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig
from repro_torch.kernels.decode_attention.ops import decode_attend
from repro_torch.kernels.flash_attention.ops import attention as flash
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
    """einsum('bsd,dhk->bshk') as one matrix product, the weight cast to
    the activation dtype."""
    d, h, k = w.shape
    return (x @ w.to(x.dtype).reshape(d, h * k)).unflatten(-1, (h, k))


def project_qkv(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ModelConfig,
                positions: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> q (B,S,H,Dh), k/v (B,S,KV,Dh), rotary applied."""
    dt = x.dtype
    q, k, v = _proj(x, p["wq"]), _proj(x, p["wk"]), _proj(x, p["wv"])
    if "bq" in p:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    if positions is None:
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def out_proj(p: Dict[str, torch.Tensor], attn: torch.Tensor) -> torch.Tensor:
    """attn: (B, S, H, Dh) -> (B, S, d)."""
    H, Dh, d = p["wo"].shape
    return attn.flatten(-2) @ p["wo"].to(attn.dtype).reshape(H * Dh, d)


# ---------------------------------------------------------------------------
# Full-sequence attention (training, evaluation)
# ---------------------------------------------------------------------------

def _chunk_attend(q_chunk: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_off: int, *, causal: bool, window: int,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q_chunk: (B, Cq, KV, G, Dh); k/v: (B, Skv, KV, Dh) -> (B,Cq,KV,G,Dh).

    As the reference: scores in the input dtype, then float32; masked
    scores are -1e30 (not -inf); the softmax is float32 and its
    probabilities are cast to the input dtype before ``P @ V``. The window
    applies only to causal attention, as in the reference. ``kv_len``
    masks padded kv positions."""
    Dh = q_chunk.shape[-1]
    scores = torch.einsum("bqkgd,bskd->bkgqs", q_chunk, k).float()
    scores = scores * Dh ** -0.5
    Skv = k.shape[1]
    kj = torch.arange(Skv, device=k.device)
    mask = None
    if causal:
        qi = q_off + torch.arange(q_chunk.shape[1], device=k.device)
        mask = kj[None, :] <= qi[:, None]
        if window > 0:
            mask = mask & (kj[None, :] > qi[:, None] - window)
    if kv_len is not None:
        kmask = kj < kv_len
        mask = kmask if mask is None else mask & kmask
    if mask is not None:
        scores = scores.masked_fill(~mask, -1e30)
    probs = torch.softmax(scores, dim=-1).to(q_chunk.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ModelConfig, *, causal: bool = True, window: int = 0,
           kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full attention. q: (B,S,H,Dh), k/v: (B,Skv,KV,Dh) -> (B,S,H,Dh).

    ``cfg.attn_impl == "cuda"`` runs the flash kernel (forward only: it
    refuses inputs that need a gradient); ``"torch"`` the q-chunked plain
    path, in chunks of ``cfg.attn_chunk`` queries, or one chunk when S is
    not a multiple of it. A loop over the chunks takes the place of the
    reference's ``lax.scan``."""
    if cfg.attn_impl == "cuda":
        if kv_len is not None:
            raise ValueError("attn_impl='cuda' has no kv_len mask (the "
                             "reference's flash path has none either)")
        return flash(q, k, v, causal=causal, window=window, impl="cuda")
    if cfg.attn_impl != "torch":
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}")
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, Dh)
    C = min(cfg.attn_chunk, S)
    if S % C != 0:
        C = S
    outs = [_chunk_attend(qg[:, i:i + C], k, v, i, causal=causal,
                          window=window, kv_len=kv_len)
            for i in range(0, S, C)]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(B, S, H, Dh)


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


# ---------------------------------------------------------------------------
# Paged decode (vLLM-style): KV lives in a shared physical page pool
# ---------------------------------------------------------------------------

def gather_pages(pages: torch.Tensor, page_table: torch.Tensor
                 ) -> torch.Tensor:
    """pages: (P, ps, ...); page_table: (B, Lp) logical->physical map.
    Returns the contiguous logical row views (B, Lp*ps, ...): position j
    of row b lives in physical page ``page_table[b, j // ps]`` at offset
    ``j % ps``. Table entries past a row's pages gather some other page;
    callers mask by ``pos`` exactly like the dense path, so what lies
    beyond the written prefix never reaches the softmax."""
    B, Lp = page_table.shape
    ps = pages.shape[1]
    view = pages.index_select(0, page_table.reshape(-1))   # (B*Lp, ps, ...)
    return view.reshape((B, Lp * ps) + tuple(pages.shape[2:]))


def attend_decode_paged(q: torch.Tensor, k_pages: torch.Tensor,
                        v_pages: torch.Tensor, page_table: torch.Tensor,
                        pos: torch.Tensor, *, window: int = 0,
                        impl: str = "cuda") -> torch.Tensor:
    """Page-table-indexed decode attention. q: (B,1,H,Dh); pools:
    (P, ps, KV, Dh); page_table: (B, Lp); pos: (B,) current index.

    The page table is the only indirection: after the gather the logical
    row view is the dense cache row (padded to Lp*ps with masked
    positions), and ``attend_decode`` runs on it, so ``impl="cuda"``
    reaches the decode kernel. The gather costs two copies of the rows'
    views per call."""
    k = gather_pages(k_pages, page_table)
    v = gather_pages(v_pages, page_table)
    return attend_decode(q, k, v, pos, window=window, impl=impl)


PageSlots = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def page_slots(page_table: torch.Tensor, pos: torch.Tensor, page_size: int,
               rows: Optional[torch.Tensor] = None) -> PageSlots:
    """Where this token's KV goes: (rows, physical page, offset) of each
    row listed in ``rows`` (an index tensor; None = every row), at its
    position ``pos`` (B,). A position past the table's last page is
    clipped into it, as the reference clips it. Every layer of a cell
    writes to the same slots, so the cell computes them once."""
    B, Lp = page_table.shape
    if rows is None:
        rows = torch.arange(B, device=pos.device)
    p = pos[rows].long()
    logical = torch.clamp(p // page_size, 0, Lp - 1)
    return rows, page_table[rows, logical].long(), p % page_size


def write_pages(k_pages: torch.Tensor, v_pages: torch.Tensor,
                k_new: torch.Tensor, v_new: torch.Tensor, slots: PageSlots
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write (B,1,KV,Dh) new entries into the page pools IN PLACE at
    ``slots`` (:func:`page_slots`); rows left out of them write
    nothing at all."""
    rows, phys, off = slots
    for pages, new in ((k_pages, k_new), (v_pages, v_new)):
        pages[phys, off] = new[rows, 0].to(pages.dtype)
    return k_pages, v_pages


def update_cache_paged(k_pages: torch.Tensor, v_pages: torch.Tensor,
                       k_new: torch.Tensor, v_new: torch.Tensor,
                       page_table: torch.Tensor, pos: torch.Tensor,
                       write_mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter (B,1,KV,Dh) new entries into the page pools IN PLACE at
    per-row positions (B,). Rows with ``write_mask`` False write nothing:
    in the paged layout a stale page-table row may point at pages that
    now belong to another request. The reference redirects such writes to
    an out-of-range page that its scatter drops (``mode="drop"``); torch
    has no drop mode and an out-of-range index is an error on CUDA, so
    the write is restricted to the kept rows instead (which reads the
    mask back to the host)."""
    rows = None if write_mask is None \
        else torch.nonzero(write_mask).flatten()
    return write_pages(k_pages, v_pages, k_new, v_new,
                       page_slots(page_table, pos, k_pages.shape[1], rows))
