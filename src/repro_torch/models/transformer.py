"""Model stacks of the ported families (counterpart of
``repro.models.transformer``): parameters, the full-sequence forward that
training and evaluation run, the decode cache, and the one-token decode
cell that serving runs for every prompt and generated token.

Families ported:
- ``dense``  : decoder-only (GQA/MQA/MHA), optional gemma3-style
               local:global sliding-window pattern;
- ``moe``    : decoder-only with the MoE FFN (``ffn.apply_moe``);
               moonshot's dense first layer(s) (``dense_layers``) and
               arctic's parallel dense-residual branch;
- ``hybrid`` : zamba2 — Mamba2 backbone with a *weight-tied shared*
               attention block invoked every ``shared_attn_every`` layers;
- ``ssm``    : rwkv6 — attention-free time-mix / channel-mix;
- ``vlm``    : qwen2-vl — the dense stack fed a precomputed patch-embedding
               prefix, positions by M-RoPE (t, h, w); its decode cell is
               the dense one (text only, 1-D RoPE at the cache index);
- ``encdec`` : seamless — a bidirectional encoder over frame embeddings
               and a causal decoder with cross-attention to its output;
               decoding attends to per-layer cross K/V caches that
               ``encode_for_decode`` fills once.

The reference scans stacked layer parameters; PyTorch runs eagerly, so
the port keeps the stacked layout (every layer leaf has a leading
``layers`` axis, zamba2's blocks ``(n_blocks, cadence)``, as in the
reference pytree) and loops over it in Python.

Sharded parameters: the sharded train and serve steps hand these
functions the rank's blocks as ``sharding.Sharded`` leaves. A layer's
blocks are taken by ``tree_unbind`` and gathered where the layer uses
them, inside the function that ``_run`` recomputes under remat, so the
backward gathers them again and a layer's full copy lives only while it
runs; the embedding, final norm and unembedding are gathered where they
are used too. Under ``tp`` every layer computes on the rank's model
blocks: attention heads, MLP ``ff`` and the vocabulary (``attention.py``,
``ffn.py``, ``layers.py``), the Mamba-2 heads (``ssm.py``) and the RWKV-6
heads and channel-mix blocks (``rwkv.py``). With plain tensors (no mesh)
nothing is gathered.

Public entry points (used by the builder, train/serve steps and engine):
    init_params(cfg, generator, device, dtype)       -> params tree
    forward(params, cfg, batch, remat)               -> (logits, aux)
    init_decode_cache(cfg, batch, max_len, device, enc_len)
                                                     -> cache tree
    encode_for_decode(params, cfg, frame_embeds, cache)
                                                     -> cache (encdec)
    decode_step(params, cfg, cache, batch)           -> (logits, cache)
    init_paged_decode_cache(cfg, batch, max_len, page_size=, num_pages=,
                            device=)                 -> paged cache tree
    decode_step_paged(params, cfg, cache, batch, advance)
                                                     -> (logits, cache)
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import sharding as SH
from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as M
from repro_torch.tree import tree_leaves, tree_map, tree_unbind

Tree = Dict[str, Any]

FAMILIES = ("dense", "moe", "hybrid", "ssm", "vlm", "encdec")


def check_family(cfg: ModelConfig) -> None:
    """Raise ValueError unless ``cfg.family`` has a stack here."""
    if cfg.family == "resnet":
        raise ValueError(f"{cfg.name}: the resnet family has no transformer "
                         "stack; models/resnet.py runs it (build_model "
                         "dispatches to it)")
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def _window_schedule(cfg: ModelConfig, n_layers: int) -> List[int]:
    """Per-layer sliding window (<=0 means global attention)."""
    return [0 if cfg.is_global_layer(i) else cfg.sliding_window
            for i in range(n_layers)]


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_dense_layer(gen, cfg: ModelConfig, dtype, device) -> Tree:
    return {
        "ln1": L.init_rms(gen, cfg.d_model, device),
        "attn": A.init_attention(gen, cfg, dtype=dtype, device=device),
        "ln2": L.init_rms(gen, cfg.d_model, device),
        "mlp": F.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                          dtype=dtype, device=device),
    }


def _init_moe_layer(gen, cfg: ModelConfig, dtype, device) -> Tree:
    return {
        "ln1": L.init_rms(gen, cfg.d_model, device),
        "attn": A.init_attention(gen, cfg, dtype=dtype, device=device),
        "ln2": L.init_rms(gen, cfg.d_model, device),
        "moe": F.init_moe(gen, cfg, dtype=dtype, device=device),
    }


def _init_moe_dense_layer(gen, cfg: ModelConfig, dtype, device) -> Tree:
    """moonshot: the first layer(s) use a plain dense MLP of width
    ``dense_ff``."""
    return {
        "ln1": L.init_rms(gen, cfg.d_model, device),
        "attn": A.init_attention(gen, cfg, dtype=dtype, device=device),
        "ln2": L.init_rms(gen, cfg.d_model, device),
        "mlp": F.init_mlp(gen, cfg.d_model, cfg.dense_ff, True, dtype=dtype,
                          device=device),
    }


def _init_mamba_layer(gen, cfg: ModelConfig, dtype, device) -> Tree:
    return {
        "ln": L.init_rms(gen, cfg.d_model, device),
        "mamba": M.init_mamba2(gen, cfg, dtype=dtype, device=device),
    }


def _init_rwkv_layer(gen, cfg: ModelConfig, dtype, device) -> Tree:
    return {
        "ln1": L.init_rms(gen, cfg.d_model, device),
        "tmix": R.init_rwkv_tmix(gen, cfg, dtype=dtype, device=device),
        "ln2": L.init_rms(gen, cfg.d_model, device),
        "cmix": R.init_rwkv_cmix(gen, cfg, dtype=dtype, device=device),
    }


def _init_cross_layer(gen, cfg: ModelConfig, dtype, device) -> Tree:
    """seamless's decoder layer: self-attention, cross-attention, MLP."""
    return {
        "ln1": L.init_rms(gen, cfg.d_model, device),
        "attn": A.init_attention(gen, cfg, dtype=dtype, device=device),
        "lnx": L.init_rms(gen, cfg.d_model, device),
        "xattn": A.init_attention(gen, cfg, dtype=dtype, device=device),
        "ln2": L.init_rms(gen, cfg.d_model, device),
        "mlp": F.init_mlp(gen, cfg.d_model, cfg.d_ff, cfg.gated_mlp,
                          dtype=dtype, device=device),
    }


def _stack(init_fn, n: int) -> Tree:
    """``n`` layers from ``init_fn()``, drawn in order, every leaf stacked
    on a new leading axis. Each stacked leaf is allocated once and filled
    layer by layer, so the peak is the stack and two layers (stacking a
    list of all the layers would hold them twice: 113 GB for full-width
    moonshot in bf16)."""
    layer = init_fn()
    out = tree_map(lambda t: t.new_empty((n, *t.shape)), layer)
    for i in range(n):
        if i:
            layer = init_fn()
        for (_, dst), (_, src) in zip(tree_leaves(out), tree_leaves(layer)):
            dst[i].copy_(src)
    return out


def init_params(cfg: ModelConfig, generator, device,
                dtype: Optional[torch.dtype] = None) -> Tree:
    """Seeded parameters on ``device`` (``generator`` must live there;
    ``None`` is allowed on the ``meta`` device, for shapes only). Weight
    matrices, biases and embeddings are stored in ``dtype``: ``cfg.dtype``
    by default (serving), ``torch.float32`` for training's masters, as the
    reference holds them; the draws are float32 either way. RMS gammas and
    the recurrent leaves the reference reads in float32 (see ``ssm.py``
    and ``rwkv.py``) are float32 always."""
    check_family(cfg)
    dt = dtype if dtype is not None else L.torch_dtype(cfg.dtype)
    # the stacks are drawn before the embeddings: the draw order fixes
    # the weights a seed gives
    fam = cfg.family
    stacks: Tree = {}
    if fam in ("dense", "vlm"):
        stacks["layers"] = _stack(
            lambda: _init_dense_layer(generator, cfg, dt, device),
            cfg.num_layers)
    elif fam == "moe":
        nd = cfg.first_dense_layers
        if nd:
            stacks["dense_layers"] = _stack(
                lambda: _init_moe_dense_layer(generator, cfg, dt, device), nd)
        stacks["layers"] = _stack(
            lambda: _init_moe_layer(generator, cfg, dt, device),
            cfg.num_layers - nd)
    elif fam == "hybrid":
        cad = cfg.shared_attn_every
        n_blocks, leftover = divmod(cfg.num_layers, cad)
        mamba = lambda: _init_mamba_layer(generator, cfg, dt, device)  # noqa: E731
        stacks["blocks"] = _stack(lambda: _stack(mamba, cad), n_blocks)
        if leftover:
            stacks["tail"] = _stack(mamba, leftover)
        stacks["shared"] = _init_dense_layer(generator, cfg, dt, device)
    elif fam == "ssm":
        stacks["layers"] = _stack(
            lambda: _init_rwkv_layer(generator, cfg, dt, device),
            cfg.num_layers)
    else:
        stacks["enc_layers"] = _stack(
            lambda: _init_dense_layer(generator, cfg, dt, device),
            cfg.enc_layers)
        stacks["enc_norm"] = L.init_rms(generator, cfg.d_model, device)
        stacks["layers"] = _stack(
            lambda: _init_cross_layer(generator, cfg, dt, device),
            cfg.dec_layers)
    return {
        "embed": L.init_embed(generator, cfg.vocab_size, cfg.d_model,
                              cfg.tie_embeddings, dtype=dt, device=device),
        "final_norm": L.init_rms(generator, cfg.d_model, device),
        **stacks,
    }


def num_shared_invocations(cfg: ModelConfig) -> int:
    """How many times zamba2's shared attn block runs per forward."""
    return cfg.num_layers // cfg.shared_attn_every


# ---------------------------------------------------------------------------
# Forward (training, evaluation)
# ---------------------------------------------------------------------------

def _attn_block(lp: Tree, x: torch.Tensor, cfg: ModelConfig, *, window: int,
                positions: Optional[torch.Tensor], causal: bool = True,
                mrope_positions: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"]["gamma"], cfg.norm_eps)
    q, k, v = A.project_qkv(lp["attn"], h, cfg, positions=positions,
                            mrope_positions=mrope_positions)
    k, v = A.local_kv(lp["attn"], cfg, k, v)
    att = A.attend(q, k, v, cfg, causal=causal, window=window)
    return x + A.out_proj(lp["attn"], att)


def _dense_layer(x: torch.Tensor, lp: Tree, cfg: ModelConfig, window: int,
                 positions: Optional[torch.Tensor], causal: bool,
                 mrope_positions: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    x = _attn_block(lp, x, cfg, window=window, positions=positions,
                    causal=causal, mrope_positions=mrope_positions)
    return _mlp_block(lp, x, cfg)


def _dense_trunk(params: Tree, cfg: ModelConfig, x: torch.Tensor,
                 positions: Optional[torch.Tensor], causal: bool = True,
                 remat: bool = True,
                 mrope_positions: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
    """The layer loop. Each layer's parameters come from one ``unbind(0)``
    of every stacked leaf per forward: indexing ``leaf[i]`` inside the
    loop would give each layer a ``select`` whose backward allocates a
    zero tensor the size of the whole stack. ``remat`` recomputes each
    layer in the backward (the reference's ``jax.checkpoint`` around the
    scanned body). ``positions=None`` means ``arange(S)``."""
    layers = tree_unbind(params["layers"])
    for lp, win in zip(layers, _window_schedule(cfg, len(layers))):
        x = _run(_dense_layer, remat, x, lp, cfg, win, positions, causal,
                 mrope_positions)
    return x


def _cross_attend(lp: Tree, x: torch.Tensor, cfg: ModelConfig,
                  k: torch.Tensor, v: torch.Tensor,
                  last: Optional[torch.Tensor] = None) -> torch.Tensor:
    """seamless's cross-attention: the query from the raw ``xattn``
    projection (no rotary, and any bias ignored, as in the reference)
    over the encoder's keys and values (B, S_enc, KV, Dh), every key
    visible: full attention, or, in the decode cell, the decode
    attention of one token with ``last`` (B,) = S_enc - 1 as the current
    index of every row."""
    p = lp["xattn"]
    hn = L.rms_norm(x, lp["lnx"]["gamma"], cfg.norm_eps)
    q = A.project(SH.copy_to(hn, *SH.split_group(p["wq"])), p["wq"])
    if last is None:
        k, v = A.local_kv(p, cfg, k, v)
        att = A.attend(q, k, v, cfg, causal=False)
    else:
        lo, hi = A.kv_range(p, cfg)
        att = A.attend_decode(q, k[:, :, lo:hi], v[:, :, lo:hi], last,
                              impl=cfg.attn_impl)
    return x + A.out_proj(p, att)


def _cross_layer(x: torch.Tensor, lp: Tree, cfg: ModelConfig,
                 enc: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    x = _attn_block(lp, x, cfg, window=0, positions=positions)
    k, v = _cross_kv(lp, enc)
    x = _cross_attend(lp, x, cfg, k, v)
    return _mlp_block(lp, x, cfg)


def _cross_kv(lp: Tree, enc: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The cross-attention's K and V of the encoder output (the rank's KV
    heads when ``wk``/``wv`` are split; ``enc`` is replicated over the
    model ranks and enters their sharded compute)."""
    p = lp["xattn"]
    e = SH.copy_to(enc, *SH.split_group(p["wk"]))
    return A.project(e, p["wk"]), A.project(e, p["wv"])


def _encode(params: Tree, cfg: ModelConfig, frame_embeds: torch.Tensor,
            remat: bool) -> torch.Tensor:
    """seamless's encoder: the dense layers over the frame embeddings,
    bidirectional, with RoPE at ``arange(S_enc)``, then ``enc_norm``."""
    enc = _dense_trunk({"layers": params["enc_layers"]}, cfg,
                       frame_embeds.to(L.torch_dtype(cfg.dtype)), None,
                       causal=False, remat=remat)
    return L.rms_norm(enc, params["enc_norm"]["gamma"], cfg.norm_eps)


def _encdec_trunk(params: Tree, cfg: ModelConfig, frame_embeds: torch.Tensor,
                  x: torch.Tensor, positions: torch.Tensor,
                  remat: bool = True) -> torch.Tensor:
    enc = _encode(params, cfg, frame_embeds, remat)
    for lp in tree_unbind(params["layers"]):
        x = _run(_cross_layer, remat, x, lp, cfg, enc, positions)
    return x


def _moe_layer(x: torch.Tensor, lp: Tree, cfg: ModelConfig,
               positions: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = _attn_block(lp, x, cfg, window=0, positions=positions)
    return _moe_block(lp, x, cfg)


def _moe_trunk(params: Tree, cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor, remat: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """moonshot's dense first layer(s), then the MoE layers, every layer
    global; returns (x, the MoE layers' summed aux, float32)."""
    if "dense_layers" in params:
        for lp in tree_unbind(params["dense_layers"]):
            x = _run(_dense_layer, remat, x, lp, cfg, 0, positions, True)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for lp in tree_unbind(params["layers"]):
        x, a = _run(_moe_layer, remat, x, lp, cfg, positions)
        aux = aux + a
    return x, aux


def _run(fn, remat: bool, *args):
    """``fn(*args)``, recomputed in the backward when ``remat`` (the
    reference's ``jax.checkpoint`` around a scanned body)."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _shared_block(sp: Tree, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor) -> torch.Tensor:
    x = _attn_block(sp, x, cfg, window=0, positions=positions)
    return _mlp_block(sp, x, cfg)


def _mamba_layer(x: torch.Tensor, lp: Tree, cfg: ModelConfig
                 ) -> torch.Tensor:
    hn = L.rms_norm(x, lp["ln"]["gamma"], cfg.norm_eps)
    return x + M.apply_mamba2(lp["mamba"], hn, cfg)


def _hybrid_block(x: torch.Tensor, layers: List[Tree], sp: Tree,
                  cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    for lp in layers:
        x = _mamba_layer(x, lp, cfg)
    return _shared_block(sp, x, cfg, positions)


def _hybrid_trunk(params: Tree, cfg: ModelConfig, x: torch.Tensor,
                  positions: torch.Tensor, remat: bool = True
                  ) -> torch.Tensor:
    """zamba2: ``n_blocks`` blocks of ``cadence`` Mamba2 layers, each
    followed by the one shared attention block, then the leftover tail
    layers. ``remat`` recomputes per block and per tail layer, as the
    reference does."""
    sp = params["shared"]
    for bp in tree_unbind(params["blocks"]):
        x = _run(_hybrid_block, remat, x, tree_unbind(bp), sp, cfg,
                 positions)
    if "tail" in params:
        for lp in tree_unbind(params["tail"]):
            x = _run(_mamba_layer, remat, x, lp, cfg)
    return x


def _rwkv_layer(h: torch.Tensor, lp: Tree, cfg: ModelConfig) -> torch.Tensor:
    zeros_tok = torch.zeros((h.shape[0], 1, cfg.d_model), dtype=h.dtype,
                            device=h.device)
    hn = L.rms_norm(h, lp["ln1"]["gamma"], cfg.norm_eps)
    out, _, _ = R.apply_tmix(lp["tmix"], hn, cfg, zeros_tok, None)
    h = h + out
    hn = L.rms_norm(h, lp["ln2"]["gamma"], cfg.norm_eps)
    out, _ = R.apply_cmix(lp["cmix"], hn, cfg, zeros_tok)
    return h + out


def _rwkv_trunk(params: Tree, cfg: ModelConfig, x: torch.Tensor,
                remat: bool = True) -> torch.Tensor:
    """rwkv6: every layer from a zero token shift and a zero state."""
    for lp in tree_unbind(params["layers"]):
        x = _run(_rwkv_layer, remat, x, lp, cfg)
    return x


def forward(params: Tree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. ``batch`` keys by family:
      dense/moe/hybrid/ssm: tokens (B, S);
      vlm: tokens (B, S_txt), patch_embeds (B, S_img, d), mrope_positions
        (B, S, 3), S = S_img + S_txt;
      encdec: frame_embeds (B, S_enc, d), tokens (B, S_dec).

    Returns (logits (B, S, V) in ``cfg.dtype``, over the decoder's S_dec
    positions for encdec; aux): ``aux`` is the MoE layers' summed router
    auxiliary loss (float32), zero for the other families, as in the
    reference."""
    check_family(cfg)
    dt = L.torch_dtype(cfg.dtype)
    x = L.embed(params["embed"], batch["tokens"], dt)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "vlm":
        # the patches, then the text; positions by M-RoPE only
        x = torch.cat([batch["patch_embeds"].to(dt), x], dim=1)
        x = _dense_trunk(params, cfg, x, None, remat=remat,
                         mrope_positions=batch["mrope_positions"])
    else:
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        if cfg.family == "dense":
            x = _dense_trunk(params, cfg, x, pos, remat=remat)
        elif cfg.family == "moe":
            x, aux = _moe_trunk(params, cfg, x, pos, remat=remat)
        elif cfg.family == "hybrid":
            x = _hybrid_trunk(params, cfg, x, pos, remat=remat)
        elif cfg.family == "ssm":
            x = _rwkv_trunk(params, cfg, x, remat=remat)
        else:
            x = _encdec_trunk(params, cfg, batch["frame_embeds"], x, pos,
                              remat=remat)
    x = L.rms_norm(x, params["final_norm"]["gamma"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg.tie_embeddings)
    return logits, aux


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device, enc_len: int = 0,
                      kv_heads: Optional[int] = None,
                      recurrent_split: int = 1) -> Tree:
    """Cache tree for ``decode_step``, laid out as the reference's: every
    leaf's leading axes are the stacked layer axes, then the batch axis,
    plus the per-row write index ``pos`` (B,) int32.
    - dense: KV leaves (layers, B, Smax, KV, Dh);
    - moe: the MoE layers' ``kv`` and, with dense first layers, their
      ``kv_dense``, both laid out as the dense family's;
    - hybrid: Mamba2 ``state`` (float32) and ``conv`` leaves under
      ``blocks`` (n_blocks, cadence, B, ...) and ``tail`` (leftover, B,
      ...), and the shared block's KV per invocation, ``shared_kv``
      (n_blocks, B, Smax, KV, Dh);
    - ssm: ``wkv`` (layers, B, H, Dh, Dh) float32 and the token-shift
      leaves ``tok_t``, ``tok_c`` (layers, B, 1, d);
    - vlm: as dense;
    - encdec: the decoder's self-attention ``kv`` (dec_layers, B, Smax,
      KV, Dh) and the cross-attention caches ``xk``, ``xv`` (dec_layers,
      B, enc_len, KV, Dh), zero until ``encode_for_decode`` fills them.

    A rank's block of a sharded cache: ``batch`` its rows, ``max_len`` its
    positions (the cache split on its sequence), ``kv_heads`` its KV
    heads (default all), as ``launch.specs.cache_shardings`` splits the
    attention leaves, and ``recurrent_split`` the number of ranks the
    Mamba-2 or RWKV-6 heads split over (``launch.specs.cache_block``):
    the ``state``, ``conv`` and ``wkv`` leaves of the rank's heads
    (``ssm.init_mamba2_cache``, ``rwkv.init_rwkv_state``)."""
    check_family(cfg)
    dt = L.torch_dtype(cfg.dtype)
    KV = cfg.num_kv_heads if kv_heads is None else kv_heads

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(n):
        shape = (n, batch, max_len, KV, cfg.head_dim)
        return {"k": zeros(shape), "v": zeros(shape)}

    def stacked(tree, lead):
        return tree_map(lambda t: t.expand(*lead, *t.shape).clone(), tree)

    pos = zeros((batch,), torch.int32)
    if cfg.family in ("dense", "vlm"):
        return {"kv": kv(cfg.num_layers), "pos": pos}
    if cfg.family == "encdec":
        cross = (cfg.dec_layers, batch, enc_len, KV, cfg.head_dim)
        return {"kv": kv(cfg.dec_layers), "xk": zeros(cross),
                "xv": zeros(cross), "pos": pos}
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        c = {"kv": kv(cfg.num_layers - nd), "pos": pos}
        if nd:
            c["kv_dense"] = kv(nd)
        return c
    if cfg.family == "hybrid":
        cad = cfg.shared_attn_every
        n_blocks, leftover = divmod(cfg.num_layers, cad)
        one = M.init_mamba2_cache(cfg, batch, dt, device, recurrent_split)
        c = {"blocks": stacked(one, (n_blocks, cad)),
             "shared_kv": kv(n_blocks), "pos": pos}
        if leftover:
            c["tail"] = stacked(one, (leftover,))
        return c
    return {**stacked(R.init_rwkv_state(cfg, batch, dt, device,
                                        recurrent_split),
                      (cfg.num_layers,)), "pos": pos}


def _mlp_block(lp: Tree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln2"]["gamma"], cfg.norm_eps)
    return x + F.apply_mlp(lp["mlp"], h)


def _moe_block(lp: Tree, x: torch.Tensor, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = L.rms_norm(x, lp["ln2"]["gamma"], cfg.norm_eps)
    out, aux = F.apply_moe(lp["moe"], h, cfg)
    return x + out, aux


def _decode_attn_layer(lp: Tree, x: torch.Tensor, cfg: ModelConfig,
                       kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor,
                       window: int, advance: Optional[torch.Tensor]
                       ) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"]["gamma"], cfg.norm_eps)
    q, k, v = A.project_qkv(lp["attn"], h, cfg, positions=pos[:, None])
    A.update_cache(kc, vc, k, v, pos, advance, offset=A.seq_offset(kc))
    lo, hi = A.kv_range(lp["attn"], cfg)
    att = A.attend_decode(q, kc[:, :, lo:hi], vc[:, :, lo:hi], pos,
                          window=window, impl=cfg.attn_impl, seq=True)
    return x + A.out_proj(lp["attn"], att)


def _commit(leaf: torch.Tensor, new: torch.Tensor,
            advance: Optional[torch.Tensor]) -> None:
    """Write a recurrent leaf's new value (batch axis 0) IN PLACE, keeping
    the old rows where ``advance`` is False."""
    if advance is not None:
        new = torch.where(advance.view(-1, *([1] * (new.dim() - 1))), new,
                          leaf)
    leaf.copy_(new)


def _decode_mamba_layer(lp: Tree, x: torch.Tensor, cfg: ModelConfig,
                        state: torch.Tensor, conv: torch.Tensor,
                        advance: Optional[torch.Tensor]) -> torch.Tensor:
    hn = L.rms_norm(x, lp["ln"]["gamma"], cfg.norm_eps)
    out, new = M.decode_mamba2(lp["mamba"], hn,
                               {"state": state, "conv": conv}, cfg)
    _commit(state, new["state"], advance)
    _commit(conv, new["conv"], advance)
    return x + out


def _decode_rwkv_layer(lp: Tree, x: torch.Tensor, cfg: ModelConfig,
                       st: Tree, advance: Optional[torch.Tensor]
                       ) -> torch.Tensor:
    hn = L.rms_norm(x, lp["ln1"]["gamma"], cfg.norm_eps)
    out, new = R.decode_tmix(lp["tmix"], hn, cfg, st)
    x = x + out
    hn = L.rms_norm(x, lp["ln2"]["gamma"], cfg.norm_eps)
    out, new = R.decode_cmix(lp["cmix"], hn, cfg, new)
    for key in ("wkv", "tok_t", "tok_c"):
        _commit(st[key], new[key], advance)
    return x + out


def _decode_attn_stacks(params: Tree, cfg: ModelConfig, cache: Tree,
                        x: torch.Tensor, attn) -> torch.Tensor:
    """The dense (and vlm) and moe families' decode layers: each layer's
    attention cell ``attn(lp, x, kc, vc, window)`` (dense or paged) over
    its KV leaves, then its FFN block. moe runs its dense first layers over
    ``kv_dense`` with the MLP, then the rest over ``kv`` with the MoE
    block, every layer global, as its forward does."""
    def mlp(lp, h):
        return _mlp_block(lp, h, cfg)

    def moe(lp, h):
        return _moe_block(lp, h, cfg)[0]

    if cfg.family in ("dense", "vlm"):
        stacks = [("layers", "kv", _window_schedule(cfg, cfg.num_layers),
                   mlp)]
    else:
        nd = cfg.first_dense_layers
        stacks = [("dense_layers", "kv_dense", [0] * nd, mlp)] if nd else []
        stacks.append(("layers", "kv", [0] * (cfg.num_layers - nd), moe))
    for name, leaf, windows, ffn in stacks:
        ks, vs = cache[leaf]["k"], cache[leaf]["v"]
        for i, (lp, win) in enumerate(zip(tree_unbind(params[name]),
                                          windows)):
            x = ffn(lp, attn(lp, x, ks[i], vs[i], win))
    return x


def decode_step(params: Tree, cfg: ModelConfig, cache: Tree,
                batch: Dict[str, torch.Tensor],
                advance: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Tree]:
    """One-token decode. batch = {tokens: (B, 1)}; the vlm decode cell
    is the dense one (text tokens at 1-D RoPE positions ``pos``, which is
    M-RoPE at (pos, pos, pos)), as in the reference.

    Returns (logits (B, 1, V), new cache). ``cache['pos']`` is the write
    index for this step. Every cache leaf but ``pos`` is updated IN PLACE
    (the returned cache holds the same tensors, saving a cache-sized copy
    per token); ``pos`` is a new tensor, advanced for every row as in the
    reference. ``advance`` (B,) bool, if given, freezes the rows where it
    is False: their KV writes are dropped, their recurrent state, conv
    and token-shift rows keep their old values, and their ``pos`` stays,
    so the cache is what the reference's per-row select after the step
    gives (the logits of frozen rows are meaningless).
    """
    check_family(cfg)
    pos = cache["pos"]
    x = L.embed(params["embed"], batch["tokens"], L.torch_dtype(cfg.dtype))
    if cfg.family in ("dense", "moe", "vlm"):
        x = _decode_attn_stacks(
            params, cfg, cache, x,
            lambda lp, x, kc, vc, win: _decode_attn_layer(
                lp, x, cfg, kc, vc, pos, win, advance))
    elif cfg.family == "encdec":
        ks, vs = cache["kv"]["k"], cache["kv"]["v"]
        xk, xv = cache["xk"], cache["xv"]
        last = torch.full_like(pos, xk.shape[2] - 1)
        for i, lp in enumerate(tree_unbind(params["layers"])):
            x = _decode_attn_layer(lp, x, cfg, ks[i], vs[i], pos, 0, advance)
            x = _cross_attend(lp, x, cfg, xk[i], xv[i], last)
            x = _mlp_block(lp, x, cfg)
    elif cfg.family == "hybrid":
        sp = params["shared"]
        blk = cache["blocks"]
        ks, vs = cache["shared_kv"]["k"], cache["shared_kv"]["v"]
        for b, bp in enumerate(tree_unbind(params["blocks"])):
            for i, lp in enumerate(tree_unbind(bp)):
                x = _decode_mamba_layer(lp, x, cfg, blk["state"][b, i],
                                        blk["conv"][b, i], advance)
            x = _decode_attn_layer(sp, x, cfg, ks[b], vs[b], pos, 0,
                                   advance)
            x = _mlp_block(sp, x, cfg)
        if "tail" in cache:
            tail = cache["tail"]
            for i, lp in enumerate(tree_unbind(params["tail"])):
                x = _decode_mamba_layer(lp, x, cfg, tail["state"][i],
                                        tail["conv"][i], advance)
    else:
        for i, lp in enumerate(tree_unbind(params["layers"])):
            st = {key: cache[key][i] for key in ("wkv", "tok_t", "tok_c")}
            x = _decode_rwkv_layer(lp, x, cfg, st, advance)
    x = L.rms_norm(x, params["final_norm"]["gamma"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg.tie_embeddings)
    nxt = pos + 1 if advance is None else pos + advance.to(pos.dtype)
    return logits, {**cache, "pos": nxt}


def encode_for_decode(params: Tree, cfg: ModelConfig,
                      frame_embeds: torch.Tensor, cache: Tree) -> Tree:
    """encdec: run the encoder once over ``frame_embeds`` (B, S_enc, d)
    and return the cache with the per-layer cross K/V, ``xk`` and ``xv``
    (dec_layers, B, S_enc, KV, Dh), in place of the ones it had, as the
    reference does. The other leaves are the same tensors."""
    enc = _encode(params, cfg, frame_embeds, remat=False)
    layers = tree_unbind(params["layers"])
    xk = xv = None
    for i, lp in enumerate(layers):
        k, v = _cross_kv(lp, enc)       # (B, S_enc, the rank's KV, Dh)
        if xk is None:
            xk = k.new_empty((len(layers), *k.shape))
            xv = v.new_empty((len(layers), *v.shape))
        xk[i] = k
        xv[i] = v
    return {**cache, "xk": xk, "xv": xv}


# ---------------------------------------------------------------------------
# Paged decode
# ---------------------------------------------------------------------------

def init_paged_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                            page_size: int, num_pages: int, device,
                            enc_len: int = 0,
                            kv_heads: Optional[int] = None,
                            recurrent_split: int = 1) -> Tree:
    """Cache tree for ``decode_step_paged``: every length-bearing KV leaf
    becomes a physical page pool ``(layers, num_pages, page_size, KV, Dh)``
    shared by all rows, indexed through a per-row ``page_table`` leaf
    ``(batch, ceil(max_len / page_size))`` int32. Recurrent per-row state
    carries no length axis and stays dense.
    - dense: ``kv`` pools, the page table and ``pos``;
    - moe: as dense, plus the dense first layers' ``kv_dense`` pools,
      indexed through the same table;
    - hybrid: the dense cache with ``shared_kv`` as pools, plus the table;
    - ssm: the dense cache plus the table (attention-free, so no pool;
      the table keeps the engine's page accounting uniform);
    - vlm: as dense;
    - encdec: none (NotImplementedError, as in the reference).
    ``kv_heads`` and ``recurrent_split``: the rank's block under tensor
    parallelism, as for :func:`init_decode_cache`."""
    check_family(cfg)
    if cfg.family == "encdec":
        raise NotImplementedError(
            f"paged decode cache not supported for family {cfg.family!r} "
            "(encdec cross-attention caches are fixed-length; use dense)")
    dt = L.torch_dtype(cfg.dtype)
    pages_per_row = -(-max_len // page_size)

    def kv_pool(n):
        shape = (n, num_pages, page_size,
                 cfg.num_kv_heads if kv_heads is None else kv_heads,
                 cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    table = torch.zeros((batch, pages_per_row), dtype=torch.int32,
                        device=device)
    pos = torch.zeros((batch,), dtype=torch.int32, device=device)
    if cfg.family in ("dense", "vlm"):
        return {"kv": kv_pool(cfg.num_layers), "page_table": table,
                "pos": pos}
    if cfg.family == "moe":
        nd = cfg.first_dense_layers
        c = {"kv": kv_pool(cfg.num_layers - nd), "page_table": table,
             "pos": pos}
        if nd:
            c["kv_dense"] = kv_pool(nd)
        return c
    c = init_decode_cache(cfg, batch, max_len, device, kv_heads=kv_heads,
                          recurrent_split=recurrent_split)
    if cfg.family == "hybrid":
        c["shared_kv"] = kv_pool(num_shared_invocations(cfg))
    c["page_table"] = table
    return c


def _advance_rows(advance, pos: torch.Tensor
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(device bool mask, device index of the advancing rows) from a host
    mask, with no device sync; (None, None) when every row advances."""
    if advance is None:
        return None, None
    adv = np.asarray(advance, dtype=bool)
    if adv.all():
        return None, None
    return (torch.as_tensor(adv, device=pos.device),
            torch.as_tensor(np.flatnonzero(adv), device=pos.device))


def _decode_attn_layer_paged(lp: Tree, x: torch.Tensor, cfg: ModelConfig,
                             kp: torch.Tensor, vp: torch.Tensor,
                             table: torch.Tensor, pos: torch.Tensor,
                             window: int, slots: A.PageSlots
                             ) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"]["gamma"], cfg.norm_eps)
    q, k, v = A.project_qkv(lp["attn"], h, cfg, positions=pos[:, None])
    A.write_pages(kp, vp, k, v, slots)
    lo, hi = A.kv_range(lp["attn"], cfg)
    att = A.attend_decode_paged(q, kp[..., lo:hi, :], vp[..., lo:hi, :],
                                table, pos, window=window,
                                impl=cfg.attn_impl)
    return x + A.out_proj(lp["attn"], att)


def decode_step_paged(params: Tree, cfg: ModelConfig, cache: Tree,
                      batch: Dict[str, torch.Tensor], advance=None
                      ) -> Tuple[torch.Tensor, Tree]:
    """One-token decode against the paged cache. Same contract as
    :func:`decode_step`, plus ``advance``: the (B,) bool rows that consume
    this token, as a host array (numpy or a sequence). Rows that
    do not advance write no page (their page-table rows may point at
    pages now owned by another request), and keep their recurrent state,
    conv and token-shift rows and ``pos``, frozen in place by the same
    batch-axis select as the dense cell's. Their logits are
    meaningless."""
    check_family(cfg)
    pos = cache["pos"]
    mask, rows = _advance_rows(advance, pos)
    if cfg.family == "ssm":
        # no paged leaves: the dense cell already is the paged cell
        return decode_step(params, cfg, cache, batch, mask)
    table = cache["page_table"]
    pool = cache["shared_kv"] if cfg.family == "hybrid" else cache["kv"]
    ks, vs = pool["k"], pool["v"]
    slots = A.page_slots(table, pos, ks.shape[2], rows)
    x = L.embed(params["embed"], batch["tokens"], L.torch_dtype(cfg.dtype))
    if cfg.family in ("dense", "moe", "vlm"):
        x = _decode_attn_stacks(
            params, cfg, cache, x,
            lambda lp, x, kc, vc, win: _decode_attn_layer_paged(
                lp, x, cfg, kc, vc, table, pos, win, slots))
    else:
        sp = params["shared"]
        blk = cache["blocks"]
        for b, bp in enumerate(tree_unbind(params["blocks"])):
            for i, lp in enumerate(tree_unbind(bp)):
                x = _decode_mamba_layer(lp, x, cfg, blk["state"][b, i],
                                        blk["conv"][b, i], mask)
            x = _decode_attn_layer_paged(sp, x, cfg, ks[b], vs[b], table,
                                         pos, 0, slots)
            x = _mlp_block(sp, x, cfg)
        if "tail" in cache:
            tail = cache["tail"]
            for i, lp in enumerate(tree_unbind(params["tail"])):
                x = _decode_mamba_layer(lp, x, cfg, tail["state"][i],
                                        tail["conv"][i], mask)
    x = L.rms_norm(x, params["final_norm"]["gamma"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg.tie_embeddings)
    nxt = pos + 1 if mask is None else pos + mask.to(pos.dtype)
    return logits, {**cache, "pos": nxt}
