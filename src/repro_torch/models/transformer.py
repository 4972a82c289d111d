"""Model stacks of the ported families (counterpart of
``repro.models.transformer``): parameters, the full-sequence forward that
training and evaluation run, the decode cache, and the one-token decode
cell that serving runs for every prompt and generated token.

Families ported:
- ``dense``  : decoder-only (GQA/MQA/MHA), optional gemma3-style
               local:global sliding-window pattern;
- ``hybrid`` : zamba2 — Mamba2 backbone with a *weight-tied shared*
               attention block invoked every ``shared_attn_every`` layers;
- ``ssm``    : rwkv6 — attention-free time-mix / channel-mix.

The reference scans stacked layer parameters; PyTorch runs eagerly, so
the port keeps the stacked layout (every layer leaf has a leading
``layers`` axis, zamba2's blocks ``(n_blocks, cadence)``, as in the
reference pytree) and loops over it in Python.

Public entry points (used by the builder, train/serve steps and engine):
    init_params(cfg, generator, device, dtype)       -> params tree
    forward(params, cfg, batch, remat)               -> (logits, aux)
    init_decode_cache(cfg, batch, max_len, device)   -> cache tree
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

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L
from repro_torch.models import rwkv as R
from repro_torch.models import ssm as M
from repro_torch.tree import tree_map, tree_unbind

Tree = Dict[str, Any]

PORTED = ("dense", "hybrid", "ssm")
# Families the port does not serve yet, and the ROADMAP.md Queue 1 item
# that ports each.
_UNPORTED = {
    "moe": "Queue 1 item 6 (MoE, multimodal and encoder-decoder)",
    "vlm": "Queue 1 item 6 (MoE, multimodal and encoder-decoder)",
    "encdec": "Queue 1 item 6 (MoE, multimodal and encoder-decoder)",
}


def require_ported(cfg: ModelConfig) -> None:
    if cfg.family == "resnet":
        raise ValueError(f"{cfg.name}: the resnet family has no transformer "
                         "stack; models/resnet.py runs it (build_model "
                         "dispatches to it)")
    if cfg.family not in PORTED:
        where = _UNPORTED.get(cfg.family, "no ROADMAP item")
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported to PyTorch "
            f"yet; see ROADMAP.md {where}")


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


def _stack(init_fn, n: int) -> Tree:
    """``n`` layers from ``init_fn()``, every leaf stacked on a new
    leading axis."""
    return tree_map(lambda *xs: torch.stack(xs), *[init_fn()
                                                   for _ in range(n)])


def init_params(cfg: ModelConfig, generator, device,
                dtype: Optional[torch.dtype] = None) -> Tree:
    """Seeded parameters on ``device`` (``generator`` must live there;
    ``None`` is allowed on the ``meta`` device, for shapes only). Weight
    matrices, biases and embeddings are stored in ``dtype``: ``cfg.dtype``
    by default (serving), ``torch.float32`` for training's masters, as the
    reference holds them; the draws are float32 either way. RMS gammas and
    the recurrent leaves the reference reads in float32 (see ``ssm.py``
    and ``rwkv.py``) are float32 always."""
    require_ported(cfg)
    dt = dtype if dtype is not None else L.torch_dtype(cfg.dtype)
    # the stacks are drawn before the embeddings: the draw order fixes
    # the weights a seed gives
    fam = cfg.family
    stacks: Tree = {}
    if fam == "dense":
        stacks["layers"] = _stack(
            lambda: _init_dense_layer(generator, cfg, dt, device),
            cfg.num_layers)
    elif fam == "hybrid":
        cad = cfg.shared_attn_every
        n_blocks, leftover = divmod(cfg.num_layers, cad)
        mamba = lambda: _init_mamba_layer(generator, cfg, dt, device)  # noqa: E731
        stacks["blocks"] = _stack(lambda: _stack(mamba, cad), n_blocks)
        if leftover:
            stacks["tail"] = _stack(mamba, leftover)
        stacks["shared"] = _init_dense_layer(generator, cfg, dt, device)
    else:
        stacks["layers"] = _stack(
            lambda: _init_rwkv_layer(generator, cfg, dt, device),
            cfg.num_layers)
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
                positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"]["gamma"], cfg.norm_eps)
    q, k, v = A.project_qkv(lp["attn"], h, cfg, positions=positions)
    att = A.attend(q, k, v, cfg, causal=causal, window=window)
    return x + A.out_proj(lp["attn"], att)


def _dense_layer(x: torch.Tensor, lp: Tree, cfg: ModelConfig, window: int,
                 positions: torch.Tensor, causal: bool) -> torch.Tensor:
    x = _attn_block(lp, x, cfg, window=window, positions=positions,
                    causal=causal)
    return _mlp_block(lp, x, cfg)


def _dense_trunk(params: Tree, cfg: ModelConfig, x: torch.Tensor,
                 positions: torch.Tensor, causal: bool = True,
                 remat: bool = True) -> torch.Tensor:
    """The layer loop. Each layer's parameters come from one ``unbind(0)``
    of every stacked leaf per forward: indexing ``leaf[i]`` inside the
    loop would give each layer a ``select`` whose backward allocates a
    zero tensor the size of the whole stack. ``remat`` recomputes each
    layer in the backward (the reference's ``jax.checkpoint`` around the
    scanned body)."""
    layers = tree_unbind(params["layers"])
    for lp, win in zip(layers, _window_schedule(cfg, len(layers))):
        x = _run(_dense_layer, remat, x, lp, cfg, win, positions, causal)
    return x


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
    """Full-sequence forward. batch = {tokens: (B, S)}.

    Returns (logits (B, S, V) in ``cfg.dtype``, aux): ``aux`` is the MoE
    auxiliary loss, a float32 zero for the ported families, as in the
    reference."""
    require_ported(cfg)
    dt = L.torch_dtype(cfg.dtype)
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, dt)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    if cfg.family == "dense":
        x = _dense_trunk(params, cfg, x, pos, remat=remat)
    elif cfg.family == "hybrid":
        x = _hybrid_trunk(params, cfg, x, pos, remat=remat)
    else:
        x = _rwkv_trunk(params, cfg, x, remat=remat)
    x = L.rms_norm(x, params["final_norm"]["gamma"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg.tie_embeddings)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device) -> Tree:
    """Cache tree for ``decode_step``, laid out as the reference's: every
    leaf's leading axes are the stacked layer axes, then the batch axis,
    plus the per-row write index ``pos`` (B,) int32.
    - dense: KV leaves (layers, B, Smax, KV, Dh);
    - hybrid: Mamba2 ``state`` (float32) and ``conv`` leaves under
      ``blocks`` (n_blocks, cadence, B, ...) and ``tail`` (leftover, B,
      ...), and the shared block's KV per invocation, ``shared_kv``
      (n_blocks, B, Smax, KV, Dh);
    - ssm: ``wkv`` (layers, B, H, Dh, Dh) float32 and the token-shift
      leaves ``tok_t``, ``tok_c`` (layers, B, 1, d)."""
    require_ported(cfg)
    dt = L.torch_dtype(cfg.dtype)

    def zeros(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def kv(n):
        shape = (n, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
        return {"k": zeros(shape), "v": zeros(shape)}

    def stacked(tree, lead):
        return tree_map(lambda t: t.expand(*lead, *t.shape).clone(), tree)

    pos = zeros((batch,), torch.int32)
    if cfg.family == "dense":
        return {"kv": kv(cfg.num_layers), "pos": pos}
    if cfg.family == "hybrid":
        cad = cfg.shared_attn_every
        n_blocks, leftover = divmod(cfg.num_layers, cad)
        one = M.init_mamba2_cache(cfg, batch, dt, device)
        c = {"blocks": stacked(one, (n_blocks, cad)),
             "shared_kv": kv(n_blocks), "pos": pos}
        if leftover:
            c["tail"] = stacked(one, (leftover,))
        return c
    return {**stacked(R.init_rwkv_state(cfg, batch, dt, device),
                      (cfg.num_layers,)), "pos": pos}


def _mlp_block(lp: Tree, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln2"]["gamma"], cfg.norm_eps)
    return x + F.apply_mlp(lp["mlp"], h)


def _decode_attn_layer(lp: Tree, x: torch.Tensor, cfg: ModelConfig,
                       kc: torch.Tensor, vc: torch.Tensor, pos: torch.Tensor,
                       window: int, advance: Optional[torch.Tensor]
                       ) -> torch.Tensor:
    h = L.rms_norm(x, lp["ln1"]["gamma"], cfg.norm_eps)
    q, k, v = A.project_qkv(lp["attn"], h, cfg, positions=pos[:, None])
    A.update_cache(kc, vc, k, v, pos, advance)
    att = A.attend_decode(q, kc, vc, pos, window=window, impl=cfg.attn_impl)
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


def decode_step(params: Tree, cfg: ModelConfig, cache: Tree,
                batch: Dict[str, torch.Tensor],
                advance: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Tree]:
    """One-token decode. batch = {tokens: (B, 1)}.

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
    require_ported(cfg)
    pos = cache["pos"]
    x = L.embed(params["embed"], batch["tokens"], L.torch_dtype(cfg.dtype))
    if cfg.family == "dense":
        ks, vs = cache["kv"]["k"], cache["kv"]["v"]
        layers = tree_unbind(params["layers"])
        for i, win in enumerate(_window_schedule(cfg, cfg.num_layers)):
            lp = layers[i]
            x = _decode_attn_layer(lp, x, cfg, ks[i], vs[i], pos, win,
                                   advance)
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


# ---------------------------------------------------------------------------
# Paged decode
# ---------------------------------------------------------------------------

def init_paged_decode_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                            page_size: int, num_pages: int, device) -> Tree:
    """Cache tree for ``decode_step_paged``: every length-bearing KV leaf
    becomes a physical page pool ``(layers, num_pages, page_size, KV, Dh)``
    shared by all rows, indexed through a per-row ``page_table`` leaf
    ``(batch, ceil(max_len / page_size))`` int32. Recurrent per-row state
    carries no length axis and stays dense.
    - dense: ``kv`` pools, the page table and ``pos``;
    - hybrid: the dense cache with ``shared_kv`` as pools, plus the table;
    - ssm: the dense cache plus the table (attention-free, so no pool;
      the table keeps the engine's page accounting uniform)."""
    require_ported(cfg)
    dt = L.torch_dtype(cfg.dtype)
    pages_per_row = -(-max_len // page_size)

    def kv_pool(n):
        shape = (n, num_pages, page_size, cfg.num_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    table = torch.zeros((batch, pages_per_row), dtype=torch.int32,
                        device=device)
    if cfg.family == "dense":
        return {"kv": kv_pool(cfg.num_layers), "page_table": table,
                "pos": torch.zeros((batch,), dtype=torch.int32,
                                   device=device)}
    c = init_decode_cache(cfg, batch, max_len, device)
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
    att = A.attend_decode_paged(q, kp, vp, table, pos, window=window,
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
    require_ported(cfg)
    pos = cache["pos"]
    mask, rows = _advance_rows(advance, pos)
    if cfg.family == "ssm":
        # no paged leaves: the dense cell already is the paged cell
        return decode_step(params, cfg, cache, batch, mask)
    table = cache["page_table"]
    pool = cache["kv"] if cfg.family == "dense" else cache["shared_kv"]
    ks, vs = pool["k"], pool["v"]
    slots = A.page_slots(table, pos, ks.shape[2], rows)
    x = L.embed(params["embed"], batch["tokens"], L.torch_dtype(cfg.dtype))
    if cfg.family == "dense":
        layers = tree_unbind(params["layers"])
        for i, win in enumerate(_window_schedule(cfg, cfg.num_layers)):
            x = _decode_attn_layer_paged(layers[i], x, cfg, ks[i], vs[i],
                                         table, pos, win, slots)
            x = _mlp_block(layers[i], x, cfg)
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
