"""The dense decoder-only stack (counterpart of the dense family of
``repro.models.transformer``): parameters, the full-sequence forward that
training and evaluation run, the decode cache, and the one-token decode
cell that serving runs for every prompt and generated token.

The reference scans stacked layer parameters; PyTorch runs eagerly, so
the port keeps the stacked layout (every layer leaf has a leading
``layers`` axis, as in the reference pytree) and loops over it in Python.

Public entry points (used by the builder, train/serve steps and engine):
    init_params(cfg, generator, device, dtype)       -> params tree
    forward(params, cfg, batch, remat)               -> (logits, aux)
    init_decode_cache(cfg, batch, max_len, device)   -> cache tree
    decode_step(params, cfg, cache, batch)           -> (logits, cache)
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import ffn as F
from repro_torch.models import layers as L
from repro_torch.tree import tree_map, tree_unbind

Tree = Dict[str, Any]

# Families the port does not serve yet, and the ROADMAP.md Queue 1 item
# that ports each.
_UNPORTED = {
    "moe": "Queue 1 item 6 (MoE, multimodal and encoder-decoder)",
    "vlm": "Queue 1 item 6 (MoE, multimodal and encoder-decoder)",
    "encdec": "Queue 1 item 6 (MoE, multimodal and encoder-decoder)",
    "hybrid": "Queue 1 item 5 (recurrent families, ssd_scan and rwkv6)",
    "ssm": "Queue 1 item 5 (recurrent families, ssd_scan and rwkv6)",
    "resnet": "Queue 1 item 2 (training, with the paper's ResNet-32)",
}


def require_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
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


def init_params(cfg: ModelConfig, generator, device,
                dtype: Optional[torch.dtype] = None) -> Tree:
    """Seeded parameters on ``device`` (``generator`` must live there;
    ``None`` is allowed on the ``meta`` device, for shapes only). Weight
    matrices, biases and embeddings are stored in ``dtype``: ``cfg.dtype``
    by default (serving), ``torch.float32`` for training's masters, as the
    reference holds them; the draws are float32 either way. RMS gammas are
    float32 always."""
    require_dense(cfg)
    dt = dtype if dtype is not None else L.torch_dtype(cfg.dtype)
    layers = [_init_dense_layer(generator, cfg, dt, device)
              for _ in range(cfg.num_layers)]
    return {
        "embed": L.init_embed(generator, cfg.vocab_size, cfg.d_model,
                              cfg.tie_embeddings, dtype=dt, device=device),
        "final_norm": L.init_rms(generator, cfg.d_model, device),
        "layers": tree_map(lambda *xs: torch.stack(xs), *layers),
    }


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
        if remat:
            x = checkpoint(_dense_layer, x, lp, cfg, win, positions, causal,
                           use_reentrant=False)
        else:
            x = _dense_layer(x, lp, cfg, win, positions, causal)
    return x


def forward(params: Tree, cfg: ModelConfig, batch: Dict[str, torch.Tensor],
            remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward of the dense family. batch = {tokens: (B, S)}.

    Returns (logits (B, S, V) in ``cfg.dtype``, aux): ``aux`` is the MoE
    auxiliary loss, a float32 zero for the dense family, as in the
    reference."""
    require_dense(cfg)
    dt = L.torch_dtype(cfg.dtype)
    tokens = batch["tokens"]
    x = L.embed(params["embed"], tokens, dt)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    x = _dense_trunk(params, cfg, x, pos, remat=remat)
    x = L.rms_norm(x, params["final_norm"]["gamma"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg.tie_embeddings)
    return logits, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_decode_cache(cfg: ModelConfig, batch: int, max_len: int,
                      device) -> Tree:
    """Cache tree for ``decode_step``: KV leaves (layers, B, Smax, KV, Dh)
    and the per-row write index ``pos`` (B,) int32."""
    require_dense(cfg)
    dt = L.torch_dtype(cfg.dtype)
    shape = (cfg.num_layers, batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {
        "kv": {"k": torch.zeros(shape, dtype=dt, device=device),
               "v": torch.zeros(shape, dtype=dt, device=device)},
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


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


def decode_step(params: Tree, cfg: ModelConfig, cache: Tree,
                batch: Dict[str, torch.Tensor],
                advance: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Tree]:
    """One-token decode. batch = {tokens: (B, 1)}.

    Returns (logits (B, 1, V), new cache). ``cache['pos']`` is the write
    index for this step. The KV leaves are updated IN PLACE (the returned
    cache holds the same KV tensors, saving a cache-sized copy per token);
    ``pos`` is a new tensor, advanced for every row as in the reference.
    ``advance`` (B,) bool, if given, freezes the rows where it is False:
    their cache writes are dropped and their ``pos`` stays, so the cache
    is what the reference's per-row select after the step gives (the
    logits of frozen rows are meaningless).
    """
    require_dense(cfg)
    pos = cache["pos"]
    x = L.embed(params["embed"], batch["tokens"], L.torch_dtype(cfg.dtype))
    ks, vs = cache["kv"]["k"], cache["kv"]["v"]
    layers = tree_unbind(params["layers"])
    for i, win in enumerate(_window_schedule(cfg, cfg.num_layers)):
        lp = layers[i]
        x = _decode_attn_layer(lp, x, cfg, ks[i], vs[i], pos, win, advance)
        x = _mlp_block(lp, x, cfg)
    x = L.rms_norm(x, params["final_norm"]["gamma"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg.tie_embeddings)
    nxt = pos + 1 if advance is None else pos + advance.to(pos.dtype)
    return logits, {**cache, "pos": nxt}
