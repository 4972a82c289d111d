"""Analytic per-cell FLOPs / HBM-bytes model for the roofline
(counterpart of ``repro.analytic``; the same formulas).

The dry-run counts one rank's FLOPs on fake tensors too
(``repro_torch.launch.dryrun``), but that count includes whatever the
port's step repeats on every rank (today every layout gathers the whole
compute copy once a step; ROADMAP item 7.5), so the report's FLOPs and
bytes are these closed forms, written against the same math as the
model code, as the reference's report takes them.

Conventions
-----------
- FLOPs are global per step (divide by chips for per-device).
- HBM bytes are PER DEVICE per step and model an attention that never
  materialises the scores (a flash kernel, which the port's ``"cuda"``
  attention is) except where the implementation named does: the
  reference asks ``attn_impl == "xla"`` (its plain path) there, and the
  port's names differ. ``"torch"``, the port's plain q-chunked path,
  materialises the scores of each chunk and counts as the reference's
  ``"xla"``; ``"cuda"``, the hand-written kernels, counts as its
  ``"pallas"``.
- All matmul flops use 2 m n k; attention uses the average causal KV
  length.
- Parameter bytes come from the port's own parameter specs
  (``models/axes.py`` and ``sharding.param_spec``) over a mesh view, so
  no process group and no allocation is needed.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.config import ModelConfig, ShapeConfig, TrainConfig

# the attention implementations whose HBM traffic includes the scores
SCORES_IMPLS = ("torch",)

FP32 = 4
BF16 = 2


# ---------------------------------------------------------------------------
# Forward FLOPs (global) per family
# ---------------------------------------------------------------------------

def _attn_flops(cfg: ModelConfig, T: float, kv_len: float, *,
                causal: bool, window: int) -> float:
    """One attention layer: projections + scores + AV + out."""
    H, KV, Dh, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.d_model
    proj = 2 * T * d * (H * Dh + 2 * KV * Dh) + 2 * T * H * Dh * d
    if window and window > 0:
        seff = min(window, kv_len)
    elif causal:
        seff = (kv_len + 1) / 2
    else:
        seff = kv_len
    sc = 2 * T * seff * H * Dh * 2                 # QK^T and PV
    return proj + sc


def _mlp_flops(cfg: ModelConfig, T: float, d_ff: Optional[int] = None,
               gated: Optional[bool] = None) -> float:
    f = d_ff if d_ff is not None else cfg.d_ff
    g = cfg.gated_mlp if gated is None else gated
    return (6 if g else 4) * T * cfg.d_model * f


def _moe_flops(cfg: ModelConfig, T: float) -> float:
    d, f = cfg.d_model, cfg.d_ff
    routed = 6 * T * d * f * cfg.top_k
    shared = 6 * T * d * f * cfg.num_shared_experts
    router = 2 * T * d * cfg.num_experts
    dense = (6 * T * d * cfg.dense_ff
             if cfg.dense_ff and not cfg.first_dense_layers else 0)
    return routed + shared + router + dense


def _mamba_flops(cfg: ModelConfig, T: float) -> float:
    d, d_in = cfg.d_model, cfg.ssm_d_inner
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    Q = cfg.ssm_chunk
    proj = 2 * T * d * (2 * d_in + 2 * N + H)
    conv = 2 * T * (d_in + 2 * N) * 4
    ssd = 2 * T * Q * N + 2 * T * Q * P * H + 4 * T * N * P * H
    out = 2 * T * d_in * d
    return proj + conv + ssd + out


def _rwkv_flops(cfg: ModelConfig, T: float) -> float:
    d, f, Dh = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
    tmix = 5 * 2 * T * d * d + 2 * 2 * T * d * 64          # projections + lora
    wkv = 5 * T * d * Dh                                   # recurrence per token
    cmix = 2 * T * (2 * d * f + d * d)
    return tmix + wkv + cmix


def fwd_flops(cfg: ModelConfig, batch: int, seq: int, *,
              kv_len: Optional[float] = None) -> float:
    """Global forward FLOPs for ``batch`` sequences of ``seq`` new tokens.

    ``kv_len`` overrides the attention context length (decode: cache size).
    """
    T = float(batch) * seq
    kv = float(kv_len if kv_len is not None else seq)
    fam = cfg.family
    total = 2 * T * cfg.d_model * cfg.vocab_size            # unembed

    if fam in ("dense", "vlm"):
        for i in range(cfg.num_layers):
            w = 0 if cfg.is_global_layer(i) else cfg.sliding_window
            total += _attn_flops(cfg, T, kv, causal=True, window=w)
            total += _mlp_flops(cfg, T)
    elif fam == "moe":
        nd = cfg.first_dense_layers
        for _ in range(nd):
            total += _attn_flops(cfg, T, kv, causal=True, window=0)
            total += _mlp_flops(cfg, T, d_ff=cfg.dense_ff, gated=True)
        for _ in range(cfg.num_layers - nd):
            total += _attn_flops(cfg, T, kv, causal=True, window=0)
            total += _moe_flops(cfg, T)
    elif fam == "hybrid":
        n_shared = cfg.num_layers // cfg.shared_attn_every
        total += cfg.num_layers * _mamba_flops(cfg, T)
        total += n_shared * (_attn_flops(cfg, T, kv, causal=True, window=0)
                             + _mlp_flops(cfg, T))
    elif fam == "ssm":
        total += cfg.num_layers * _rwkv_flops(cfg, T)
    elif fam == "encdec":
        ne = seq // 2
        nd = seq - ne
        Tenc, Tdec = float(batch) * ne, float(batch) * nd
        for _ in range(cfg.enc_layers):
            total += _attn_flops(cfg, Tenc, ne, causal=False, window=0)
            total += _mlp_flops(cfg, Tenc)
        for _ in range(cfg.dec_layers):
            total += _attn_flops(cfg, Tdec, kv if kv_len else nd,
                                 causal=True, window=0)
            total += _attn_flops(cfg, Tdec, ne, causal=False, window=0)  # cross
            total += _mlp_flops(cfg, Tdec)
        total -= 2 * T * cfg.d_model * cfg.vocab_size
        total += 2 * Tdec * cfg.d_model * cfg.vocab_size
    else:
        raise ValueError(fam)
    return total


def step_flops(cfg: ModelConfig, shape: ShapeConfig,
               remat: str = "full") -> float:
    """Global FLOPs for the cell's step function."""
    if shape.kind == "train":
        mult = 4.0 if remat == "full" else 3.0
        return mult * fwd_flops(cfg, shape.global_batch, shape.seq_len)
    if shape.kind == "prefill":
        return fwd_flops(cfg, shape.global_batch, shape.seq_len)
    # decode: one token per sequence against a seq_len cache
    return fwd_flops(cfg, shape.global_batch, 1, kv_len=shape.seq_len)


# ---------------------------------------------------------------------------
# Sharded parameter bytes (exact, from the same specs the dry-run uses)
# ---------------------------------------------------------------------------

def sharded_param_bytes(model, cfg: ModelConfig, mesh,
                        bytes_per_param: int = FP32, layout: str = "tp",
                        fsdp: bool = True) -> int:
    """Per-device parameter bytes under ``param_shardings``' layout.
    ``mesh`` is a ``sharding.MeshView`` or a live ``sharding.Mesh``;
    ``model`` is unused (the shapes and axes come from ``cfg``) and kept
    for the reference's signature."""
    from repro_torch.models.axes import param_axes, param_shapes
    from repro_torch.sharding import param_shardings, spec_axes
    from repro_torch.tree import tree_leaves

    shardings = dict(tree_leaves(param_shardings(
        param_axes(cfg), cfg, mesh, fsdp=fsdp, layout=layout)))
    total = 0
    for path, shape in tree_leaves(param_shapes(cfg)):
        shard = math.prod(mesh.shape[a]
                          for a in spec_axes(shardings[path].spec))
        total += math.prod(shape) // shard * bytes_per_param
    return total


# ---------------------------------------------------------------------------
# HBM bytes per device per step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class MemoryBreakdown:
    params: float
    grads_opt: float
    activations: float
    attn_scores: float            # SCORES_IMPLS only (flash kernel: 0)
    kv_cache: float

    @property
    def total(self) -> float:
        return (self.params + self.grads_opt + self.activations
                + self.attn_scores + self.kv_cache)


def _layer_count(cfg: ModelConfig) -> int:
    if cfg.family == "encdec":
        return cfg.enc_layers + cfg.dec_layers
    return cfg.num_layers


def step_hbm_bytes(model, cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                   tcfg: Optional[TrainConfig] = None,
                   attn_impl: Optional[str] = None,
                   serve_fsdp: bool = True) -> MemoryBreakdown:
    """Per-device HBM bytes of one step of the cell. ``attn_impl``
    (default ``cfg.attn_impl``) in ``SCORES_IMPLS`` adds the scores'
    traffic (module docstring)."""
    from repro_torch.sharding import data_size

    impl = attn_impl or cfg.attn_impl
    layout = tcfg.layout if tcfg else "tp"
    dsz = data_size(mesh, layout)
    chips = mesh.size
    p_dev = sharded_param_bytes(model, cfg, mesh, 1, layout=layout,
                                fsdp=serve_fsdp if shape.kind == "decode"
                                else True)               # param COUNT sharded
    T_dev = shape.global_batch * (shape.seq_len
                                  if shape.kind in ("train", "prefill")
                                  else 1) / dsz
    d = cfg.d_model
    L = _layer_count(cfg)

    if shape.kind == "train":
        # bf16 cast read in fwd + remat + bwd; grad write+read at grad
        # dtype; optimizer m/v read+write + fp32 param read+write.
        opt_name = (tcfg.optimizer.name if tcfg else "adamw")
        gbytes = BF16 if (tcfg and tcfg.grad_dtype == "bfloat16") else FP32
        opt_bytes = (2 if opt_name == "momentum" else 4) * 2 * FP32
        n_fwd = 3 if (tcfg and tcfg.remat != "none") else 2
        params = p_dev * (n_fwd * BF16 + 2 * gbytes + opt_bytes + 2 * FP32)
        grads_opt = 0.0                                   # folded above
        # layer-boundary activations: write fwd (+ read remat) + read bwd
        act_visits = 3 if (tcfg and tcfg.remat != "none") else 2
        activations = L * T_dev * d * BF16 * act_visits * 4   # ~4 tensors
        scores = 0.0
        if impl in SCORES_IMPLS:
            h_div = 1 if layout == "fsdp" else max(1, mesh.shape["model"])
            kvl = shape.seq_len
            for i in range(L if cfg.family in ("dense", "vlm", "moe") else 0):
                w = (0 if cfg.is_global_layer(i) else cfg.sliding_window) \
                    if cfg.family == "dense" else 0
                seff = min(w, kvl) if w else kvl / 2
                scores += (shape.global_batch / dsz) * cfg.num_heads \
                    / h_div * shape.seq_len * seff * (FP32 + BF16) * 2
        return MemoryBreakdown(params, grads_opt, activations, scores, 0.0)

    if shape.kind == "prefill":
        params = p_dev * BF16
        activations = L * T_dev * d * BF16 * 4
        scores = 0.0
        if impl in SCORES_IMPLS and cfg.family in ("dense", "vlm", "moe"):
            h_div = 1 if layout == "fsdp" else max(1, mesh.shape["model"])
            scores = (shape.global_batch / dsz) * cfg.num_heads \
                / h_div * shape.seq_len \
                * (shape.seq_len / 2) * (FP32 + BF16)
        kv = T_dev * _layer_count(cfg) * 2 * cfg.num_kv_heads \
            * cfg.head_dim * BF16
        return MemoryBreakdown(params, 0.0, activations, scores, kv)

    # decode: weights stream once per token; KV cache read once per token
    params = p_dev * BF16
    activations = L * T_dev * d * BF16 * 4
    kv_bytes = _decode_state_bytes(cfg, shape) / chips
    return MemoryBreakdown(params, 0.0, activations, 0.0, kv_bytes)


def _decode_state_bytes(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Global bytes of decode state READ per step (KV cache / SSM states)."""
    B, S = shape.global_batch, shape.seq_len
    fam = cfg.family
    kv_layer = 2 * cfg.num_kv_heads * cfg.head_dim * BF16
    if fam in ("dense", "vlm", "moe"):
        tot = 0.0
        for i in range(cfg.num_layers):
            w = 0 if cfg.is_global_layer(i) else cfg.sliding_window
            eff = min(w, S) if w else S
            tot += B * eff * kv_layer
        return tot
    if fam == "hybrid":
        n_shared = cfg.num_layers // cfg.shared_attn_every
        ssm = cfg.num_layers * B * cfg.ssm_heads * cfg.ssm_state \
            * cfg.ssm_head_dim * FP32
        return ssm + n_shared * B * S * kv_layer
    if fam == "ssm":
        Dh = cfg.rwkv_head_dim
        return cfg.num_layers * B * (cfg.d_model // Dh) * Dh * Dh * FP32
    if fam == "encdec":
        return cfg.dec_layers * B * S * kv_layer * 2      # self + cross
    raise ValueError(fam)
