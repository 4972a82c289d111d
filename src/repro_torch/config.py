"""Configuration for the PyTorch port: the fields of the dense, MoE,
hybrid (zamba2), recurrent (rwkv6), multimodal (qwen2-vl),
encoder-decoder (seamless) and resnet families, and the training
configuration.

A copy of the part of ``repro.config`` that the ported serving and
training paths read, with the same field names and defaults, so that a
configuration means the same model in both packages. The port keeps its
own copy because it never imports the JAX package.

Three fields select implementations, each ``"cuda"`` (the hand-written
Hopper kernels; the default, since the port's entry points run on the
card) or ``"torch"`` (the plain PyTorch paths, which run anywhere):
``attn_impl`` (decode and flash attention; ``"torch"`` is the decode
kernel's plain version and the q-chunked full attention), ``ssm_impl``
(the Mamba-2 SSD scan, and around it the mixer's glue: the causal conv
with SiLU, dt and xdt in one kernel, the skip-gated RMS norm in another;
``"torch"`` is the reference's chunked form and the glue's plain
versions) and ``rwkv_impl`` (the RWKV-6 WKV recurrence; ``"torch"`` is
the sequential scan). None of the kernels has a backward, as none of the reference's
Pallas kernels has one, so a model that is differentiated is built with
all three set to ``"torch"``.

A fourth, ``moe_impl``, selects the mixture-of-experts route under a
device mesh (``repro_torch.sharding.use_mesh``): ``"gspmd"`` (the
reference's name; here the row-local dispatch every rank runs on its own
rows), ``"ep"`` (experts split over the ``model`` axis, one all-reduce of
the combined output) or ``"a2a"`` (tokens shipped to their experts'
owners and back). Outside a mesh every value runs the row-local path.
``MeshConfig`` is the reference's mesh shape.

``ShapeConfig`` and ``SHAPES`` are the reference's dry-run cells (train,
prefill and decode input shapes), ``shape_applicable`` says which
(arch, shape) cells run, and ``param_count`` / ``active_param_count``
are the reference's closed-form parameter counts (the ssm family's
counts only r/k/v/g/o and the channel mix's two ``d_ff`` matrices).

The RWKV-6 fields ``rwkv_mix_rank`` and ``rwkv_decay_rank`` are the
port's own (``PORT_ONLY_FIELDS``): their defaults are the reference's
block, and ``rwkv6-7b``'s ``full()`` sets them to Finch's
(``repro_torch.models.rwkv``). ``reference_block(cfg)`` resets them,
giving the model the reference builds.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple


MOE_IMPLS = ("gspmd", "ep", "a2a")


@dataclass(frozen=True)
class ModelConfig:
    """One architecture. Fields unused by a family stay at their defaults."""

    name: str
    family: str

    # --- transformer trunk -------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    norm_eps: float = 1e-5
    qkv_bias: bool = False         # qwen2.5 / starcoder2 attention QKV bias
    gated_mlp: bool = True         # SwiGLU when True, tanh-GeLU 4x when False
    tie_embeddings: bool = False
    rope_theta: float = 1e4
    use_mrope: bool = False        # qwen2-vl multimodal rotary (t,h,w)

    # --- local/global attention pattern (gemma3) ---------------------------
    sliding_window: int = 0        # 0 = every layer global
    global_every: int = 0          # e.g. 6 -> layers 5,11,... are global

    # --- MoE ---------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0    # moonlight/deepseek-style always-on experts
    dense_ff: int = 0              # width of dense-residual MLP (arctic) or
                                   # dense first layer (moonshot)
    first_dense_layers: int = 0    # moonshot: first k layers use dense FFN
    router_aux_coef: float = 0.001

    # --- SSM / Mamba2 (zamba2) ---------------------------------------------
    ssm_state: int = 0             # N, state dimension per head
    ssm_heads: int = 0             # Mamba2 value heads
    ssm_head_dim: int = 0          # P, head channel dim
    ssm_expand: int = 2            # d_inner = expand * d_model
    ssm_chunk: int = 128           # SSD chunk length of the plain path
    shared_attn_every: int = 0     # zamba2: shared attn block cadence

    # --- RWKV6 ---------------------------------------------------------------
    rwkv_head_dim: int = 64
    # Finch's time mix, the port's own (the defaults are the reference's
    # block): the rank of the data-dependent token shift's LoRA (0: static
    # sigmoid lerps and one RMS ``ln_x``; above 0 also Finch's GroupNorm
    # per head), and the rank of the decay's LoRA
    rwkv_mix_rank: int = 0
    rwkv_decay_rank: int = 64

    # --- encoder-decoder ----------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0

    # --- modality stub ------------------------------------------------------
    # Fraction of the sequence fed as precomputed frontend embeddings
    # (vision patches / audio frames). The rest are ordinary tokens.
    modality_prefix_frac: float = 0.0

    # --- resnet -------------------------------------------------------------
    resnet_n: int = 0              # ResNet-(6n+2); n=5 -> ResNet-32
    image_size: int = 32
    num_classes: int = 10

    # --- numerics / implementation ------------------------------------------
    dtype: str = "bfloat16"
    attn_impl: str = "cuda"
    ssm_impl: str = "cuda"
    rwkv_impl: str = "cuda"
    moe_impl: str = "gspmd"        # "gspmd" (row-local) | "ep" | "a2a"
    # q-chunk size of the plain full-attention path (memory control)
    attn_chunk: int = 1024

    def __post_init__(self):
        if self.moe_impl not in MOE_IMPLS:
            raise ValueError(f"moe_impl {self.moe_impl!r} is not one of "
                             f"{MOE_IMPLS}")

    @property
    def kv_groups(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def is_global_layer(self, layer_idx: int) -> bool:
        """gemma3-style local:global pattern."""
        if self.sliding_window == 0 or self.global_every == 0:
            return True
        return (layer_idx + 1) % self.global_every == 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # Parameter count (analytic; exact for the reference's construction).
    def param_count(self) -> int:
        return _param_count(self)

    def active_param_count(self) -> int:
        return _param_count(self, active_only=True)


# The port's own fields, which the reference's configuration lacks: the
# RWKV-6 Finch time mix (``rwkv6-7b``'s ``full()``)
PORT_ONLY_FIELDS = ("rwkv_mix_rank", "rwkv_decay_rank")


def reference_block(cfg: ModelConfig) -> ModelConfig:
    """``cfg`` with the port's own fields at their defaults: the model the
    reference builds from the same name (for rwkv6-7b the reference's
    block, with static lerps, a rank-64 decay LoRA and an RMS ``ln_x``,
    at ``cfg``'s widths)."""
    fields = ModelConfig.__dataclass_fields__
    return cfg.replace(**{f: fields[f].default for f in PORT_ONLY_FIELDS})


def _moe_ffn_params(cfg: ModelConfig, active_only: bool) -> int:
    """Per-layer FFN params for an MoE layer."""
    e = cfg.top_k if active_only else cfg.num_experts
    routed = e * 3 * cfg.d_model * cfg.d_ff
    shared = cfg.num_shared_experts * 3 * cfg.d_model * cfg.d_ff
    router = cfg.d_model * cfg.num_experts
    # arctic-style parallel dense branch; NOT moonshot's dense first layer
    # (that one is counted by the first_dense_layers arm of _param_count)
    dense = (3 * cfg.d_model * cfg.dense_ff
             if cfg.dense_ff and not cfg.first_dense_layers else 0)
    return routed + shared + router + dense


def _attn_params(cfg: ModelConfig) -> int:
    q = cfg.d_model * cfg.num_heads * cfg.head_dim
    kv = 2 * cfg.d_model * cfg.num_kv_heads * cfg.head_dim
    o = cfg.num_heads * cfg.head_dim * cfg.d_model
    return q + kv + o


def _dense_ffn_params(cfg: ModelConfig) -> int:
    mult = 3 if cfg.gated_mlp else 2
    return mult * cfg.d_model * cfg.d_ff


def _param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    if cfg.family == "resnet":
        # ResNet-(6n+2) on CIFAR: ~1.9M for n=5; compute exactly via the
        # builder in models/resnet.py when instantiated; here use the known
        # closed form for 3x3 convs with widths 16/32/64.
        n = cfg.resnet_n
        w = [16, 32, 64]
        total = 3 * 3 * 3 * 16 + 16  # stem
        for si, width in enumerate(w):
            prev = 16 if si == 0 else w[si - 1]
            for b in range(n):
                cin = prev if b == 0 else width
                total += 3 * 3 * cin * width + width      # conv1 + bn-ish
                total += 3 * 3 * width * width + width    # conv2
                if b == 0 and cin != width:
                    total += cin * width                  # projection
        total += 64 * cfg.num_classes + cfg.num_classes
        return total

    emb = cfg.vocab_size * cfg.d_model
    out = 0 if cfg.tie_embeddings else cfg.vocab_size * cfg.d_model

    if cfg.family == "ssm":  # rwkv6
        # time-mix: r,k,v,g,o projections + decay/ddlerp small params
        per_layer = 5 * cfg.d_model * cfg.d_model + 2 * cfg.d_model * cfg.d_ff
        return emb + out + cfg.num_layers * per_layer

    if cfg.family == "hybrid":  # zamba2: mamba2 backbone + 1 shared attn blk
        d_in = cfg.ssm_d_inner
        conv = 4 * (d_in + 2 * cfg.ssm_heads * cfg.ssm_state)
        per_mamba = (
            cfg.d_model * (2 * d_in + 2 * cfg.ssm_heads * cfg.ssm_state + cfg.ssm_heads)
            + conv + d_in * cfg.d_model
        )
        shared = _attn_params(cfg) + _dense_ffn_params(cfg)
        return emb + out + cfg.num_layers * per_mamba + shared

    n_layers = cfg.num_layers
    if cfg.family == "encdec":
        n_layers = cfg.enc_layers + cfg.dec_layers

    total = emb + out
    for i in range(n_layers):
        total += _attn_params(cfg)
        if cfg.family == "encdec" and i >= cfg.enc_layers:
            total += _attn_params(cfg)  # cross attention
        if cfg.family == "moe" and i >= cfg.first_dense_layers:
            total += _moe_ffn_params(cfg, active_only)
        elif cfg.family == "moe":
            total += 3 * cfg.d_model * cfg.dense_ff  # dense first layer(s)
        else:
            total += _dense_ffn_params(cfg)
    return total


# ---------------------------------------------------------------------------
# Input shapes (assigned per-arch shape set)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeConfig("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeConfig("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeConfig("long_500k", "decode", 524288, 1)

LM_SHAPES: Tuple[ShapeConfig, ...] = (TRAIN_4K, PREFILL_32K, DECODE_32K,
                                      LONG_500K)
SHAPES: Dict[str, ShapeConfig] = {s.name: s for s in LM_SHAPES}

# Archs allowed to run long_500k (sub-quadratic sequence mixing).
SUBQUADRATIC_ARCHS = ("zamba2-1.2b", "rwkv6-7b")


def shape_applicable(arch: str, shape: ShapeConfig, family: str
                     ) -> Tuple[bool, str]:
    """(runs?, reason-if-skipped) for an (arch, shape) cell; the reason is
    the reference's text, word for word."""
    if shape.name == "long_500k" and arch not in SUBQUADRATIC_ARCHS:
        return False, "long_500k skipped: full-attention arch is quadratic at 512k (per spec; see DESIGN.md §4)"
    return True, ""


# ---------------------------------------------------------------------------
# Training configuration (copies of ``repro.config``'s, same defaults)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "momentum"        # paper's optimizer (Table II) | "adamw"
    lr: float = 0.1
    momentum: float = 0.9
    weight_decay: float = 1e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # paper C6: linear-scaling LR by the number of ACTIVE workers
    adaptive_lr: bool = True
    base_workers: int = 1


@dataclass(frozen=True)
class ScheduleConfig:
    kind: str = "cosine"           # "constant" | "cosine" | "step"
    warmup_steps: int = 200
    total_steps: int = 64_000      # paper's workload: 64K steps
    min_ratio: float = 0.1
    # paper's ResNet-32 schedule is step-decay at 32k/48k
    step_boundaries: Tuple[int, ...] = (32_000, 48_000)
    step_factors: Tuple[float, ...] = (0.1, 0.01)


@dataclass(frozen=True)
class TrainConfig:
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    schedule: ScheduleConfig = field(default_factory=ScheduleConfig)
    microbatches: int = 1          # gradient accumulation factor
    remat: str = "full"            # "none" | "full" | "selective"
    zero1: bool = True             # shard optimizer state over data axis
    layout: str = "tp"             # "tp" (megatron, baseline) | "fsdp"
    grad_dtype: str = "float32"    # "bfloat16" halves grad-reduce wire bytes
    compression: str = "none"      # "none" | "topk" | "ternary" (pod axis)
    compression_ratio: float = 0.01
    checkpoint_every: int = 1000
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """Production mesh shape. multi_pod adds the leading 'pod' axis."""
    data: int = 16
    model: int = 16
    pods: int = 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("pod", "data", "model") if self.pods > 1 else ("data", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        return ((self.pods, self.data, self.model) if self.pods > 1
                else (self.data, self.model))

    @property
    def num_devices(self) -> int:
        return self.data * self.model * max(1, self.pods)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}
_REDUCED: Dict[str, Callable[[], ModelConfig]] = {}


def register(arch_id: str, full: Callable[[], ModelConfig],
             reduced: Callable[[], ModelConfig]) -> None:
    _REGISTRY[arch_id] = full
    _REDUCED[arch_id] = reduced


def get_config(arch_id: str, reduced: bool = False) -> ModelConfig:
    _ensure_loaded()
    table = _REDUCED if reduced else _REGISTRY
    if arch_id not in table:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(table)}")
    return table[arch_id]()


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


ASSIGNED_ARCHS = (
    "zamba2-1.2b", "qwen2.5-14b", "granite-20b", "gemma3-27b",
    "starcoder2-3b", "moonshot-v1-16b-a3b", "arctic-480b",
    "seamless-m4t-large-v2", "rwkv6-7b", "qwen2-vl-7b",
)


def _ensure_loaded() -> None:
    # Import the configs package once so every module registers itself.
    if not _REGISTRY:
        from repro_torch import configs as _  # noqa: F401
