"""Model configuration for the PyTorch port: the dense decoder's fields.

A copy of the part of ``repro.config`` that the dense serving path reads,
with the same field names and defaults, so that a configuration means the
same model in both packages. The port keeps its own copy because it never
imports the JAX package.

``attn_impl`` selects decode attention: ``"cuda"`` (the hand-written
Hopper kernel, the default, since the port's entry points run on the card)
or ``"torch"`` (the kernel's plain PyTorch version, which runs anywhere).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Dict, List


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

    # --- local/global attention pattern (gemma3) ---------------------------
    sliding_window: int = 0        # 0 = every layer global
    global_every: int = 0          # e.g. 6 -> layers 5,11,... are global

    # --- numerics / implementation ------------------------------------------
    dtype: str = "bfloat16"
    attn_impl: str = "cuda"

    @property
    def kv_groups(self) -> int:
        return max(1, self.num_heads // max(1, self.num_kv_heads))

    def is_global_layer(self, layer_idx: int) -> bool:
        """gemma3-style local:global pattern."""
        if self.sliding_window == 0 or self.global_every == 0:
            return True
        return (layer_idx + 1) % self.global_every == 0

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


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


def _ensure_loaded() -> None:
    # Import the configs package once so every module registers itself.
    if not _REGISTRY:
        from repro_torch import configs as _  # noqa: F401
