"""arctic-480b — 128-expert top-2 MoE with a dense residual MLP per layer.

[hf:Snowflake/snowflake-arctic-base; hf]  35L d_model=7168 56H (GQA kv=8)
d_ff=4864 (per expert) vocab=32000, MoE 128e top-2 composed *in parallel*
with a dense residual MLP (Arctic's dense-MoE hybrid design).
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,                 # per-expert width
        vocab_size=32000,
        num_experts=128,
        top_k=2,
        dense_ff=7168,             # dense residual branch width
    )


def reduced() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=64, vocab_size=512,
        num_experts=8, top_k=2, dense_ff=64,
    )


register("arctic-480b", full, reduced)
