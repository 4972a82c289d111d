"""zamba2-1.2b — hybrid Mamba2 backbone + shared attention blocks.

[arXiv:2411.15242; hf]  38L d_model=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64. Zamba2 interleaves Mamba2 blocks with a *shared* (weight-tied)
attention+MLP block invoked every ``shared_attn_every`` layers.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="zamba2-1.2b",
        family="hybrid",
        num_layers=38,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,
        head_dim=64,               # 2048 / 32
        d_ff=8192,
        vocab_size=32000,
        tie_embeddings=True,
        ssm_state=64,
        ssm_expand=2,
        ssm_heads=64,              # d_inner=4096, P=64
        ssm_head_dim=64,
        ssm_chunk=128,
        shared_attn_every=6,
    )


def reduced() -> ModelConfig:
    return full().replace(
        num_layers=4,
        d_model=64,
        num_heads=4,
        num_kv_heads=4,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        ssm_state=16,
        ssm_heads=8,
        ssm_head_dim=16,
        ssm_chunk=16,
        shared_attn_every=2,
    )


register("zamba2-1.2b", full, reduced)
