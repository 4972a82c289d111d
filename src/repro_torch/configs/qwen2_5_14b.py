"""qwen2.5-14b — dense GQA decoder with QKV bias.

[hf:Qwen/Qwen2.5 family]  48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064. SwiGLU, RoPE (theta=1e6), attention QKV bias.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-14b",
        family="dense",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        head_dim=128,
        d_ff=13824,
        vocab_size=152064,
        qkv_bias=True,
        rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
    )


register("qwen2.5-14b", full, reduced)
