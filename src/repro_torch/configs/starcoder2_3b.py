"""starcoder2-3b — dense GQA code model with RoPE.

[arXiv:2402.19173; hf]  30L d_model=3072 24H (GQA kv=2) d_ff=12288
vocab=49152, non-gated GeLU 4x MLP, attention QKV bias. The serving
entry point's default architecture.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="starcoder2-3b",
        family="dense",
        num_layers=30,
        d_model=3072,
        num_heads=24,
        num_kv_heads=2,
        head_dim=128,
        d_ff=12288,
        vocab_size=49152,
        gated_mlp=False,
        qkv_bias=True,
    )


def reduced() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=256, vocab_size=512,
    )


register("starcoder2-3b", full, reduced)
