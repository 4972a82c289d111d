"""gemma3-27b — dense GQA with a 5:1 local:global attention pattern.

[hf:google/gemma-3 family]  62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, tied embeddings. Sliding window 1024 on local layers; every
6th layer is global.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="gemma3-27b",
        family="dense",
        num_layers=62,
        d_model=5376,
        num_heads=32,
        num_kv_heads=16,
        head_dim=128,
        d_ff=21504,
        vocab_size=262144,
        tie_embeddings=True,
        sliding_window=1024,
        global_every=6,
        rope_theta=1e6,
    )


def reduced() -> ModelConfig:
    return full().replace(
        num_layers=4, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
        sliding_window=16, global_every=2,
    )


register("gemma3-27b", full, reduced)
