"""moonshot-v1-16b-a3b (Moonlight-16B-A3B) — DeepSeek-style fine-grained MoE.

[hf:moonshotai/Moonlight-16B-A3B; hf]  48L d_model=2048 16H (kv=16)
d_ff=1408 (per expert) vocab=163840, MoE 64 experts top-6 + 2 shared
experts; first layer dense (d_ff 11264), per the Moonlight config.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        family="moe",
        num_layers=48,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        head_dim=128,
        d_ff=1408,                 # per-expert width
        vocab_size=163840,
        num_experts=64,
        top_k=6,
        num_shared_experts=2,
        dense_ff=11264,            # dense first layer width
        first_dense_layers=1,
        rope_theta=5e4,
    )


def reduced() -> ModelConfig:
    return full().replace(
        num_layers=3, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=64, vocab_size=512,
        num_experts=8, top_k=2, num_shared_experts=1,
        dense_ff=128, first_dense_layers=1,
    )


register("moonshot-v1-16b-a3b", full, reduced)
