"""granite-20b — dense MQA (kv=1) code model.

[arXiv:2405.04324; hf]  52L d_model=6144 48H (kv=1) d_ff=24576
vocab=49152, non-gated GeLU 4x MLP, RoPE.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        family="dense",
        num_layers=52,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,
        head_dim=128,
        d_ff=24576,
        vocab_size=49152,
        gated_mlp=False,
    )


def reduced() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1,
        head_dim=16, d_ff=256, vocab_size=512,
    )


register("granite-20b", full, reduced)
