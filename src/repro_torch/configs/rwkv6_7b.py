"""rwkv6-7b (Finch) — attention-free RNN with data-dependent decay.

[arXiv:2404.05892; hf RWKV/v6-Finch-7B-HF]  32L d_model=4096 (attn-free)
d_ff=14336 vocab=65536. Head dim 64 -> 64 heads; time-mix with
data-dependent token shift (a LoRA of rank 64 with five outputs) and
decay w_t (a LoRA of rank 128), ``ln_x`` a GroupNorm per head (eps 1e-5 x
head_size_divisor^2 = 6.4e-4); channel-mix with squared-ReLU.

``full()`` is Finch. ``reduced()`` keeps the reference's block (static
sigmoid lerps, a decay LoRA of rank 64, an RMS ``ln_x``): the port's
tests hold it against ``repro``, which has no other.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b",
        family="ssm",
        num_layers=32,
        d_model=4096,
        num_heads=64,              # d_model / rwkv_head_dim
        num_kv_heads=64,
        head_dim=64,
        d_ff=14336,
        vocab_size=65536,
        rwkv_head_dim=64,
        rwkv_mix_rank=64,
        rwkv_decay_rank=128,
    )


def reduced() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
        head_dim=16, d_ff=128, vocab_size=512, rwkv_head_dim=16,
        rwkv_mix_rank=0, rwkv_decay_rank=64,
    )


register("rwkv6-7b", full, reduced)
