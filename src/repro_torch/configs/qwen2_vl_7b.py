"""qwen2-vl-7b — VLM decoder with M-RoPE and a vision-embedding stub.

[arXiv:2409.12191; hf]  28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064. The vision tower is a stub: batches carry precomputed
patch embeddings for a prefix of the sequence (``modality_prefix_frac``),
and M-RoPE gives the patches (t, h, w) rotary coordinates.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        family="vlm",
        num_layers=28,
        d_model=3584,
        num_heads=28,
        num_kv_heads=4,
        head_dim=128,
        d_ff=18944,
        vocab_size=152064,
        qkv_bias=True,
        use_mrope=True,
        rope_theta=1e6,
        modality_prefix_frac=0.25,  # a quarter of the sequence is patches
    )


def reduced() -> ModelConfig:
    return full().replace(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
        head_dim=16, d_ff=128, vocab_size=512,
    )


register("qwen2-vl-7b", full, reduced)
