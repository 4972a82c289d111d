"""seamless-m4t-large-v2 — encoder-decoder multimodal (audio) backbone.

[arXiv:2308.11596; hf]  24L (enc) + 24L (dec) d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206. The speech frontend is a stub: batches carry
precomputed frame embeddings for the encoder; the decoder consumes
target tokens with cross-attention to the encoder's output.
"""
from repro_torch.config import ModelConfig, register


def full() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2",
        family="encdec",
        num_layers=48,             # bookkeeping total
        enc_layers=24,
        dec_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=8192,
        vocab_size=256206,
        gated_mlp=False,           # conformer-lineage GeLU FFN
        modality_prefix_frac=1.0,  # the encoder's input is all frames
    )


def reduced() -> ModelConfig:
    return full().replace(
        num_layers=4, enc_layers=2, dec_layers=2,
        d_model=64, num_heads=4, num_kv_heads=4, head_dim=16,
        d_ff=128, vocab_size=512,
    )


register("seamless-m4t-large-v2", full, reduced)
