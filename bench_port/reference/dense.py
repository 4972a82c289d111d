"""Plain float32 reference of the dense decoder family (starcoder2-3b):
token embedding, ``num_layers`` pre-norm layers of GQA attention with
RoPE and the optional q/k/v biases over a causal sliding window, and a
tanh-GeLU (or SiLU-gated) MLP, then a final norm and the unembedding.

It reads the parameter tree by the program's names (``embed/tok``,
``layers/attn/wq`` stacked on a leading layer axis, ...), in float32.

Departures from the published starcoder2-3b (hf bigcode/starcoder2-3b,
arXiv:2402.19173), which the program makes and the reference follows:
RMS norms with a gain around 1 and no bias, where the published model
has LayerNorm with biases; no bias on the output projection or the MLP,
where the published model has ``use_bias`` on every linear layer.
"""
from __future__ import annotations

from typing import Mapping

import torch

from bench_port.reference import common as C

STACKED = ("layers",)   # subtrees whose leaves stack the layers on axis 0


def _layer(lp: Mapping, x: torch.Tensor, m: Mapping, window: int,
           prec: str) -> torch.Tensor:
    x = C.attention_block(lp, x, m, window, prec)
    return C.mlp_block(lp, x, m, prec)


def forward(params: Mapping, m: Mapping, tokens: torch.Tensor,
            prec: str = "float32", remat: bool = False) -> torch.Tensor:
    """Logits (B, S, V) in float32 of tokens (B, S). ``remat`` recomputes
    each layer in the backward (memory only; the same numbers)."""
    x = params["embed"]["tok"][tokens]
    for i, lp in enumerate(C.stacked(params["layers"], 1)):
        every = m.get("global_every", 0)
        glob = (m.get("sliding_window", 0) == 0 or every == 0
                or (i + 1) % every == 0)
        window = 0 if glob else m["sliding_window"]
        x = C.checkpointed(_layer, lp, x, m, window, prec, remat=remat)
    return C.logits(params, x, m, prec)
