"""The benchmark's plain reference: float32 PyTorch (TF32 off) forwards
of each model family, and the training steps, written from the models'
published descriptions and the program's stated departures from them.
It imports nothing of the program and takes nothing the program made:
the harness hands it the weights and batches it made itself.
"""
from __future__ import annotations

from importlib import import_module


def model(family: str):
    """The reference module of ``family`` (``reference/<family>.py``):
    it has ``forward(params, m, tokens, prec, remat) -> logits`` and
    ``STACKED``, the top-level subtrees whose leaves stack the layers on
    a leading axis."""
    return import_module(f"bench_port.reference.{family}")
