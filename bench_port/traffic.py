"""The one generator of the benchmark's traffic, driven by the parameters
in ``traffic/<name>.json``.

Every batch is drawn on the device from a generator seeded by (seed,
index): the same seed gives the same batches, any batch can be drawn
again for the reference, and drawing one neither syncs nor touches the
host. Tokens are uniform over the vocabulary: the dense and recurrent
layers do the same work on any ids.
"""
from __future__ import annotations

from typing import Dict

import torch

from bench_port.weights import derive


def tokens(seed: int, index: int, batch: int, length: int, vocab: int,
           device) -> torch.Tensor:
    """(batch, length) int64 ids, batch ``index`` of ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(derive(seed, "tokens", index))
    return torch.randint(0, vocab, (batch, length), generator=gen,
                         device=device)


class TokenFeed:
    """The training job's data: batch ``step`` is ``tokens(seed, step)``
    with one more position, its inputs and its next-token labels. It has
    the ``global_batch_at`` the program's ``Trainer`` reads."""

    def __init__(self, seed: int, batch: int, seq_len: int, vocab: int,
                 device):
        self.seed, self.batch, self.seq_len = seed, batch, seq_len
        self.vocab, self.device = vocab, device

    def global_batch_at(self, step: int) -> Dict[str, torch.Tensor]:
        with torch.profiler.record_function("bench.feed"):
            t = tokens(self.seed, step, self.batch, self.seq_len + 1,
                       self.vocab, self.device)
            return {"tokens": t[:, :-1], "labels": t[:, 1:]}
