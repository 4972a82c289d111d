"""forward_ms.train: device milliseconds a training step launches
inside the program's ``train.forward`` span (the leaves' cast, the loss;
zero1's gather), from the traced window; on several cards rank 0's."""
from bench_port import spans


def read(ctx):
    return spans.READERS["forward_ms.train"](ctx)
