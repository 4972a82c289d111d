"""optimizer_ms.train: device milliseconds a training step launches
inside the program's ``train.optimizer`` span (the gradients' cast, the
norm, the clip, the schedule, the update), from the traced window; on
several cards rank 0's."""
from bench_port import spans


def read(ctx):
    return spans.READERS["optimizer_ms.train"](ctx)
