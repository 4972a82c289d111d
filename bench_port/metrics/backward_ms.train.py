"""backward_ms.train: device milliseconds a training step launches
inside the program's ``train.backward`` span (the remat recompute, the
backward, a sharded step's sums), from the traced window; on several
cards rank 0's."""
from bench_port import spans


def read(ctx):
    return spans.READERS["backward_ms.train"](ctx)
