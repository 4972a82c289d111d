"""collective_ms.train: device milliseconds a training step spends in
NCCL's kernels (the gradients' reduce-scatter, the compute copy's
all-gather and the small all-reduces), from rank 0's traced window over
its steps."""


def read(ctx):
    nccl = [s for name, s in ctx.summary.kernels if "nccl" in name.lower()]
    if not ctx.units or not nccl:
        return None
    return 1e3 * sum(nccl) / ctx.units
