"""launches.train: device kernels a training step launched, from the
traced window's kernels over its steps."""


def read(ctx):
    if not ctx.units or not ctx.summary.kernels:
        return None
    return len(ctx.summary.kernels) / ctx.units
