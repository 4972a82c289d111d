"""device_idle.train: the share of the traced window, in %, in which no
kernel, copy or fill ran on the device."""


def read(ctx):
    s = ctx.summary
    if not s.kernels or s.window_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
