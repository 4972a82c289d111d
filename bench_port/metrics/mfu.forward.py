"""mfu.forward: the window's model FLOPs over what the chips could do in
it, in %: the closed-form forward FLOPs of each forward's batch
(``counts.fwd_flops``) summed over the forwards, over (window x chips x
the bf16 peak)."""


def read(ctx):
    if not ctx.units:
        return None
    return 100.0 * ctx.units * ctx.unit_flops / (
        ctx.window_s * ctx.chips * ctx.counts.PEAK_FLOPS_BF16)
