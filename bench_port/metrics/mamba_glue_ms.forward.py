"""mamba_glue_ms.forward: device milliseconds a forward launches
inside the program's ``ssm.mixer`` span and outside both ``ssm.scan``
and ``ssm.proj``: the Mamba-2 mixer's glue around its scan and its
projections, from the traced window."""
from bench_port import spans


def read(ctx):
    return spans.READERS["mamba_glue_ms.forward"](ctx)
