"""rwkv_glue_ms.forward: device milliseconds a forward launches inside
the program's ``rwkv.tmix`` span and outside both ``rwkv.scan`` and
``rwkv.proj``: the RWKV-6 time mix's glue (token shift and lerps, the
decay, ``ln_x``, the gate) around its WKV scan and its projections, from
the traced window. Nothing where the program opens no such span."""

TMIX, SCAN, PROJ = "rwkv.tmix", "rwkv.scan", "rwkv.proj"


def read(ctx):
    sp = getattr(ctx.summary, "spans", None)
    if sp is None or not ctx.units or not sp.device(TMIX):
        return None
    return 1e3 * sp.device(TMIX, outside=(SCAN, PROJ)) / ctx.units
