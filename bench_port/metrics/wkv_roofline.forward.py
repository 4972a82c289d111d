"""wkv_roofline.forward: the WKV kernel's share of its roofline over the
traced window, in %: the least time of its calls (``counts.wkv_bound`` at
the RWKV-6 layers' shape with no initial state: r, k, v and o in the
configuration's dtype, w, u and the final state in float32, each read or
written once against the memory rate, or 5 flops per state entry, token
and head against the float32 peak) summed, over the device time of its
launches.

The launches are found by the kernel's symbol names (``SYMBOLS``), and
their count has to be the window's forwards x the RWKV-6 layers of one
forward; otherwise nothing is read."""
import sys

SYMBOLS = ("wkv_token_kernel",)


def read(ctx):
    m, t = ctx.model, ctx.traffic
    times = [s for name, s in ctx.summary.kernels
             if any(sym in name for sym in SYMBOLS)]
    if not times:
        return None
    if len(times) != ctx.units * m["num_layers"]:
        print(f"wkv_roofline.forward: {len(times)} launches, expected "
              f"{ctx.units} x {m['num_layers']}", file=sys.stderr)
        return None
    Dh = m.get("rwkv_head_dim", 64)
    bound = ctx.counts.wkv_bound(
        t["batch"], t["seq_len"], m["d_model"] // Dh, Dh, False,
        m.get("dtype", "bfloat16"))[0]
    return 100.0 * len(times) * bound / sum(times)
