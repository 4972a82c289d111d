"""ssd_roofline.forward: the SSD scan kernel's share of its roofline over
the traced window, in %: the least time of its calls (``counts.ssd_bound``
at the Mamba-2 layers' shape: xdt, B, C and dA read once and y written
once against the memory rate, or the chunked algorithm's operations
against the peak) summed, over the device time of its launches.

The launches are found by the kernel's symbol names (``SYMBOLS``), and
their count has to be the window's forwards x the Mamba-2 layers of one
forward; otherwise nothing is read."""
import sys

SYMBOLS = ("ssd_scan_tc_kernel", "ssd_scan_kernel")


def read(ctx):
    m, t = ctx.model, ctx.traffic
    times = [s for name, s in ctx.summary.kernels
             if any(sym in name for sym in SYMBOLS)]
    if not times:
        return None
    if len(times) != ctx.units * m["num_layers"]:
        print(f"ssd_roofline.forward: {len(times)} launches, expected "
              f"{ctx.units} x {m['num_layers']}", file=sys.stderr)
        return None
    bound = ctx.counts.ssd_bound(
        t["batch"], t["seq_len"], m["ssm_heads"], m["ssm_head_dim"],
        m["ssm_state"], m.get("dtype", "bfloat16"))[0]
    return 100.0 * len(times) * bound / sum(times)
