"""flash_roofline.forward: the flash attention kernel's share of its
roofline over the traced window, in %: the least time of its calls
(``counts.flash_bound`` at each attention layer's shape and window: 4 D
flops per visible (query, key) pair and head against the bf16 peak, or
q, k, v read and the output written once against the memory rate)
summed, over the device time of its launches.

The launches are found by the kernel's symbol names (``SYMBOLS``), and
their count has to be the window's forwards x the attention layers of
one forward; otherwise nothing is read."""
import sys

SYMBOLS = ("flash_fwd_wgmma", "flash_fwd_bf16")


def _layers(m):
    """The window of each attention call of one forward."""
    if m["family"] == "hybrid":
        return [0] * (m["num_layers"] // m["shared_attn_every"])
    every, w = m.get("global_every", 0), m.get("sliding_window", 0)
    return [0 if w == 0 or every == 0 or (i + 1) % every == 0 else w
            for i in range(m["num_layers"])]


def read(ctx):
    m, t = ctx.model, ctx.traffic
    times = [s for name, s in ctx.summary.kernels
             if any(sym in name for sym in SYMBOLS)]
    windows = _layers(m)
    if not times:
        return None
    if len(times) != ctx.units * len(windows):
        print(f"flash_roofline.forward: {len(times)} launches, expected "
              f"{ctx.units} x {len(windows)}", file=sys.stderr)
        return None
    B, S = t["batch"], t["seq_len"]
    bound = sum(ctx.counts.flash_bound(
        B, S, S, m["num_heads"], m["num_kv_heads"], m["head_dim"], True, w,
        m.get("dtype", "bfloat16"))[0] for w in windows)
    return 100.0 * ctx.units * bound / sum(times)
