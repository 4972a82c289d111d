"""The per-layer readings taken from the program's spans in a traced
window.

The program opens ``torch.profiler`` annotations at its layer
boundaries (``repro_torch/obs/profiling.py``). ``devtrace.summarise``
reduces every one of them in the window into ``Summary.spans``
(``devtrace.Spans``), whatever its name, so a reader of a span the
program opens later needs no edit here. ``NAMES`` holds the names the
readers below read.

The readers (``READERS``: ``read(ctx) -> value or None``, as a file of
``metrics/`` reads) take the reduction from ``ctx.summary.spans`` and
give None where it is missing or holds none of their span: a program
without the span, or a summary made without the spans.
"""
from __future__ import annotations

from typing import Optional

from bench_port import devtrace, harness

TRAIN_FORWARD = "train.forward"
TRAIN_BACKWARD = "train.backward"
TRAIN_OPTIMIZER = "train.optimizer"
ATTN_CORE = "attn.core"
SSM_MIXER = "ssm.mixer"
SSM_PROJ = "ssm.proj"
SSM_SCAN = "ssm.scan"
NAMES = (TRAIN_FORWARD, TRAIN_BACKWARD, TRAIN_OPTIMIZER, ATTN_CORE,
         SSM_MIXER, SSM_PROJ, SSM_SCAN)


def attach() -> None:
    """Nothing left to do: ``devtrace.summarise`` fills
    ``Summary.spans`` itself. Kept for the callers that still make it
    (``tools/span_figures.py``)."""


# -- readers -------------------------------------------------------------

def spans_of(ctx) -> Optional[devtrace.Spans]:
    return getattr(ctx.summary, "spans", None)


def phase_ms(ctx, name: str) -> Optional[float]:
    """Device milliseconds a unit launched inside ``name``; None where
    nothing was (no such span, or a run with no device)."""
    sp = spans_of(ctx)
    if sp is None or not ctx.units or not sp.device(name):
        return None
    return 1e3 * sp.device(name) / ctx.units


def forward_ms_train(ctx) -> Optional[float]:
    """forward_ms.train: device ms a step in ``train.forward``."""
    return phase_ms(ctx, TRAIN_FORWARD)


def backward_ms_train(ctx) -> Optional[float]:
    """backward_ms.train: device ms a step in ``train.backward`` (the
    remat recompute, the backward, a sharded step's sums)."""
    return phase_ms(ctx, TRAIN_BACKWARD)


def optimizer_ms_train(ctx) -> Optional[float]:
    """optimizer_ms.train: device ms a step in ``train.optimizer`` (the
    gradients' cast, the norm, the clip, the schedule, the update)."""
    return phase_ms(ctx, TRAIN_OPTIMIZER)


def _windows(model) -> list:
    """The window of each attention call of one forward, as
    ``flash_roofline.forward`` reads them."""
    return harness.load_module(harness.ROOT / "metrics"
                               / "flash_roofline.forward.py")._layers(model)


def attn_core_roofline_forward(ctx) -> Optional[float]:
    """attn_core_roofline.forward, %: ``counts.flash_bound`` summed over
    the ``attn.core`` instances, over their device time; None unless
    there are forwards x attention layers of them."""
    sp, m, t = spans_of(ctx), ctx.model, ctx.traffic
    windows = _windows(m)
    if sp is None or not ctx.units or not sp.device(ATTN_CORE) or \
            sp.instances.get(ATTN_CORE) != ctx.units * len(windows):
        return None
    B, S = t["batch"], t["seq_len"]
    bound = sum(ctx.counts.flash_bound(
        B, S, S, m["num_heads"], m["num_kv_heads"], m["head_dim"], True, w,
        m.get("dtype", "bfloat16"))[0] for w in windows)
    return 100.0 * ctx.units * bound / sp.device(ATTN_CORE)


def ssd_core_roofline_forward(ctx) -> Optional[float]:
    """ssd_core_roofline.forward, %: ``counts.ssd_bound`` x the
    ``ssm.scan`` instances over their device time; None unless there are
    forwards x Mamba-2 layers of them."""
    sp, m, t = spans_of(ctx), ctx.model, ctx.traffic
    n = sp.instances.get(SSM_SCAN) if sp is not None else None
    if not n or n != ctx.units * m["num_layers"] or not sp.device(SSM_SCAN):
        return None
    bound = ctx.counts.ssd_bound(
        t["batch"], t["seq_len"], m["ssm_heads"], m["ssm_head_dim"],
        m["ssm_state"], m.get("dtype", "bfloat16"))[0]
    return 100.0 * n * bound / sp.device(SSM_SCAN)


def mamba_glue_ms_forward(ctx) -> Optional[float]:
    """mamba_glue_ms.forward: device ms a forward in ``ssm.mixer`` and
    outside both ``ssm.scan`` and ``ssm.proj``."""
    sp = spans_of(ctx)
    if sp is None or not ctx.units or not sp.device(SSM_MIXER):
        return None
    return 1e3 * sp.device(SSM_MIXER, outside=(SSM_SCAN, SSM_PROJ)) \
        / ctx.units


READERS = {
    "forward_ms.train": forward_ms_train,
    "backward_ms.train": backward_ms_train,
    "optimizer_ms.train": optimizer_ms_train,
    "attn_core_roofline.forward": attn_core_roofline_forward,
    "ssd_core_roofline.forward": ssd_core_roofline_forward,
    "mamba_glue_ms.forward": mamba_glue_ms_forward,
}
