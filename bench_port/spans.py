"""The program's spans in a traced window, and the per-layer readings
taken from them.

The program opens ``torch.profiler`` annotations at its layer
boundaries (``repro_torch/obs/profiling.py``, ``SPANS``; ``NAMES`` here
holds the same names as the benchmark reads them). They land in the
same kineto capture as the device's operations, so they share its
clock. ``reduce`` takes that capture's events, as ``devtrace.summarise``
does, and gives for each name the instances that start inside the
window and their host seconds (clipped to it), and, by the set of names
open at each launch, the device seconds of the kernels, copies and fills
(clipped to the window) and of the idle gaps that launch ended
(``devtrace``'s gaps).

A launch is inside an instance when its runtime call, found by the
operation's correlation id, starts within the instance's interval on
ANY thread: the backward runs on autograd's thread while the main thread
sits inside ``train.backward``. A launch inside nested spans counts for
each of them.

The readers (``READERS``: ``read(ctx) -> value or None``, as a file of
``metrics/`` reads) take the reduction from ``ctx.summary.spans`` and
give None where it is missing: a program without the spans, or a
harness whose summaries do not carry it. ``attach()`` makes
``devtrace.summarise`` attach it in the calling process, for the tools
and tests that run a cell (``tools/span_figures.py``).
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
from typing import Dict, FrozenSet, Iterable, Optional

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
OUTSIDE: FrozenSet[str] = frozenset()


@dataclasses.dataclass
class Spans:
    """What the window's spans held (module docstring)."""
    instances: Dict[str, int]
    host_s: Dict[str, float]
    device_s: Dict[FrozenSet[str], float]    # by the names open at launch
    idle_s: Dict[FrozenSet[str], float]      # the same, of the gaps

    def device(self, *names: str, outside: Iterable[str] = ()) -> float:
        """Device seconds launched inside all of ``names`` and none of
        ``outside``."""
        return _sum(self.device_s, names, outside)

    def idle(self, *names: str, outside: Iterable[str] = ()) -> float:
        """Idle seconds ended by such launches."""
        return _sum(self.idle_s, names, outside)


def _sum(by_set, names, outside) -> float:
    want, skip = set(names), set(outside)
    return sum(s for k, s in by_set.items()
               if want <= k and not (skip & k))


class _Intervals:
    """Is a time inside any of a name's instances: their starts in order
    and the latest end up to each."""

    def __init__(self, spans):
        spans = sorted(spans)
        self.starts = [s for s, _ in spans]
        self.ends, top = [], None
        for _, e in spans:
            top = e if top is None else max(top, e)
            self.ends.append(top)

    def __contains__(self, t: int) -> bool:
        k = bisect.bisect_right(self.starts, t)
        return k > 0 and self.ends[k - 1] >= t


def reduce(events, names: Iterable[str] = NAMES) -> Spans:
    """Reduce a profiler's kineto events (module docstring)."""
    names = tuple(names)
    win, dev, runtime = None, [], {}
    found = collections.defaultdict(list)
    for e in events:
        act = devtrace._kind(e)
        if act in devtrace.DEVICE_ACTIVITIES:
            dev.append((e.start_ns(), e.end_ns(), e.correlation_id()))
        elif act == "cuda_runtime":
            runtime[e.correlation_id()] = e.start_ns()
        elif act in devtrace.HOST_ACTIVITIES:
            if e.name() == devtrace.WINDOW:
                win = (e.start_ns(), e.end_ns())
            elif e.name() in names:
                found[e.name()].append((e.start_ns(), e.end_ns()))
    if win is None:
        raise RuntimeError(f"the trace holds no {devtrace.WINDOW!r} span")
    lo, hi = win
    inside = {n: [(s, e) for s, e in found[n] if lo <= s < hi]
              for n in names}
    where = {n: _Intervals(v) for n, v in inside.items() if v}

    def open_at(corr) -> FrozenSet[str]:
        t = runtime.get(corr)
        if t is None:
            return OUTSIDE
        return frozenset(n for n, iv in where.items() if t in iv)

    device_s = collections.Counter()
    idle_s = collections.Counter()
    cur_end = lo
    for s, e, corr in sorted(d for d in dev if d[1] > lo and d[0] < hi):
        s, e = max(s, lo), min(e, hi)
        key = open_at(corr)
        device_s[key] += (e - s) * 1e-9
        if s > cur_end:
            idle_s[key] += (s - cur_end) * 1e-9
        cur_end = max(cur_end, e)
    if hi > cur_end:
        idle_s[OUTSIDE] += (hi - cur_end) * 1e-9
    return Spans(
        instances={n: len(v) for n, v in inside.items() if v},
        host_s={n: sum(min(e, hi) - s for s, e in v) * 1e-9
                for n, v in inside.items() if v},
        device_s=dict(device_s), idle_s=dict(idle_s))


def attach() -> None:
    """Make ``devtrace.summarise`` set ``summary.spans`` to the same
    events' reduction, in this process."""
    if getattr(devtrace.summarise, "spans_attached", False):
        return
    plain = devtrace.summarise

    def summarise(events):
        events = list(events)
        summary = plain(events)
        summary.spans = reduce(events)
        return summary

    summarise.spans_attached = True
    devtrace.summarise = summarise


# -- readers -------------------------------------------------------------

def spans_of(ctx) -> Optional[Spans]:
    return getattr(ctx.summary, "spans", None)


def phase_ms(ctx, name: str) -> Optional[float]:
    """Device milliseconds a unit launched inside ``name``."""
    sp = spans_of(ctx)
    if sp is None or not ctx.units or not sp.instances.get(name):
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
    if sp is None or not ctx.units or not sp.instances.get(SSM_MIXER):
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
