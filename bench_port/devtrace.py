"""The traced window: a ``torch.profiler`` capture of the device and the
host over exactly the window's work, reduced to what the per-layer
metrics and the breakdown read.

The window is the span of the ``bench.window`` annotation, which ends
after the device has finished (the caller synchronises inside it). Of
the device's activity only kernels, copies and fills count (never the
device-side copies of annotations). Busy time is the union of their
intervals inside the window; every stretch of the window outside that
union is an idle gap, named by what the host was doing when it launched
the operation that ended the gap: the two innermost host operations
open on the launching thread at that moment.

The summary also carries the program's spans (``Spans``): every host
range of the window whose name has the program's span form, lower-case
dotted words such as ``train.forward`` (``SPAN``), other than the
benchmark's own ``bench.*``, so a span the program opens later is
reduced with no edit here. For each name it gives the instances that
start inside the window and their host seconds (clipped to it), and, by
the set of names open at each launch, the device seconds of the
kernels, copies and fills (clipped to the window) and of the idle gaps
that launch ended. A launch is inside an instance when its runtime
call, found by the operation's correlation id, starts within the
instance's interval on ANY thread: the backward runs on autograd's
thread while the main thread sits inside ``train.backward``. A launch
inside nested spans counts for each of them.
"""
from __future__ import annotations

import bisect
import collections
import dataclasses
import re
from typing import Dict, FrozenSet, Iterable, List, Optional, Tuple

import torch

WINDOW = "bench.window"
OWN = "bench."                               # the benchmark's annotations
SPAN = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")
OUTSIDE: FrozenSet[str] = frozenset()
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_ACTIVITIES = ("cpu_op", "user_annotation")
RUNTIME = re.compile(r"^cu(da)?[A-Z]")       # cudaLaunchKernel, cuLaunchKernel
TOP = 10


def is_span(name: str) -> bool:
    """Is ``name`` a span of the program: the span form, not ``bench.*``."""
    return SPAN.match(name) is not None and not name.startswith(OWN)


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


@dataclasses.dataclass
class Summary:
    """What one traced window held."""
    window_s: float
    busy_s: float
    kernels: List[Tuple[str, float]]          # (name, seconds), in order
    device_ops: List[Tuple[str, float]]       # top by total seconds
    idle_gaps: List[Tuple[str, float]]        # top by total seconds
    spans: Optional[Spans] = None             # the program's spans

    def breakdown(self) -> Dict[str, list]:
        return {"device_ops": [list(x) for x in self.device_ops],
                "idle_gaps": [list(x) for x in self.idle_gaps]}


class Window:
    """``with Window(enabled, device) as w:`` around the window's work;
    ``w.summary`` after it (None when not enabled). The body should end
    with the device synchronised; the exit synchronises once more."""

    def __init__(self, enabled: bool, device: torch.device):
        self.enabled, self.device = enabled, device
        self.summary: Optional[Summary] = None
        self._prof = self._span = None

    def __enter__(self) -> "Window":
        if self.enabled:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = torch.profiler.profile(activities=acts)
            self._prof.__enter__()
            self._span = torch.profiler.record_function(WINDOW)
            self._span.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        if not self.enabled:
            return
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.summary = summarise(self._prof.profiler.kineto_results
                                     .events())


def _short(name: str, n: int = 100) -> str:
    """A kernel's or operation's name without its return type and
    arguments."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name)[:n].strip() or "unnamed"


def _kind(e) -> str:
    """The event's activity: kineto's name for it where this PyTorch
    reports one, else worked out from the device and the name."""
    act = getattr(e, "activity_type", None)
    if act is not None:
        return act()
    name = e.name()
    annotation = getattr(e, "is_user_annotation", None)
    marked = annotation() if annotation else name.startswith("bench.")
    if e.device_type() != torch.autograd.DeviceType.CPU:
        if marked:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    if marked:
        return "user_annotation"
    if RUNTIME.match(name):
        return "cuda_runtime"
    return "cpu_op"


def summarise(events) -> Summary:
    """Reduce a profiler's kineto events (see the module docstring)."""
    win = None
    dev, runtime = [], {}
    host: Dict[int, list] = collections.defaultdict(list)
    for e in events:
        act = _kind(e)
        if act in DEVICE_ACTIVITIES:
            dev.append((e.start_ns(), e.end_ns(), e.name(),
                        e.correlation_id(), act))
        elif act == "cuda_runtime":
            runtime[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
        elif act in HOST_ACTIVITIES:
            if e.name() == WINDOW:
                win = (e.start_ns(), e.end_ns())
            else:
                host[e.start_thread_id()].append(
                    (e.start_ns(), e.end_ns(), e.name()))
    if win is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    lo, hi = win
    dev = sorted(d for d in dev if d[1] > lo and d[0] < hi)
    # busy intervals and the gaps between them
    busy, gaps = 0, []                       # gaps: (ns, op ending it)
    cur_end = lo
    for d in dev:
        s, e = max(d[0], lo), min(d[1], hi)
        if s > cur_end:
            gaps.append((s - cur_end, d))
        if e > cur_end:
            busy += e - max(s, cur_end)
            cur_end = e
    if hi > cur_end:
        gaps.append((hi - cur_end, None))
    kernels = [(d[2], (d[1] - d[0]) * 1e-9) for d in dev if d[4] == "kernel"]
    by_name: Dict[str, float] = collections.Counter()
    for name, s in kernels:
        by_name[_short(name)] += s
    for d in dev:
        if d[4] != "kernel":
            by_name[d[4]] += (d[1] - d[0]) * 1e-9
    idle: Dict[str, float] = collections.Counter()
    for name, ns in _attribute(gaps, runtime, host):
        idle[name] += ns * 1e-9
    top = lambda c: sorted(c.items(), key=lambda kv: -kv[1])[:TOP]  # noqa
    return Summary(window_s=(hi - lo) * 1e-9, busy_s=busy * 1e-9,
                   kernels=kernels, device_ops=top(by_name),
                   idle_gaps=top(idle),
                   spans=_spans(lo, hi, dev, gaps, runtime, host))


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


def _spans(lo, hi, dev, gaps, runtime, host) -> Spans:
    """The program's spans (module docstring), from ``summarise``'s
    device operations inside the window, in order, its gaps, launches
    and host operations."""
    inside = collections.defaultdict(list)
    for ops in host.values():
        for s, e, name in ops:
            if lo <= s < hi and is_span(name):
                inside[name].append((s, e))
    where = {n: _Intervals(v) for n, v in inside.items()}

    def open_at(d) -> FrozenSet[str]:
        launch = runtime.get(d[3]) if d is not None else None
        if launch is None:
            return OUTSIDE
        return frozenset(n for n, iv in where.items() if launch[1] in iv)

    device_s: Dict[FrozenSet[str], float] = collections.Counter()
    idle_s: Dict[FrozenSet[str], float] = collections.Counter()
    for d in dev:
        device_s[open_at(d)] += (min(d[1], hi) - max(d[0], lo)) * 1e-9
    for ns, d in gaps:
        idle_s[open_at(d)] += ns * 1e-9
    return Spans(
        instances={n: len(v) for n, v in inside.items()},
        host_s={n: sum(min(e, hi) - s for s, e in v) * 1e-9
                for n, v in inside.items()},
        device_s=dict(device_s), idle_s=dict(idle_s))


def _attribute(gaps, runtime, host):
    """(name, ns) of each gap: the two innermost host operations open on
    the thread that launched the operation ending it, at the launch."""
    queries = collections.defaultdict(list)
    for ns, d in gaps:
        launch = runtime.get(d[3]) if d is not None else None
        if launch is None:
            yield ("after the last launch" if d is None
                   else "no launch recorded"), ns
            continue
        queries[launch[0]].append((launch[1], ns))
    for thread, qs in queries.items():
        ops = sorted(host.get(thread, ()))
        starts = [o[0] for o in ops]
        for t, ns in qs:
            # the operations open at t, innermost last
            k = bisect.bisect_right(starts, t)
            open_ = [o for o in ops[max(0, k - 64):k] if o[1] >= t]
            names = [_short(o[2], 60) for o in open_[-2:]]
            yield (" > ".join(names) or "no host operation open"), ns
