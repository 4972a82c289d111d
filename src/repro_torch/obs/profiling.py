"""Device-trace bridge on ``torch.profiler`` (counterpart of
``repro.obs.profiling``): device traces aligned with the event log.

``annotate_span(name)`` names a region for the profiler: a
``torch.profiler.record_function`` range, plus an NVTX range when the
process runs on the card (CUDA is initialised), so the name shows on the
host and the device timelines alike.

``TraceContext`` joins a ``Recorder`` span and that annotation, so one
``with`` statement lands the event in the JSONL log *and* the device
trace under the same name.

``start_trace(dir, max_steps)`` starts a ``torch.profiler.profile`` (CPU
activity, and CUDA activity where a card is present); ``stop_trace()``
stops it and writes its Chrome trace into the directory. An eager run
records every operator, about a thousand events per full-width decode
step, so a long run's whole trace would run to gigabytes: drivers call
``step()`` once per engine or training step, and after ``max_steps`` of
them the trace stops and is written. Unlike the reference, which
proceeds untraced when ``jax.profiler`` is missing, a profiler that
cannot start raises: a run asked for a device trace gets one or fails.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Iterator, Optional

import torch

from repro_torch.obs.events import CAT_KERNEL, NULL, Recorder

DEVICE_TRACE = "device.trace.json"      # stop_trace's file in the dir


@dataclasses.dataclass
class _Trace:
    prof: torch.profiler.profile
    path: str
    steps_left: Optional[int]
    running: bool = True


_ACTIVE: Optional[_Trace] = None


@contextlib.contextmanager
def annotate_span(name: str) -> Iterator[None]:
    """Name a region for the profiler (and for NVTX on the card)."""
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


@contextlib.contextmanager
def TraceContext(recorder: Optional[Recorder], name: str, *,
                 cat: str = CAT_KERNEL, track: str = "main",
                 **args: Any) -> Iterator[Any]:
    """Recorder span + device annotation under one name."""
    rec = recorder or NULL
    with annotate_span(name):
        with rec.span(name, cat=cat, track=track, **args) as live:
            yield live


def start_trace(log_dir: str, max_steps: Optional[int] = None) -> bool:
    """Start a profiler trace that is written into ``log_dir`` after
    ``max_steps`` calls of :func:`step` (None: at ``stop_trace``).
    Returns True; raises if a trace is already running or the profiler
    cannot start."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError(f"a device trace into {_ACTIVE.path} is already "
                           "running")
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    _ACTIVE = _Trace(prof, os.path.join(log_dir, DEVICE_TRACE), max_steps)
    return True


def _finish(trace: _Trace) -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    trace.prof.stop()
    trace.prof.export_chrome_trace(trace.path)
    trace.running = False


def step() -> None:
    """Count one driver step of the running trace (no-op without one);
    the step that uses up ``max_steps`` stops and writes the trace."""
    trace = _ACTIVE
    if trace is None or not trace.running or trace.steps_left is None:
        return
    trace.steps_left -= 1
    if trace.steps_left <= 0:
        _finish(trace)


def stop_trace() -> Optional[str]:
    """Stop the trace (if it still runs) and write it; returns the trace
    file's path, or None if no trace was started."""
    global _ACTIVE
    trace, _ACTIVE = _ACTIVE, None
    if trace is None:
        return None
    if trace.running:
        _finish(trace)
    return trace.path
