"""Device-trace bridge on ``torch.profiler`` (counterpart of
``repro.obs.profiling``): device traces aligned with the event log.

``annotate_span(name)`` names a region for the profiler: while a
profiler runs, a ``torch.profiler.record_function`` range, plus an NVTX
range when the process runs on the card (CUDA is initialised), so the
name shows on the host and the device timelines alike and shares the
profiler's clock with the device's operations. With no profiler running
it costs one check of the profiler's state and returns a shared null
context, so the hot path carries its spans at no cost. ``SPANS`` names
the spans the port's hot path opens (the train step's phases, the
attention core, the Mamba-2 mixer's parts, the RWKV-6 time mix's parts
and its channel mix).

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
from typing import ContextManager, Iterator, Optional

import torch

DEVICE_TRACE = "device.trace.json"      # stop_trace's file in the dir

# the hot path's spans, each opened where its name says
TRAIN_FORWARD = "train.forward"         # train/step.py value_and_grad
TRAIN_BACKWARD = "train.backward"       # its autograd.grad, the sums after
TRAIN_OPTIMIZER = "train.optimizer"     # make_train_step: cast, norm, update
ATTN_CORE = "attn.core"                 # models/attention.py attend
SSM_MIXER = "ssm.mixer"                 # models/ssm.py apply_mamba2
SSM_PROJ = "ssm.proj"                   # its in_proj and out_proj matmuls
SSM_SCAN = "ssm.scan"                   # its SSD scan
RWKV_TMIX = "rwkv.tmix"                 # models/rwkv.py apply_tmix
RWKV_SHIFT = "rwkv.shift"               # its token shift and lerps
RWKV_PROJ = "rwkv.proj"                 # its r/k/v/g matmuls, then wo
RWKV_SCAN = "rwkv.scan"                 # its WKV recurrence
RWKV_CMIX = "rwkv.cmix"                 # models/rwkv.py apply_cmix
SPANS = (TRAIN_FORWARD, TRAIN_BACKWARD, TRAIN_OPTIMIZER, ATTN_CORE,
         SSM_MIXER, SSM_PROJ, SSM_SCAN, RWKV_TMIX, RWKV_SHIFT, RWKV_PROJ,
         RWKV_SCAN, RWKV_CMIX)

_OFF = contextlib.nullcontext()
_profiling = torch._C._autograd._profiler_enabled


@dataclasses.dataclass
class _Trace:
    prof: torch.profiler.profile
    path: str
    steps_left: Optional[int]
    running: bool = True


_ACTIVE: Optional[_Trace] = None


def annotate_span(name: str) -> ContextManager[None]:
    """Name a region for the profiler (and for NVTX on the card) while
    one runs; a shared null context otherwise."""
    if not _profiling():
        return _OFF
    return _traced(name)


@contextlib.contextmanager
def _traced(name: str) -> Iterator[None]:
    with contextlib.ExitStack() as stack:
        stack.enter_context(torch.profiler.record_function(name))
        if torch.cuda.is_initialized():
            stack.enter_context(torch.cuda.nvtx.range(name))
        yield


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
