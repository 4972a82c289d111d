"""Shared ``--events`` / ``--profile`` observability flags of the drivers
(counterpart of ``repro.launch.obs_args``).

Both drivers (``launch.train``, ``launch.serve``) expose the same pair:

``--events PATH``   record a structured event log and flush it as JSONL
                    (``repro_torch.obs`` Recorder format; feed it to
                    ``python -m repro_torch.obs.export`` for a Perfetto
                    trace).
``--profile DIR``   also run a ``torch.profiler`` trace of the run's first
                    ``PROFILE_STEPS`` driver steps and write it into DIR
                    (``device.trace.json``), with ``events.jsonl`` and a
                    validated ``timeline.trace.json`` beside it, so the
                    device trace and the sim/step timeline can be opened
                    side by side in Perfetto. A profiler that cannot
                    start raises.

Either flag alone enables the Recorder; with neither, every instrumented
call site sees the NULL recorder and the run is observability-free.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional, Tuple

from repro_torch import obs
from repro_torch.obs import export, profiling

# driver steps the --profile trace records: an eager full-width step
# records thousands of events (tens of MB of Chrome trace), so a whole
# run's trace would not open in a viewer
PROFILE_STEPS = 4


def add_obs_args(ap) -> None:
    ap.add_argument("--events", default=None, metavar="PATH",
                    help="write a structured event log (JSONL) here")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="torch.profiler trace dir; also writes events.jsonl "
                         "+ timeline.trace.json")


def recorder_from_args(args, *, meta: Optional[Dict[str, Any]] = None
                       ) -> Tuple[Optional[obs.Recorder], bool]:
    """(recorder, device_trace_started) per the flags; (None, False) when
    observability is off."""
    if not (args.events or args.profile):
        return None, False
    rec = obs.Recorder(jsonl=args.events, meta=meta)
    traced = False
    if args.profile:
        traced = profiling.start_trace(args.profile, PROFILE_STEPS)
    return rec, traced


def finalize_recorder(args, rec: Optional[obs.Recorder], traced: bool, *,
                      clock: str = "sim") -> Dict[str, str]:
    """Stop the device trace, flush the log, export the timeline.

    Returns the paths written (for the driver's stdout summary): the
    reference's keys, plus ``device_trace``, the profiler's Chrome trace.
    ``clock`` picks the exported timeline's axis: "sim" for trace/step-
    driven runs, "wall" for serving without a trace.
    """
    out: Dict[str, str] = {}
    if traced:
        out["device_trace"] = profiling.stop_trace()
        out["profile_dir"] = args.profile
    if rec is None:
        return out
    if args.events:
        out["events"] = rec.flush(args.events)
    if args.profile:
        jsonl = os.path.join(args.profile, "events.jsonl")
        out.setdefault("events", rec.flush(jsonl))
        if rec.events:
            out["timeline"] = export.write_chrome_trace(
                rec.events, os.path.join(args.profile, "timeline.trace.json"),
                clock=clock, meta=rec.meta)
    return out
