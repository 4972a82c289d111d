"""Exporters: Chrome-trace/Perfetto JSON, CSV, and flat stats summaries.

A copy of ``repro.obs.export`` (stdlib only).

``to_chrome_trace`` emits the Trace Event Format (the JSON Perfetto and
``chrome://tracing`` both open): one process per category, one thread per
track, ``X`` complete-spans and ``i`` instants with microsecond
timestamps. ``clock="sim"`` places events on the simulated wall clock
(events without a sim timestamp are dropped — kernel dispatch has no sim
time); ``clock="wall"`` places them on the host clock. Metadata events
name the processes/threads so the timeline reads ``gym / slot3`` instead
of bare pids.

``validate_chrome_trace`` is the schema check the round-trip test and the
CI obs-smoke job run on every exported trace — shape drift fails loudly,
not in the viewer.

Events carrying a ``trace_id`` (the serving engine's request-correlation
id) get **flow events**: whenever consecutive events of one trace land on
different tracks — a request migrating between replicas, or hopping from
its queue track to a slot track — the exporter emits an ``s``/``f``
(flow start/finish) pair bound by a per-trace ``id``. Perfetto draws
these as arrows, so one request's enqueue→prefill→decode→migrate→resume
reads as a single connected path across replica tracks.

``metrics_stats`` flattens a ``MetricsRegistry`` (or passes a dict
through) into the numeric stats dict that ``emit(stats=)`` persists.

CLI (used by CI to validate an event log end-to-end)::

    python -m repro_torch.obs.export events.jsonl [out.trace.json] [--clock sim]
"""
from __future__ import annotations

import csv
import json
from typing import Any, Dict, Iterable, List, Optional, Union

from repro_torch.obs.events import (PH_INSTANT, PH_SPAN, Event, load_events,
                              load_header)
from repro_torch.obs.metrics import MetricsRegistry

_US = 1e6        # seconds -> Trace Event Format microseconds


def to_chrome_trace(events: Iterable[Event], *, clock: str = "sim",
                    meta: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Trace Event Format dict. ``clock``: "sim" or "wall"."""
    if clock not in ("sim", "wall"):
        raise ValueError(f"clock must be 'sim' or 'wall', got {clock!r}")
    pids: Dict[str, int] = {}
    tids: Dict[tuple, int] = {}
    out: List[Dict[str, Any]] = []
    # trace_id -> (pid, tid, end_ts) of its latest event; a change of
    # (pid, tid) emits one s/f flow arrow from there to here
    flows: Dict[str, tuple] = {}
    n_flows = 0

    def pid_for(cat: str) -> int:
        if cat not in pids:
            pids[cat] = len(pids) + 1
            out.append({"name": "process_name", "ph": "M", "pid": pids[cat],
                        "tid": 0, "args": {"name": cat}})
        return pids[cat]

    def tid_for(cat: str, track: str) -> int:
        key = (cat, track)
        if key not in tids:
            tids[key] = len(tids) + 1
            out.append({"name": "thread_name", "ph": "M", "pid": pid_for(cat),
                        "tid": tids[key], "args": {"name": track}})
        return tids[key]

    for ev in events:
        if clock == "sim":
            if ev.t_sim is None:
                continue
            ts, dur = ev.t_sim * _US, (ev.dur_sim or 0.0) * _US
        else:
            ts, dur = ev.t_wall * _US, ev.dur_wall * _US
        rec: Dict[str, Any] = {"name": ev.name, "cat": ev.cat, "ph": ev.ph,
                               "ts": ts, "pid": pid_for(ev.cat),
                               "tid": tid_for(ev.cat, ev.track)}
        if ev.ph == PH_SPAN:
            rec["dur"] = dur
        elif ev.ph == PH_INSTANT:
            rec["s"] = "t"                       # thread-scoped instant
        if ev.args:
            rec["args"] = ev.args
        if ev.trace_id is not None:
            rec.setdefault("args", {})
            rec["args"] = dict(rec["args"], trace_id=ev.trace_id)
            if ev.span_id is not None:
                rec["args"]["span_id"] = ev.span_id
            if ev.parent_id is not None:
                rec["args"]["parent_id"] = ev.parent_id
        out.append(rec)
        if ev.trace_id is not None:
            loc = (rec["pid"], rec["tid"])
            prev = flows.get(ev.trace_id)
            if prev is not None and (prev[0], prev[1]) != loc:
                # the trace moved tracks (queue->slot, replica->replica):
                # draw the arrow from the previous event's end to here
                n_flows += 1
                src_ts = min(prev[2], ts)
                common = {"name": "req_flow", "cat": "flow",
                          "id": n_flows,
                          "args": {"trace_id": ev.trace_id}}
                out.append({**common, "ph": "s", "pid": prev[0],
                            "tid": prev[1], "ts": src_ts})
                out.append({**common, "ph": "f", "bp": "e",
                            "pid": loc[0], "tid": loc[1], "ts": ts})
            flows[ev.trace_id] = (loc[0], loc[1], ts + dur)
    return {"traceEvents": out, "displayTimeUnit": "ms",
            "otherData": dict(meta or {}, clock=clock, flows=n_flows)}


def validate_chrome_trace(trace: Dict[str, Any]) -> int:
    """Assert Trace Event Format invariants; returns the event count.

    Checks what the viewers actually require: ``traceEvents`` is a list;
    every entry has ``name``/``ph``/``pid``/``tid``; phases are from the
    supported set; ``X`` spans carry numeric non-negative ``ts``+``dur``;
    instants carry ``ts``; metadata events carry ``args.name``. Flow
    events (``s``/``f``) must carry an ``id``, pair up exactly (each id
    has one start and one finish), and never flow backwards in time.
    """
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("not a Chrome trace: missing traceEvents")
    evs = trace["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("traceEvents must be a list")
    flow_ts: Dict[Any, Dict[str, float]] = {}
    for i, e in enumerate(evs):
        where = f"traceEvents[{i}]"
        for field in ("name", "ph", "pid", "tid"):
            if field not in e:
                raise ValueError(f"{where}: missing {field!r}")
        ph = e["ph"]
        if ph not in ("X", "i", "M", "B", "E", "C", "s", "f"):
            raise ValueError(f"{where}: unsupported phase {ph!r}")
        if ph == "M":
            if e.get("args", {}).get("name") is None:
                raise ValueError(f"{where}: metadata event without args.name")
            continue
        if not isinstance(e.get("ts"), (int, float)):
            raise ValueError(f"{where}: non-numeric ts {e.get('ts')!r}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"{where}: X span needs dur >= 0, "
                                 f"got {dur!r}")
        elif ph in ("s", "f"):
            if "id" not in e:
                raise ValueError(f"{where}: flow event without id")
            ends = flow_ts.setdefault(e["id"], {})
            if ph in ends:
                raise ValueError(f"{where}: duplicate flow {ph!r} "
                                 f"for id {e['id']!r}")
            ends[ph] = e["ts"]
    for fid, ends in flow_ts.items():
        if set(ends) != {"s", "f"}:
            raise ValueError(f"flow id {fid!r}: unpaired "
                             f"(has {sorted(ends)})")
        if ends["f"] < ends["s"]:
            raise ValueError(f"flow id {fid!r}: finish at {ends['f']} "
                             f"before start at {ends['s']}")
    return len(evs)


def write_chrome_trace(events: Iterable[Event], path: str, *,
                       clock: str = "sim",
                       meta: Optional[Dict[str, Any]] = None) -> str:
    trace = to_chrome_trace(events, clock=clock, meta=meta)
    validate_chrome_trace(trace)
    with open(path, "w") as f:
        json.dump(trace, f)
    return path


def write_events_csv(events: Iterable[Event], path: str) -> str:
    """Flat CSV of the event stream (args JSON-encoded in one column)."""
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "ph", "cat", "track", "t_wall", "dur_wall",
                    "t_sim", "dur_sim", "args"])
        for ev in events:
            w.writerow([ev.name, ev.ph, ev.cat, ev.track, ev.t_wall,
                        ev.dur_wall,
                        "" if ev.t_sim is None else ev.t_sim,
                        "" if ev.dur_sim is None else ev.dur_sim,
                        json.dumps(ev.args) if ev.args else ""])
    return path


# ---------------------------------------------------------------------------
# Flat stats summaries (the emit(stats=) seam)
# ---------------------------------------------------------------------------

def metrics_stats(metrics: Union[MetricsRegistry, Dict[str, Any]]
                  ) -> Dict[str, Any]:
    """Normalize to the flat numeric stats dict ``emit(stats=)`` persists
    — a registry flattens via ``to_stats()``, a dict passes through."""
    if isinstance(metrics, MetricsRegistry):
        return metrics.to_stats()
    return metrics


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(
        description="Validate an event log and export its Perfetto trace")
    ap.add_argument("events_jsonl")
    ap.add_argument("trace_out", nargs="?", default=None)
    ap.add_argument("--clock", default="sim", choices=["sim", "wall"])
    args = ap.parse_args(argv)
    events = load_events(args.events_jsonl)
    header = load_header(args.events_jsonl)
    trace = to_chrome_trace(events, clock=args.clock,
                            meta=header.get("meta", {}))
    n = validate_chrome_trace(trace)
    if args.trace_out:
        with open(args.trace_out, "w") as f:
            json.dump(trace, f)
    print(json.dumps({"events": len(events), "trace_events": n,
                      "clock": args.clock,
                      "metrics_series": len(header.get("metrics", {})),
                      "out": args.trace_out}))


if __name__ == "__main__":
    main()
