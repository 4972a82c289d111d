"""Structured event log: typed spans/instants with dual clocks.

A copy of ``repro.obs.events`` (stdlib only).

Every event carries both clocks the reproduction runs on:

``t_wall``  seconds since the recorder's epoch on the *host* monotonic
            clock — what benchmarks and a device profiler measure;
``t_sim``   seconds on the *simulated* wall clock of the MC engine / gym
            fleet model (``None`` when the event has no sim-time meaning,
            e.g. a kernel dispatch). Elastic-training events use the
            training step index as their sim clock — the gym's
            ``training_schedule`` maps virtual-step events onto step
            indices, so both streams line up on the same axis.

The taxonomy is a closed set of dotted names (``EV_*`` below): layer code
emits those constants, the exporters group by them, and the docs table in
``docs/ARCHITECTURE.md`` is generated from the same list. Unknown names
are allowed (the log is extensible) but everything the repo itself emits
is enumerated here.

``Recorder`` buffers events in memory and flushes them as JSONL (one
header line with meta, then one event per line — lossless round-trip via
``load_events``). ``NULL`` is the no-op instance every instrumented call
site defaults to; its methods return immediately and its ``span`` hands
back a shared ``nullcontext``, so un-observed runs pay a dict lookup and
an attribute check, nothing more.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, Iterator, List, Optional

from repro_torch.obs.metrics import MetricsRegistry

# -- categories: one per instrumented layer ---------------------------------
CAT_SIM = "sim"          # batched MC engine trial streams
CAT_GYM = "gym"          # TransientGym wall-clock fleet model
CAT_TRAIN = "train"      # ElasticRuntime / Trainer real training steps
CAT_SERVE = "serve"      # ServeEngine request lifecycle
CAT_POLICY = "policy"    # policy replanning decisions
CAT_KERNEL = "kernel"    # kernel dispatch (profiling bridge)
CAT_BENCH = "bench"      # benchmark harness timing

# -- event taxonomy ----------------------------------------------------------
EV_REVOKE_WARN = "revocation.warn"     # provider warning (GCE: 30 s)
EV_REVOKE_FIRE = "revocation.fire"     # server actually revoked
EV_SLOT_JOIN = "slot.join"             # slot activated (join/refill)
EV_SLOT_RELEASE = "slot.release"       # policy released the server
EV_SLOT_REQUEST = "slot.request"       # join requested (activation pending)
EV_REPLAN = "replan"                   # policy decision span
EV_STEP = "step"                       # one training step / sim segment
EV_ALLREDUCE = "allreduce"             # gradient sync inside a step
EV_PREFILL = "prefill"                 # serving: prompt ingestion span
EV_DECODE = "decode"                   # serving: token generation span
EV_ENQUEUE = "request.enqueue"         # serving: request submitted
EV_COMPLETE = "request.complete"       # serving: request retired
EV_MIGRATE = "request.migrate"         # serving: displaced by revocation
EV_REJECT = "request.reject"           # serving: shed by admission control
EV_DRAIN = "drain"                     # serving: replica draining span
EV_EPISODE = "episode"                 # one whole gym episode span
EV_TRIAL_DONE = "trial.complete"       # MC trial reached total_steps
EV_ALERT = "alert"                     # SLO monitor fired a typed alert

TAXONOMY = {
    EV_REVOKE_WARN: "provider revocation warning (fast-save window opens)",
    EV_REVOKE_FIRE: "server revoked; slot leaves the active set",
    EV_SLOT_JOIN: "slot activated (initial fleet, join, or refill)",
    EV_SLOT_RELEASE: "policy released the server (switch/shrink)",
    EV_SLOT_REQUEST: "join requested; activation pending JOIN_OVERHEAD_S",
    EV_REPLAN: "policy observed the market and chose a fleet",
    EV_STEP: "one training step (train) / constant-rate segment (sim/gym)",
    EV_ALLREDUCE: "gradient synchronization inside a step",
    EV_PREFILL: "serving: prompt tokens fed through the decode path",
    EV_DECODE: "serving: autoregressive token generation",
    EV_ENQUEUE: "serving: request entered the queue",
    EV_COMPLETE: "serving: request retired with its generation",
    EV_MIGRATE: "serving: in-flight request displaced by a revocation",
    EV_REJECT: "serving: request shed (capacity, deadline, or draining)",
    EV_DRAIN: "serving: replica draining after a revocation warning",
    EV_EPISODE: "one gym episode end-to-end",
    EV_TRIAL_DONE: "MC trial completed its virtual workload",
    EV_ALERT: "SLO monitor alert (burn rate, revocation storm, pool "
              "exhaustion)",
}

PH_SPAN = "X"       # complete span (has a duration)
PH_INSTANT = "i"    # point event

_JSONL_VERSION = 1


@dataclasses.dataclass(frozen=True)
class Event:
    """One observed event. ``ph`` is Chrome-trace phase: span or instant.

    ``trace_id``/``span_id``/``parent_id`` are the correlation fields: all
    events of one logical operation (a serving request's whole lifecycle,
    across migrations and replicas) share a ``trace_id``; each event gets
    its own ``span_id`` and points at the span that caused it via
    ``parent_id`` (``None`` marks the root). The exporter turns
    cross-track parent links into Perfetto flow arrows.
    """
    name: str
    ph: str                       # PH_SPAN | PH_INSTANT
    cat: str                      # CAT_* layer tag
    track: str = "main"           # timeline lane (slot/trial/request id)
    t_wall: float = 0.0           # seconds since recorder epoch (host clock)
    dur_wall: float = 0.0         # span duration on the host clock
    t_sim: Optional[float] = None    # sim-clock seconds (or step index)
    dur_sim: Optional[float] = None  # span duration on the sim clock
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)
    trace_id: Optional[str] = None   # correlates one operation's events
    span_id: Optional[str] = None    # this event's own span identity
    parent_id: Optional[str] = None  # causal predecessor span (None=root)

    def to_json(self) -> Dict[str, Any]:
        d = {"name": self.name, "ph": self.ph, "cat": self.cat,
             "track": self.track, "t_wall": self.t_wall,
             "dur_wall": self.dur_wall}
        if self.t_sim is not None:
            d["t_sim"] = self.t_sim
        if self.dur_sim is not None:
            d["dur_sim"] = self.dur_sim
        if self.trace_id is not None:
            d["trace_id"] = self.trace_id
        if self.span_id is not None:
            d["span_id"] = self.span_id
        if self.parent_id is not None:
            d["parent_id"] = self.parent_id
        if self.args:
            d["args"] = self.args
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Event":
        return Event(name=d["name"], ph=d["ph"], cat=d["cat"],
                     track=d.get("track", "main"),
                     t_wall=d.get("t_wall", 0.0),
                     dur_wall=d.get("dur_wall", 0.0),
                     t_sim=d.get("t_sim"), dur_sim=d.get("dur_sim"),
                     args=d.get("args", {}),
                     trace_id=d.get("trace_id"), span_id=d.get("span_id"),
                     parent_id=d.get("parent_id"))


class Recorder:
    """Collects events + metrics for one run; flushable to JSONL.

    ``deterministic=True`` zeroes the host clock (every ``t_wall`` is 0)
    so two runs of a seeded simulation produce bit-identical event logs —
    what the determinism regression test pins. Sim-clock timestamps are
    always exact replay state and never wobble.
    """

    enabled = True

    def __init__(self, *, jsonl: Optional[str] = None,
                 deterministic: bool = False,
                 meta: Optional[Dict[str, Any]] = None):
        self.events: List[Event] = []
        self.metrics = MetricsRegistry()
        self.jsonl = jsonl
        self.deterministic = deterministic
        self.meta: Dict[str, Any] = dict(meta or {})
        self._epoch = time.monotonic()
        self.epoch_unix = time.time()

    # -- clocks --------------------------------------------------------------
    def now(self) -> float:
        if self.deterministic:
            return 0.0
        return time.monotonic() - self._epoch

    # -- emission ------------------------------------------------------------
    def emit(self, ev: Event) -> None:
        self.events.append(ev)

    def instant(self, name: str, *, cat: str, track: str = "main",
                sim_t: Optional[float] = None,
                trace_id: Optional[str] = None,
                span_id: Optional[str] = None,
                parent_id: Optional[str] = None, **args: Any) -> None:
        self.events.append(Event(name=name, ph=PH_INSTANT, cat=cat,
                                 track=track, t_wall=self.now(),
                                 t_sim=sim_t, args=args, trace_id=trace_id,
                                 span_id=span_id, parent_id=parent_id))

    def sim_span(self, name: str, *, cat: str, t0: float, t1: float,
                 track: str = "main", **args: Any) -> None:
        """A span located purely on the sim clock (fleet-model segments)."""
        self.events.append(Event(name=name, ph=PH_SPAN, cat=cat,
                                 track=track, t_wall=self.now(),
                                 t_sim=t0, dur_sim=max(0.0, t1 - t0),
                                 args=args))

    def span_at(self, name: str, *, cat: str, t_wall: float,
                dur_wall: float, track: str = "main",
                sim_t: Optional[float] = None,
                dur_sim: Optional[float] = None,
                trace_id: Optional[str] = None,
                span_id: Optional[str] = None,
                parent_id: Optional[str] = None, **args: Any) -> None:
        """Record a span retrospectively from explicit wall timestamps
        (serving retires a request long after its prefill started)."""
        self.events.append(Event(name=name, ph=PH_SPAN, cat=cat,
                                 track=track, t_wall=t_wall,
                                 dur_wall=max(0.0, dur_wall), t_sim=sim_t,
                                 dur_sim=dur_sim, args=args,
                                 trace_id=trace_id, span_id=span_id,
                                 parent_id=parent_id))

    @contextlib.contextmanager
    def span(self, name: str, *, cat: str, track: str = "main",
             sim_t: Optional[float] = None,
             **args: Any) -> Iterator[Dict[str, Any]]:
        """Wall-clock span context; mutate the yielded dict to add args
        discovered inside the span (e.g. the decision a replan chose)."""
        t0 = self.now()
        live_args: Dict[str, Any] = dict(args)
        try:
            yield live_args
        finally:
            t1 = self.now()
            self.events.append(Event(name=name, ph=PH_SPAN, cat=cat,
                                     track=track, t_wall=t0,
                                     dur_wall=t1 - t0, t_sim=sim_t,
                                     args=live_args))

    # -- persistence ---------------------------------------------------------
    def flush(self, path: Optional[str] = None) -> str:
        """Write header + events as JSONL. Returns the path written."""
        path = path or self.jsonl
        if path is None:
            raise ValueError("no JSONL path: pass one or set Recorder(jsonl=)")
        header = {"jsonl_version": _JSONL_VERSION,
                  "epoch_unix": self.epoch_unix,
                  "deterministic": self.deterministic,
                  "n_events": len(self.events),
                  "meta": self.meta,
                  "metrics": self.metrics.to_dict()}
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for ev in self.events:
                f.write(json.dumps(ev.to_json()) + "\n")
        return path


class NullRecorder(Recorder):
    """The disabled recorder: every emission is a constant-time no-op.

    Instrumented hot loops additionally guard bulk work behind
    ``recorder.enabled`` so argument construction is skipped too.
    """

    enabled = False
    _NULL_CTX = contextlib.nullcontext({})

    def __init__(self):
        super().__init__(deterministic=True)

    def emit(self, ev: Event) -> None:
        pass

    def instant(self, *a: Any, **kw: Any) -> None:
        pass

    def sim_span(self, *a: Any, **kw: Any) -> None:
        pass

    def span_at(self, *a: Any, **kw: Any) -> None:
        pass

    def span(self, *a: Any, **kw: Any):
        return self._NULL_CTX

    def flush(self, path: Optional[str] = None) -> str:
        raise ValueError("NullRecorder has nothing to flush")


NULL = NullRecorder()


def load_events(path: str) -> List[Event]:
    """Inverse of ``Recorder.flush``: the event list (header skipped).

    A trailing *partial* line — the signature of a writer killed mid-flush
    (revocation firing during a crash dump) — is tolerated: the complete
    prefix loads, the torn tail is dropped. A malformed line anywhere
    before the tail is still corruption and raises.
    """
    events: List[Event] = []
    with open(path) as f:
        lines = f.read().splitlines()
    if not lines:
        raise ValueError(f"empty event log {path}")
    header = json.loads(lines[0])
    if header.get("jsonl_version") != _JSONL_VERSION:
        raise ValueError(f"unsupported event-log version in {path}: "
                         f"{header.get('jsonl_version')!r}")
    last = len(lines) - 1
    for i, line in enumerate(lines[1:], start=1):
        line = line.strip()
        if not line:
            continue
        try:
            d = json.loads(line)
        except json.JSONDecodeError:
            if i == last:
                break                 # crash-truncated tail: keep the prefix
            raise ValueError(f"corrupt event log {path}: malformed JSON on "
                             f"line {i + 1} (not the final line)")
        events.append(Event.from_json(d))
    return events


def load_header(path: str) -> Dict[str, Any]:
    """The JSONL header line: meta + the flushed metrics snapshot."""
    with open(path) as f:
        return json.loads(next(f))
