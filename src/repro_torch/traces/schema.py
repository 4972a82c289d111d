"""Trace schema: a timestamped record of transient-market conditions.

A copy of ``repro.traces.schema``: the same code and the same numpy draws in the
same order, so one seed gives the same numbers in both packages.

A ``Trace`` is an ordered sequence of ``TraceEvent``s over a horizon,
each tagged with a server type (``kind``) and a zone:

``price``     the spot ($/hr) for ``kind`` in ``zone`` changed to ``value``
              (piecewise-constant until the next update for that pair).
``revoke``    an instance of ``kind`` in ``zone`` was revoked after
              ``value`` seconds of life — an *observation* of the lifetime
              process, what replay bootstrap-resamples from.
``capacity``  the number of ``kind`` slots the provider would currently
              fulfil in ``zone`` changed to ``value`` (policies read this
              as an availability signal; the engine does not consume it).

Serialization is deliberately dual:

- **JSONL** (interchange, human-diffable): one header line
  ``{"trace": {...meta...}}`` followed by one event per line. Python's
  ``json`` round-trips finite IEEE-754 doubles exactly (``repr``-based),
  so the format is lossless.
- **npz** (bulk, mmap-friendly): columnar float64/int64 arrays plus
  small vocab arrays for the categorical columns and the meta as a JSON
  string — what the vectorized replay path loads.

Both directions are pinned lossless in ``tests/test_traces.py``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

EVENT_KINDS = ("price", "revoke", "capacity")
_FORMAT_VERSION = 1


@dataclasses.dataclass(frozen=True, order=True)
class TraceEvent:
    """One timestamped observation. Ordered by (t, event, kind, zone)."""
    t: float                  # seconds since trace start, in [0, horizon_s]
    event: str                # "price" | "revoke" | "capacity"
    kind: str                 # server type: "K80" | "P100" | "V100" | "PS"
    zone: str                 # e.g. "us-east1"
    value: float              # price: $/hr; revoke: lifetime_s; capacity: slots

    def __post_init__(self):
        if self.event not in EVENT_KINDS:
            raise ValueError(f"unknown event {self.event!r}; "
                             f"expected one of {EVENT_KINDS}")
        if not (self.t >= 0.0):
            raise ValueError(f"event time must be >= 0, got {self.t}")
        if self.event in ("price", "revoke") and not (self.value > 0.0):
            raise ValueError(f"{self.event} value must be > 0, "
                             f"got {self.value}")


@dataclasses.dataclass(frozen=True)
class Trace:
    """An immutable, time-sorted event timeline with metadata.

    ``events`` are sorted on construction (stable), so two traces built
    from the same events in any order compare equal.
    """
    name: str
    horizon_s: float
    events: Tuple[TraceEvent, ...]
    source: str = "synthetic"           # "synthetic" | "recorded"
    seed: Optional[int] = None          # generator seed, if synthetic

    def __post_init__(self):
        if self.horizon_s <= 0:
            raise ValueError(f"horizon_s must be > 0, got {self.horizon_s}")
        evs = tuple(sorted(self.events))
        for e in evs:
            if e.t > self.horizon_s:
                raise ValueError(f"event at t={e.t} beyond horizon "
                                 f"{self.horizon_s}")
        object.__setattr__(self, "events", evs)

    # -- columnar access (what replay vectorizes over) ---------------------

    def columns(self, event: Optional[str] = None,
                kind: Optional[str] = None,
                zone: Optional[str] = None) -> Dict[str, np.ndarray]:
        """Filtered columns as arrays: ``{"t": f8[n], "value": f8[n]}``."""
        sel = [e for e in self.events
               if (event is None or e.event == event)
               and (kind is None or e.kind == kind)
               and (zone is None or e.zone == zone)]
        return {"t": np.array([e.t for e in sel], dtype=np.float64),
                "value": np.array([e.value for e in sel], dtype=np.float64)}

    def lifetimes(self, kind: str) -> np.ndarray:
        """All observed lifetimes (seconds) for ``kind``, in event order."""
        return self.columns(event="revoke", kind=kind)["value"]

    def price_series(self, kind: str,
                     zone: Optional[str] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """(times, $/hr) of the piecewise-constant price path for ``kind``.

        With multiple zones and ``zone=None``, updates from every zone are
        merged in time order (the replay path treats the trace as one
        market; per-zone playback passes an explicit zone).
        """
        c = self.columns(event="price", kind=kind, zone=zone)
        return c["t"], c["value"]

    @property
    def kinds(self) -> Tuple[str, ...]:
        return tuple(sorted({e.kind for e in self.events}))

    @property
    def zones(self) -> Tuple[str, ...]:
        return tuple(sorted({e.zone for e in self.events}))

    def window(self, t0: float, t1: float) -> "Trace":
        """Sub-trace of events with ``t0 <= t < t1``, times re-zeroed."""
        evs = tuple(dataclasses.replace(e, t=e.t - t0) for e in self.events
                    if t0 <= e.t < t1)
        return Trace(name=f"{self.name}[{t0:g}:{t1:g}]",
                     horizon_s=max(t1 - t0, 1e-9), events=evs,
                     source=self.source, seed=self.seed)

    # -- JSONL -------------------------------------------------------------

    def _meta(self) -> Dict:
        return {"name": self.name, "horizon_s": self.horizon_s,
                "source": self.source, "seed": self.seed,
                "version": _FORMAT_VERSION}

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(json.dumps({"trace": self._meta()}) + "\n")
            for e in self.events:
                f.write(json.dumps({"t": e.t, "event": e.event,
                                    "kind": e.kind, "zone": e.zone,
                                    "value": e.value}) + "\n")

    @staticmethod
    def from_jsonl(path: str) -> "Trace":
        with open(path) as f:
            header = json.loads(f.readline())
            if "trace" not in header:
                raise ValueError(f"{path}: first line must be the "
                                 "{'trace': ...} header")
            meta = header["trace"]
            if meta.get("version", 1) > _FORMAT_VERSION:
                raise ValueError(f"{path}: trace format version "
                                 f"{meta['version']} is newer than "
                                 f"{_FORMAT_VERSION}")
            events = []
            for line in f:
                if not line.strip():
                    continue
                d = json.loads(line)
                events.append(TraceEvent(t=d["t"], event=d["event"],
                                         kind=d["kind"], zone=d["zone"],
                                         value=d["value"]))
        return Trace(name=meta["name"], horizon_s=meta["horizon_s"],
                     events=tuple(events),
                     source=meta.get("source", "recorded"),
                     seed=meta.get("seed"))

    # -- npz ---------------------------------------------------------------

    def to_npz(self, path: str) -> None:
        kinds = self.kinds or ("",)
        zones = self.zones or ("",)
        kidx = {k: i for i, k in enumerate(kinds)}
        zidx = {z: i for i, z in enumerate(zones)}
        eidx = {e: i for i, e in enumerate(EVENT_KINDS)}
        np.savez(
            path,
            t=np.array([e.t for e in self.events], dtype=np.float64),
            value=np.array([e.value for e in self.events], dtype=np.float64),
            event=np.array([eidx[e.event] for e in self.events],
                           dtype=np.int64),
            kind=np.array([kidx[e.kind] for e in self.events],
                          dtype=np.int64),
            zone=np.array([zidx[e.zone] for e in self.events],
                          dtype=np.int64),
            kind_vocab=np.array(kinds), zone_vocab=np.array(zones),
            meta=np.array(json.dumps(self._meta())))

    @staticmethod
    def from_npz(path: str) -> "Trace":
        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(str(z["meta"]))
            kinds = [str(k) for k in z["kind_vocab"]]
            zones = [str(s) for s in z["zone_vocab"]]
            events = tuple(
                TraceEvent(t=float(t), event=EVENT_KINDS[int(ev)],
                           kind=kinds[int(k)], zone=zones[int(s)],
                           value=float(v))
                for t, ev, k, s, v in zip(z["t"], z["event"], z["kind"],
                                          z["zone"], z["value"]))
        return Trace(name=meta["name"], horizon_s=meta["horizon_s"],
                     events=events, source=meta.get("source", "recorded"),
                     seed=meta.get("seed"))
