"""Synthetic inference *request* traces: the serving-side workload object.

A copy of ``repro.traces.requests``: the same code and the same numpy
draws in the same order, so one seed gives the same trace in both
packages.

``traces/synth.py`` makes the supply side (spot prices, revocations) a
first-class timeline; this module does the same for the demand side. A
``RequestTrace`` is a deterministic, seeded arrival process the serving
stack replays: the engine tests, ``launch/serve.py``, and
``benchmarks/serve_frontier.py`` all consume the identical workload, so
latency/cost numbers are comparable across runs and platforms.

The arrival process is a non-homogeneous Poisson process sampled by
thinning: a base rate shaped by a **diurnal** sinusoid (the day/night
swing every serving paper measures) times multiplicative **burst**
windows (flash-crowd spikes, the arrival analogue of a revocation
storm). Prompt/output lengths are lognormal-ish integer draws, and each
request carries SLO metadata (class label, relative deadline) so the
SLO queue has something real to order by.

Serialization mirrors ``traces/schema.py``: one JSONL header line with
meta, one event per line, lossless round-trip.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

# (t0_frac, t1_frac, factor) — multiplicative rate windows, as in synth.py
Regime = Tuple[float, float, float]

_JSONL_VERSION = 1


@dataclasses.dataclass(frozen=True)
class RequestEvent:
    """One arrival: when, how big, and under what SLO."""
    t_s: float                    # arrival time on the trace clock
    rid: int
    prompt_len: int
    max_new_tokens: int
    slo: str = "default"          # SLO class label
    priority: int = 0             # lower sorts first
    deadline_rel_s: float = math.inf   # deadline relative to arrival

    def to_json(self) -> dict:
        d = {"t_s": self.t_s, "rid": self.rid,
             "prompt_len": self.prompt_len,
             "max_new_tokens": self.max_new_tokens}
        if self.slo != "default":
            d["slo"] = self.slo
        if self.priority:
            d["priority"] = self.priority
        if math.isfinite(self.deadline_rel_s):
            d["deadline_rel_s"] = self.deadline_rel_s
        return d

    @staticmethod
    def from_json(d: dict) -> "RequestEvent":
        return RequestEvent(t_s=float(d["t_s"]), rid=int(d["rid"]),
                            prompt_len=int(d["prompt_len"]),
                            max_new_tokens=int(d["max_new_tokens"]),
                            slo=d.get("slo", "default"),
                            priority=int(d.get("priority", 0)),
                            deadline_rel_s=float(d.get("deadline_rel_s",
                                                       math.inf)))


@dataclasses.dataclass(frozen=True)
class RequestTrace:
    name: str
    horizon_s: float
    events: Tuple[RequestEvent, ...]     # sorted by t_s
    seed: Optional[int] = None

    def __post_init__(self):
        ts = [e.t_s for e in self.events]
        if ts != sorted(ts):
            raise ValueError("request events must be sorted by t_s")

    @property
    def n_requests(self) -> int:
        return len(self.events)

    def rate_per_s(self) -> float:
        if self.horizon_s <= 0:
            return 0.0
        return len(self.events) / self.horizon_s

    # -- serialization (same header+lines shape as traces/schema.py) --------
    def to_jsonl(self, path: str) -> str:
        header = {"jsonl_version": _JSONL_VERSION, "name": self.name,
                  "horizon_s": self.horizon_s, "seed": self.seed,
                  "n_events": len(self.events)}
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for ev in self.events:
                f.write(json.dumps(ev.to_json()) + "\n")
        return path

    @staticmethod
    def from_jsonl(path: str) -> "RequestTrace":
        with open(path) as f:
            header = json.loads(next(f))
            if header.get("jsonl_version") != _JSONL_VERSION:
                raise ValueError(
                    f"unsupported request-trace version in {path}: "
                    f"{header.get('jsonl_version')!r}")
            events = tuple(RequestEvent.from_json(json.loads(line))
                           for line in f if line.strip())
        return RequestTrace(name=header["name"],
                            horizon_s=float(header["horizon_s"]),
                            events=events, seed=header.get("seed"))


def _regime_factor(t: np.ndarray, horizon_s: float,
                   regimes: Sequence[Regime]) -> np.ndarray:
    f = np.ones_like(t)
    for t0, t1, factor in regimes:
        f = np.where((t >= t0 * horizon_s) & (t < t1 * horizon_s),
                     f * factor, f)
    return f


# SLO classes: (label, priority, relative deadline, sampling weight).
# interactive = chat-like traffic with a tight deadline; batch = offline
# work that tolerates queueing — what admission control sheds first.
SLO_CLASSES = (("interactive", 0, 30.0, 0.6),
               ("standard", 1, 120.0, 0.3),
               ("batch", 2, math.inf, 0.1))


def synthetic_request_trace(name: str = "serve-diurnal", *, seed: int = 0,
                            horizon_s: float = 600.0,
                            base_rate_per_s: float = 0.5,
                            diurnal_amplitude: float = 0.6,
                            diurnal_period_s: Optional[float] = None,
                            bursts: Sequence[Regime] = (),
                            prompt_len_mean: int = 12,
                            max_prompt_len: int = 64,
                            new_tokens_mean: int = 12,
                            max_new_tokens: int = 48,
                            slo_classes=SLO_CLASSES) -> RequestTrace:
    """Deterministic non-homogeneous Poisson arrivals by thinning.

    rate(t) = base * (1 + A*sin(2*pi*t/period)) * burst_factor(t), with
    candidate arrivals drawn at the peak rate and accepted with
    probability rate(t)/peak — the standard thinning construction, so the
    accepted set is an exact draw from the shaped process. ``bursts`` are
    fractional-horizon windows multiplying the rate (a flash crowd),
    mirroring ``synth.py``'s regime windows on the supply side.
    """
    if not (0.0 <= diurnal_amplitude < 1.0):
        raise ValueError(f"diurnal_amplitude must be in [0, 1), "
                         f"got {diurnal_amplitude}")
    rng = np.random.default_rng(seed)
    period = diurnal_period_s if diurnal_period_s is not None else horizon_s
    peak = base_rate_per_s * (1.0 + diurnal_amplitude) \
        * max([f for _, _, f in bursts], default=1.0)
    n_cand = rng.poisson(peak * horizon_s)
    t = np.sort(rng.uniform(0.0, horizon_s, size=n_cand))
    rate = base_rate_per_s * (
        1.0 + diurnal_amplitude * np.sin(2.0 * math.pi * t / period))
    rate = rate * _regime_factor(t, horizon_s, bursts)
    keep = rng.uniform(0.0, peak, size=n_cand) < rate
    t = t[keep]

    n = len(t)
    plen = np.clip(np.round(rng.lognormal(math.log(max(prompt_len_mean, 1)),
                                          0.5, size=n)),
                   1, max_prompt_len).astype(int)
    ntok = np.clip(np.round(rng.lognormal(math.log(max(new_tokens_mean, 1)),
                                          0.6, size=n)),
                   1, max_new_tokens).astype(int)
    weights = np.array([w for _, _, _, w in slo_classes], dtype=float)
    cls = rng.choice(len(slo_classes), size=n, p=weights / weights.sum())

    events = []
    for i in range(n):
        label, prio, ddl, _ = slo_classes[int(cls[i])]
        events.append(RequestEvent(t_s=float(t[i]), rid=i,
                                   prompt_len=int(plen[i]),
                                   max_new_tokens=int(ntok[i]),
                                   slo=label, priority=prio,
                                   deadline_rel_s=ddl))
    return RequestTrace(name=name, horizon_s=horizon_s,
                        events=tuple(events), seed=seed)
