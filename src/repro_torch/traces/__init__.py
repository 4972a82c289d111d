"""Trace subsystem: recorded/synthetic transient-market timelines
(counterpart of ``repro.traces``, numpy only).

The paper's redesign call is that transient conditions are *dynamic*:
prices drift, revocation intensity comes in bursts, capacity appears and
disappears. The static closed-form lifetime mixtures in
``core/transient.py`` average all of that away. This package makes the
timeline a first-class object:

schema   ``Trace``/``TraceEvent`` — timestamped per-zone, per-type spot
         price updates, revocation observations, and capacity changes,
         with lossless JSONL and npz round-trip serialization.
synth    deterministic generators calibrated to the paper's Fig 3
         lifetime mixtures plus a mean-reverting (OU) spot-price process.
replay   vectorized trace playback for the batched MC engine
         (``ReplayContext``): bootstrap-resampled lifetime windows and
         piecewise-constant price integration, keeping the trial axis an
         array axis.
requests the demand-side twin: seeded inference *request* traces
         (diurnal + bursty Poisson arrivals with SLO classes) that the
         serving engine and ``launch/serve.py`` replay.

``simulate_many(..., trace=...)`` and the policy layer
(``core/policy.py``) consume these.
"""
from repro_torch.traces.schema import (EVENT_KINDS, Trace,  # noqa: F401
                                       TraceEvent)
from repro_torch.traces.synth import (default_trace_suite,  # noqa: F401
                                      synthetic_trace, trace_from_model)
from repro_torch.traces.replay import ReplayContext  # noqa: F401
from repro_torch.traces.requests import (RequestEvent,  # noqa: F401
                                         RequestTrace,
                                         synthetic_request_trace)


def load_trace(spec: str, seed: int = 0) -> Trace:
    """Resolve a CLI trace argument: a file path or a synthetic name.

    ``*.jsonl`` / ``*.npz`` load the recorded file; ``calm`` /
    ``volatile`` / ``bursty`` name the deterministic synthetic suite
    (``synth.default_trace_suite``).
    """
    if spec.endswith(".jsonl"):
        return Trace.from_jsonl(spec)
    if spec.endswith(".npz"):
        return Trace.from_npz(spec)
    suite = {t.name: t for t in default_trace_suite(seed)}
    if spec in suite:
        return suite[spec]
    raise ValueError(f"unknown trace {spec!r}: expected a .jsonl/.npz path "
                     f"or one of {sorted(suite)}")
