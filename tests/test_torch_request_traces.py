"""The port's request traces (``repro_torch.traces.requests``) against the
reference's: for several seeds, with and without a burst window and with
the serve driver's two named traces, the same events, field for field
(floats exactly); JSONL written by either package reads back equal in
both. Mirrors ``tests/test_request_traces.py``."""
import dataclasses
import math

import pytest

pytest.importorskip("torch")

from repro.traces import requests as JR  # noqa: E402
from repro_torch import traces as T  # noqa: E402
from repro_torch.traces import requests as R  # noqa: E402


def _rows(trace):
    return (trace.name, trace.horizon_s, trace.seed,
            [dataclasses.astuple(e) for e in trace.events])


@pytest.mark.parametrize("seed", [0, 1, 7, 123])
@pytest.mark.parametrize("kw", [
    {},
    {"bursts": ((0.4, 0.55, 3.0),), "name": "serve-bursty"},
    {"horizon_s": 120.0, "base_rate_per_s": 1.5, "diurnal_amplitude": 0.9,
     "bursts": ((0.1, 0.2, 2.0), (0.5, 0.9, 4.0))},
    {"horizon_s": 50.0, "prompt_len_mean": 30, "max_prompt_len": 40,
     "new_tokens_mean": 4, "max_new_tokens": 8},
])
def test_synthetic_request_trace_equals_reference(seed, kw):
    mine = R.synthetic_request_trace(seed=seed, **kw)
    assert mine.n_requests > 0
    assert _rows(mine) == _rows(JR.synthetic_request_trace(seed=seed, **kw))
    assert mine.rate_per_s() == JR.synthetic_request_trace(
        seed=seed, **kw).rate_per_s()


@pytest.mark.parametrize("writer", ["torch", "jax"])
def test_jsonl_round_trip_across_packages(writer, tmp_path):
    path = str(tmp_path / "reqs.jsonl")
    src = (R if writer == "torch" else JR).synthetic_request_trace(
        seed=11, horizon_s=120.0, bursts=((0.4, 0.55, 3.0),))
    src.to_jsonl(path)
    mine, ref = R.RequestTrace.from_jsonl(path), \
        JR.RequestTrace.from_jsonl(path)
    assert _rows(mine) == _rows(ref) == _rows(src)
    assert any(e.deadline_rel_s == math.inf for e in mine.events)
    with open(path) as f:
        text = f.read()
    other = str(tmp_path / "again.jsonl")
    mine.to_jsonl(other)
    with open(other) as f:
        assert f.read() == text                 # byte-identical writer


def test_slo_classes_and_package_exports():
    assert R.SLO_CLASSES == JR.SLO_CLASSES
    assert T.synthetic_request_trace is R.synthetic_request_trace
    assert T.RequestTrace is R.RequestTrace and T.RequestEvent is \
        R.RequestEvent


def test_validation_and_defaults_match_reference():
    with pytest.raises(ValueError, match="sorted"):
        R.RequestTrace(name="bad", horizon_s=10.0,
                       events=(R.RequestEvent(5.0, 0, 4, 4),
                               R.RequestEvent(1.0, 1, 4, 4)))
    with pytest.raises(ValueError, match="diurnal_amplitude"):
        R.synthetic_request_trace(seed=0, diurnal_amplitude=1.5)
    ev = R.RequestEvent(1.0, 0, 8, 16)
    assert ev.to_json() == JR.RequestEvent(1.0, 0, 8, 16).to_json()
    assert R.RequestEvent.from_json(ev.to_json()) == ev
    assert R.RequestTrace("empty", 0.0, ()).rate_per_s() == 0.0
