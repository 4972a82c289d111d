"""Observability: structured events and metrics (counterpart of
``repro.obs``, stdlib only).

``events``     typed spans/instants with dual wall/sim-clock timestamps,
               a ``Recorder`` that buffers them (JSONL sink), and a
               zero-cost ``NULL`` recorder every integration point
               defaults to.
``metrics``    labeled counters/gauges/histograms in a ``MetricsRegistry``
               (each ``Recorder`` carries one).

Not ported yet (ROADMAP.md Queue 1): ``export``, ``timeseries``, ``slo``
and ``report`` (item 2a), and ``profiling``, the device-trace bridge
(item 7).
"""
from repro_torch.obs.events import (CAT_BENCH, CAT_GYM,  # noqa: F401
                                    CAT_KERNEL, CAT_POLICY, CAT_SERVE,
                                    CAT_SIM, CAT_TRAIN, EV_ALERT,
                                    EV_ALLREDUCE, EV_COMPLETE, EV_DECODE,
                                    EV_DRAIN, EV_ENQUEUE, EV_EPISODE,
                                    EV_MIGRATE, EV_PREFILL, EV_REJECT,
                                    EV_REPLAN, EV_REVOKE_FIRE,
                                    EV_REVOKE_WARN, EV_SLOT_JOIN,
                                    EV_SLOT_RELEASE, EV_SLOT_REQUEST,
                                    EV_STEP, EV_TRIAL_DONE, TAXONOMY, Event,
                                    NULL, NullRecorder, Recorder,
                                    load_events, load_header)
from repro_torch.obs.metrics import (Counter, Gauge,  # noqa: F401
                                     Histogram, MetricsRegistry)
