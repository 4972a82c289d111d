"""Observability: structured events and metrics (counterpart of
``repro.obs``, stdlib only).

``events``     typed spans/instants with dual wall/sim-clock timestamps,
               a ``Recorder`` that buffers them (JSONL sink), and a
               zero-cost ``NULL`` recorder every integration point
               defaults to.
``metrics``    labeled counters/gauges/histograms in a ``MetricsRegistry``
               (each ``Recorder`` carries one).
``export``     Chrome-trace/Perfetto JSON for timeline viewing, CSV and
               flat stats summaries.
``timeseries`` windowed ring-buffer time-series sampled on a sim-clock
               cadence, plus the serving fleet's signal set
               (``attach_serve_cluster``).
``slo``        rolling SLO health: attainment, multi-window burn rates,
               typed alerts the autoscaler consumes.
``report``     self-contained HTML/text ops report.
``profiling``  the ``torch.profiler`` bridge (``annotate_span``,
               ``start_trace``); the only module here that imports torch,
               so this package does not import it.
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
from repro_torch.obs.export import (metrics_stats,  # noqa: F401
                                    perf_entry, to_chrome_trace,
                                    validate_chrome_trace,
                                    write_chrome_trace, write_events_csv)
from repro_torch.obs.timeseries import (TimeSeries,  # noqa: F401
                                        TimeSeriesSampler,
                                        attach_serve_cluster,
                                        load_series_jsonl)
from repro_torch.obs.slo import (ALERT_POOL_EXHAUSTION,  # noqa: F401
                                 ALERT_REVOCATION_STORM, ALERT_SLO_BURN,
                                 Alert, SLOMonitor, SLOSpec)
from repro_torch.obs.report import (render_report,  # noqa: F401
                                    render_text, validate_report)
