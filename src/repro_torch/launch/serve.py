"""Serving entry point: ``python -m repro_torch.launch.serve --arch <id> [...]``
(counterpart of ``repro.launch.serve``).

Batched decode on the slot-based continuous-batching engine, on the card
by default (``--device cpu`` runs the plain PyTorch paths on the CPU).
Serves the dense family (the default, starcoder2-3b), the MoE family
(moonshot-v1-16b-a3b, 56.8 GB of bf16 weights at full width, which one
80 GB card holds; arctic-480b only reduced, as 957 GB fit neither one card
nor four), zamba2-1.2b (hybrid), rwkv6-7b (recurrent) and qwen2-vl-7b
(multimodal, served text-only through the dense decode cell, as the
reference serves it); ``--reduced`` is on by default and ``--no-reduced``
serves the full-width model. The encoder-decoder seamless-m4t-large-v2
exits with the reference's message: the driver serves decoder-only
families. Parameters are drawn from ``--seed``. Two workload modes:

- default: ``--requests N`` synthetic prompts submitted up front (more
  requests than slots: admission and retirement in waves);
- ``--trace``: replay a seeded request trace (``serve-diurnal`` /
  ``serve-bursty`` from ``traces.requests``, or a ``.jsonl`` path) on an
  accelerated virtual clock, with SLO-aware queueing and optionally a
  mid-trace revocation (``--revoke-at FRAC`` fires ``revoke_slot``;
  ``--warn-at FRAC`` begins a graceful drain instead).

``--cache-impl paged`` keeps the KV in a page pool (``--page-size``,
``--num-pages``). With ``--replicas N`` (or ``--autoscale`` /
``--monitor`` / ``--report`` / ``--series-out``) the driver runs a
``ServeCluster`` instead of a single engine: replicas share the step
callables and the one parameter tree, revocations warn/fire whole
replicas (drain + page-ship/replay migration onto survivors),
``--monitor`` attaches the SLO burn-rate monitor whose alerts
``--autoscale`` consumes as a scale-up signal, and ``--report`` renders
the run's time series + alerts + per-replica summary as a self-contained
HTML ops report (``--series-out`` exports the sampled series as JSONL).
``--events``/``--profile`` record the event log and a ``torch.profiler``
trace.

The JSON summary has the reference's keys (in trace mode TTFT/TPOT are
on the virtual clock, not the card's), plus the device, ``reduced`` and
the kernel implementations.
"""
from __future__ import annotations

import argparse
import json
import math
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import get_config, list_archs
from repro_torch.launch.obs_args import (add_obs_args, finalize_recorder,
                                         recorder_from_args)
from repro_torch.models.builder import Model, build_model
from repro_torch.obs import profiling
from repro_torch.obs.slo import SLOMonitor, SLOSpec
from repro_torch.obs.timeseries import TimeSeriesSampler, attach_serve_cluster
from repro_torch.serving import FIFOQueue, Request, ServeEngine, SLOQueue
from repro_torch.serving.autoscale import ReplicaAutoscaler, ServeLoad
from repro_torch.serving.cluster import ServeCluster
from repro_torch.traces.requests import RequestTrace, synthetic_request_trace


def _pct(xs, q):
    return round(float(np.percentile(xs, q)), 4) if xs else None


def _load_request_trace(spec: str, seed: int) -> RequestTrace:
    if spec.endswith(".jsonl"):
        return RequestTrace.from_jsonl(spec)
    if spec == "serve-diurnal":
        return synthetic_request_trace("serve-diurnal", seed=seed)
    if spec == "serve-bursty":
        return synthetic_request_trace(
            "serve-bursty", seed=seed,
            bursts=((0.4, 0.55, 3.0),))
    raise SystemExit(f"unknown request trace {spec!r}: expected a .jsonl "
                     "path, 'serve-diurnal', or 'serve-bursty'")


def _step(sysobj) -> None:
    """One engine or cluster step, counted by the ``--profile`` trace."""
    sysobj.step()
    profiling.step()


def _trace_request(ev, rng: np.random.Generator, vocab: int) -> Request:
    return Request(rid=ev.rid,
                   prompt=rng.integers(1, vocab,
                                       size=(ev.prompt_len,)).tolist(),
                   max_new_tokens=ev.max_new_tokens,
                   arrival_s=ev.t_s, priority=ev.priority,
                   deadline_s=ev.t_s + ev.deadline_rel_s, slo=ev.slo)


def _replay_trace(args, engine: ServeEngine, trace: RequestTrace,
                  clock_state: dict, rng) -> list:
    """Replay arrivals on the virtual clock: between arrivals the engine
    steps (each step advances the clock by ``--step-cost-s``), and the
    revocation (if any) fires at its fractional position in the trace."""
    vocab = engine.model.cfg.vocab_size
    reqs = []
    warn_done = revoke_done = False
    t_warn = args.warn_at * trace.horizon_s if args.warn_at else None
    t_revoke = args.revoke_at * trace.horizon_s if args.revoke_at else None

    def mid_decode(req):
        return req is not None and req.generated \
            and req.remaining_tokens > args.grace_tokens

    def maybe_revoke():
        # revocations wait until a decode is genuinely in flight (a
        # warn/fire on an idle replica displaces no decoded work)
        nonlocal warn_done, revoke_done
        if t_warn is not None and not warn_done \
                and clock_state["t"] >= t_warn \
                and any(mid_decode(r) for r in engine.slots):
            migrated = engine.begin_drain(grace_tokens=args.grace_tokens)
            # single-engine driver: the replacement replica IS this engine
            # reopened, so migrated work comes right back in
            engine.draining = False
            for m in migrated:
                engine.submit(m)
            warn_done = True
        if t_revoke is not None and not revoke_done \
                and clock_state["t"] >= t_revoke \
                and engine.slots[0] is not None \
                and engine.slots[0].generated:
            engine.revoke_slot(0)
            revoke_done = True

    for ev in trace.events:
        while clock_state["t"] < ev.t_s and engine.has_work():
            _step(engine)
            clock_state["t"] += args.step_cost_s
            maybe_revoke()
        clock_state["t"] = max(clock_state["t"], ev.t_s)
        req = _trace_request(ev, rng, vocab)
        reqs.append(req)
        engine.submit(req)
    while engine.has_work():
        _step(engine)
        clock_state["t"] += args.step_cost_s
        maybe_revoke()
    return reqs


def _replay_trace_cluster(args, cluster: ServeCluster, trace: RequestTrace,
                          clock_state: dict, rng, vocab: int,
                          on_tick) -> list:
    """Cluster replay: arrivals route through the least-loaded picker,
    the warn/fire revocation hits a whole replica mid-decode (drain +
    page-ship/replay migration onto survivors), and ``on_tick`` runs the
    live-telemetry loop (sampler, monitor, autoscaler) after every
    virtual-clock advance."""
    reqs = []
    warn_done = revoke_done = False
    t_warn = args.warn_at * trace.horizon_s if args.warn_at else None
    t_revoke = args.revoke_at * trace.horizon_s if args.revoke_at else None

    def mid_decode(eng):
        return any(r is not None and r.generated
                   and r.remaining_tokens > args.grace_tokens
                   for r in eng.slots)

    def victim():
        # a replica with decoded work in flight, and at least one other
        # live replica to migrate onto
        live = [i for i, e in enumerate(cluster.replicas) if not e.draining]
        if len(live) < 2:
            return None
        return next((i for i in live
                     if mid_decode(cluster.replicas[i])), None)

    def maybe_revoke():
        nonlocal warn_done, revoke_done
        if t_warn is not None and not warn_done \
                and clock_state["t"] >= t_warn:
            idx = victim()
            if idx is not None:
                cluster.warn(idx, grace_tokens=args.grace_tokens)
                warn_done = True
        if t_revoke is not None and not revoke_done \
                and clock_state["t"] >= t_revoke:
            idx = victim()
            if idx is not None:
                cluster.revoke(idx)
                revoke_done = True

    def tick():
        maybe_revoke()
        on_tick()

    for ev in trace.events:
        while clock_state["t"] < ev.t_s and cluster.has_work():
            _step(cluster)
            clock_state["t"] += args.step_cost_s
            tick()
        clock_state["t"] = max(clock_state["t"], ev.t_s)
        tick()
        req = _trace_request(ev, rng, vocab)
        reqs.append(req)
        cluster.submit(req)
    while cluster.has_work():
        _step(cluster)
        clock_state["t"] += args.step_cost_s
        tick()
    return reqs


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="starcoder2-3b", choices=list_archs())
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the reduced config (default); --no-reduced "
                         "serves the model at full width")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; the CUDA kernels) or 'cpu' "
                         "(their plain PyTorch versions)")
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefill-mode", choices=("block", "token"),
                    default="block",
                    help="blocked prefill (one loop over the decode cell "
                         "per block) or one prompt token per engine step")
    ap.add_argument("--prefill-block", type=int, default=16,
                    help="max prompt tokens ingested per prefill step")
    ap.add_argument("--cache-impl", choices=("dense", "paged"),
                    default="dense",
                    help="KV-cache layout: dense per-slot rows or a paged "
                         "pool with per-request page tables")
    ap.add_argument("--page-size", type=int, default=16,
                    help="positions per KV page (paged cache only)")
    ap.add_argument("--num-pages", type=int, default=None,
                    help="pool size in pages (paged cache only; default "
                         "is capacity-equivalent to the dense layout)")
    ap.add_argument("--queue", choices=("fifo", "slo"), default="fifo",
                    help="request queue discipline")
    ap.add_argument("--queue-capacity", type=int, default=None,
                    help="SLO queue backlog bound (admission control)")
    ap.add_argument("--trace", default=None, metavar="SPEC",
                    help="replay a request trace: 'serve-diurnal', "
                         "'serve-bursty', or a RequestTrace .jsonl path")
    ap.add_argument("--step-cost-s", type=float, default=0.05,
                    help="virtual seconds one engine step costs during "
                         "trace replay")
    ap.add_argument("--warn-at", type=float, default=None, metavar="FRAC",
                    help="begin a graceful drain (migration) at this "
                         "fraction of the trace horizon")
    ap.add_argument("--revoke-at", type=float, default=None, metavar="FRAC",
                    help="fire a revocation at this fraction of the trace "
                         "horizon")
    ap.add_argument("--grace-tokens", type=int, default=4,
                    help="decodes within this many tokens of done finish "
                         "on a draining replica")
    # -- fleet / live telemetry ---------------------------------------------
    ap.add_argument("--replicas", type=int, default=1,
                    help="run a ServeCluster with this many replicas "
                         "(shared steps and weights); >1 enables replica-"
                         "level warn/fire revocation")
    ap.add_argument("--autoscale", action="store_true",
                    help="let ReplicaAutoscaler replan the replica count "
                         "(consumes SLO alerts when --monitor is on)")
    ap.add_argument("--min-replicas", type=int, default=1)
    ap.add_argument("--max-replicas", type=int, default=4)
    ap.add_argument("--target-util", type=float, default=0.75)
    ap.add_argument("--scale-interval-s", type=float, default=2.0,
                    help="virtual seconds between autoscaler decisions")
    ap.add_argument("--monitor", action="store_true",
                    help="attach the SLO burn-rate monitor (alerts print "
                         "in the summary and feed the autoscaler)")
    ap.add_argument("--slo-attainment", type=float, default=0.9,
                    help="SLO attainment target the burn rate burns "
                         "against")
    ap.add_argument("--slo-ttft-s", type=float, default=None,
                    help="per-request TTFT bound counted into attainment")
    ap.add_argument("--burn-threshold", type=float, default=2.0)
    ap.add_argument("--slo-window-s", type=float, default=30.0,
                    help="long burn window (short window = 1/6 of this)")
    ap.add_argument("--sample-interval-s", type=float, default=1.0,
                    help="virtual-clock cadence of the time-series "
                         "sampler")
    ap.add_argument("--series-out", default=None, metavar="PATH",
                    help="export sampled time-series as JSONL")
    ap.add_argument("--report", default=None, metavar="PATH",
                    help="render the HTML ops report (time-series + "
                         "alerts + per-replica summary) here")
    add_obs_args(ap)
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> Tuple[Model, dict]:
    """The model on ``args.device`` and its parameters, drawn from
    ``args.seed``. The kernels (attention, SSD scan, WKV) run on the card
    and their plain versions on the CPU."""
    impl = "torch" if torch.device(args.device).type == "cpu" else "cuda"
    cfg = get_config(args.arch, reduced=args.reduced).replace(
        attn_impl=impl, ssm_impl=impl, rwkv_impl=impl)
    if cfg.family == "encdec":
        raise SystemExit("serve driver targets decoder-only families; "
                         "seamless decode is exercised by the dry-run")
    model = build_model(cfg, args.device)
    return model, model.init(model.generator(args.seed))


def make_engine(args: argparse.Namespace, model: Model, params: dict,
                **kwargs) -> ServeEngine:
    """One engine as the flags say, with its own queue; ``kwargs``
    (recorder, clock, shared_fns) go to ``ServeEngine``."""
    queue = SLOQueue(capacity=args.queue_capacity) \
        if args.queue == "slo" else FIFOQueue()
    return ServeEngine(model, params, max_batch=args.max_batch,
                       max_len=args.max_len, queue=queue,
                       prefill=args.prefill_mode,
                       prefill_block=args.prefill_block,
                       cache_impl=args.cache_impl, page_size=args.page_size,
                       num_pages=args.num_pages, **kwargs)


def make_requests(args: argparse.Namespace, vocab: int,
                  rng: Optional[np.random.Generator] = None
                  ) -> List[Request]:
    rng = rng if rng is not None else np.random.default_rng(args.seed)
    return [Request(rid=rid,
                    prompt=rng.integers(1, vocab,
                                        size=(args.prompt_len,)).tolist(),
                    max_new_tokens=args.max_new_tokens)
            for rid in range(args.requests)]


def summarize(args: argparse.Namespace, stats, reqs: List[Request],
              steps: Optional[int], wall: float) -> dict:
    """The reference's summary keys (and the port's device keys) for an
    engine or a cluster (``stats``)."""
    done = [r for r in reqs if r.done]
    ttfts = [r.timing.ttft_s for r in done if r.timing.ttft_s is not None]
    tpots = [t for t in (r.timing.tpot_s(len(r.generated)) for r in done)
             if t is not None]
    attained = [r for r in done if r.timing.t_complete <= r.deadline_s]
    eng = stats.replicas[0] if isinstance(stats, ServeCluster) else stats
    dev = eng.device
    return {
        "arch": args.arch, "reduced": args.reduced,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "attn_impl": eng.model.cfg.attn_impl,
        "ssm_impl": eng.model.cfg.ssm_impl,
        "rwkv_impl": eng.model.cfg.rwkv_impl,
        "requests": len(reqs), "completed": len(done),
        "rejected": stats.requests_rejected,
        "engine_steps": steps, "tokens_decoded": stats.tokens_decoded,
        "tokens_lost": stats.tokens_lost,
        "tokens_replayed": stats.tokens_replayed,
        "wall_s": round(wall, 2),
        "tokens_per_s": round(stats.tokens_decoded / max(wall, 1e-9), 1),
        "ttft_p50_s": _pct(ttfts, 50), "ttft_p95_s": _pct(ttfts, 95),
        "tpot_p50_s": _pct(tpots, 50), "tpot_p95_s": _pct(tpots, 95),
        "attainment": round(len(attained) / len(reqs), 4) if reqs else None,
    }


def run(args: argparse.Namespace, model: Optional[Model] = None,
        params: Optional[dict] = None) -> Tuple[dict, list, object]:
    """Serve as the flags say, on ``model``/``params`` if given (else
    built from the flags). Returns (summary, requests, the engine or
    cluster)."""
    if model is None:
        model, params = build(args)
    cfg = model.cfg
    rng = np.random.default_rng(args.seed)
    rec, traced = recorder_from_args(
        args, meta={"driver": "serve", "arch": args.arch,
                    "trace": args.trace, "queue": args.queue,
                    "prefill": args.prefill_mode,
                    "replicas": args.replicas})
    clock_state = {"t": 0.0}
    engine_clock = (lambda: clock_state["t"]) if args.trace else None
    use_cluster = bool(args.replicas > 1 or args.autoscale or args.monitor
                       or args.report or args.series_out)
    monitor = sampler = scaler = cluster = engine = None
    if args.monitor:
        monitor = SLOMonitor(SLOSpec(
            attainment_target=args.slo_attainment,
            ttft_target_s=(args.slo_ttft_s if args.slo_ttft_s is not None
                           else math.inf),
            long_window_s=args.slo_window_s,
            short_window_s=args.slo_window_s / 6.0,
            burn_threshold=args.burn_threshold), recorder=rec)
    if args.autoscale:
        scaler = ReplicaAutoscaler(min_replicas=args.min_replicas,
                                   max_replicas=args.max_replicas,
                                   target_util=args.target_util)

    if use_cluster:
        shared = {}

        def new_engine():
            eng = make_engine(args, model, params, recorder=rec,
                              clock=engine_clock,
                              shared_fns=shared.get("fns"))
            shared.setdefault("fns", eng.shared_fns)
            return eng

        cluster = ServeCluster(new_engine, n_replicas=args.replicas,
                               clock=engine_clock, recorder=rec,
                               monitor=monitor)
        if args.report or args.series_out:
            sampler = TimeSeriesSampler(interval_s=args.sample_interval_s)
            attach_serve_cluster(sampler, cluster)
        last_scale = {"t": -math.inf}

        def on_tick():
            t = cluster.clock()
            if sampler is not None:
                sampler.maybe_sample(t)
            if monitor is not None:
                monitor.evaluate(now=t)
            if scaler is not None \
                    and t - last_scale["t"] >= args.scale_interval_s:
                last_scale["t"] = t
                live = sum(1 for e in cluster.replicas if not e.draining)
                dec = scaler.act(ServeLoad(
                    t_s=t, utilization=cluster.load,
                    queue_depth=cluster.queue_depth, n_replicas=live,
                    slots_per_replica=args.max_batch,
                    alerts=(monitor.recent_alerts(now=t)
                            if monitor is not None else ())))
                if dec.n_replicas != live:
                    cluster.scale_to(dec.n_replicas)
    else:
        engine = make_engine(args, model, params, recorder=rec,
                             clock=engine_clock)

    t0 = time.monotonic()
    if args.trace:
        trace = _load_request_trace(args.trace, args.seed)
        if use_cluster:
            reqs = _replay_trace_cluster(args, cluster, trace, clock_state,
                                         rng, cfg.vocab_size, on_tick)
        else:
            reqs = _replay_trace(args, engine, trace, clock_state, rng)
        steps = None
    else:
        reqs = make_requests(args, cfg.vocab_size, rng)
        sysobj = cluster if use_cluster else engine
        for req in reqs:
            sysobj.submit(req)
        steps = 0
        while sysobj.has_work() and steps < 10_000:
            _step(sysobj)
            steps += 1
            if use_cluster:
                on_tick()
        if not use_cluster and engine.has_work():
            raise RuntimeError(f"the engine left work after {steps} steps")
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    wall = time.monotonic() - t0

    stats = cluster if use_cluster else engine
    out = summarize(args, stats, reqs, steps, wall)
    if use_cluster:
        out["replicas_spawned"] = cluster._next_rid
        out["replica_seconds"] = round(cluster.replica_seconds, 2)
        out["pages_shipped"] = cluster.pages_shipped
        out["requests_imported"] = cluster.requests_imported
    if monitor is not None:
        out["alerts"] = [a.to_json() for a in monitor.alerts]
    if sampler is not None and args.series_out:
        out["series"] = sampler.write_jsonl(args.series_out)
    if sampler is not None and args.report:
        from repro_torch.obs.report import render_report, validate_report
        doc = render_report(
            series=sampler.series(),
            alerts=monitor.alerts if monitor is not None else [],
            replicas=cluster.replica_summaries(),
            summary={"arch": args.arch, "requests": len(reqs),
                     "completed": out["completed"],
                     "attainment": out["attainment"],
                     "tokens_decoded": stats.tokens_decoded,
                     "replica_seconds": out["replica_seconds"]},
            title=f"serve ops report · {args.arch}"
                  f"{' · ' + args.trace if args.trace else ''}")
        validate_report(doc)
        with open(args.report, "w") as f:
            f.write(doc)
        out["report"] = args.report
    # trace replays live on the virtual clock -> sim timeline; ad-hoc
    # runs keep the host-clock axis
    out.update(finalize_recorder(args, rec, traced,
                                 clock="sim" if args.trace else "wall"))
    return out, reqs, stats


def main(argv: Optional[List[str]] = None) -> dict:
    out, _, _ = run(parse_args(argv))
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
