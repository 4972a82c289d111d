"""Serving entry point: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Batched decode on the slot-based continuous-batching engine, on the card
by default (``--device cpu`` runs the plain PyTorch path on the CPU).
Serves the dense family (the default, starcoder2-3b), zamba2-1.2b
(hybrid) and rwkv6-7b (recurrent).
``--requests N`` synthetic prompts are submitted up front (more requests
than slots: admission and retirement in waves). Mirrors the single-engine,
non-trace flags of ``repro.launch.serve``; ``--reduced`` is on by default
and ``--no-reduced`` serves the full-width model. Parameters are drawn
from ``--seed``. Throughput and TTFT/TPOT percentiles print as JSON.

Not ported yet (ROADMAP.md Queue 1): the paged cache (item 3); trace
replay, multiple replicas, autoscaling, the SLO monitor and event
recording (item 4).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import get_config, list_archs
from repro_torch.models.builder import Model, build_model
from repro_torch.serving import FIFOQueue, Request, ServeEngine, SLOQueue


def _pct(xs, q):
    return round(float(np.percentile(xs, q)), 4) if xs else None


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
    ap.add_argument("--queue", choices=("fifo", "slo"), default="fifo",
                    help="request queue discipline")
    ap.add_argument("--queue-capacity", type=int, default=None,
                    help="SLO queue backlog bound (admission control)")
    return ap.parse_args(argv)


def build(args: argparse.Namespace) -> Tuple[Model, dict]:
    """The model on ``args.device`` and its parameters, drawn from
    ``args.seed``. The kernels (attention, SSD scan, WKV) run on the card
    and their plain versions on the CPU."""
    impl = "torch" if torch.device(args.device).type == "cpu" else "cuda"
    cfg = get_config(args.arch, reduced=args.reduced).replace(
        attn_impl=impl, ssm_impl=impl, rwkv_impl=impl)
    model = build_model(cfg, args.device)
    return model, model.init(model.generator(args.seed))


def make_engine(args: argparse.Namespace, model: Model,
                params: dict) -> ServeEngine:
    queue = SLOQueue(capacity=args.queue_capacity) \
        if args.queue == "slo" else FIFOQueue()
    return ServeEngine(model, params, max_batch=args.max_batch,
                       max_len=args.max_len, queue=queue,
                       prefill=args.prefill_mode,
                       prefill_block=args.prefill_block)


def make_requests(args: argparse.Namespace, vocab: int) -> List[Request]:
    rng = np.random.default_rng(args.seed)
    return [Request(rid=rid,
                    prompt=rng.integers(1, vocab,
                                        size=(args.prompt_len,)).tolist(),
                    max_new_tokens=args.max_new_tokens)
            for rid in range(args.requests)]


def summarize(args: argparse.Namespace, engine: ServeEngine,
              reqs: List[Request], steps: int, wall: float) -> dict:
    done = [r for r in reqs if r.done]
    ttfts = [r.timing.ttft_s for r in done if r.timing.ttft_s is not None]
    tpots = [t for t in (r.timing.tpot_s(len(r.generated)) for r in done)
             if t is not None]
    attained = [r for r in done if r.timing.t_complete <= r.deadline_s]
    dev = engine.device
    return {
        "arch": args.arch, "reduced": args.reduced,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "attn_impl": engine.model.cfg.attn_impl,
        "ssm_impl": engine.model.cfg.ssm_impl,
        "rwkv_impl": engine.model.cfg.rwkv_impl,
        "requests": len(reqs), "completed": len(done),
        "rejected": engine.requests_rejected,
        "engine_steps": steps, "tokens_decoded": engine.tokens_decoded,
        "tokens_lost": engine.tokens_lost,
        "tokens_replayed": engine.tokens_replayed,
        "wall_s": round(wall, 2),
        "tokens_per_s": round(engine.tokens_decoded / max(wall, 1e-9), 1),
        "ttft_p50_s": _pct(ttfts, 50), "ttft_p95_s": _pct(ttfts, 95),
        "tpot_p50_s": _pct(tpots, 50), "tpot_p95_s": _pct(tpots, 95),
        "attainment": round(len(attained) / len(reqs), 4) if reqs else None,
    }


def main(argv: Optional[List[str]] = None) -> dict:
    args = parse_args(argv)
    model, params = build(args)
    engine = make_engine(args, model, params)
    reqs = make_requests(args, model.cfg.vocab_size)
    t0 = time.monotonic()
    for req in reqs:
        engine.submit(req)
    steps = engine.run_to_completion()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    out = summarize(args, engine, reqs, steps, time.monotonic() - t0)
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
