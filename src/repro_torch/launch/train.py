"""Training entry point: ``python -m repro_torch.launch.train --arch <id> [...]``.

Single-process end-to-end training with the transient runtime wired in:
the sharded deterministic data pipeline, masked elastic membership
(sparse mapping, ``--elastic``) with the adaptive LR, master-less
checkpointing (``--ckpt-dir``) and a revocation trace, either a schedule
(``--join-every``, ``--revoke-at``) or Monte-Carlo lifetimes drawn from
the paper-calibrated distributions (``--monte-carlo``). On the card by
default (``--device cpu`` runs on the CPU). The flags are the
reference's (``repro.launch.train``), ``--reduced`` on by default and
``--full`` for the published widths; the JSON summary has its keys
(``loss_first``, ``loss_last``, ``wall_s``, ``final_step``, ...) plus the
device, the implementations that trained, the per-step losses, gradient
norms and wall times, and the peak device memory; with ``--elastic``
also each step's active workers and LR and the fast saves' count,
seconds and bytes.

None of the port's kernels has a backward (the reference's Pallas
kernels have none either), so the differentiated forward runs the plain
paths, ``attn_impl``, ``ssm_impl`` and ``rwkv_impl`` all ``"torch"``
(the q-chunked attention, the chunked SSD form, the sequential WKV
scan), on every device; the summary says so. Full-width training of
rwkv6-7b does not fit one card (about 120 GB of float32 masters and
moments).

Not ported yet: ``--gym`` (ROADMAP.md Queue 1 item 2e, the gym's execute
path) and the ``--events``/``--profile`` recorder flags (Queue 1
item 4).
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import (OptimizerConfig, ScheduleConfig, TrainConfig,
                                get_config, list_archs)
from repro_torch.core import (CheckpointManager, ElasticRuntime,
                              RevocationEvent, SparseCluster)
from repro_torch.core.transient import LIFETIMES
from repro_torch.data.pipeline import ShardedDataset
from repro_torch.models.builder import build_model
from repro_torch.train.step import TrainState, init_state
from repro_torch.train.trainer import Trainer

_NOT_PORTED = {
    "gym": "ROADMAP.md Queue 1 item 2e (the gym's execute path)",
}


def build_trace(args, rng: np.random.Generator) -> List[RevocationEvent]:
    """Revocation/join events: explicit schedule or sampled lifetimes."""
    events = []
    if args.join_every:
        for i in range(1, args.slots):
            events.append(RevocationEvent(step=i * args.join_every, slot=i,
                                          kind="join"))
    if args.revoke_at is not None:
        events.append(RevocationEvent(step=max(0, args.revoke_at - 1),
                                      slot=0, kind="warn"))
        events.append(RevocationEvent(step=args.revoke_at, slot=0,
                                      kind="revoke"))
    if args.monte_carlo:
        # sample a lifetime per initially-active slot; convert to steps via
        # the configured steps/sec so traces match the paper's timescales
        life = LIFETIMES[args.server_kind]
        for s in range(args.initial_workers):
            t_s = life.sample(rng, 1)[0]
            step = int(t_s * args.steps_per_sec)
            if step < args.steps:
                events.append(RevocationEvent(step=max(0, step - 1), slot=s,
                                              kind="warn"))
                events.append(RevocationEvent(step=step, slot=s,
                                              kind="revoke"))
    return events


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="starcoder2-3b", choices=list_archs())
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default) or 'cpu'")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "momentum"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=100)
    # elastic / transient options
    ap.add_argument("--elastic", action="store_true",
                    help="use slot-masked elastic runtime (sparse mapping)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--initial-workers", type=int, default=1)
    ap.add_argument("--join-every", type=int, default=0,
                    help="fill one slot every N steps (paper Fig 5)")
    ap.add_argument("--revoke-at", type=int, default=None)
    ap.add_argument("--monte-carlo", action="store_true",
                    help="sample revocations from paper lifetime CDFs")
    ap.add_argument("--server-kind", default="K80")
    ap.add_argument("--steps-per-sec", type=float, default=4.5)
    ap.add_argument("--naive-lr", action="store_true",
                    help="disable adaptive LR (paper's TF default)")
    ap.add_argument("--seed", type=int, default=0)
    # gym: trace-driven end-to-end replay (market trace -> real training)
    ap.add_argument("--gym", action="store_true",
                    help="replay a market trace through the training gym")
    ap.add_argument("--trace", default="calm")
    ap.add_argument("--policy", default="static",
                    choices=["static", "greedy", "lookahead"])
    ap.add_argument("--gym-total-steps", type=int, default=64_000)
    ap.add_argument("--gym-epoch-s", type=float, default=1800.0)
    ap.add_argument("--gym-async-updates", type=int, default=0)
    return ap.parse_args(argv)


def run(args: argparse.Namespace) -> Tuple[Dict[str, Any], Any, TrainState]:
    """Train as the flags say; returns (summary, the ``Trainer`` or, with
    ``--elastic``, the ``ElasticRuntime``, final state)."""
    for flag, where in _NOT_PORTED.items():
        if getattr(args, flag):
            raise NotImplementedError(
                f"--{flag.replace('_', '-')} is not ported to PyTorch yet; "
                f"see {where}")
    # the kernels have no backward: train through the plain paths
    cfg = get_config(args.arch, reduced=args.reduced).replace(
        attn_impl="torch", ssm_impl="torch", rwkv_impl="torch")
    model = build_model(cfg, args.device)
    dev = model.device
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr,
                                  adaptive_lr=not args.naive_lr,
                                  base_workers=1),
        schedule=ScheduleConfig(kind="cosine", warmup_steps=20,
                                total_steps=args.steps),
        checkpoint_every=args.checkpoint_every,
        seed=args.seed)
    ds = ShardedDataset(cfg, global_batch=args.global_batch,
                        seq_len=args.seq_len, seed=args.seed,
                        device=str(dev))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    per_step: List[Dict[str, float]] = []
    clock = [time.monotonic()]

    def on_step(step: int, m: Dict) -> None:
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # syncs
        now = time.monotonic()
        per_step.append({"loss": loss, "grad_norm": gnorm,
                         "step_s": now - clock[0]})
        clock[0] = now

    t0 = time.monotonic()
    extra: Dict[str, Any] = {}
    if args.elastic:
        cluster = SparseCluster(max_slots=args.slots)
        for s in range(args.initial_workers):
            cluster.fill_and_activate(s, 0, kind=args.server_kind)
        loop = ElasticRuntime(model, tcfg, ds, cluster, ckpt)
        loop.add_events(build_trace(args, np.random.default_rng(args.seed)))
        state = init_state(model, tcfg)
        state = loop.run(state, args.steps, on_step=on_step)
        log = loop.metrics_log
        extra = {
            "slots": args.slots, "active": [r["active"] for r in log],
            "lr": [r["lr"] for r in log], "fast_saves": loop.fast_saves,
            "fast_save_s": [r["seconds"] for r in loop.fast_save_log],
            "fast_save_bytes": [r["bytes"] for r in loop.fast_save_log],
        }
        step_s = loop.step_seconds
    else:
        loop = Trainer(model, tcfg, ds, ckpt)
        state = loop.init_or_restore()
        clock[0] = time.monotonic()
        state = loop.fit(state, args.steps, on_step=on_step)
        log = loop.metrics_log
        step_s = [r["step_s"] for r in per_step]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.monotonic() - t0
    first, last = log[0], log[-1]
    out = {
        "arch": args.arch, "reduced": args.reduced, "steps": args.steps,
        "wall_s": round(wall, 2),
        "loss_first": round(float(first["loss"]), 4),
        "loss_last": round(float(last["loss"]), 4),
        "elastic": args.elastic,
        "final_step": int(state.step),
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "attn_impl": cfg.attn_impl,
        "ssm_impl": cfg.ssm_impl, "rwkv_impl": cfg.rwkv_impl,
        "attn_impl_note": "the kernels have no backward; training "
                          "differentiates the plain paths",
        "global_batch": args.global_batch, "seq_len": args.seq_len,
        "losses": [r["loss"] for r in per_step],
        "grad_norms": [r["grad_norm"] for r in per_step],
        "step_s": step_s,
        "peak_device_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None),
        **extra,
    }
    return out, loop, state


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    out, _, _ = run(parse_args(argv))
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
