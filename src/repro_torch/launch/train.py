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

``--gym`` replays a market trace (``--trace``) through the training gym:
an online policy (``--policy``) plans the fleet, the realized membership
timeline trains the model with the elastic runtime (``--steps`` steps,
``--full`` for the published widths, where the reference always trains
the reduced config), and ``--gym-async-updates`` replays it through the
async parameter server for the staleness histogram. Its summary has the
reference's keys, plus the device, ``reduced``, the per-step losses and
wall times, and each phase's seconds with the async-PS pushes per second.

``--events PATH`` records the run's event log (the trainer's, the
elastic runtime's or the gym's events, as the reference records them)
and ``--profile DIR`` a ``torch.profiler`` trace of its first
few steps beside it (``launch/obs_args.py``); the paths
join the summary.
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
from repro_torch.device import resolve_device
from repro_torch.launch.obs_args import (add_obs_args, finalize_recorder,
                                         recorder_from_args)
from repro_torch.models.builder import build_model
from repro_torch.obs import profiling
from repro_torch.train.step import TrainState, init_state
from repro_torch.train.trainer import Trainer


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
    ap.add_argument("--trace", default="calm",
                    help="trace file (.jsonl/.npz) or synthetic name "
                         "(calm|volatile|bursty)")
    ap.add_argument("--policy", default="static",
                    choices=["static", "greedy", "lookahead"])
    ap.add_argument("--gym-total-steps", type=int, default=64_000,
                    help="virtual workload the trace replay simulates "
                         "(--steps real steps are trained against it)")
    ap.add_argument("--gym-epoch-s", type=float, default=1800.0)
    ap.add_argument("--gym-async-updates", type=int, default=0,
                    help=">0: also replay through the async-PS simulator "
                         "for the staleness histogram")
    add_obs_args(ap)
    return ap.parse_args(argv)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_gym(args: argparse.Namespace, rec=None
            ) -> Tuple[Dict[str, Any], Any]:
    """The ``--gym --trace ...`` path: replay a market trace end to end.

    A ``TransientGym`` plans the fleet against the trace (with the chosen
    online policy replanning at decision epochs), then trains the
    realized membership timeline with the elastic runtime on
    ``--device`` and, with ``--gym-async-updates``, replays it through
    the async PS. The phases are ``TransientGym.run``'s, called one by
    one so each is timed; ``rec`` records them. Returns (summary, ledger).
    """
    from repro_torch.core.policy import (GreedyCheapest, LookaheadMC,
                                         PolicyDecision, StaticPolicy)
    from repro_torch.gym import (TransientGym, execute_async_ps,
                                 execute_masked)
    from repro_torch.traces import load_trace

    dev = resolve_device(args.device)
    trace = load_trace(args.trace, seed=args.seed)
    if args.policy == "static":
        policy = StaticPolicy(PolicyDecision(args.server_kind,
                                             args.initial_workers))
    elif args.policy == "greedy":
        policy = GreedyCheapest(n_workers=args.initial_workers)
    else:
        policy = LookaheadMC(seed=args.seed)
    gym = TransientGym(trace, policy, total_steps=args.gym_total_steps,
                       epoch_s=args.gym_epoch_s, refill=args.policy != "static",
                       seed=args.seed, recorder=rec)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    ledger = gym.plan()
    t_plan = time.monotonic()
    execute_masked(ledger, arch=args.arch, train_steps=args.steps,
                   seq_len=args.seq_len, seed=gym.seed, ckpt=ckpt,
                   recorder=gym.rec, reduced=args.reduced, device=dev)
    _sync(dev)
    t_train = time.monotonic()
    if args.gym_async_updates > 0:
        execute_async_ps(ledger, updates=args.gym_async_updates,
                         seed=gym.seed, recorder=gym.rec, device=dev)
        _sync(dev)
    t_end = time.monotonic()
    out = ledger.to_dict()
    out["wall_s"] = round(t_end - t0, 2)
    del out["epochs"], out["schedule"]          # keep stdout scannable
    out["n_epochs"] = len(ledger.epochs)
    out["n_events"] = len(ledger.schedule)
    pushes = sum(ledger.staleness_hist.values())
    out.update({
        "arch": args.arch, "reduced": args.reduced, "steps": args.steps,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else dev.type),
        "loss_first": ledger.losses[0] if ledger.losses else None,
        "loss_last": ledger.losses[-1] if ledger.losses else None,
        "losses": list(ledger.losses), "step_s": list(ledger.step_s),
        "plan_s": t_plan - t0, "train_s": t_train - t_plan,
        "async_s": t_end - t_train, "async_pushes": pushes,
        "async_pushes_per_s": (pushes / (t_end - t_train) if pushes
                               else None),
        "peak_device_memory_bytes": (torch.cuda.max_memory_allocated(dev)
                                     if dev.type == "cuda" else None),
    })
    return out, ledger


def run(args: argparse.Namespace
        ) -> Tuple[Dict[str, Any], Any, Optional[TrainState]]:
    """Train as the flags say; returns (summary, the ``Trainer`` or, with
    ``--elastic``, the ``ElasticRuntime``, final state), or with
    ``--gym`` (summary, the ``GymLedger``, None)."""
    if args.gym:
        rec, traced = recorder_from_args(
            args, meta={"driver": "gym", "trace": args.trace,
                        "policy": args.policy, "arch": args.arch})
        out, ledger = run_gym(args, rec)
        out.update(finalize_recorder(args, rec, traced, clock="sim"))
        return out, ledger, None
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

    rec, traced = recorder_from_args(
        args, meta={"driver": "elastic" if args.elastic else "trainer",
                    "arch": args.arch, "steps": args.steps})
    per_step: List[Dict[str, float]] = []
    clock = [time.monotonic()]

    def on_step(step: int, m: Dict) -> None:
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # syncs
        now = time.monotonic()
        per_step.append({"loss": loss, "grad_norm": gnorm,
                         "step_s": now - clock[0]})
        clock[0] = now
        profiling.step()

    t0 = time.monotonic()
    extra: Dict[str, Any] = {}
    if args.elastic:
        cluster = SparseCluster(max_slots=args.slots)
        for s in range(args.initial_workers):
            cluster.fill_and_activate(s, 0, kind=args.server_kind)
        loop = ElasticRuntime(model, tcfg, ds, cluster, ckpt, recorder=rec)
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
        loop = Trainer(model, tcfg, ds, ckpt, recorder=rec)
        state = loop.init_or_restore()
        clock[0] = time.monotonic()
        state = loop.fit(state, args.steps, on_step=on_step)
        log = loop.metrics_log
        step_s = [r["step_s"] for r in per_step]
    _sync(dev)
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
    out.update(finalize_recorder(args, rec, traced, clock="sim"))
    return out, loop, state


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    out, _, _ = run(parse_args(argv))
    print(json.dumps(out, indent=1))
    return out


if __name__ == "__main__":
    main()
