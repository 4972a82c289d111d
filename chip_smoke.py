#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths at full width with random weights from a
seed, through the four hand-written CUDA kernels (decode attention,
flash attention, the Mamba-2 SSD scan and the RWKV-6 WKV recurrence):
serving starcoder2-3b (30 layers, d_model 3072, 24 heads / 2 KV heads,
bf16) with the dense and the paged cache and as a fleet of transient
replicas replaying a request trace, its full-sequence forward, its training step and its training on
transient servers (elastic slots, the warning's fast save, restore);
the paper's ResNet-32 trained elastically and through the trace-driven
gym; the full-width
forwards of zamba2-1.2b (38 Mamba-2 layers, d_model 2048, 64 SSM heads x
P 64, N 64, a shared attention block every 6 layers) and rwkv6-7b (32
layers, d_model 4096, 64 heads x 64, d_ff 14336); and serving both. In
phases that each print their name and ``ok``:

1. environment: torch, CUDA, the card and its power limit;
2. build: compile the four kernels from ``src/repro_torch`` with nvcc,
   one nvcc per source, started together, and print their ptxas lines;
3. kernel-vs-plain: the decode kernel against its plain PyTorch version
   on the serve shape, a long cache, a window, one KV head, ragged
   lengths (0 and past the cache), zamba2's shared block (H = KV = 32,
   D = 64) and the tensor-core path's tile edges (S = 65, G = 48 with a
   window), in bf16 and fp32, with the split plan, one split and three;
4. flash-vs-plain: the flash kernel against its plain version on the
   starcoder2 forward shape, a gemma3 local layer, MQA, a ragged length,
   non-causal attention, D=64, zamba2's shared block and the wgmma
   kernel's tile edges (S = 127, 129, a window that cuts a tile, and
   Sq = 129 against Sk = 127 at D = 64), in bf16 and fp32; and, at
   D = 64, where P meets V in fp16, V far beyond either end of fp16's
   range;
5. ssd-vs-plain: the SSD kernels (bf16: tensor cores; fp32: CUDA
   cores) against their plain version (the per-token recurrence) on
   zamba2's forward shape, a ragged S, fast decays, head counts that are
   not a multiple of the bf16 kernel's two-head blocks (3, 5), S = 63, 64
   and 65, P = N = 32 and a long (8192-token) slowly decaying sequence,
   with B and C read as column slices, in bf16 and fp32;
6. rwkv6-vs-plain: the WKV kernel against its plain version, every shape
   with r, k, v (and o) in bf16 and in fp32: rwkv6's forward shape with
   pathological decays, with a nonzero and a zero initial state, r, k, v
   as views of one fused projection and as the model's contiguous
   tensors; a ragged S; S = 1, 31, 32, 33 around the kernel's 32-token
   blocks; D = 16 and 32; and 8192 slowly decaying tokens (the largest
   state); outputs and final states (float32);
7. decode-cell: full-width starcoder2 decode steps with the kernel and
   with the plain version on the same cache; logits must agree;
8. serve: the serve entry point's engine answers 8 requests undisturbed,
   then again with a hard revocation of one slot and a drain that
   migrates work to a second engine; the migrated tokens must equal the
   undisturbed ones, and the kernel must have run once per layer per
   decode cell;
9. serve-paged: the same 8 requests through the paged cache (pages of
   16 positions): tokens equal to the dense engine's and the decode
   kernel once per layer per cell; the drain ships the decoding
   requests' pages to the second engine (pages shipped, no replay, the
   undisturbed tokens); then the host wall per decode step and the
   device busy share of profiled steps, dense and paged in turns, with
   the device time of the paged cell's gathers;
10. serve-fleet: ``launch.serve`` (through its ``run``) on a serve-bursty
   trace written with the port's ``RequestTrace.to_jsonl`` (seed 0,
   ``FLEET_HORIZON_S`` of virtual time): a 2-replica paged fleet with the
   SLO queue, the autoscaler (2 to 3 replicas), the monitor, a warning
   at 40% and a revocation at 70% of the horizon, the event log, time
   series, ops report and a profiler trace of the first steps. Every
   request completed or rejected, the revocation lost tokens, the
   warning moved work, the report, the event log and the Chrome traces
   validate, each completed request's tokens equal one undisturbed dense
   engine's, and the decode kernel ran once per layer per cell; wall,
   decode cells, host tokens/s, replicas spawned and the virtual-clock
   TTFT/TPOT (not card times);
11. profile: one decode step under torch.profiler (device busy share);
12. forward: ``Model.apply`` of starcoder2-3b on one batch of 4 x 2048
    tokens through the flash kernel and through the plain attention;
    logits must agree, and the kernel must run once per layer; device
    time from torch.profiler;
13. train: three steps of ``python -m repro_torch.launch.train --full``
    (through its ``run``), finite losses and gradient norms, the first
    loss near ln(vocab); a fourth step under torch.profiler; then
    ``evaluate_accuracy`` of the trained weights through the flash kernel
    and through the plain attention;
14. train-parity: three ``Trainer.fit`` steps of reduced starcoder2-3b,
    gemma3-27b, zamba2-1.2b and rwkv6-7b in float32 on the card against
    the same steps on the CPU, from the same numpy weights;
15. elastic: ``launch.train --full --elastic`` of starcoder2-3b (through
    its ``run``): 2 slots, a worker joining at step 1, slot 0 warned at
    step 2 (a fast save of the whole AdamW state into ``CKPT_DIR``) and
    revoked at step 3; the active counts must be [1, 2, 2, 1], the LR
    follow them, the losses and gradient norms be finite and the first
    loss lie in [ln(vocab), 12.3]; the fast save's seconds, bytes and
    GB/s against GCE's 30 s warning. Then the state is freed, the fast
    save restored onto the card and steps 2 and 3 replayed from it (their
    losses within ``RESUME_TOL`` of the uninterrupted run's), and the
    result evaluated through the flash kernel and the plain attention:
    the phase must launch flash once per layer and no other kernel;
16. checkpoint-resume: reduced starcoder2-3b in float32 on the card with
    two replicas: a corrupted replica fails over to the other, a torn
    write (``fail_after_bytes``) leaves the previous step restorable and
    no ``.tmp_`` debris, and the resumed run equals the uninterrupted one
    within ``CKPT_PARAM_TOL`` / ``RESUME_TOL``;
17. resnet32: the paper's ResNet-32 at its published size through
    ``launch.train --elastic`` (momentum, global batch 128 over 4 slots,
    a join every 5 steps, one warned revocation, 20 steps): the active
    counts as scheduled, finite losses, steps/s, and 5 more steps under
    torch.profiler for the device-busy share; the first step's loss and
    gradients in float32 on the card held to float64 on the CPU (and
    the run's bf16 first loss to ``RESNET_BF16_TOL``). The reference's
    initialisation (scale-1 projections, GroupNorm) gives logits of tens,
    so the first loss is far above ln 10;
18. gym: ``launch.train --gym`` (through its ``run``) of the volatile
    trace with the greedy policy over 4 workers, training the paper's
    ResNet-32 at its published size for 64 steps on the mixed K80/P100
    plan (the hetero allocator) and replaying it through the async PS
    (384 pushes): the plan completes, the executed steps are the
    schedule's, the loss falls, every push is counted and the mean
    staleness is above 0.5; wall, per-step, plan and async-PS times.
    Then a revocation of the intensity-sweep trace whose warning
    fast-saves a checkpoint that ``restore_latest`` finds, and the
    execute paths at reduced size in float32 on the card against the
    CPU from the same weights: the final loss within ``GYM_LOSS_TOL``,
    equal staleness histograms, the PS params within ``GYM_PS_TOL``
    after ``GYM_PS_UPDATES`` pushes;
19. hybrid-forward: ``Model.apply`` of zamba2-1.2b at B=4, S=2048
    through the kernels (38 SSD launches, all of the bf16 tensor-core
    kernel in the profiled bf16 forward, and 6 flash) and through the
    plain paths, in bf16 and in float32: the float32 logits must agree
    within 1e-3 x max|logit|, and the bf16 kernel path must be no further
    from them, in root mean square, than 1.5x the bf16 plain path (bf16
    rounding alone moves these random models' logits by several percent
    of max|logit|); a profiled device breakdown;
20. rwkv-forward: the same for rwkv6-7b (32 WKV launches), the plain
    path being the sequential scan, at the same B=4, S=2048;
21. serve-recurrent: each family served at full width as in phase 8
    (undisturbed, then revoke + drain; migrated tokens equal), zamba2's
    decode cell running 6 decode-attention launches, and zamba2 again
    with the paged cache (the dense run's tokens, pages shipped; dense
    and paged decode steps in turns, as in phase 9); zamba2 decode logits
    through the kernel and the plain attention must agree, in float32
    within 1e-3 and in bf16 as the forwards' gate says;
22. timing: device time of each kernel, its plain version and, where
    one PyTorch call computes the same function,
    ``scaled_dot_product_attention`` (the library yardstick, which the
    port never calls) beside the kernel's bound and the share of it
    reached: decode at the serve shape, a long cache and zamba2's decode
    cell (SDPA with the length mask and, since the lengths are full,
    without one); flash at the starcoder2 forward, a gemma3 local layer
    and zamba2's shared block; the SSD scan at zamba2's forward; WKV at
    rwkv6's forward in fp32 (fused views, nonzero s0) and as the model
    calls it (bf16 r, k, v and o, zero s0).

Any failure raises and exits non-zero. The last lines are the kernel
records (JSON), the card's name and power limit, and
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits non-zero
without one or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM HBM3
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense, no sparsity
TOL_TEXT = {"bfloat16": "2^-6 x (|ref| + rms(ref))",
            "float32": "1e-4 x (1 + |ref|)"}
L2_BYTES = 50 * 2 ** 20
REPLACES = "src/repro/kernels/decode_attention/kernel.py:93"
SOURCE = "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"
FLASH_REPLACES = "src/repro/kernels/flash_attention/kernel.py:112"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SSD_REPLACES = "src/repro/kernels/ssd_scan/kernel.py:76"
SSD_SOURCE = "src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu"
WKV_REPLACES = "src/repro/kernels/rwkv6/kernel.py:83"
WKV_SOURCE = "src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu"

# name: (B, H, KV, S, D, lengths or None for full, window)
SHAPES = {
    "serve": (4, 24, 2, 512, 128, None, 0),
    "long": (8, 24, 2, 4096, 128, None, 0),
    "window": (4, 24, 2, 512, 128, [512, 300, 50, 0], 128),
    "kv1": (4, 24, 1, 512, 128, [512, 257, 33, 1], 0),
    "ragged": (4, 24, 2, 512, 128, [0, 1, 333, 700], 0),
    "zamba2": (4, 32, 32, 512, 64, [512, 300, 17, 0], 0),  # shared block
    "zamba2_decode": (4, 32, 32, 512, 64, None, 0),  # its decode cell
    # the tensor-core path's tile edges (64 keys): S = 64 + 1 with a
    # length of 64 - 1, and G = 48 with a window that cuts tiles
    "edge65": (2, 24, 2, 65, 128, [65, 63], 0),
    "g48": (2, 48, 1, 600, 128, [600, 450], 100),
}
# name: (B, Sq, Sk, H, KV, D, causal, window)
FLASH_SHAPES = {
    "forward": (4, 2048, 2048, 24, 2, 128, True, 0),   # starcoder2-3b
    "gemma3_window": (1, 4096, 4096, 32, 16, 128, True, 1024),
    "mqa": (2, 2048, 2048, 48, 1, 128, True, 0),
    "ragged": (2, 1000, 1000, 24, 2, 128, True, 0),
    "noncausal": (2, 1000, 1000, 24, 2, 128, False, 0),
    "d64": (2, 1024, 1024, 16, 4, 64, True, 256),
    "zamba2": (4, 2048, 2048, 32, 32, 64, True, 0),    # shared block
    # the wgmma kernel's tile edges (128 queries x 128 keys)
    "edge127": (2, 127, 127, 8, 2, 128, True, 0),
    "edge129": (2, 129, 129, 8, 2, 128, False, 0),
    "window_cut": (1, 600, 600, 8, 2, 128, True, 200),
    "edge_d64": (2, 129, 127, 8, 2, 64, False, 0),    # fp16 P at D = 64
}
# name: (B, S, H, P, N, lowest dA); dA is uniform in [lowest, -0.01]
SSD_SHAPES = {
    "forward": (4, 2048, 64, 64, 64, -0.5),            # zamba2-1.2b
    "ragged": (2, 1000, 8, 64, 64, -0.5),
    "fast_decay": (2, 333, 4, 64, 64, -20.0),
    # the bf16 tensor-core kernel's edges: heads that are not a multiple
    # of its two-head blocks, S around one 64-token chunk, P = N = 32, and
    # the carried state through 128 chunks of slow decay
    "heads3": (2, 300, 3, 64, 64, -0.5),
    "heads5": (2, 300, 5, 64, 64, -0.5),
    "s63": (2, 63, 4, 64, 64, -0.5),
    "s64": (2, 64, 4, 64, 64, -0.5),
    "s65": (2, 65, 4, 64, 64, -0.5),
    "pn32": (2, 500, 8, 32, 32, -0.5),
    "long_slow": (1, 8192, 8, 64, 64, -0.05),
}
# name: (B, S, H, D, nonzero initial state, r/k/v as views of one fused
# projection (else the model's contiguous tensors), lowest log-log decay):
# decays w = exp(-exp(U(lo, 4))), or U(-8, -6) for the slow shape
WKV_SHAPES = {
    "forward": (4, 2048, 64, 64, True, True, -8.0),    # rwkv6-7b
    "model": (4, 2048, 64, 64, False, False, -8.0),    # as the model calls
    "zero_s0": (4, 2048, 64, 64, False, True, -8.0),
    "ragged": (2, 1000, 8, 64, True, True, -8.0),
    "s1": (2, 1, 8, 64, True, False, -8.0),
    "s31": (2, 31, 8, 64, True, True, -8.0),
    "s32": (2, 32, 8, 64, True, False, -8.0),
    "s33": (2, 33, 8, 64, True, True, -8.0),
    "d16": (3, 300, 4, 16, True, True, -8.0),
    "d32": (2, 300, 8, 32, True, False, -8.0),
    "slow": (2, 8192, 8, 64, True, False, None),       # U(-8, -6)
}
FORWARD_BATCH = (4, 2048)
TRAIN_ARGS = ["--full", "--arch", "starcoder2-3b", "--steps", "3",
              "--global-batch", "2", "--seq-len", "1024"]
ELASTIC_ARGS = ["--full", "--arch", "starcoder2-3b", "--elastic",
                "--slots", "2", "--initial-workers", "1", "--join-every",
                "1", "--revoke-at", "3", "--global-batch", "2",
                "--seq-len", "1024", "--steps", "4"]
RESNET_ARGS = ["--arch", "resnet32-cifar10", "--full", "--elastic",
               "--optimizer", "momentum", "--global-batch", "128",
               "--slots", "4", "--initial-workers", "1", "--join-every", "5",
               "--revoke-at", "17", "--steps", "20"]
RESNET_ACTIVE = [1] * 5 + [2] * 5 + [3] * 5 + [4] * 2 + [3] * 3
# the gym: a mixed K80/P100 plan of the volatile trace by the greedy
# policy, trained at full width and replayed through the async PS
GYM_ARGS = ["--gym", "--trace", "volatile", "--policy", "greedy",
            "--initial-workers", "4", "--arch", "resnet32-cifar10", "--full",
            "--steps", "64", "--gym-async-updates", "384"]
GYM_PARITY_STEPS = 8          # reduced ResNet-8, float32, card vs CPU
GYM_LOSS_TOL = 1e-4           # relative, the final loss
# the async PS, card vs CPU: params within GYM_PS_TOL (max|diff| /
# max|param|) after GYM_PS_UPDATES pushes. Four stale workers at the
# gym's LR amplify rounding differences push by push (after the full
# run's 384 pushes card and CPU params lie ~1e-2 apart), so the 384-push
# run is held to equal histograms and its params' distance only printed
GYM_PS_UPDATES = 64
GYM_PS_TOL = 1e-4
# where the training phases checkpoint, inside the checkout (gitignored)
CKPT_DIR = os.path.join(ROOT, "build", "chip_smoke_ckpt")
# a run resumed from a checkpoint against the uninterrupted run: the same
# weights and batches, only the backward's summation order may differ
RESUME_TOL = 1e-4            # relative, per-step loss
CKPT_PARAM_TOL = 1e-4        # absolute, every float32 master after 3 steps
RESNET_BF16_TOL = 2e-2       # the run's bf16 first loss vs float64
PARITY_ARCHS = ("starcoder2-3b", "gemma3-27b", "zamba2-1.2b", "rwkv6-7b")
RECURRENT_ARCHS = ("zamba2-1.2b", "rwkv6-7b")
SERVE_ARGS = ["--no-reduced", "--requests", "8", "--max-batch", "4",
              "--max-len", "512", "--prompt-len", "16",
              "--max-new-tokens", "32", "--seed", "0"]
PAGED_ARGS = ["--cache-impl", "paged", "--page-size", "16"]
# the serve-fleet phase: a serve-bursty trace written with the port's
# RequestTrace.to_jsonl, replayed through launch.serve at full width
FLEET_DIR = os.path.join(ROOT, "build", "chip_smoke_fleet")
FLEET_HORIZON_S = 80.0         # virtual seconds of the trace
FLEET_ARGS = ["--no-reduced", "--queue", "slo", "--cache-impl", "paged",
              "--replicas", "2", "--autoscale", "--min-replicas", "2",
              "--max-replicas", "3", "--monitor", "--warn-at", "0.4",
              "--revoke-at", "0.7", "--max-batch", "4", "--max-len", "512",
              "--seed", "0"]


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str):
    print(f"== phase {name}", flush=True)
    t0 = time.monotonic()
    yield
    print(f"== phase {name}: ok ({time.monotonic() - t0:.1f} s)", flush=True)


def attention_inputs(torch, shape, dtype, gen, device="cuda"):
    """q (B, H, D) and the model's cache layout (B, S, KV, D) seen as
    (B, KV, S, D) views, as the decode path hands them to the kernel."""
    B, H, KV, S, D, lengths, window = shape
    dt = getattr(torch, dtype)
    q = torch.randn(B, 1, H, D, generator=gen, device=device).to(dt)[:, 0]
    kc = torch.randn(B, S, KV, D, generator=gen, device=device).to(dt)
    vc = torch.randn(B, S, KV, D, generator=gen, device=device).to(dt)
    lens = torch.tensor(lengths if lengths is not None else [S] * B,
                        dtype=torch.int32, device=device)
    return q, kc.transpose(1, 2), vc.transpose(1, 2), lens, window


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def allowed(want, dtype):
    """Per-element bound on |kernel - plain|. float32: 1e-4 x (1 + |ref|)
    (another summation order and ``expf``). bfloat16: two bf16 ulps
    (2 x 2^-7) of |ref| + rms(ref): both outputs are rounded to bf16 from
    float32 values that agree to ~1e-6, so they differ by at most one ulp
    of the value; the rms term covers outputs near 0."""
    ref = want.float().abs()
    if dtype == "float32":
        return 1e-4 * (1 + ref)
    return 2 ** -6 * (ref + ref.pow(2).mean().sqrt())


def worst(got, want, bound):
    err = (got.float() - want.float()).abs()
    return float(err.max()), int((err > bound).sum())


def bound_ms(shape, dtype, lengths):
    """Least time for the work: each input byte read once (only the valid
    KV positions), the output written once, against the card's memory
    rate; and 4*D flops per valid (head, position) against its peak."""
    B, H, KV, S, D, _, window = shape
    size = 2 if dtype == "bfloat16" else 4
    valid = []
    for n in lengths:
        lo = max(n - window, 0) if window > 0 else 0
        valid.append(max(min(n, S) - lo, 0))
    nbytes = (2 * B * H * D + 2 * KV * D * sum(valid)) * size + 4 * B
    flops = 4 * H * D * sum(valid)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), nbytes


def flash_inputs(torch, shape, dtype, gen):
    """q, k, v in the model's layout (B, S, H, D) / (B, S, KV, D)."""
    B, Sq, Sk, H, KV, D = shape[:6]
    dt = getattr(torch, dtype)
    q = torch.randn(B, Sq, H, D, generator=gen, device="cuda").to(dt)
    k = torch.randn(B, Sk, KV, D, generator=gen, device="cuda").to(dt)
    v = torch.randn(B, Sk, KV, D, generator=gen, device="cuda").to(dt)
    return q, k, v


def flash_pairs(Sq, Sk, causal, window):
    """Visible (query, key) pairs: the work these inputs need."""
    n = 0
    for i in range(Sq):
        hi = min(Sk, i + 1) if causal else Sk
        lo = max(0, i - window + 1) if window > 0 else 0
        n += max(0, hi - lo)
    return n


def flash_bound_ms(shape, dtype):
    """Least time for the work: 4*D flops per visible (query, key) pair
    (Q K^T and P V) per head against the card's peak for the dtype, and
    q, k, v read once and the output written once against its memory
    rate."""
    B, Sq, Sk, H, KV, D, causal, window = shape
    size = 2 if dtype == "bfloat16" else 4
    flops = 4 * B * H * D * flash_pairs(Sq, Sk, causal, window)
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KV * D) * size
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes"), flops, nbytes


def ssd_inputs(torch, shape, dtype, gen):
    """xdt (B, S, H, P), and B, C (B, S, N) as column slices of one
    conv-output-like tensor, as the model hands them to the kernel; dA
    (B, S, H) float32 uniform in [lowest, -0.01]."""
    B, S, H, P, N, lo = shape
    dt = getattr(torch, dtype)
    xdt = torch.randn(B, S, H, P, generator=gen, device="cuda").to(dt)
    conv = torch.randn(B, S, H * P + 2 * N, generator=gen,
                       device="cuda").to(dt)
    dA = lo + (-0.01 - lo) * torch.rand(B, S, H, generator=gen,
                                        device="cuda")
    return xdt, conv[..., H * P:H * P + N], conv[..., H * P + N:], dA


def ssd_bound_ms(shape, dtype):
    """Least time for the work: xdt, B, C and dA read once and y written
    once against the memory rate; and the chunked algorithm's operations
    at 64-token chunks with C B^T formed once per chunk for all heads and
    only its lower triangle used (2 Q(Q+1)/2 N per chunk and row, plus
    2 Q(Q+1)/2 P + 4 Q N P per chunk, row and head), against the peak for
    the dtype."""
    B, S, H, P, N, _ = shape
    size = 2 if dtype == "bfloat16" else 4
    Q, nc = 64, -(-S // 64)
    tri = Q * (Q + 1) // 2
    flops = B * nc * (2 * tri * N + H * (2 * tri * P + 4 * Q * N * P))
    nbytes = (2 * B * S * H * P + 2 * B * S * N) * size + 4 * B * S * H
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), flops, nbytes


def wkv_inputs(torch, shape, gen, dtype="float32"):
    """r, k, v (B, S, H, D) in ``dtype``, as views of one fused projection
    output or as three contiguous tensors (the model's call); the decays
    (float32) drawn as the reference's kernel test draws them, down to
    exp(-e^4) ~ 1.9e-24, or slowly (exp(-exp(U(-8, -6)))); u (H, D) and
    s0 (B, H, D, D) or None, float32."""
    B, S, H, D, with_s0, fused, lo = shape
    dt = getattr(torch, dtype)
    if fused:
        rkv = torch.randn(B, S, H, 3 * D, generator=gen,
                          device="cuda").to(dt)
        r, k, v = rkv[..., :D], rkv[..., D:2 * D], rkv[..., 2 * D:]
    else:
        r, k, v = (torch.randn(B, S, H, D, generator=gen,
                               device="cuda").to(dt) for _ in range(3))
    lo, hi = (-8.0, -6.0) if lo is None else (lo, 4.0)
    w = torch.exp(-torch.exp(lo + (hi - lo) * torch.rand(
        B, S, H, D, generator=gen, device="cuda")))
    u = torch.randn(H, D, generator=gen, device="cuda")
    s0 = torch.randn(B, H, D, D, generator=gen, device="cuda") \
        if with_s0 else None
    return r, k, v, w, u, s0


def wkv_bound_ms(shape, dtype="float32"):
    """Least time for the work: r, k, v (in ``dtype``), w, u and s0
    (float32) read once, o (in ``dtype``) and the final state (float32)
    written once, against the memory rate; and the recurrence's 5 flops
    per state entry per token and head (r^T S, then w * S + k v^T)
    against the float32 peak."""
    B, S, H, D, with_s0 = shape[:5]
    size = 2 if dtype == "bfloat16" else 4
    flops = 5 * B * S * H * D * D
    nbytes = (4 * size + 4) * B * S * H * D + 4 * (
        H * D + (2 if with_s0 else 1) * B * H * D * D)
    t_ops = flops / PEAK_FLOPS["float32"]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations"), flops, nbytes


def build_all(build, sources):
    """Compile every kernel at once, one nvcc per source; returns
    {name: seconds} and raises on the first failed build."""
    times, errors = {}, {}

    def one(name, src):
        t0 = time.monotonic()
        try:
            build.load_library(name, [src], rebuild=True)
        except Exception as exc:             # reported below, by name
            errors[name] = exc
        times[name] = time.monotonic() - t0

    threads = [threading.Thread(target=one, args=item)
               for item in sources.items()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, exc in errors.items():
        raise RuntimeError(f"building {name} failed") from exc
    return times


def release(torch):
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def device_ms(torch, fn, n_inputs, calls=64, reps=5):
    """Device time per call: ``calls`` calls (cycling over ``n_inputs``
    input copies, so repeated calls find the cache cold in L2) captured
    in a CUDA graph and replayed, timed with CUDA events. Host overhead
    between calls is excluded."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):
            fn(i % n_inputs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(calls):
            fn(i % n_inputs)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (reps * calls)


def serve_and_migrate(torch, serve, args, model, params, card_line,
                      expect):
    """The serve entry point's engine on ``args``: an undisturbed run of
    ``args.requests`` requests, then the same requests again with a hard
    revocation of slot 1 and a drain that migrates the in-flight work to
    a second engine. The migrated requests must give the undisturbed
    tokens. ``expect`` lists (wrapper, launches per decode cell): every
    count is set to 0 first, and after the undisturbed run and after all
    runs it must be that many per decode cell. On a paged engine
    (``--cache-impl paged``) the drain ships the decoding requests' pages
    to the second engine: at least one lands there, with no replay
    charged. Returns the undisturbed run's numbers, the decode cells of
    all engines (``cells``) and the migration's counters, and the
    undisturbed tokens by request id."""
    cfg = model.cfg
    for fn, _ in expect:
        fn.launches = 0                           # the path's run starts
    base = serve.make_engine(args, model, params)
    reqs = serve.make_requests(args, cfg.vocab_size)
    step_ms, t0 = [], time.monotonic()
    for r in reqs:
        base.submit(r)
    while base.has_work():
        n0, s0 = base.tokens_decoded, time.monotonic()
        base.step()
        torch.cuda.synchronize()
        if base.tokens_decoded > n0:
            step_ms.append((time.monotonic() - s0) * 1e3)
    wall = time.monotonic() - t0
    summary = serve.summarize(args, base, reqs, None, wall)
    expected = {r.rid: r.generated for r in reqs}
    check(all(r.done for r in reqs), "undisturbed run left work")
    for fn, per_cell in expect:
        check(fn.launches == per_cell * base.decode_cells,
              f"the undisturbed run launched {fn.__name__} {fn.launches} "
              f"times, not {per_cell} per decode cell x {base.decode_cells}")
    tps = base.tokens_decoded / wall
    mean_step = sum(step_ms) / len(step_ms)
    print(f"  {cfg.name} undisturbed: {base.tokens_decoded} tokens in "
          f"{wall:.2f} s = {tps:.1f} tokens/s, mean decode step "
          f"{mean_step:.2f} ms over {len(step_ms)} steps, "
          f"{base.decode_cells} decode cells [{card_line}]")
    print("  summary " + json.dumps(summary))

    first = serve.make_engine(args, model, params)
    reqs = serve.make_requests(args, cfg.vocab_size)
    for r in reqs:
        first.submit(r)
    while not all(len(r.generated) >= 4 for r in first.slots
                  if r is not None) or first.n_active < args.max_batch:
        first.step()
    lost = first.revoke_slot(1)                  # fired: no warning
    for _ in range(3):
        first.step()
    migrated = first.begin_drain(grace_tokens=2)  # warned
    second = serve.make_engine(args, model, params)
    for r in migrated:
        check(second.submit(r), f"request {r.rid} refused on migration")
    first.run_to_completion()
    second.run_to_completion()
    torch.cuda.synchronize()
    same = sum(r.generated == expected[r.rid] for r in reqs)
    cells = base.decode_cells + first.decode_cells + second.decode_cells
    replayed = first.tokens_replayed + second.tokens_replayed
    print(f"  revoke+drain run: slot 1 lost {lost.timing.tokens_lost} "
          f"tokens, {len(migrated)} requests migrated, tokens_replayed "
          f"{replayed}, pages shipped {second.pages_shipped} in "
          f"{second.requests_imported} requests; tokens equal to the "
          f"undisturbed run: {same}/{len(reqs)}")
    if args.cache_impl == "paged":
        check(second.pages_shipped > 0 and second.requests_imported > 0
              and replayed == 0, "the paged drain shipped no pages or "
                                 "charged a replay")
    print("  kernel launches " + ", ".join(
        f"{fn.__name__} {fn.launches} = {per_cell} x {cells} decode cells"
        for fn, per_cell in expect))
    check(same == len(reqs) and all(r.done for r in reqs),
          "migrated requests diverged from the undisturbed run")
    for fn, per_cell in expect:                   # and ends
        check(fn.launches == per_cell * cells,
              f"the main path launched {fn.__name__} {fn.launches} times, "
              f"not {per_cell} per decode cell x {cells}")
    return ({"tokens_per_s": tps, "decode_step_ms_mean": mean_step,
             "decode_steps": len(step_ms),
             "decode_cells": base.decode_cells, "wall_s": wall,
             "migrated": len(migrated), "cells": cells, "tokens_equal": same,
             "tokens_replayed": replayed,
             "pages_shipped": second.pages_shipped,
             "requests_imported": second.requests_imported}, expected)


def step_walls(torch, eng, n):
    """Host wall (ms) of each of ``n`` engine steps, each synchronised."""
    walls = []
    for _ in range(n):
        t0 = time.monotonic()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    return walls


def step_profile(torch, eng, n_prof=3):
    """``n_prof`` engine steps under torch.profiler: (device busy ms a
    step, {kernel name: (us a step, launches a step)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            eng.step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name = {}
    for e in kernels:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us() / n_prof,
                           n + 1 / n_prof)
    busy = sum(t for t, _ in by_name.values()) / 1e3
    return busy, by_name


def paged_step_compare(torch, serve, model, params, card_line,
                       arch_args=()):
    """One dense and one paged engine on the serve phase's first four
    requests, in mid-decode: the host wall of 10 decode steps each,
    dense, paged, paged, dense, then 3 profiled steps each for the
    device busy time. The paged cell gathers each row's pages (two
    index_select copies a layer) and writes through the page table; the
    device time of the index kernels is printed beside the dense
    cell's."""
    engines = {}
    for impl in ("dense", "paged"):
        args = serve.parse_args(SERVE_ARGS + list(arch_args) + (
            PAGED_ARGS if impl == "paged" else []))
        eng = serve.make_engine(args, model, params)
        for r in serve.make_requests(args, model.cfg.vocab_size)[:4]:
            eng.submit(r)
        while not all(r is not None and r.generated for r in eng.slots):
            eng.step()
        engines[impl] = eng
    walls = {"dense": [], "paged": []}
    for impl in ("dense", "paged", "paged", "dense"):
        walls[impl] += step_walls(torch, engines[impl], 10)
    out = {}
    for impl, eng in engines.items():
        busy, by_name = step_profile(torch, eng)
        wall = sorted(walls[impl])[len(walls[impl]) // 2]
        index = sum(t for nm, (t, _) in by_name.items()
                    if "index" in nm.lower())
        out[impl] = {"wall_ms": walls[impl], "wall_ms_median": wall,
                     "busy_ms": busy, "busy_share": busy / wall,
                     "index_us": index,
                     "launches_per_step": sum(n for _, n in
                                              by_name.values())}
        print(f"  {model.cfg.name} {impl} decode step (B=4, max_len 512): "
              f"host wall median "
              f"{wall:.2f} ms (mean {sum(walls[impl]) / 20:.2f}, min "
              f"{min(walls[impl]):.2f}), device busy {busy:.3f} ms (share "
              f"{busy / wall:.3f}), index kernels {index:.1f} us a step, "
              f"{out[impl]['launches_per_step']:.0f} device launches a "
              f"step [{card_line}]")
        for t, n, nm in sorted(((t, n, nm[:60]) for nm, (t, n)
                                in by_name.items()), reverse=True)[:5]:
            print(f"    {t:9.1f} us/step  x{n:<4.0f} {nm}")
    return out


def fleet_phase(torch, serve, card_line, dense_model, dense_params):
    """``launch.serve`` on a serve-bursty trace (written here with the
    port's ``RequestTrace.to_jsonl``) at full width: a 2-replica paged
    fleet with the SLO queue, the autoscaler, the monitor, a warning at
    40% and a revocation at 70% of the horizon, the event log, the time
    series, the ops report and a profiler trace. Gates: every request
    completed or rejected; the revocation lost tokens; the warning moved
    work (pages shipped or tokens replayed); the report, the event log's
    warn/revoke/migrate events and the Chrome traces validate; each
    completed request's tokens equal the same request served undisturbed
    by one dense engine; the decode kernel ran once per layer per decode
    cell. TTFT/TPOT are on the virtual clock, not the card's."""
    from repro_torch import obs
    from repro_torch.launch.obs_args import PROFILE_STEPS
    from repro_torch.obs import export
    from repro_torch.obs.report import validate_report
    from repro_torch.serving import Request, ServeEngine
    from repro_torch.traces.requests import synthetic_request_trace
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    os.makedirs(FLEET_DIR)
    trace = synthetic_request_trace("serve-bursty", seed=0,
                                    horizon_s=FLEET_HORIZON_S,
                                    bursts=((0.4, 0.55, 3.0),))
    path = trace.to_jsonl(os.path.join(FLEET_DIR, "trace.jsonl"))
    files = {k: os.path.join(FLEET_DIR, v) for k, v in (
        ("events", "events.jsonl"), ("series_out", "series.jsonl"),
        ("report", "report.html"), ("profile", "profile"))}
    args = serve.parse_args(FLEET_ARGS + ["--trace", path] + [
        x for k, v in files.items()
        for x in ("--" + k.replace("_", "-"), v)])
    zero_counts()                                 # the path's run starts
    t0 = time.monotonic()
    out, reqs, cluster = serve.run(args)
    wall = time.monotonic() - t0
    counts = read_counts()                        # and ends
    engines = cluster.replicas + cluster.retired
    cells = sum(e.decode_cells for e in engines)
    print("  summary " + json.dumps(out))
    print(f"  {len(reqs)} requests over {FLEET_HORIZON_S:.0f} s of virtual "
          f"time: wall {wall:.2f} s (run, weights included), serving "
          f"{out['wall_s']} s, {cells} decode cells, host "
          f"{out['tokens_per_s']} tokens/s, replicas spawned "
          f"{out['replicas_spawned']}; virtual-clock TTFT p50/p95 "
          f"{out['ttft_p50_s']}/{out['ttft_p95_s']} s, TPOT p50/p95 "
          f"{out['tpot_p50_s']}/{out['tpot_p95_s']} s (not the card's "
          f"times) [{card_line}]")
    check(all(r.done or r.dropped for r in reqs)
          and out["completed"] + sum(r.dropped for r in reqs) == len(reqs),
          "a fleet request was neither completed nor rejected")
    check(out["tokens_lost"] > 0, "the fleet's revocation lost no tokens")
    check(out["pages_shipped"] > 0 or out["tokens_replayed"] > 0,
          "the fleet's warning moved no work")
    n_layers = engines[0].model.cfg.num_layers
    check(counts["decode_attention"] == n_layers * cells
          and counts["flash_attention"] == 0,
          f"fleet launches {counts}, not {n_layers} decode per cell x "
          f"{cells}")
    with open(out["report"]) as f:
        report_counts = validate_report(f.read())
    events = obs.load_events(out["events"])
    names = {e.name for e in events}
    check({obs.EV_REVOKE_WARN, obs.EV_REVOKE_FIRE, obs.EV_MIGRATE} <= names,
          f"the event log lacks warn/revoke/migrate events: {sorted(names)}")
    n_trace = export.validate_chrome_trace(
        export.to_chrome_trace(events, clock="sim"))
    with open(out["timeline"]) as f:
        export.validate_chrome_trace(json.load(f))
    trace_mb = os.path.getsize(out["device_trace"]) / 1e6
    # the same requests, undisturbed, on one dense engine
    ref = ServeEngine(dense_model, dense_params, max_batch=4, max_len=512)
    copies = [Request(rid=r.rid, prompt=list(r.prompt),
                      max_new_tokens=r.max_new_tokens) for r in reqs]
    for r in copies:
        ref.submit(r)
    t1 = time.monotonic()
    ref.run_to_completion()
    torch.cuda.synchronize()
    ref_s = time.monotonic() - t1
    done = [r for r in reqs if r.done]
    same = sum(r.generated == c.generated for r, c in zip(reqs, copies)
               if r.done)
    print(f"  events {len(events)} ({n_trace} Chrome trace events), "
          f"report {report_counts}, profiler trace of the first "
          f"{PROFILE_STEPS} steps {trace_mb:.1f} MB; completed "
          f"requests equal to the undisturbed dense engine's: "
          f"{same}/{len(done)} (that engine: {ref_s:.2f} s) [{card_line}]")
    check(same == len(done), "fleet tokens differ from the undisturbed "
                             "dense engine's")
    return {"requests": len(reqs), "completed": out["completed"],
            "rejected": out["rejected"], "wall_s": wall,
            "serve_wall_s": out["wall_s"], "decode_cells": cells,
            "tokens_decoded": out["tokens_decoded"],
            "tokens_per_s": out["tokens_per_s"],
            "tokens_lost": out["tokens_lost"],
            "tokens_replayed": out["tokens_replayed"],
            "pages_shipped": out["pages_shipped"],
            "requests_imported": out["requests_imported"],
            "replicas_spawned": out["replicas_spawned"],
            "replica_seconds": out["replica_seconds"],
            "alerts": len(out["alerts"]), "events": len(events),
            "virtual_ttft_p50_s": out["ttft_p50_s"],
            "virtual_tpot_p50_s": out["tpot_p50_s"],
            "device_trace_MB": trace_mb, "dense_reference_s": ref_s,
            "decode_launches": counts["decode_attention"]}


def rel(a, b):
    """max|a - b| / max|b|, in float32."""
    return float((a.float() - b.float()).abs().max() / b.float().abs().max())


def rms(a, b):
    """Root mean square of a - b, in float32."""
    return float((a.float() - b.float()).pow(2).mean().sqrt())


def forward_check(torch, model, plain_model, params, batch, expect,
                  card_line, fp32_gate=False):
    """``Model.apply`` on one batch through the kernels (``model``) and
    through the plain paths (``plain_model``), finite logits of the right
    shape. ``expect`` lists (wrapper, launches, device-kernel name):
    every wrapper's count is set to 0 just before the kernel path's
    forward and read just after, and must equal its launches.

    The gate on the logits: without ``fp32_gate``, the two paths' bf16
    logits within 0.05 x max|logit|. With it, both paths also run in
    float32 (the weights cast up), where they must agree within 1e-3 x
    max|logit|, and the kernel path's bf16 logits must lie no further
    from the plain path's float32 logits, in root mean square, than 1.5x
    the plain path's own bf16 logits do: random full-width models amplify
    bf16 rounding to several percent of max|logit| on either path, so the
    bf16 gate is held against that floor, measured in the same run.

    Then one more forward under torch.profiler: device busy time, each
    kernel's device time and launches (which must equal its launches
    too), and the largest kernels. Returns stats."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import with_impls
    from repro_torch.tree import tree_map
    cfg = model.cfg
    B, S = batch["tokens"].shape

    with torch.no_grad():
        t0 = time.monotonic()
        want, _ = plain_model.apply(params, batch)
        torch.cuda.synchronize()
        plain_s = time.monotonic() - t0
        for fn, _, _ in expect:
            fn.launches = 0                       # the path's run starts
        t0 = time.monotonic()
        got, aux = model.apply(params, batch)
        torch.cuda.synchronize()
        fwd_s = time.monotonic() - t0
        launches = [fn.launches for fn, _, _ in expect]   # and ends
    for (fn, n, _), got_n in zip(expect, launches):
        check(got_n == n, f"{got_n} {fn.__name__} launches in one "
                          f"{cfg.name} forward, expected {n}")
    check(torch.isfinite(got.float()).all().item()
          and tuple(got.shape) == (B, S, cfg.vocab_size)
          and float(aux) == 0.0, "forward output malformed")
    rel16 = rel(got, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    counts = ", ".join(f"{fn.__name__} {n}" for (fn, _, _), n
                       in zip(expect, launches))
    print(f"  {cfg.name} full width, B={B} S={S}: bf16 logits kernels vs "
          f"plain max|diff|/max|logit| {rel16:.3e}, argmax agreement "
          f"{agree:.4f}; launches: {counts}; forward {fwd_s * 1e3:.1f} ms, "
          f"plain path {plain_s * 1e3:.1f} ms [{card_line}]")
    stats = {"B": B, "S": S, "wall_ms": fwd_s * 1e3,
             "plain_wall_ms": plain_s * 1e3, "logit_rel_diff": rel16,
             "argmax_agreement": agree}
    if not fp32_gate:
        check(rel16 <= 0.05, f"full-width {cfg.name} forward: kernel path "
                             f"and plain path disagree (tol 0.05)")
    else:
        params32 = tree_map(lambda t: t.float(), params)
        with torch.no_grad():
            k32 = with_impls(model, dtype="float32").apply(
                params32, batch)[0]
            p32 = with_impls(plain_model, dtype="float32").apply(
                params32, batch)[0]
        del params32
        rel32 = rel(k32, p32)
        floor, rms_k = rms(want, p32), rms(got, p32)
        print(f"  float32: logits kernels vs plain max|diff|/max|logit| "
              f"{rel32:.3e} (tol 1e-3); bf16 against the float32 plain "
              f"logits: max|diff|/max|logit| kernel path "
              f"{rel(got, p32):.3e}, plain path {rel(want, p32):.3e}; "
              f"rms diff kernel path {rms_k:.4f}, plain path {floor:.4f} "
              f"(tol: kernel <= 1.5 x plain)")
        check(rel32 <= 1e-3, f"full-width {cfg.name} forward in float32: "
                             f"kernel path and plain path disagree")
        check(rms_k <= 1.5 * floor, f"full-width {cfg.name} forward in "
                                    f"bf16: the kernel path is further from "
                                    f"the float32 logits than the plain path")
        stats.update(logit_rel_diff_fp32=rel32, bf16_rms_vs_fp32_kernel=rms_k,
                     bf16_rms_vs_fp32_plain=floor)
        del k32, p32
    del got, want
    with torch.no_grad(), profile(activities=[
            ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.apply(params, batch)
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    by_name = {}
    for e in kern:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    per_kernel = {}
    for fn, n, part in expect:
        ev = [e for e in kern if part in e.name]
        ms = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        check(len(ev) == n, f"profiled {cfg.name} forward ran {len(ev)} "
                            f"{part} kernels, expected {n}")
        per_kernel[fn.__name__] = {"ms": ms, "launches": len(ev)}
        if n:
            print(f"  profiled forward: {fn.__name__} {ms:.2f} ms over "
                  f"{len(ev)} launches ({ms / busy:.3f} of device time)")
    print(f"  profiled forward: device busy {busy:.2f} ms; largest "
          f"kernels [{card_line}]:")
    for name, (tot, n) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][0])[:6]:
        print(f"    {tot / 1e3:8.2f} ms  x{n:<5d} {name[:70]}")
    stats.update(device_busy_ms=busy, kernels=per_kernel)
    return stats


def decode_check(torch, model, params, gen, card_line):
    """Four decode steps through the decode kernel and through the plain
    attention, from one cache with random KV and state, in bf16 and in
    float32 (weights and cache cast up), gated as ``forward_check`` gates
    with ``fp32_gate``. Returns the differences."""
    from repro_torch.serving import with_impls
    from repro_torch.tree import tree_leaves, tree_map
    cfg = model.cfg
    plain = with_impls(model, attn_impl="torch")
    cache = model.init_cache(4, 512)
    for path, leaf in tree_leaves(cache):
        if path != "pos":
            leaf.copy_(0.5 * torch.randn(leaf.shape, generator=gen,
                                         device="cuda"))
    cache["pos"] = torch.tensor([200, 37, 510, 0], dtype=torch.int32,
                                device="cuda")
    toks = [torch.randint(1, cfg.vocab_size, (4, 1), generator=gen,
                          device="cuda") for _ in range(4)]
    params32 = tree_map(lambda t: t.float(), params)
    logits = {}
    for key, m, p, f32 in (("k16", model, params, False),
                           ("p16", plain, params, False),
                           ("k32", model, params32, True),
                           ("p32", plain, params32, True)):
        if f32:
            m = with_impls(m, dtype="float32")
        c = tree_map(lambda t: t.to(torch.float32 if f32 and t.is_floating_point()
                                    else t.dtype, copy=True), cache)
        outs = []
        with torch.no_grad():
            for tok in toks:
                out, c = m.decode(p, c, {"tokens": tok})
                outs.append(out.float())
        logits[key] = torch.stack(outs)
        check(torch.equal(c["pos"], cache["pos"] + len(toks)),
              f"{cfg.name} decode: pos did not advance")
    torch.cuda.synchronize()
    out = {"bf16": rel(logits["k16"], logits["p16"]),
           "fp32": rel(logits["k32"], logits["p32"]),
           "bf16_rms_vs_fp32_kernel": rms(logits["k16"], logits["p32"]),
           "bf16_rms_vs_fp32_plain": rms(logits["p16"], logits["p32"])}
    print(f"  {cfg.name} decode logits, 4 steps, kernel vs plain attention: "
          f"float32 max|diff|/max|logit| {out['fp32']:.3e} (tol 1e-3); bf16 "
          f"{out['bf16']:.3e}; rms diff from the float32 plain logits: "
          f"kernel path {out['bf16_rms_vs_fp32_kernel']:.4f}, plain path "
          f"{out['bf16_rms_vs_fp32_plain']:.4f} (tol: kernel <= 1.5 x plain) "
          f"[{card_line}]")
    check(out["fp32"] <= 1e-3 and out["bf16_rms_vs_fp32_kernel"]
          <= 1.5 * out["bf16_rms_vs_fp32_plain"],
          f"{cfg.name} decode: kernel path and plain path disagree")
    return out


# ---------------------------------------------------------------------------
# Transient training: the elastic runtime, checkpoints, ResNet-32
# ---------------------------------------------------------------------------

def kernel_wrappers():
    """The four kernel wrappers, whose ``launches`` count their launches."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv6 import rwkv6_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"decode_attention": decode_attention,
            "flash_attention": flash_attention, "ssd_scan": ssd_scan,
            "rwkv6_scan": rwkv6_scan}


def zero_counts():
    for w in kernel_wrappers().values():
        w.launches = 0


def read_counts():
    return {n: w.launches for n, w in kernel_wrappers().items()}


def host_room(path):
    """Free disk under ``path`` and the host's memory, in GB."""
    os.makedirs(path, exist_ok=True)
    free = shutil.disk_usage(path).free / 1e9
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":")
            if key in ("MemTotal", "MemAvailable"):
                mem[key] = int(val.split()[0]) * 1024 / 1e9
    return {"disk_free_GB": free, "mem_total_GB": mem.get("MemTotal"),
            "mem_available_GB": mem.get("MemAvailable"),
            "cpus": os.cpu_count()}


def elastic_phase(torch, card_line):
    """Full-width starcoder2-3b through ``launch.train --elastic`` (a join,
    a warning with its fast save, a revocation), the fast save restored
    onto the card and the rest of the run replayed from it, and the
    restored run's weights evaluated through the flash kernel and through
    the plain attention. Returns its numbers."""
    from repro_torch.core import (CheckpointManager, ElasticRuntime,
                                  RevocationEvent, SparseCluster)
    from repro_torch.core.transient import GCE_WARNING_S
    from repro_torch.data import make_batch
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import make_schedule
    from repro_torch.serving import with_impls
    from repro_torch.train.trainer import evaluate_accuracy
    from repro_torch.tree import tree_leaves
    flash = kernel_wrappers()["flash_attention"]
    room = host_room(CKPT_DIR)
    print(f"  host: {room['disk_free_GB']:.1f} GB free under {CKPT_DIR}, "
          f"{room['mem_total_GB']:.1f} GB memory "
          f"({room['mem_available_GB']:.1f} GB available), {room['cpus']} "
          f"CPUs")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    zero_counts()
    args = launch_train.parse_args(ELASTIC_ARGS + ["--ckpt-dir", CKPT_DIR])
    out, rt, state = launch_train.run(args)
    model, tcfg, ds = rt.model, rt.tcfg, rt.dataset
    print("  summary " + json.dumps(out))
    losses, norms, active = out["losses"], out["grad_norms"], out["active"]
    vocab = model.cfg.vocab_size
    check(active == [1, 2, 2, 1], f"active counts {active}, expected "
          "[1, 2, 2, 1]")
    sched = make_schedule(tcfg.schedule)
    want_lr = [tcfg.optimizer.lr * sched(i) * a
               / tcfg.optimizer.base_workers for i, a in enumerate(active)]
    check(all(abs(a - b) <= 1e-9 * b for a, b in zip(out["lr"], want_lr)),
          f"LRs {out['lr']} do not follow the active counts ({want_lr})")
    check(len(losses) == 4 and all(map(math.isfinite, losses + norms)),
          "elastic training gave a non-finite loss or gradient norm")
    check(math.log(vocab) <= losses[0] <= 12.3,
          f"first loss {losses[0]:.4f} outside [ln {vocab} = "
          f"{math.log(vocab):.2f}, 12.3]")
    check(out["fast_saves"] == 1 and out["final_step"] == 4,
          f"{out['fast_saves']} fast saves, final step {out['final_step']}")
    save_s, save_b = out["fast_save_s"][0], out["fast_save_bytes"][0]
    n_params = sum(t.numel() for _, t in tree_leaves(state.params))
    print(f"  {n_params / 1e9:.3f} B float32 parameters, AdamW; steps "
          + ", ".join(f"{t:.3f} s" for t in out["step_s"])
          + f" (active {active}); peak device memory "
          f"{out['peak_device_memory_bytes'] / 1e9:.2f} GB [{card_line}]")
    print(f"  fast save at the warning (step 2): {save_b / 1e9:.2f} GB in "
          f"{save_s:.2f} s, {save_b / save_s / 1e9:.2f} GB/s; the warning "
          f"gives {GCE_WARNING_S:.0f} s ({save_s / GCE_WARNING_S:.2f} of "
          f"it) [{card_line}]")
    del state, rt
    release(torch)

    ck = CheckpointManager(CKPT_DIR)
    t0 = time.monotonic()
    step, restored, extra = ck.restore_latest("cuda")
    torch.cuda.synchronize()
    restore_s = time.monotonic() - t0
    check(step == 2 and restored.step == 2 and extra.get("slot") == 0,
          f"restored step {step}, extra {extra}")
    print(f"  restored the fast save onto the card in {restore_s:.2f} s "
          f"({save_b / restore_s / 1e9:.2f} GB/s, checksum verified)")
    cluster = SparseCluster(args.slots)          # membership at step 2
    cluster.fill_and_activate(0, 0)
    cluster.fill_and_activate(1, 1)
    replay = ElasticRuntime(model, tcfg, ds, cluster)
    replay.add_events([RevocationEvent(step=3, slot=0, kind="revoke")])
    final = replay.run(restored, 2, start_step=2)
    again = [r["loss"] for r in replay.metrics_log]
    diffs = [abs(a - b) / abs(b) for a, b in zip(again, losses[2:])]
    print(f"  resumed steps 2, 3: losses " + ", ".join(
        f"{x:.6f}" for x in again) + " / uninterrupted " + ", ".join(
        f"{x:.6f}" for x in losses[2:]) + f"; relative differences "
        + ", ".join(f"{d:.2e}" for d in diffs) + f" (tol {RESUME_TOL:g})")
    check([r["active"] for r in replay.metrics_log] == [2, 1]
          and final.step == 4 and max(diffs) <= RESUME_TOL,
          "the run resumed from the fast save left the uninterrupted one")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)

    ev_batch = make_batch(model.cfg, 2, 1024, seed=99)
    accs = {}
    for impl in ("cuda", "torch"):
        n0 = flash.launches
        accs[impl] = evaluate_accuracy(with_impls(model, attn_impl=impl),
                                       final.params, ev_batch)
        check((flash.launches - n0)
              == (model.cfg.num_layers if impl == "cuda" else 0),
              f"evaluation with attn_impl={impl} launched the flash kernel "
              f"{flash.launches - n0} times")
    counts = read_counts()
    print(f"  evaluate_accuracy of the resumed weights: flash "
          f"{accs['cuda']:.6f}, plain {accs['torch']:.6f}; kernel launches "
          f"in the phase {counts}")
    check(counts == {"decode_attention": 0,
                     "flash_attention": model.cfg.num_layers,
                     "ssd_scan": 0, "rwkv6_scan": 0},
          "the elastic path launched another set of kernels")
    stats = {k: out[k] for k in ("losses", "grad_norms", "step_s", "active",
                                 "lr", "peak_device_memory_bytes",
                                 "fast_saves", "fast_save_s",
                                 "fast_save_bytes", "wall_s")}
    stats.update(host=room, params=n_params, restore_s=restore_s,
                 fast_save_GBps=save_b / save_s / 1e9,
                 resumed_losses=again, resume_rel_diff=diffs,
                 eval_accuracy=accs, kernel_launches=counts)
    del final, restored, replay, ev_batch
    release(torch)
    return stats



def checkpoint_phase(torch, card_line):
    """Reduced starcoder2-3b in float32 on the card: replicated saves every
    step, a corrupted replica that restore fails over from, a torn write
    (``fail_after_bytes``) that leaves the previous step restorable and no
    ``.tmp_`` debris, and a resumed run against the uninterrupted one."""
    import dataclasses as dc

    from repro_torch.config import (OptimizerConfig, ScheduleConfig,
                                    TrainConfig, get_config)
    from repro_torch.core import CheckpointManager
    from repro_torch.data import ShardedDataset
    from repro_torch.models.builder import build_model
    from repro_torch.train.step import init_state
    from repro_torch.train.trainer import Trainer
    from repro_torch.tree import tree_leaves
    cfg = get_config("starcoder2-3b", reduced=True).replace(
        dtype="float32", attn_impl="torch")
    model = build_model(cfg, "cuda")
    tcfg = TrainConfig(
        optimizer=OptimizerConfig(name="adamw", lr=1e-3),
        schedule=ScheduleConfig(kind="constant", warmup_steps=1,
                                total_steps=8),
        checkpoint_every=1, seed=0)
    ds = ShardedDataset(cfg, global_batch=4, seq_len=64, seed=0,
                        device="cuda")
    zero_counts()
    ref = Trainer(model, dc.replace(tcfg, checkpoint_every=0), ds,
                  log_every=1)
    ref_state = ref.fit(init_state(model, tcfg), 6)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    mgr = CheckpointManager(CKPT_DIR, replicas=2)
    tr = Trainer(model, tcfg, ds, mgr)
    state = tr.fit(init_state(model, tcfg), 3)        # saves at 1, 2, 3
    step3 = os.path.join(CKPT_DIR, "worker_0", "step_0000000003", "state.bin")
    with open(step3, "r+b") as f:                    # one flipped bit
        f.seek(1000)
        byte = f.read(1)
        f.seek(1000)
        f.write(bytes([byte[0] ^ 1]))
    check(mgr._load(os.path.dirname(step3), None) is None,
          "the corrupted replica passed its checksum")
    step, got, _ = mgr.restore_latest("cuda")
    check(step == 3 and all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves(got.params), tree_leaves(state.params))),
          "restore did not fail over to the intact replica of step 3")
    mgr.fail_after_bytes = 1 << 16                   # revoked mid-write
    try:
        tr.fit(state, 1)
    except RuntimeError as e:
        check("mid-write" in str(e), f"unexpected error {e}")
    else:
        check(False, "the torn write did not fail the save")
    mgr.fail_after_bytes = None
    debris = [d for r in os.listdir(CKPT_DIR)
              for d in os.listdir(os.path.join(CKPT_DIR, r))
              if d.startswith(".tmp_")]
    check(not debris, f"the torn write left {debris}")
    tr2 = Trainer(model, dc.replace(tcfg, checkpoint_every=0), ds, mgr,
                  log_every=1)
    resumed = tr2.init_or_restore()
    check(resumed.step == 3, f"resumed at step {resumed.step}, not 3")
    final = tr2.fit(resumed, 3)
    diff = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        tree_leaves(ref_state.params), tree_leaves(final.params)))
    loss_diff = max(abs(a["loss"] - b["loss"]) / abs(b["loss"])
                    for a, b in zip(tr2.metrics_log, ref.metrics_log[3:]))
    print(f"  replicas 2, saves every step; step 3's replica 0 corrupted: "
          f"restore failed over to replica 1; step 4's write torn after "
          f"{1 << 16} bytes: step 3 restored, no .tmp_ debris; resumed "
          f"steps 3-5 vs uninterrupted: max|param diff| {diff:.2e} (tol "
          f"{CKPT_PARAM_TOL:g}), loss {loss_diff:.2e} (tol {RESUME_TOL:g}) "
          f"[{card_line}]")
    check(diff <= CKPT_PARAM_TOL and loss_diff <= RESUME_TOL,
          "the resumed run left the uninterrupted one")
    check(read_counts() == dict.fromkeys(kernel_wrappers(), 0),
          "reduced training launched a kernel")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return {"param_max_abs_diff": diff, "loss_rel_diff": loss_diff}


def resnet_phase(torch, card_line):
    """The paper's workload at its published size: ResNet-32 / CIFAR-10
    through ``launch.train --elastic`` (momentum, global batch 128 over
    four slots, a join every five steps, one warned revocation), its
    steps/s, five more steps under torch.profiler for the device-busy
    share, and the first step held to float64 on the CPU: the same
    initial weights and slot-0 batch in float32 on the card and on the
    CPU and in float64 on the CPU."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import train as launch_train
    from repro_torch.models import layers as L
    from repro_torch.models.builder import build_model
    from repro_torch.train.step import loss_fn, value_and_grad
    from repro_torch.tree import tree_leaves, tree_map
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    zero_counts()
    args = launch_train.parse_args(RESNET_ARGS + ["--ckpt-dir", CKPT_DIR])
    out, rt, state = launch_train.run(args)
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    print("  summary " + json.dumps(out))
    losses, norms = out["losses"], out["grad_norms"]
    check(out["active"] == RESNET_ACTIVE,
          f"active counts {out['active']}, expected {RESNET_ACTIVE}")
    check(len(losses) == args.steps and all(map(math.isfinite,
                                                losses + norms)),
          "ResNet-32 training gave a non-finite loss or gradient norm")
    check(out["fast_saves"] == 1, f"{out['fast_saves']} fast saves")
    step_s = out["step_s"]
    steady = (len(step_s) - 1) / sum(step_s[1:])
    print(f"  ResNet-32, global batch {args.global_batch} over {args.slots} "
          f"slots (every slot's rows computed), bf16: {args.steps} steps, "
          f"first {step_s[0]:.3f} s, then {steady:.2f} steps/s "
          f"({steady * args.global_batch:.0f} images/s); fast save "
          f"{out['fast_save_bytes'][0] / 1e6:.1f} MB in "
          f"{out['fast_save_s'][0]:.3f} s [{card_line}]")
    n_prof = 5
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        rt.run(state, n_prof, start_step=args.steps)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
    print(f"  {n_prof} profiled steps: device busy {busy * 1e3:.1f} ms of "
          f"{wall * 1e3:.1f} ms wall, busy share {busy / wall:.3f}, "
          f"{len(kern) / n_prof:.0f} device launches a step [{card_line}]")
    counts = read_counts()
    check(counts == dict.fromkeys(kernel_wrappers(), 0),
          f"ResNet-32 launched a kernel: {counts}")

    # the first step against float32 on the card and on the CPU, and the
    # CPU in float64: the model's float32 gradients themselves sit ~1e-3
    # (of a leaf's largest) from float64 (large logits at init), so the
    # card's are held to twice the CPU's distance from float64
    L.DTYPES.setdefault("float64", torch.float64)
    w0 = rt.model.init(rt.model.generator(args.seed),
                       dtype=torch.float32)         # init_state's draws
    b0 = rt.dataset.shard_batch(0, 0, args.slots)   # slot 0, step 0
    got = {}
    for key, dev, dt in (("cuda", "cuda", torch.float32),
                         ("cpu", "cpu", torch.float32),
                         ("cpu64", "cpu", torch.float64)):
        m = build_model(rt.model.cfg.replace(dtype=str(dt).split(".")[1]),
                        dev)
        p = tree_map(lambda t: t.to(device=dev, dtype=dt), w0)
        b = {k: v.to(dev) for k, v in b0.items()}
        grads, met = value_and_grad(lambda q: loss_fn(m, q, b, rt.tcfg), p)
        got[key] = (float(met["loss"]), dict(tree_leaves(tree_map(
            lambda t: t.double().cpu(), grads))))
    ref = got["cpu64"][1]

    def gerr(key):
        return max(float((got[key][1][k] - g).abs().max() / g.abs().max())
                   for k, g in ref.items())

    loss64 = got["cpu64"][0]
    err_card, err_cpu = gerr("cuda"), gerr("cpu")
    first_rel = abs(losses[0] - loss64) / loss64
    print(f"  first step: loss float32 card {got['cuda'][0]:.6f}, CPU "
          f"{got['cpu'][0]:.6f}, float64 CPU {loss64:.6f}; gradients "
          f"max|diff|/max|grad| from float64: card {err_card:.2e}, CPU "
          f"float32 {err_cpu:.2e} (tol: card <= 2 x CPU); the run's bf16 "
          f"first loss {losses[0]:.4f}, {first_rel:.2e} from float64 (tol "
          f"{RESNET_BF16_TOL:g}); ln 10 = {math.log(10):.2f} (the "
          f"reference's init gives large logits)")
    check(abs(got["cuda"][0] - loss64) <= 1e-5 * loss64
          and err_card <= 2 * err_cpu and first_rel <= RESNET_BF16_TOL,
          "ResNet-32's first step disagrees with the float64 reference")
    stats = {k: out[k] for k in ("losses", "grad_norms", "step_s", "active",
                                 "lr", "fast_save_s", "fast_save_bytes",
                                 "peak_device_memory_bytes", "wall_s")}
    stats.update(steps_per_s=steady, profiled_wall_s=wall,
                 profiled_busy_s=busy, busy_share=busy / wall,
                 first_loss={k: v[0] for k, v in got.items()},
                 grad_err_vs_float64={"cuda": err_card, "cpu": err_cpu})
    del rt, state, w0, got, ref, prof, kern
    release(torch)
    return stats


@contextlib.contextmanager
def patched(module, **attrs):
    """Set attributes of ``module`` for the block, then restore them."""
    old = {k: getattr(module, k) for k in attrs}
    for k, v in attrs.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(module, k, v)


def gym_phase(torch, card_line):
    """The trace-driven gym on the card: ``launch.train --gym`` at full
    width (a mixed K80/P100 plan, so the hetero allocator runs, and the
    async PS), a revocation whose warning fast-saves, and the execute
    paths on the card against the CPU from the same float32 weights."""
    from repro_torch.config import get_config
    from repro_torch.core import CheckpointManager
    from repro_torch.core.policy import (GreedyCheapest, PolicyDecision,
                                         StaticPolicy)
    from repro_torch.gym import gym as G
    from repro_torch.gym import (TransientGym, execute_async_ps,
                                 execute_masked, intensity_sweep_traces,
                                 training_schedule)
    from repro_torch.launch import train as launch_train
    from repro_torch.models.builder import build_model
    from repro_torch.traces import load_trace
    from repro_torch.train.step import init_state
    from repro_torch.tree import tree_leaves, tree_map

    stats = {}
    # 1. the entry point, ResNet-32 at its published size
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    zero_counts()
    args = launch_train.parse_args(GYM_ARGS + ["--ckpt-dir", CKPT_DIR])
    out, ledger, _ = launch_train.run(args)
    counts = read_counts()
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    short = {k: v for k, v in out.items() if k not in ("losses", "step_s")}
    print("  summary " + json.dumps(short))
    full = get_config(args.arch, reduced=False)
    check(not out["reduced"] and full.resnet_n == 5
          and full.image_size == 32, "the gym did not train ResNet-32")
    kinds = sorted({e.server_kind for e in ledger.schedule})
    check(len(kinds) > 1, f"the plan is not a mixed fleet: {kinds}")
    want_steps = training_schedule(ledger, args.steps).executed_steps
    losses = out["losses"]
    pushes = sum(ledger.staleness_hist.values())
    want_pushes = (args.gym_async_updates if ledger.completed else
                   int(ledger.vsteps_done / ledger.total_steps
                       * args.gym_async_updates))
    check(out["completed"], f"the plan did not complete: {out['failure']}")
    check(out["executed_steps"] == want_steps == len(losses),
          f"executed {out['executed_steps']} steps ({len(losses)} losses), "
          f"the schedule says {want_steps}")
    check(all(map(math.isfinite, losses)) and out["loss_last"]
          < out["loss_first"], f"losses {losses[0]} -> {losses[-1]}")
    check(pushes == want_pushes, f"{pushes} async pushes, the ledger's "
          f"progress implies {want_pushes}")
    check(out["mean_staleness"] > 0.5,
          f"mean staleness {out['mean_staleness']}: the async PS is not "
          f"stale")
    check(counts == dict.fromkeys(kernel_wrappers(), 0),
          f"the gym's ResNet-32 launched a kernel: {counts}")
    step_s = out["step_s"]
    steady = sorted(step_s[1:])[len(step_s[1:]) // 2]
    print(f"  gym, ResNet-32 full width (bf16), {len(kinds)} kinds {kinds}, "
          f"{out['n_events']} membership events, {out['revocations']} "
          f"revocations: wall {out['wall_s']:.2f} s; plan "
          f"{out['plan_s']:.3f} s; {len(losses)} steps in "
          f"{out['train_s']:.2f} s (first {step_s[0]:.3f} s, then median "
          f"{steady * 1e3:.1f} ms a step); loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}; accuracy {out['accuracy']:.3f}; async PS "
          f"{pushes} pushes in {out['async_s']:.2f} s = "
          f"{out['async_pushes_per_s']:.1f} pushes/s, mean staleness "
          f"{out['mean_staleness']:.3f} {out['staleness_hist']} "
          f"[{card_line}]")
    stats["cli"] = dict(short, steady_step_s=steady,
                        first_step_s=step_s[0], kinds=kinds)

    # 2. a revocation inside the run: the warning fast-saves
    ck = CheckpointManager(CKPT_DIR)
    trace = intensity_sweep_traces(0)[1]
    t0 = time.monotonic()
    led = TransientGym(trace, StaticPolicy(PolicyDecision("K80", 4)),
                       seed=0).run(arch="resnet32-cifar10", train_steps=32,
                                   ckpt=ck)
    got = ck.restore_latest("cuda")
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    reason = got[2].get("reason") if got is not None else None
    print(f"  {trace.name}, static 4 x K80, reduced: {led.revocations} "
          f"revocations, {led.fast_saves} fast saves, {led.executed_steps} "
          f"steps, restore_latest reason {reason!r} "
          f"({time.monotonic() - t0:.2f} s)")
    check(led.revocations >= 1 and led.fast_saves >= 1
          and reason == "revocation_warning",
          "no revocation warning fast-saved a restorable checkpoint")
    stats["fast_save"] = {"revocations": led.revocations,
                          "fast_saves": led.fast_saves,
                          "executed_steps": led.executed_steps}
    del got

    # 3. the card against the CPU, reduced, float32, the same weights
    def fp32(arch, reduced=False):
        return get_config(arch, reduced=reduced).replace(dtype="float32")

    host = build_model(fp32(args.arch, True), "cpu")
    w0 = host.init(host.generator(0), dtype=torch.float32)

    def shared_init(model, tcfg, generator=None, params=None):
        return init_state(model, tcfg, params=tree_map(
            lambda t: t.to(model.device, copy=True), w0))

    def ps_err(x, y):
        big = max(float(t.abs().max()) for _, t in tree_leaves(y))
        return max(float((x[k].cpu() - t).abs().max())
                   for k, t in y.items()) / big

    res = {}
    for dev in ("cuda", "cpu"):
        plan = TransientGym(load_trace("volatile"),
                            GreedyCheapest(n_workers=4), refill=True,
                            seed=0).plan()
        with patched(G, get_config=fp32, init_state=shared_init):
            execute_masked(plan, arch=args.arch,
                           train_steps=GYM_PARITY_STEPS, device=dev)
        runs = []
        for updates in (GYM_PS_UPDATES, args.gym_async_updates):
            execute_async_ps(plan, updates=updates, device=dev)
            runs.append((dict(plan.staleness_hist), plan.ps_params))
        res[dev] = plan, runs
    (a, a_ps), (b, b_ps) = res["cuda"], res["cpu"]
    loss_rel = abs(a.final_loss - b.final_loss) / abs(b.final_loss)
    errs = [ps_err(x[1], y[1]) for x, y in zip(a_ps, b_ps)]
    hists_equal = all(x[0] == y[0] for x, y in zip(a_ps, b_ps))
    print(f"  card vs CPU, reduced ResNet-8 float32, {GYM_PARITY_STEPS} "
          f"steps: final loss {a.final_loss:.6f} / {b.final_loss:.6f} "
          f"(rel {loss_rel:.2e}, tol {GYM_LOSS_TOL:g}), accuracy "
          f"{a.accuracy:.4f} / {b.accuracy:.4f}; async PS histograms "
          f"{'equal' if hists_equal else 'DIFFER'} at {GYM_PS_UPDATES} and "
          f"{args.gym_async_updates} pushes, params max|diff|/max|param| "
          f"{errs[0]:.2e} (tol {GYM_PS_TOL:g}) and {errs[1]:.2e} (not "
          f"gated: rounding amplified)")
    check(a.executed_steps == b.executed_steps == GYM_PARITY_STEPS
          and a.fast_saves == b.fast_saves and loss_rel <= GYM_LOSS_TOL,
          "the masked execution on the card disagrees with the CPU")
    check(hists_equal and errs[0] <= GYM_PS_TOL,
          "the async PS on the card disagrees with the CPU")
    stats["parity"] = {"final_loss": [a.final_loss, b.final_loss],
                       "loss_rel": loss_rel,
                       "accuracy": [a.accuracy, b.accuracy],
                       "staleness_hist": a_ps[-1][0],
                       "ps_param_err": dict(zip(
                           (GYM_PS_UPDATES, args.gym_async_updates), errs))}
    del ledger, led, res, a, b, a_ps, b_ps, w0, host
    release(torch)
    return stats


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import kernel as K
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.rwkv6 import kernel as WK
    from repro_torch.kernels.rwkv6 import rwkv6_plain, rwkv6_scan
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_plain
    from repro_torch.launch import serve
    from repro_torch.models.transformer import num_shared_invocations
    from repro_torch.serving import with_impls
    from repro_torch.tree import tree_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {"name": "decode_attention", "route": "cuda", "source": SOURCE,
              "replaces": REPLACES}
    flash_record = {"name": "flash_attention", "route": "cuda",
                    "source": FLASH_SOURCE, "replaces": FLASH_REPLACES}
    ssd_record = {"name": "ssd_scan", "route": "cuda", "source": SSD_SOURCE,
                  "replaces": SSD_REPLACES}
    wkv_record = {"name": "rwkv6_scan", "route": "cuda", "source": WKV_SOURCE,
                  "replaces": WKV_REPLACES}

    with phase("environment"):
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}")
        print(f"  device {torch.cuda.get_device_name(0)} capability "
              f"{torch.cuda.get_device_capability(0)} count "
              f"{torch.cuda.device_count()}")
        print(f"  card {card_line}")

    with phase("build"):
        t0 = time.monotonic()
        times = build_all(build, {"decode_attention": K.SOURCE,
                                  "flash_attention": FK.SOURCE,
                                  "ssd_scan": SK.SOURCE,
                                  "rwkv6": WK.SOURCE})
        for lib in (K, FK, SK, WK):
            lib.library()
        print(f"  built four kernels with nvcc in {time.monotonic() - t0:.1f}"
              f" s (in parallel: " + ", ".join(
                  f"{n} {t:.1f} s" for n, t in times.items()) +
              f") [{card_line}]")
        for name in times:
            print(f"  {name}:")
            for line in build.build_log(name).splitlines():
                if "registers" in line or "spill" in line \
                        or "Compiling entry" in line:
                    print("   ", line.strip())

    with phase("kernel-vs-plain"):
        max_err = 0.0
        for name, shape in SHAPES.items():
            B, H, KV, S = shape[:4]
            for dtype in ("bfloat16", "float32"):
                q, k, v, lens, win = attention_inputs(torch, shape, dtype,
                                                      gen)
                want = decode_attention_plain(q, k, v, lens, window=win)
                # the plan, one split (no merge launch), and three
                for splits in (K.split_plan(B, KV, H, S)[0], 1, 3):
                    got = decode_attention(q, k, v, lens, window=win,
                                           num_splits=splits)
                    torch.cuda.synchronize()
                    err, outside = worst(got, want, allowed(want, dtype))
                    max_err = max(max_err, err)
                    print(f"  {name:7s} {dtype:8s} splits={splits:<3d}: "
                          f"max_abs_err {err:.3e} (tol {TOL_TEXT[dtype]}), "
                          f"{outside} outside")
                    check(outside == 0 and math.isfinite(err),
                          f"kernel disagrees with plain on {name}/{dtype}")
        record["max_abs_err"] = max_err

    with phase("flash-vs-plain"):
        max_err = 0.0
        for name, shape in FLASH_SHAPES.items():
            causal, window = shape[6], shape[7]
            for dtype in ("bfloat16", "float32"):
                q, k, v = flash_inputs(torch, shape, dtype, gen)
                want = flash_attention_plain(q, k, v, causal=causal,
                                             window=window)
                got = flash_attention(q, k, v, causal=causal, window=window)
                torch.cuda.synchronize()
                err, outside = worst(got, want, allowed(want, dtype))
                max_err = max(max_err, err)
                print(f"  {name:13s} {dtype:8s}: max_abs_err {err:.3e} "
                      f"(tol {TOL_TEXT[dtype]}), {outside} outside")
                check(outside == 0 and math.isfinite(err),
                      f"flash kernel disagrees with plain on {name}/{dtype}")
                del q, k, v, want, got
        # at D = 64 P meets V in fp16, V scaled by a power of two into
        # fp16's range: V far beyond either end of it (normal in bf16)
        # gives the plain answer too. Both outputs are divided by v_scale
        # first, so that the bound's mean square stays inside float32.
        shape = FLASH_SHAPES["edge_d64"]
        q, k, v = flash_inputs(torch, shape, "bfloat16", gen)
        for v_scale in (1e6, 1e-15, 1e-30, 3e37):
            vs = (v.float() * v_scale).bfloat16()
            want = flash_attention_plain(q, k, vs, causal=shape[6])
            got = flash_attention(q, k, vs, causal=shape[6])
            torch.cuda.synchronize()
            finite = bool(torch.isfinite(got.float()).all())
            got, want = got.double() / v_scale, want.double() / v_scale
            err, outside = worst(got, want, allowed(want, "bfloat16"))
            print(f"  edge_d64 bfloat16, V x {v_scale:.0e}: max_abs_err "
                  f"{err:.3e} of V's scale (tol {TOL_TEXT['bfloat16']}), "
                  f"{outside} outside")
            check(finite and outside == 0 and math.isfinite(err),
                  f"flash kernel fails at D = 64 with V x {v_scale:.0e}")
        del q, k, v, vs, want, got
        flash_record["max_abs_err"] = max_err
        release(torch)

    with phase("ssd-vs-plain"):
        max_err = 0.0
        for name, shape in SSD_SHAPES.items():
            for dtype in ("bfloat16", "float32"):
                xdt, Bc, Cc, dA = ssd_inputs(torch, shape, dtype, gen)
                t0 = time.monotonic()
                want = ssd_scan_plain(xdt, Bc, Cc, dA)
                torch.cuda.synchronize()
                plain_s = time.monotonic() - t0
                got = ssd_scan(xdt, Bc, Cc, dA)
                torch.cuda.synchronize()
                err, outside = worst(got, want, allowed(want, dtype))
                max_err = max(max_err, err)
                print(f"  {name:10s} {dtype:8s} {shape[:5]}: max_abs_err "
                      f"{err:.3e} (tol {TOL_TEXT[dtype]}), {outside} "
                      f"outside; max|y| {float(want.float().abs().max()):.1f}"
                      f"; plain {plain_s:.2f} s")
                check(outside == 0 and math.isfinite(err)
                      and got.dtype == xdt.dtype,
                      f"SSD kernel disagrees with plain on {name}/{dtype}")
                del xdt, Bc, Cc, dA, want, got
        ssd_record["max_abs_err"] = max_err
        release(torch)

    with phase("rwkv6-vs-plain"):
        max_err = 0.0
        for (name, shape), dtype in itertools.product(
                WKV_SHAPES.items(), ("bfloat16", "float32")):
            args_ = wkv_inputs(torch, shape, gen, dtype)
            t0 = time.monotonic()
            want_o, want_s = rwkv6_plain(*args_)
            torch.cuda.synchronize()
            plain_s = time.monotonic() - t0
            got_o, got_s = rwkv6_scan(*args_)
            torch.cuda.synchronize()
            check(got_o.dtype == args_[0].dtype
                  and got_s.dtype == torch.float32, "WKV output dtypes")
            # the final state is float32 in both: the float32 gate
            for what, got, want, gate in (
                    ("o", got_o, want_o, dtype),
                    ("final state", got_s, want_s, "float32")):
                err, outside = worst(got, want, allowed(want, gate))
                max_err = max(max_err, err)
                print(f"  {name:8s} {dtype:8s} {shape[:4]} {what:11s}: "
                      f"max_abs_err {err:.3e} (tol {TOL_TEXT[gate]}), "
                      f"{outside} outside; max|ref| "
                      f"{float(want.float().abs().max()):.1f}; plain "
                      f"{plain_s:.2f} s")
                check(outside == 0 and math.isfinite(err),
                      f"WKV kernel disagrees with plain on "
                      f"{name}/{dtype}/{what}")
            del args_, want_o, want_s, got_o, got_s
        wkv_record["max_abs_err"] = max_err
        release(torch)

    with phase("decode-cell"):
        args = serve.parse_args(SERVE_ARGS)
        t0 = time.monotonic()
        model, params = serve.build(args)
        torch.cuda.synchronize()
        cfg = model.cfg
        n_bytes = sum(t.numel() * t.element_size()
                      for _, t in tree_leaves(params))
        print(f"  {cfg.name} full width: {cfg.num_layers} layers, d_model "
              f"{cfg.d_model}, {cfg.num_heads}H/{cfg.num_kv_heads}KV, "
              f"weights {n_bytes / 1e9:.2f} GB {cfg.dtype}, init "
              f"{time.monotonic() - t0:.1f} s")
        check(cfg.attn_impl == "cuda" and cfg.num_layers == 30
              and cfg.d_model == 3072, "not the full-width kernel path")
        plain_model = with_impls(model, attn_impl="torch")
        cache = model.init_cache(4, 512)
        for leaf in (cache["kv"]["k"], cache["kv"]["v"]):
            leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                   device="cuda").to(leaf.dtype))
        # row 2 is driven past the cache: its writes must be dropped
        cache["pos"] = torch.tensor([200, 37, 510, 0], dtype=torch.int32,
                                    device="cuda")
        other = {"kv": {k: t.clone() for k, t in cache["kv"].items()},
                 "pos": cache["pos"].clone()}
        agree, rel = [], 0.0
        with torch.no_grad():
            for _ in range(4):
                tok = torch.randint(1, cfg.vocab_size, (4, 1), generator=gen,
                                    device="cuda")
                got, cache = model.decode(params, cache, {"tokens": tok})
                want, other = plain_model.decode(params, other,
                                                 {"tokens": tok})
                rel = max(rel, float((got.float() - want.float()).abs().max()
                                     / want.float().abs().max()))
                agree.append((got.argmax(-1) == want.argmax(-1)).float()
                             .mean().item())
        torch.cuda.synchronize()
        kv_diff = max(float((cache["kv"][k].float() - other["kv"][k].float())
                            .abs().max()) for k in ("k", "v"))
        print(f"  logits cuda vs torch: max|diff|/max|logit| {rel:.3e} "
              f"(tol 0.05), argmax agreement {sum(agree) / len(agree):.3f}; "
              f"cache max|diff| {kv_diff:.3e} [{card_line}]")
        check(rel <= 0.05 and torch.equal(cache["pos"], other["pos"]),
              "full-width decode cell: kernel path and plain path disagree")

    with phase("serve"):
        serve_stats, dense_tokens = serve_and_migrate(
            torch, serve, args, model, params, card_line,
            [(decode_attention, cfg.num_layers), (flash_attention, 0)])
        mean_step = serve_stats["decode_step_ms_mean"]
        record["launches"] = decode_attention.launches

    with phase("serve-paged"):
        pargs = serve.parse_args(SERVE_ARGS + PAGED_ARGS)
        paged_stats, paged_tokens = serve_and_migrate(
            torch, serve, pargs, model, params, card_line,
            [(decode_attention, cfg.num_layers), (flash_attention, 0)])
        check(paged_tokens == dense_tokens, "the paged engine's tokens "
                                            "differ from the dense one's")
        paged_stats["step_compare"] = paged_step_compare(
            torch, serve, model, params, card_line)

    with phase("serve-fleet"):
        fleet_stats = fleet_phase(torch, serve, card_line, model, params)
        release(torch)

    with phase("profile"):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        eng = serve.make_engine(args, model, params)
        for r in serve.make_requests(args, cfg.vocab_size)[:args.max_batch]:
            eng.submit(r)
        while not all(r is not None and r.generated for r in eng.slots):
            eng.step()
        torch.cuda.synchronize()
        n_steps = 3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for _ in range(n_steps):
                eng.step()
            torch.cuda.synchronize()
            step = (time.monotonic() - t0) * 1e3 / n_steps
        kernels = [e for e in prof.events()
                   if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / n_steps
        by_name = {}
        for e in kernels:
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
        # each wrapper call is one device launch of the split pass, and
        # one of the merge when the plan has more than one split
        splits = K.split_plan(args.max_batch, cfg.num_kv_heads,
                              cfg.num_heads, args.max_len)[0]
        attn = {}                           # part -> (ms, launches) per step
        for part in ("decode_split_kernel", "decode_merge_kernel"):
            hits = [tn for nm, tn in by_name.items() if part in nm]
            attn[part] = (sum(t for t, _ in hits) / 1e3 / n_steps,
                          sum(n for _, n in hits) // n_steps)
        check(attn["decode_split_kernel"][1] == cfg.num_layers
              and attn["decode_merge_kernel"][1]
              == (cfg.num_layers if splits > 1 else 0),
              f"decode attention device launches per step {attn} "
              f"({splits} splits)")
        # the profiler slows the host loop, so the idle share is taken
        # against the unprofiled mean decode step of the serve phase
        idle = 1 - busy / mean_step
        profile_stats = {"profiled_step_ms": step,
                         "device_busy_ms_per_step": busy,
                         "device_idle_share": idle,
                         "device_launches_per_step": len(kernels) / n_steps,
                         "decode_attention_ms_per_step": {
                             k: t for k, (t, _) in attn.items()}}
        print(f"  decode step: device busy {busy:.3f} ms of "
              f"{mean_step:.2f} ms (unprofiled; {step:.2f} ms profiled), "
              f"idle share {idle:.3f}, {len(kernels) / n_steps:.0f} device "
              f"launches/step [{card_line}]")
        for name, (tot, n) in top:
            print(f"    {tot / n_steps:9.1f} us/step  x{n // n_steps:<4d} "
                  f"{name[:60]}")
        for part, (t, n) in attn.items():
            print(f"  {part}: {t * 1e3:.1f} us/step over {n} launches "
                  f"[{card_line}]")

    with phase("forward"):
        from repro_torch.data import make_batch
        B, S = FORWARD_BATCH
        batch = make_batch(cfg, B, S, seed=0)
        fwd = forward_check(
            torch, model, with_impls(model, attn_impl="torch"), params,
            batch, [(flash_attention, cfg.num_layers, "flash_fwd"),
                    (decode_attention, 0, "decode_split_kernel")],
            card_line)
        flash_record["launches"] = fwd["kernels"]["flash_attention"][
            "launches"]
        profile_stats["forward"] = fwd
        del batch
        # the serving weights go: training needs the card's memory
        del params, model, eng, cache, other
        release(torch)

    with phase("train"):
        from repro_torch.launch import train as launch_train
        from repro_torch.train.trainer import evaluate_accuracy
        flash_attention.launches = 0
        targs = launch_train.parse_args(TRAIN_ARGS)
        out, trainer, state = launch_train.run(targs)
        tcfg_model = trainer.model
        print("  summary " + json.dumps(out))
        losses, norms = out["losses"], out["grad_norms"]
        vocab = tcfg_model.cfg.vocab_size
        check(len(losses) == 3 and all(map(math.isfinite, losses + norms)),
              "training gave a non-finite loss or gradient norm")
        check(math.log(vocab) <= losses[0] <= 12.3,
              f"first loss {losses[0]:.4f} outside [ln {vocab} = "
              f"{math.log(vocab):.2f}, 12.3]")
        check(out["final_step"] == 3 and out["attn_impl"] == "torch",
              "training did not take 3 steps through the plain attention")
        check(flash_attention.launches == 0,
              "the differentiated forward launched the flash kernel")
        n_params = sum(t.numel() for _, t in tree_leaves(state.params))
        print(f"  {n_params / 1e9:.3f} B float32 parameters; steps "
              + ", ".join(f"{t:.3f} s" for t in out["step_s"])
              + f"; peak device memory "
              f"{out['peak_device_memory_bytes'] / 1e9:.2f} GB [{card_line}]")
        # one more step under the profiler: where a step's device time goes
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            state = trainer.fit(state, 1)
            torch.cuda.synchronize()
            step_ms = (time.monotonic() - t0) * 1e3
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        by_name = {}
        for e in kern:
            tot, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]
        print(f"  profiled step 4: device busy {busy:.1f} ms of {step_ms:.1f}"
              f" ms wall (profiled), {len(kern)} device launches "
              f"[{card_line}]")
        for name, (tot, n) in top:
            print(f"    {tot / 1e3:8.2f} ms  x{n:<5d} {name[:70]}")
        ev_batch = make_batch(tcfg_model.cfg, 2, 1024, seed=99)
        accs = {}
        for impl in ("cuda", "torch"):
            m_eval = with_impls(tcfg_model, attn_impl=impl)
            n0 = flash_attention.launches
            accs[impl] = evaluate_accuracy(m_eval, state.params, ev_batch)
            check((flash_attention.launches - n0)
                  == (tcfg_model.cfg.num_layers if impl == "cuda" else 0),
                  f"evaluation with attn_impl={impl} launched the flash "
                  f"kernel {flash_attention.launches - n0} times")
        with torch.no_grad():
            la, _ = with_impls(tcfg_model, attn_impl="cuda").apply(
                state.params, ev_batch)
            lb, _ = with_impls(tcfg_model, attn_impl="torch").apply(
                state.params, ev_batch)
            eval_agree = float((la.argmax(-1) == lb.argmax(-1)).float()
                               .mean())
        print(f"  evaluate_accuracy of the trained weights: flash "
              f"{accs['cuda']:.6f}, plain {accs['torch']:.6f}; argmax "
              f"agreement {eval_agree:.4f} (reported, not gated)")
        train_stats = {**{k: out[k] for k in (
            "losses", "grad_norms", "step_s", "peak_device_memory_bytes",
            "wall_s", "global_batch", "seq_len")},
            "params": n_params, "eval_accuracy": accs,
            "eval_argmax_agreement": eval_agree,
            "profiled_step_ms": step_ms, "profiled_device_busy_ms": busy,
            "profiled_device_launches": len(kern)}
        del trainer, state, tcfg_model, m_eval, la, lb, ev_batch, prof, kern
        release(torch)

    with phase("train-parity"):
        from repro_torch.bridge import params_from_numpy
        from repro_torch.config import (OptimizerConfig, ScheduleConfig,
                                        TrainConfig, get_config)
        from repro_torch.data import ShardedDataset
        from repro_torch.models.builder import build_model
        from repro_torch.train.step import init_state
        from repro_torch.train.trainer import Trainer
        tcfg = TrainConfig(
            optimizer=OptimizerConfig(name="adamw", lr=1e-3, grad_clip=1.0),
            schedule=ScheduleConfig(kind="cosine", warmup_steps=2,
                                    total_steps=10))
        parity = {}
        for arch in PARITY_ARCHS:
            pcfg = get_config(arch, reduced=True).replace(
                dtype="float32", attn_impl="torch", ssm_impl="torch",
                rwkv_impl="torch")
            host = build_model(pcfg, "cpu")
            tree = tree_map(lambda t: t.numpy(), host.init(
                host.generator(0), dtype=torch.float32))
            logs = {}
            for dev in ("cuda", "cpu"):
                m = build_model(pcfg, dev)
                ds = ShardedDataset(pcfg, global_batch=4, seq_len=64, seed=1,
                                    device=dev)
                tr = Trainer(m, tcfg, ds, log_every=1)
                tr.fit(init_state(m, tcfg, params=params_from_numpy(
                    tree, pcfg, dev, dtype=torch.float32)), 3)
                logs[dev] = tr.metrics_log
            worst_rel = 0.0
            for a, b in zip(logs["cuda"], logs["cpu"]):
                for key in ("loss", "grad_norm"):
                    worst_rel = max(worst_rel, abs(a[key] - b[key])
                                    / abs(b[key]))
            print(f"  {arch} reduced fp32, 3 steps: losses cuda "
                  + ", ".join(f"{r['loss']:.6f}" for r in logs["cuda"])
                  + " / cpu " + ", ".join(f"{r['loss']:.6f}"
                                          for r in logs["cpu"])
                  + f"; worst relative difference (loss, grad_norm) "
                    f"{worst_rel:.2e} (tol 1e-4)")
            check(len(logs["cuda"]) == 3 and worst_rel <= 1e-4,
                  f"{arch}: training on the card and on the CPU disagree")
            parity[arch] = worst_rel

    with phase("elastic"):
        elastic_stats = elastic_phase(torch, card_line)

    with phase("checkpoint-resume"):
        checkpoint_stats = checkpoint_phase(torch, card_line)

    with phase("resnet32"):
        resnet_stats = resnet_phase(torch, card_line)

    with phase("gym"):
        gym_stats = gym_phase(torch, card_line)

    recurrent = {}                # arch -> (model, params, stats)
    for arch, ph in zip(RECURRENT_ARCHS, ("hybrid-forward", "rwkv-forward")):
        with phase(ph):
            rargs = serve.parse_args(SERVE_ARGS + ["--arch", arch])
            t0 = time.monotonic()
            rmodel, rparams = serve.build(rargs)
            torch.cuda.synchronize()
            rcfg = rmodel.cfg
            n_bytes = sum(t.numel() * t.element_size()
                          for _, t in tree_leaves(rparams))
            print(f"  {rcfg.name} full width: {rcfg.num_layers} layers, "
                  f"d_model {rcfg.d_model}, weights {n_bytes / 1e9:.2f} GB "
                  f"{rcfg.dtype}, init {time.monotonic() - t0:.1f} s")
            check((rcfg.attn_impl, rcfg.ssm_impl, rcfg.rwkv_impl)
                  == ("cuda",) * 3, "not the kernel path")
            if rcfg.family == "hybrid":
                check(rcfg.num_layers == 38 and rcfg.d_model == 2048
                      and rcfg.ssm_heads * rcfg.ssm_head_dim == 4096,
                      "not zamba2-1.2b at full width")
                n_shared = num_shared_invocations(rcfg)
                expect = [(ssd_scan, rcfg.num_layers, "ssd_scan_tc_kernel"),
                          (flash_attention, n_shared, "flash_fwd"),
                          (rwkv6_scan, 0, "wkv_token_kernel")]
            else:
                check(rcfg.num_layers == 32 and rcfg.d_model == 4096
                      and rcfg.d_ff == 14336, "not rwkv6-7b at full width")
                expect = [(rwkv6_scan, rcfg.num_layers,
                           "wkv_token_kernel"),
                          (ssd_scan, 0, "ssd_scan"),
                          (flash_attention, 0, "flash_fwd")]
            batch = make_batch(rcfg, *FORWARD_BATCH, seed=0)
            plain = with_impls(rmodel, attn_impl="torch", ssm_impl="torch",
                               rwkv_impl="torch")
            stats = forward_check(torch, rmodel, plain, rparams, batch,
                                  expect + [(decode_attention, 0,
                                             "decode_split_kernel")],
                                  card_line, fp32_gate=True)
            rec = ssd_record if rcfg.family == "hybrid" else wkv_record
            rec["launches"] = stats["kernels"][rec["name"]]["launches"]
            recurrent[arch] = (rmodel, rparams, {"forward": stats})
            del batch, plain
            release(torch)

    with phase("serve-recurrent"):
        for arch, (rmodel, rparams, stats) in recurrent.items():
            rargs = serve.parse_args(SERVE_ARGS + ["--arch", arch])
            rcfg = rmodel.cfg
            per_cell = (num_shared_invocations(rcfg)
                        if rcfg.family == "hybrid" else 0)
            # the kernels of the full-sequence path never run while
            # serving: every token goes through the decode cell
            expect = [(decode_attention, per_cell), (ssd_scan, 0),
                      (rwkv6_scan, 0), (flash_attention, 0)]
            stats["serve"], dense_rec = serve_and_migrate(
                torch, serve, rargs, rmodel, rparams, card_line, expect)
            if rcfg.family != "hybrid":
                continue
            # zamba2 with the paged cache: its shared block's KV in pages,
            # the same tokens and decode launches as the dense cache
            pargs = serve.parse_args(SERVE_ARGS + ["--arch", arch,
                                                   *PAGED_ARGS])
            stats["serve_paged"], paged_rec = serve_and_migrate(
                torch, serve, pargs, rmodel, rparams, card_line, expect)
            check(paged_rec == dense_rec, f"{rcfg.name}: the paged engine's "
                                          f"tokens differ from the dense one's")
            stats["step_compare"] = paged_step_compare(
                torch, serve, rmodel, rparams, card_line, ["--arch", arch])
            stats["decode_logit_rel_diff"] = decode_check(
                torch, rmodel, rparams, gen, card_line)
        recurrent_stats = {arch: st for arch, (_, _, st) in recurrent.items()}
        del recurrent, rmodel, rparams
        release(torch)

    with phase("timing"):
        # decode: the serve cell's shape, a long cache, zamba2's decode
        # cell (H = KV = 32, D = 64), all at full lengths
        timings = []
        for name in ("serve", "long", "zamba2_decode"):
            shape = SHAPES[name]
            B, H, KV, S, D, _, win = shape
            per_copy = 2 * B * S * KV * D * 2
            n = max(2, math.ceil(2 * L2_BYTES / per_copy))
            ins = [attention_inputs(torch, shape, "bfloat16", gen)
                   for _ in range(n)]
            masks = [(torch.arange(S, device="cuda")[None, :]
                      < lens[:, None])[:, None, None, :]
                     for _, _, _, lens, _ in ins]
            q, k, v, lens, _ = ins[0]
            # a sanity check that both yardsticks compute the same function
            # (their bf16 probabilities round more than the kernel's)
            want = decode_attention_plain(q, k, v, lens)
            for mask in (masks[0], None):
                sdpa = F.scaled_dot_product_attention(
                    q[:, :, None], k, v, attn_mask=mask, enable_gqa=True)
                err, outside = worst(sdpa[:, :, 0], want,
                                     2e-2 * (1 + want.float().abs()))
                check(outside == 0,
                      "SDPA yardstick computes another function")
            ms = device_ms(torch, lambda i: decode_attention(
                *ins[i][:4], window=win), n)
            plain = device_ms(torch, lambda i: decode_attention_plain(
                *ins[i][:4], window=win), n)
            masked = device_ms(torch, lambda i: F.scaled_dot_product_attention(
                ins[i][0][:, :, None], ins[i][1], ins[i][2],
                attn_mask=masks[i], enable_gqa=True), n)
            # the lengths are full, so SDPA without the mask computes the
            # same function here: the library yardstick is that call
            lib = device_ms(torch, lambda i: F.scaled_dot_product_attention(
                ins[i][0][:, :, None], ins[i][1], ins[i][2],
                enable_gqa=True), n)
            bms, by, nbytes = bound_ms(shape, "bfloat16", lens.tolist())
            ns = K.split_plan(B, KV, H, S)[0]
            print(f"  {name}: B={B} H={H} KV={KV} S={S} D={D} bf16, full "
                  f"lengths: kernel {ms * 1e3:.2f} us, plain "
                  f"{plain * 1e3:.2f} us, sdpa {lib * 1e3:.2f} us (with the "
                  f"length mask {masked * 1e3:.2f} us); bound "
                  f"{bms * 1e3:.2f} us ({by}, {nbytes / 1e6:.1f} MB); "
                  f"kernel at {nbytes / ms / 1e9:.3f} TB/s, "
                  f"{bms / ms:.3f} of the bound; {ns} splits, {n} input "
                  f"copies [{card_line}]")
            timings.append({"shape": name, "B": B, "H": H, "KV": KV, "S": S,
                            "D": D, "dtype": "bfloat16", "num_splits": ns,
                            "ms": ms, "plain_ms": plain, "library_ms": lib,
                            "library_masked_ms": masked,
                            "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                            "achieved_GBps": nbytes / ms / 1e6,
                            "bound_share": bms / ms})
            del ins, masks
        serve_t = timings[0]
        record.update(ms=serve_t["ms"], plain_ms=serve_t["plain_ms"],
                      bound_ms=serve_t["bound_ms"],
                      bound_by=serve_t["bound_by"],
                      library_ms=serve_t["library_ms"])

        # flash: the starcoder2 forward, a gemma3 local layer, zamba2's
        # shared block
        flash_timings = []
        for name in ("forward", "gemma3_window", "zamba2"):
            shape = FLASH_SHAPES[name]
            B, Sq, Sk, H, KV, D, causal, win = shape
            per_copy = 2 * (2 * B * Sq * H * D + 2 * B * Sk * KV * D)
            n = max(2, math.ceil(2 * L2_BYTES / per_copy))
            ins = [flash_inputs(torch, shape, "bfloat16", gen)
                   for _ in range(n)]
            pos = torch.arange(Sq, device="cuda")
            mask = (pos[None, :] <= pos[:, None]) & (
                pos[None, :] > pos[:, None] - win) if win > 0 else None

            def sdpa(i):
                q, k, v = (x.transpose(1, 2) for x in ins[i])
                return F.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask, is_causal=mask is None,
                    enable_gqa=True).transpose(1, 2)

            # a sanity check that the yardstick computes the same function
            # (its bf16 probabilities round more than the kernel's)
            want = flash_attention_plain(*ins[0], causal=causal, window=win)
            err, outside = worst(sdpa(0), want,
                                 2e-2 * (1 + want.float().abs()))
            check(outside == 0, "SDPA yardstick computes another function")
            del want

            ms = device_ms(torch, lambda i: flash_attention(
                *ins[i], causal=causal, window=win), n, calls=16, reps=3)
            plain = device_ms(torch, lambda i: flash_attention_plain(
                *ins[i], causal=causal, window=win), n, calls=2, reps=3)
            lib = device_ms(torch, sdpa, n, calls=16, reps=3)
            bms, by, flops, nbytes = flash_bound_ms(shape, "bfloat16")
            print(f"  flash {name}: B={B} S={Sq} H={H} KV={KV} D={D} "
                  f"window={win} bf16: kernel {ms * 1e3:.1f} us, plain "
                  f"{plain * 1e3:.1f} us, sdpa "
                  f"{lib * 1e3:.1f} us; bound {bms * 1e3:.1f} us ({by}, "
                  f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); kernel "
                  f"at {flops / ms / 1e9:.1f} TFLOP/s, {bms / ms:.3f} of the "
                  f"bound [{card_line}]")
            flash_timings.append({
                "shape": name, "B": B, "S": Sq, "H": H, "KV": KV, "D": D,
                "window": win, "dtype": "bfloat16", "ms": ms,
                "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
                "bound_by": by, "flops": flops, "bytes": nbytes,
                "achieved_TFLOPs": flops / ms / 1e9, "bound_share": bms / ms})
            del ins
            release(torch)
        fwd_t = flash_timings[0]
        flash_record.update(ms=fwd_t["ms"], plain_ms=fwd_t["plain_ms"],
                            bound_ms=fwd_t["bound_ms"],
                            bound_by=fwd_t["bound_by"],
                            library_ms=fwd_t["library_ms"])

        # no single PyTorch call computes the SSD scan or the WKV
        # recurrence: their library column is null
        shape = SSD_SHAPES["forward"]
        B, S, H, P, N, _ = shape
        n = max(2, math.ceil(2 * L2_BYTES / (2 * 2 * B * S * H * P)))
        ins = [ssd_inputs(torch, shape, "bfloat16", gen) for _ in range(n)]
        ms = device_ms(torch, lambda i: ssd_scan(*ins[i]), n, calls=16,
                       reps=3)
        plain = device_ms(torch, lambda i: ssd_scan_plain(*ins[i]), n,
                          calls=1, reps=2)
        bms, by, flops, nbytes = ssd_bound_ms(shape, "bfloat16")
        print(f"  ssd_scan forward: B={B} S={S} H={H} P={P} N={N} bf16: "
              f"kernel {ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, no "
              f"library call; bound {bms * 1e3:.1f} us ({by}, "
              f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
              f"[{card_line}]")
        ssd_timing = {"shape": "forward", "B": B, "S": S, "H": H, "P": P,
                      "N": N, "dtype": "bfloat16", "ms": ms,
                      "plain_ms": plain, "library_ms": None,
                      "bound_ms": bms, "bound_by": by, "flops": flops,
                      "bytes": nbytes, "achieved_GBps": nbytes / ms / 1e6}
        ssd_record.update(ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                          library_ms=None)
        del ins
        release(torch)

        # WKV: the float32 row (fused views, nonzero s0) and the model's
        # own call (bf16 r, k, v and o, zero s0); the record carries the
        # model's call, the main path's
        wkv_timings = []
        for name, dtype in (("forward", "float32"), ("model", "bfloat16")):
            shape = WKV_SHAPES[name]
            B, S, H, D, with_s0 = shape[:5]
            bms, by, flops, nbytes = wkv_bound_ms(shape, dtype)
            n = max(2, math.ceil(2 * L2_BYTES / nbytes))
            ins = [wkv_inputs(torch, shape, gen, dtype) for _ in range(n)]
            ms = device_ms(torch, lambda i: rwkv6_scan(*ins[i]), n,
                           calls=16, reps=3)
            plain = device_ms(torch, lambda i: rwkv6_plain(*ins[i]), n,
                              calls=1, reps=2)
            print(f"  rwkv6_scan {name}: B={B} S={S} H={H} D={D} {dtype} "
                  f"r/k/v/o, {'nonzero' if with_s0 else 'zero'} s0: kernel "
                  f"{ms * 1e3:.1f} us, plain {plain * 1e3:.1f} us, no "
                  f"library call; bound {bms * 1e3:.1f} us ({by}, "
                  f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
                  f"{bms / ms:.3f} of it [{card_line}]")
            wkv_timings.append({
                "shape": name, "B": B, "S": S, "H": H, "D": D,
                "dtype": dtype, "s0": with_s0, "ms": ms, "plain_ms": plain,
                "library_ms": None, "bound_ms": bms, "bound_by": by,
                "flops": flops, "bytes": nbytes,
                "achieved_GBps": nbytes / ms / 1e6, "bound_share": bms / ms})
            del ins
            release(torch)
        fp32_t, model_t = wkv_timings
        wkv_record.update(
            ms=model_t["ms"], plain_ms=model_t["plain_ms"],
            bound_ms=model_t["bound_ms"], bound_by=model_t["bound_by"],
            library_ms=None, float32_row={
                k: fp32_t[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by")})
        print(json.dumps({"kernel_timings": timings,
                          "flash_timings": flash_timings,
                          "ssd_timing": ssd_timing,
                          "wkv_timings": wkv_timings,
                          "serve": serve_stats, "profile": profile_stats,
                          "serve_paged": paged_stats, "fleet": fleet_stats,
                          "train": train_stats, "train_parity": parity,
                          "elastic": elastic_stats,
                          "checkpoint": checkpoint_stats,
                          "resnet32": resnet_stats, "gym": gym_stats,
                          "recurrent": recurrent_stats,
                          "card": card_line}))

    print(json.dumps({"kernels": [record, flash_record, ssd_record,
                                  wkv_record]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
