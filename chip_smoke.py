#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths at full width with random weights from a
seed, through the hand-written CUDA kernels (decode attention, flash
attention, the Mamba-2 SSD scan and its glue, the RWKV-6 WKV recurrence):
serving starcoder2-3b (30 layers, d_model 3072, 24 heads / 2 KV heads,
bf16) with the dense and the paged cache and as a fleet of transient
replicas replaying a request trace, its full-sequence forward, its training step and its training on
transient servers (elastic slots, the warning's fast save, restore);
the paper's ResNet-32 trained elastically and through the trace-driven
gym; the full-width
forwards of zamba2-1.2b (38 Mamba-2 layers, d_model 2048, 64 SSM heads x
P 64, N 64, a shared attention block every 6 layers) and rwkv6-7b (32
layers, d_model 4096, 64 heads x 64, d_ff 14336); serving both; and the
MoE family's moonshot-v1-16b-a3b (48 layers, d_model 2048, 16 heads = 16
KV heads of 128, 64 experts of width 1408, top-6, 2 shared experts, a
dense first layer, vocab 163840; 56.8 GB of bf16 weights), its forward
and serving it; the multimodal qwen2-vl-7b (28 layers, d_model 3584, 28
heads over 4 KV heads of 128, M-RoPE, a patch-embedding prefix; 15.23
GB), its forward and serving it; and the encoder-decoder
seamless-m4t-large-v2 (24 + 24 layers, d_model 1024, 16 heads of 64,
vocab 256206), its forward and its decoding; and the SPMD layer (the
sharding layouts, the sharded training step, the expert-parallel MoE
routes) on a one-rank NCCL mesh. In phases that each print their name,
``ok`` and their wall time:

1. environment: torch, CUDA, the card and its power limit;
2. build: compile the five kernel sources from ``src/repro_torch`` with
   nvcc, one nvcc per source, started together, and print their ptxas
   lines;
3. kernel-vs-plain: the decode kernel against its plain PyTorch version
   on the serve shape, a long cache, a window, one KV head, ragged
   lengths (0 and past the cache), zamba2's shared block (H = KV = 32,
   D = 64), moonshot's decode cell (H = KV = 16, D = 128; full and ragged
   lengths), the tensor-core path's tile edges (S = 65, G = 48 with a
   window), qwen2-vl's cell (a GQA group of 7; full and ragged lengths)
   and seamless's self and cross caches (D = 64; the cross cache full in
   every row, at S = 1024 and at S = 1000, not a multiple of the 64-key
   tile), in bf16 and fp32, with the split plan, one split and three;
4. flash-vs-plain: the flash kernel against its plain version on the
   starcoder2 forward shape, a gemma3 local layer, MQA, a ragged length,
   non-causal attention, D=64, zamba2's shared block, moonshot's
   forward (B = 4, S = 2048, H = KV = 16, D = 128), the wgmma
   kernel's tile edges (S = 127, 129, a window that cuts a tile, and
   Sq = 129 against Sk = 127 at D = 64), qwen2-vl's forward (a group of
   7), seamless's encoder and cross-attention (non-causal, D = 64,
   S = 1024) and decoder (causal), and a ragged non-causal D = 64 case
   (Sq = 1000 against Sk = 777), in bf16 and fp32; and, at
   D = 64, where P meets V in fp16, V far beyond either end of fp16's
   range;
5. ssd-vs-plain: the SSD kernels (bf16: tensor cores; fp32: CUDA
   cores) against their plain version (the per-token recurrence) on
   zamba2's forward shape, a ragged S, fast decays, head counts that are
   not a multiple of the bf16 kernel's two-head blocks (3, 5), S = 63, 64
   and 65, P = N = 32 and a long (8192-token) slowly decaying sequence,
   with B and C read as column slices, in bf16 and fp32; and a tp rank's
   head block at train_4k's per-rank shape on the 16 x 16 mesh (B = 16,
   S = 4096, 4 of the 64 heads, B and C column slices of the rank's
   384-channel conv output [x, B, C]) against its plain version and the
   same heads of the 64-head call;
5b. glue-vs-plain: the Mamba-2 glue kernels (``conv_silu_dt``: the
   causal conv with SiLU, dt, dA and xdt in one pass; ``gated_rms_norm``:
   the skip-gated RMS norm) against their plain versions, bf16 and fp32,
   inputs as column slices of one projection: the benchmark cell's shape
   (B = 8, S = 4096, zamba2's widths), S = 3 and 4097, reduced zamba2, a
   reduced config whose slices are not 16-byte aligned and zamba2's
   widths with every slice 4 bytes off (narrower loads, not refused), a
   tp rank's heads (4 of 64); outputs equal or within one bf16 ulp (16
   float32 ulps), each wrapper launched once a call;
6. rwkv6-vs-plain: the WKV kernel against its plain version, every shape
   with r, k, v (and o) in bf16 and in fp32: rwkv6's forward shape with
   pathological decays, with a nonzero and a zero initial state, r, k, v
   as views of one fused projection and as the model's contiguous
   tensors; a ragged S; S = 1, 31, 32, 33 around the kernel's 32-token
   blocks; D = 16 and 32; and 8192 slowly decaying tokens (the largest
   state); outputs and final states (float32); and a tp rank's head
   block (B = 16, S = 4096, 4 of the 64 heads of the column-parallel r,
   k, v) against its plain version and the same heads of the 64-head
   call;
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
    time from torch.profiler (a profiled forward after a warm-up one, in
    every forward phase);
12b. tp-serve: the same weights through the tp layout's sharded
    programs on a one-rank NCCL mesh: ``make_forward(param_shardings=)``
    on the forward's batch, then a 16-token prompt through the sharded
    ``make_prefill_step`` and 32 cells of the sharded ``make_serve_step``
    on the rank's cache block (per-use gathers, the heads, ff and
    vocabulary as the rank's blocks, their all-reduces); logits within
    the bf16 gate of the unsharded kernel path's, tokens equal to the
    unsharded steps', flash once per layer, decode attention once per
    layer a cell;
13. train: three steps of ``python -m repro_torch.launch.train --full``
    (through its ``run``), finite losses and gradient norms, the first
    loss near ln(vocab); a fourth step under torch.profiler; then
    ``evaluate_accuracy`` of the trained weights through the flash kernel
    and through the plain attention;
14. train-parity: three ``Trainer.fit`` steps of reduced starcoder2-3b,
    gemma3-27b, zamba2-1.2b, rwkv6-7b, moonshot-v1-16b-a3b and
    arctic-480b in float32 on the card against the same steps on the
    CPU, from the same numpy weights; the MoE models' router aux loss
    nonzero and equal on both;
14b. spmd-train: the SPMD layer on a one-rank NCCL mesh (1 x 1) on the
    card: the train phase's full-width starcoder2-3b and batches, 3 steps
    of ``make_train_step(param_shardings=..., zero1_mask=...)`` under
    ``zero1`` and ``fsdp`` at ``grad_dtype`` float32 and bfloat16 and
    under ``tp`` at float32 (the state each rank's blocks; zero1 gathers
    the compute copy once a step, fsdp and tp per use, tp with its
    tensor-parallel compute and vocabulary-parallel loss; the gradients
    reduce-scattered) against 3 static float32 steps: float32 losses,
    gradient norms and parameters within the CPU tests' tolerances, bf16
    updates with a cosine above 0.98; step walls, peak memory and, for
    zero1's and fsdp's float32 runs, the device launches of a profiled
    step and a counted step (FLOPs, collectives); then zamba2-1.2b at full
    width under tp (float32 gradients; its Mamba-2 heads as the rank's,
    the gated norm's all-reduce) against its own static step, with the
    float32 gates;
14c. dryrun: ``repro_torch.launch.dryrun`` tied to the card: spmd-train's
    zero1 and fsdp float32 cells (full-width starcoder2-3b, global batch
    2 x 1024) run on fake tensors over a fake 1 x 1 process group (a
    subprocess each) must count the FLOPs and the collectives (kind,
    count, bytes) that the card's counted step of that layout counted;
    each cell's analytic FLOPs
    against that count, its H100 roofline (compute, memory, bound)
    against the measured step and its analytic HBM bytes against the
    measured peak; then three production cells on 256 fake ranks on the
    host (starcoder2-3b train_4k, moonshot-v1-16b-a3b decode_32k,
    rwkv6-7b long_500k) through ``python -m repro_torch.launch.dryrun``,
    each artifact's analytic numbers equal to a direct call of
    ``repro_torch.analytic``;
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
    kernel in the profiled bf16 forward, 38 of each glue kernel, and 6
    flash) and through the
    plain paths, in bf16 and in float32: the float32 logits must agree
    within 1e-3 x max|logit|, and the bf16 kernel path must be no further
    from them, in root mean square, than 1.5x the bf16 plain path (bf16
    rounding alone moves these random models' logits by several percent
    of max|logit|); a profiled device breakdown;
20. rwkv-forward: the same for rwkv6-7b (32 WKV launches), the plain
    path being the sequential scan, at the same B=4, S=2048, with the
    reference's block (``config.reference_block``; the recurrent phases
    below reuse that model): random full-width Finch amplifies float32
    rounding far past the 1e-3 gate (kernel against plain 0.58 of
    max|logit|), so its full-width forward is held to the float32
    reference by the benchmark cell ``rwkv6-7b.forward-4x4096``;
20b. tp-recurrent: phase 12b's sharded programs for both recurrent
    models (bf16, the kernel paths) on a one-rank NCCL mesh: their
    Mamba-2 and RWKV-6 layers on the rank's heads, the cache the rank's
    block (``specs.cache_block``); logits within the bf16 gate of the
    unsharded kernel path's, tokens equal to the unsharded steps', SSD
    38, ``conv_silu_dt`` 38 (a rank's conv slice), ``gated_rms_norm`` 0
    (its mean is all-reduced over the ranks: the plain norm) and flash 6
    times a zamba2 forward, WKV 32 times an rwkv6 forward, decode
    attention 6 times a zamba2 cell;
21. serve-recurrent: each family served at full width as in phase 8
    (undisturbed, then revoke + drain; migrated tokens equal), zamba2's
    decode cell running 6 decode-attention launches, and zamba2 again
    with the paged cache (the dense run's tokens, pages shipped; dense
    and paged decode steps in turns, as in phase 9); zamba2 decode logits
    through the kernel and the plain attention must agree, in float32
    within 1e-3 and in bf16 as the forwards' gate says;
22. moe-forward: moonshot at its published widths, B=4, S=2048: at a
    depth of 4 (1 dense + 3 MoE layers) the float32 and bf16 gates of
    phase 19; then all 48 layers in bf16 through ``launch.serve``'s
    ``build``: finite logits, a positive aux, flash 48 times, the
    weights' bytes and peak memory, and a profiled device breakdown into
    the MoE einsums, the routing glue, the rest of the MoE FFN, flash and
    the rest;
23. moe-serve: ``launch.serve --no-reduced --arch moonshot-v1-16b-a3b``
    through its ``run`` (phase 8's requests), then a revocation and a
    drain (migrated tokens equal), again with the paged cache (the dense
    tokens, pages shipped), decode attention 48 times a cell, and dense
    and paged decode steps in turns (wall, device-busy share);
23b. moe-ep: the expert-parallel MoE routes on phase 22's full-width
    moonshot weights, on a one-rank NCCL mesh: ``moe_impl="ep"`` (layout
    tp) against the row-local path and ``"a2a"`` (layout fsdp) against
    its oracle (each rank's tokens dispatched row-locally at the a2a
    capacity), at a depth of 4 in float32 (within 1e-3) and at all 48
    layers in bf16 (1.5x the oracle's own bf16 distance from its float32
    logits; flash 48 times a forward); then 32 greedy decode cells under
    a2a (decode attention 48 times a cell), the tokens equal to the
    oracle's; ``ffn.moe_routes`` shows every MoE layer took the
    route; wall, device busy and launches of each;
24. vlm-forward: qwen2-vl-7b at its published widths, B=4, S=2048 from
    ``make_batch`` at seed 0 (484 patch positions, a 22 x 22 grid, and
    1564 text tokens): at a depth of 4 the float32 and bf16 gates of
    phase 19, then all 28 layers through ``launch.serve``'s ``build``
    with the same gates (the float32 forwards cast each bf16 weight at
    use): flash 28 times and a profiled device breakdown;
25. vlm-serve: ``launch.serve --no-reduced --arch qwen2-vl-7b`` (text
    only, the dense decode cell) through its ``run`` as phase 23:
    undisturbed, revocation and drain, paged; decode attention 28 times
    a cell; dense and paged decode steps in turns;
26. encdec-forward: seamless-m4t-large-v2 at its published widths and
    depth, B=4, S=2048 (1024 frames into the encoder, 1024 decoder
    tokens): the float32 and bf16 gates at full depth; flash 72 times
    (24 non-causal encoder layers, 24 causal decoder self-attentions, 24
    non-causal cross-attentions);
27. encdec-decode: ``Model.init_cache`` (B=4, max_len 512, enc_len
    1024), ``encode_for_decode`` (flash 24 times) and 32 greedy steps of
    ``make_serve_step`` (decode attention 48 times a cell: self and
    cross); the float32 kernel path's tokens equal the plain path's;
    the decode cell's host wall and device busy;
27b. decode-seq-split: the decode kernel at zamba2's long_500k attention
    shape (B = 1, H = KV = 32, D = 64, S = 524,288, bf16; K and V 4.3
    GB), the cache split into 2 and into 16 blocks: each block's partial
    (its offset, its (m, l) output), merged, against the unsplit kernel
    call and the plain version within the bf16 gate, for the whole
    cache, a length ending inside a block, a window across a block edge
    and a length past the cache; the unsplit call's (m, l) against the
    plain version's; device times of the unsplit call with and without
    the (m, l) output, the plain version and mask-free SDPA, beside the
    bound;
28. timing: device time of each kernel, its plain version and, where
    one PyTorch call computes the same function,
    ``scaled_dot_product_attention`` (the library yardstick, which the
    port never calls) beside the kernel's bound and the share of it
    reached: decode at the serve shape, a long cache and zamba2's decode
    cell, moonshot's, qwen2-vl's and seamless's self and cross caches
    (SDPA with the length mask and, since the lengths are full, without
    one); flash at the starcoder2 forward, a gemma3 local layer, zamba2's
    shared block, moonshot's and qwen2-vl's forwards and seamless's
    encoder and decoder layers;
    the SSD scan at zamba2's forward; WKV at
    rwkv6's forward in fp32 (fused views, nonzero s0) and as the model
    calls it (bf16 r, k, v and o, zero s0); both at a tp rank's head
    block (phases 5 and 6, bf16); the two glue kernels at the benchmark
    cell's shape (B = 8, S = 4096, bf16; no single PyTorch call computes
    either).

Any failure raises and exits non-zero. The last lines are the kernel
records (JSON), the card's name and power limit, and
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits non-zero
without one or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
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
# no TPU kernel: the reference leaves the Mamba-2 glue to XLA
GLUE_REPLACES = None
GLUE_SOURCE = "src/repro_torch/kernels/mamba_glue/csrc/mamba_glue.cu"
GLUE_KERNELS = ("conv_silu_dt", "gated_rms_norm")
GLUE_ULPS = {"bfloat16": 1, "float32": 16}

# name: (B, H, KV, S, D, lengths or None for full, window)
SHAPES = {
    "serve": (4, 24, 2, 512, 128, None, 0),
    "long": (8, 24, 2, 4096, 128, None, 0),
    "window": (4, 24, 2, 512, 128, [512, 300, 50, 0], 128),
    "kv1": (4, 24, 1, 512, 128, [512, 257, 33, 1], 0),
    "ragged": (4, 24, 2, 512, 128, [0, 1, 333, 700], 0),
    "zamba2": (4, 32, 32, 512, 64, [512, 300, 17, 0], 0),  # shared block
    "zamba2_decode": (4, 32, 32, 512, 64, None, 0),  # its decode cell
    # moonshot-v1-16b-a3b's decode cell: H = KV = 16 (no GQA) at D = 128
    "moonshot": (4, 16, 16, 512, 128, None, 0),
    "moonshot_ragged": (4, 16, 16, 512, 128, [512, 300, 17, 0], 0),
    # the tensor-core path's tile edges (64 keys): S = 64 + 1 with a
    # length of 64 - 1, and G = 48 with a window that cuts tiles
    "edge65": (2, 24, 2, 65, 128, [65, 63], 0),
    "g48": (2, 48, 1, 600, 128, [600, 450], 100),
    # qwen2-vl-7b's decode cell: a GQA group of 7 (28 heads over 4)
    "qwen2vl": (4, 28, 4, 512, 128, None, 0),
    "qwen2vl_ragged": (4, 28, 4, 512, 128, [512, 300, 17, 0], 0),
    # seamless-m4t-large-v2's decode cell at D = 64: the self-attention
    # cache and the cross-attention cache over 1024 encoder frames, full
    # in every row; and a cross cache of 1000 frames (not a multiple of
    # the 64-key tile), full in every row
    "seamless_self": (4, 16, 16, 512, 64, None, 0),
    "seamless_cross": (4, 16, 16, 1024, 64, None, 0),
    "cross1000": (2, 16, 16, 1000, 64, None, 0),
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
    "moonshot": (4, 2048, 2048, 16, 16, 128, True, 0),  # moonshot forward
    # the wgmma kernel's tile edges (128 queries x 128 keys)
    "edge127": (2, 127, 127, 8, 2, 128, True, 0),
    "edge129": (2, 129, 129, 8, 2, 128, False, 0),
    "window_cut": (1, 600, 600, 8, 2, 128, True, 200),
    "edge_d64": (2, 129, 127, 8, 2, 64, False, 0),    # fp16 P at D = 64
    "qwen2vl": (4, 2048, 2048, 28, 4, 128, True, 0),   # a group of 7
    # seamless: the encoder and the cross-attention (non-causal), the
    # decoder's self-attention (causal), and a ragged non-causal D = 64
    "seamless_enc": (4, 1024, 1024, 16, 16, 64, False, 0),
    "seamless_dec": (4, 1024, 1024, 16, 16, 64, True, 0),
    "ragged_nc_d64": (2, 1000, 777, 16, 16, 64, False, 0),
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
    # rwkv6-7b.forward-4x4096's call: 4 rows of the published context
    "cell": (4, 4096, 64, 64, False, False, -8.0),
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
# a tp rank's head block at train_4k's per-rank shape on the 16 x 16
# mesh: 256 rows over 16 data ranks, S = 4096, the 64 heads over 16 model
# ranks, of which rank TP_HEADS["rank"] holds 4: zamba2's SSD scan (P = N
# = 64, B and C column slices of the rank's conv output [x_r, B, C] of
# 4 x 64 + 2 x 64 = 384 channels) and rwkv6's WKV scan (D = 64, r, k
# and v of the column-parallel products, zero initial state)
TP_HEADS = {"B": 16, "S": 4096, "H": 64, "M": 16, "rank": 5}
TP_SSD_SHAPE = (16, 4096, 4, 64, 64, -0.5)
TP_WKV_SHAPE = (16, 4096, 4, 64, False, False, -8.0)
# name: (B, S, H, P, N, columns before the projection's z): the benchmark
# cell zamba2-1.2b.forward-8x4096's shape first; S = 3 (inside the conv's
# window) and 4097 (past a 64-token tile); reduced zamba2; a reduced
# config whose column slices are not 16-byte aligned; zamba2's widths
# with every slice 4 bytes off; a tp rank's heads at train_4k on 16 x 16
# (4 of 64 heads: the rank's projection [z_i, x_i, B, C, dt_i])
GLUE_SHAPES = {
    "forward": (8, 4096, 64, 64, 64, 0),
    "ragged_3": (1, 3, 64, 64, 64, 0),
    "ragged_4097": (1, 4097, 64, 64, 64, 0),
    "reduced": (2, 37, 8, 16, 16, 0),
    "unaligned": (2, 37, 3, 12, 4, 0),
    "offset": (2, 100, 64, 64, 64, 2),
    "tp_rank": (16, 4096, 4, 64, 64, 0),
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
PARITY_ARCHS = ("starcoder2-3b", "gemma3-27b", "zamba2-1.2b", "rwkv6-7b",
                "moonshot-v1-16b-a3b", "arctic-480b")
RECURRENT_ARCHS = ("zamba2-1.2b", "rwkv6-7b")
SERVE_ARGS = ["--no-reduced", "--requests", "8", "--max-batch", "4",
              "--max-len", "512", "--prompt-len", "16",
              "--max-new-tokens", "32", "--seed", "0"]
PAGED_ARGS = ["--cache-impl", "paged", "--page-size", "16"]
# the MoE phases: moonshot-v1-16b-a3b at its published widths, its forward
# gated at a depth of 4 (1 dense + 3 MoE layers), then served at 48
MOE_ARCH = "moonshot-v1-16b-a3b"
MOE_REDUCED_DEPTH = 4
MOE_SERVE_ARGS = SERVE_ARGS + ["--arch", MOE_ARCH]
# the SPMD layer on a one-rank NCCL mesh (1 x 1): spmd-train runs these
# (layout, gradient dtype) pairs of the train phase's model and batch, and
# profiles and counts the float32 steps of SPMD_COUNTED (zero1 gathers
# once a step, fsdp per use: two programs), which the dryrun phase ties
SPMD_RUNS = (("zero1", "float32"), ("zero1", "bfloat16"),
             ("fsdp", "float32"), ("fsdp", "bfloat16"), ("tp", "float32"))
SPMD_COUNTED = ("zero1", "fsdp")
# and zamba2-1.2b at full width (38 Mamba-2 layers) under tp against its
# static step: its heads, the regrouped in_proj and conv, the gated norm's
# all-reduce (rwkv6-7b's AdamW state, ~120 GB, does not fit the card)
SPMD_RECURRENT_ARGS = ["--full", "--arch", "zamba2-1.2b", "--steps", "3",
                       "--global-batch", "2", "--seq-len", "1024"]
SPMD_STEPS = 3
PG_DIR = os.path.join(ROOT, "build", "chip_smoke_pg")
MOE_EP_DECODE = {"B": 4, "max_len": 512, "steps": 32}
# tp-serve: the serve phase's starcoder2-3b through the sharded forward
# (FORWARD_BATCH) and the sharded prefill and serve steps of the tp layout
# on a one-rank NCCL mesh: B rows, a prompt, greedy cells
TP_SERVE = {"B": 4, "max_len": 512, "prompt": 16, "steps": 32}
# decode-seq-split: the decode kernel at zamba2-1.2b's long_500k attention
# shape (its shared block: H = KV = 32, D = 64; B = 1, a 524,288-position
# cache, bf16: K and V 4.3 GB), the cache split into each count of blocks;
# (length, window) cases: the whole cache, a length that ends inside a
# block, a window across the middle block edge (a 16-block edge too),
# a length past the cache
SEQ_SPLIT = {"B": 1, "H": 32, "KV": 32, "S": 524288, "D": 64,
             "blocks": (2, 16)}
SEQ_SPLIT_CASES = ((524288, 0), (5 * 32768 + 12345, 0),
                   (262144 + 1000, 4096), (524288 + 100, 0))
# the dryrun phase: spmd-train's counted float32 cells (SPMD_COUNTED) run
# by the dry-run on a fake 1 x 1 group (in a subprocess each, as the fake
# group is process-wide), printing the cell's artifact with its
# collectives as its last line
DRYRUN_TIE = """
import json, sys
sys.path.insert(0, {src!r})
from repro_torch.config import (MeshConfig, OptimizerConfig, ShapeConfig,
                                TrainConfig, get_config)
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_mesh
tcfg = TrainConfig(optimizer=OptimizerConfig(name={opt!r}),
                   layout={layout!r}, grad_dtype="float32")
with dryrun.fake_world(1):
    counts, info = dryrun.lower_cell(
        {arch!r}, "train_4k", multi_pod=False, tcfg_override=tcfg,
        cfg_override=get_config({arch!r}, reduced={reduced!r}),
        mesh_override=make_mesh(MeshConfig(data=1, model=1), "cpu"),
        shape_override=ShapeConfig("spmd-train", "train", {seq}, {batch}))
info["collectives"] = [(c.kind, c.out_bytes, c.group)
                       for c in counts.collectives]
print(json.dumps(info))
"""
# the production cells the dryrun phase runs on 256 fake ranks (host only)
DRYRUN_CELLS = (("starcoder2-3b", "train_4k"),
                ("moonshot-v1-16b-a3b", "decode_32k"),
                ("rwkv6-7b", "long_500k"))
DRYRUN_DIR = os.path.join(ROOT, "build", "chip_smoke_dryrun")
# the multimodal phases: qwen2-vl-7b at its published widths, its forward
# gated in float32 at a depth of 4, then at all 28 layers, and served
VLM_ARCH = "qwen2-vl-7b"
VLM_REDUCED_DEPTH = 4
VLM_SERVE_ARGS = SERVE_ARGS + ["--arch", VLM_ARCH]
# the encoder-decoder phases: seamless-m4t-large-v2 at its published
# widths; its decode: B rows, a self cache of max_len, the cross caches
# of enc_len frames, greedy steps
ENCDEC_ARCH = "seamless-m4t-large-v2"
ENCDEC_DECODE = {"B": 4, "max_len": 512, "enc_len": 1024, "steps": 32}
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


def roof(flops, nbytes, dtype):
    """(least time in ms, "operations" or "bytes"): the H100 roofline of
    ``flops`` at the peak for ``dtype`` and ``nbytes`` of HBM traffic,
    from ``repro_torch.roofline``, which holds the card's rates."""
    from repro_torch import roofline as R
    peak = R.PEAK_FLOPS_FP32 if dtype == "float32" else R.PEAK_FLOPS_BF16
    k = R.kernel_roofline(flops, nbytes, peak_flops=peak)
    return k.t_bound * 1e3, ("operations" if k.bottleneck == "compute"
                             else "bytes")


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
    return (*roof(flops, nbytes, dtype), nbytes)


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
    return (*roof(flops, nbytes, dtype), flops, nbytes)


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
    return (*roof(flops, nbytes, dtype), flops, nbytes)


def glue_inputs(torch, shape, dtype, gen):
    """The glue kernels' inputs as the model hands them: (z, u = [x, B,
    C], dt) column slices of one (B, S, 2 d_in + 2N + H) projection, the
    conv's and the norm's parameters (A_log, dt_bias and gamma float32),
    y (B, S, H, P) as the SSD scan returns it, and xh, a view of the
    plain conv's output."""
    from repro_torch.kernels.mamba_glue import conv_silu_dt_plain
    B, S, H, P, N, lead = shape
    d_in, C = H * P, H * P + 2 * N
    dt_ = getattr(torch, dtype)

    def randn(*dims, scale=1.0):
        return scale * torch.randn(*dims, generator=gen, device="cuda")
    proj = randn(B, S, lead + 2 * d_in + 2 * N + H).to(dt_)[..., lead:]
    z, u, dt = (proj[..., :d_in], proj[..., d_in:d_in + C],
                proj[..., d_in + C:])
    p = {"conv_w": randn(4, C, scale=0.5).to(dt_),
         "conv_b": randn(C, scale=0.1).to(dt_),
         "dt_bias": randn(H, scale=0.5), "A_log": randn(H, scale=0.5),
         "D": (1 + randn(H, scale=0.1)).to(dt_),
         "norm": randn(d_in, scale=0.1)}
    conv = (u, p["conv_w"], p["conv_b"], dt, p["dt_bias"], p["A_log"], P)
    xh = conv_silu_dt_plain(*conv)[0][..., :d_in].unflatten(-1, (H, P))
    norm = (randn(B, S, H, P).to(dt_), xh, z, p["D"], p["norm"], 1e-5)
    return conv, norm


def glue_bound_ms(shape, dtype):
    """Least time of each glue kernel: its bytes, every input read once
    and every output written once (the parameters too), against the
    memory rate: ``conv_silu_dt`` reads u (C channels) and dt and writes
    the conv output, xdt (d_in) and dA (float32); ``gated_rms_norm``
    reads y, xh and z and writes its output (d_in each). Elementwise
    work: no operation count bounds either. {name: (ms, "bytes",
    bytes)}."""
    B, S, H, P, N, _ = shape
    size = 2 if dtype == "bfloat16" else 4
    T, d_in = B * S, H * P
    C = d_in + 2 * N
    conv = T * ((2 * C + H + d_in) * size + 4 * H) + 5 * C * size + 8 * H
    norm = T * 4 * d_in * size + H * size + 4 * d_in
    out = {}
    for name, nbytes in zip(GLUE_KERNELS, (conv, norm)):
        ms, by = roof(0, nbytes, dtype)
        out[name] = (ms, by, nbytes)
    return out


def ulps(torch, got, want):
    """max |got - want| in units in the last place of ``want`` in its
    dtype (bfloat16 or float32)."""
    mant = 7 if want.dtype == torch.bfloat16 else 23
    w = want.float().abs().clamp_min(torch.finfo(want.dtype).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(w)) - mant)
    return float(((got.float() - want.float()).abs() / ulp).max())


def glue_vs_plain(torch, gen, name, shape, dtype):
    """Both glue kernels against their plain versions on ``shape``: every
    output equal or within ``GLUE_ULPS`` of the dtype's ulps, each wrapper
    launched once. Returns {kernel: max ulps}."""
    from repro_torch.kernels.mamba_glue import (conv_silu_dt,
                                                conv_silu_dt_plain,
                                                gated_rms_norm,
                                                gated_rms_norm_plain)
    conv, norm = glue_inputs(torch, shape, dtype, gen)
    out = {}
    for fn, plain, args in ((conv_silu_dt, conv_silu_dt_plain, conv),
                            (gated_rms_norm, gated_rms_norm_plain, norm)):
        want = plain(*args)
        n0 = fn.launches
        got = fn(*args)
        torch.cuda.synchronize()
        pairs = list(zip(got, want)) if isinstance(got, tuple) \
            else [(got, want)]
        worst_ulps, unequal = 0.0, 0
        for g, w in pairs:
            w = w.contiguous()
            check(g.shape == w.shape and g.dtype == w.dtype
                  and bool(torch.isfinite(g.float()).all()),
                  f"{fn.__name__} on {name}/{dtype}: output malformed")
            limit = GLUE_ULPS["float32" if g.dtype == torch.float32
                              else dtype]
            u = ulps(torch, g, w)
            worst_ulps = max(worst_ulps, u)
            unequal += int((g != w).sum())
            check(u <= limit, f"{fn.__name__} on {name}/{dtype}: {u:.1f} "
                              f"ulps from the plain version (limit {limit})")
        check(fn.launches == n0 + 1, f"{fn.__name__} launched "
                                     f"{fn.launches - n0} times in a call")
        print(f"  {name:11s} {dtype:8s} {shape[:5]} {fn.__name__}: max "
              f"{worst_ulps:.1f} ulps from plain, {unequal} elements not "
              f"equal")
        out[fn.__name__] = worst_ulps
        del got, want
    del conv, norm
    return out


def glue_timing(torch, gen, card_line):
    """Device time of each glue kernel and its plain version at the
    benchmark cell's shape (bf16), beside its bound (``glue_bound_ms``);
    no single PyTorch call computes either."""
    from repro_torch.kernels.mamba_glue import (conv_silu_dt,
                                                conv_silu_dt_plain,
                                                gated_rms_norm,
                                                gated_rms_norm_plain)
    shape = GLUE_SHAPES["forward"]
    bounds = glue_bound_ms(shape, "bfloat16")
    ins = [glue_inputs(torch, shape, "bfloat16", gen) for _ in range(2)]
    rows = []
    for i, (fn, plain) in enumerate(((conv_silu_dt, conv_silu_dt_plain),
                                     (gated_rms_norm, gated_rms_norm_plain))):
        ms = device_ms(torch, lambda j: fn(*ins[j][i]), 2, calls=16, reps=3)
        plain_ms = device_ms(torch, lambda j: plain(*ins[j][i]), 2,
                             calls=2, reps=2)
        bms, by, nbytes = bounds[fn.__name__]
        print(f"  {fn.__name__} forward: B={shape[0]} S={shape[1]} "
              f"H={shape[2]} P={shape[3]} N={shape[4]} bf16: kernel "
              f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, no "
              f"library call; bound {bms * 1e3:.1f} us ({by}, "
              f"{nbytes / 1e6:.1f} MB), {bms / ms:.3f} of it, "
              f"{nbytes / ms / 1e6:.0f} GB/s [{card_line}]")
        rows.append({"name": fn.__name__, "shape": "forward",
                     "dims": list(shape[:5]), "dtype": "bfloat16", "ms": ms,
                     "plain_ms": plain_ms, "library_ms": None,
                     "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                     "achieved_GBps": nbytes / ms / 1e6,
                     "bound_share": bms / ms})
    del ins
    release(torch)
    return rows


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


def wkv_vs_plain(torch, gen, name, shape, dtype, scan, plain):
    """The WKV kernel ``scan`` against ``plain`` on one ``WKV_SHAPES``
    entry: o within ``allowed`` at ``dtype``, the final state at the
    float32 gate. Returns the largest absolute error."""
    args_ = wkv_inputs(torch, shape, gen, dtype)
    t0 = time.monotonic()
    want_o, want_s = plain(*args_)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    got_o, got_s = scan(*args_)
    torch.cuda.synchronize()
    check(got_o.dtype == args_[0].dtype
          and got_s.dtype == torch.float32, "WKV output dtypes")
    max_err = 0.0
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
              f"WKV kernel disagrees with plain on {name}/{dtype}/{what}")
    return max_err


def wkv_timing(torch, gen, name, dtype, scan, plain, card_line):
    """Device time a call of the WKV kernel ``scan`` and of ``plain`` on
    ``WKV_SHAPES[name]``, beyond L2, beside its bound: one row of the
    timing phase."""
    shape = WKV_SHAPES[name]
    B, S, H, D, with_s0 = shape[:5]
    bms, by, flops, nbytes = wkv_bound_ms(shape, dtype)
    n = max(2, math.ceil(2 * L2_BYTES / nbytes))
    ins = [wkv_inputs(torch, shape, gen, dtype) for _ in range(n)]
    ms = device_ms(torch, lambda i: scan(*ins[i]), n, calls=16, reps=3)
    plain_ms = device_ms(torch, lambda i: plain(*ins[i]), n, calls=1,
                         reps=2)
    print(f"  rwkv6_scan {name}: B={B} S={S} H={H} D={D} {dtype} "
          f"r/k/v/o, {'nonzero' if with_s0 else 'zero'} s0: kernel "
          f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, no "
          f"library call; bound {bms * 1e3:.1f} us ({by}, "
          f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), "
          f"{bms / ms:.3f} of it [{card_line}]")
    del ins
    release(torch)
    return {"shape": name, "B": B, "S": S, "H": H, "D": D, "dtype": dtype,
            "s0": with_s0, "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "flops": flops, "bytes": nbytes,
            "achieved_GBps": nbytes / ms / 1e6, "bound_share": bms / ms}


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
    return (*roof(flops, nbytes, "float32"), flops, nbytes)


def tp_heads_inputs(torch, gen, kind, dtype):
    """The 64-head call's inputs at ``TP_HEADS``' batch and length, and
    the tp rank's block of them, in new tensors (the whole call's may go
    first). ``kind`` "ssd": (xdt, B, C, dA), B and C column slices of the
    whole conv output (4096 + 128 channels) and, for the rank, of its
    384-channel [x_r, B, C], xdt and dA its 4 heads (contiguous, as the
    model computes them). "wkv": (r, k, v, w, u, None), the rank's 4
    heads of r, k, v (contiguous, as the column-parallel products come),
    w and u. Returns (whole, rank, the rank's heads as a slice)."""
    B, S, H, M, r = (TP_HEADS[k] for k in ("B", "S", "H", "M", "rank"))
    hl, D = H // M, 64
    heads = slice(r * hl, (r + 1) * hl)
    dt = getattr(torch, dtype)
    if kind == "ssd":
        _, _, _, P, N, lo = TP_SSD_SHAPE
        xdt = torch.randn(B, S, H, P, generator=gen, device="cuda").to(dt)
        conv = torch.randn(B, S, H * P + 2 * N, generator=gen,
                           device="cuda").to(dt)
        dA = lo + (-0.01 - lo) * torch.rand(B, S, H, generator=gen,
                                            device="cuda")
        whole = (xdt, conv[..., H * P:H * P + N], conv[..., H * P + N:], dA)
        mine = torch.cat([conv[..., r * hl * P:(r + 1) * hl * P],
                          conv[..., H * P:]], -1)
        rank = (xdt[:, :, heads].contiguous(), mine[..., hl * P:hl * P + N],
                mine[..., hl * P + N:], dA[:, :, heads].contiguous())
        return whole, rank, heads
    r_, k, v = (torch.randn(B, S, H, D, generator=gen, device="cuda").to(dt)
                for _ in range(3))
    w = torch.exp(-torch.exp(-8.0 + 12.0 * torch.rand(
        B, S, H, D, generator=gen, device="cuda")))
    u = torch.randn(H, D, generator=gen, device="cuda")
    whole = (r_, k, v, w, u, None)
    rank = tuple(None if t is None else t[heads].contiguous() if t is u
                 else t[:, :, heads].contiguous() for t in whole)
    return whole, rank, heads


def tp_heads_vs_plain(torch, gen, kind, dtype, kernel, plain):
    """The kernel on the tp rank's head block against its plain version
    (the kernel gate) and against the same heads of the 64-head call
    (the same gate; whether equal to the bit is printed). Returns the
    largest error."""
    whole, rank, heads = tp_heads_inputs(torch, gen, kind, dtype)
    all_heads = kernel(*whole)
    if kind == "wkv":
        all_heads = all_heads[0]
    same = all_heads[:, :, heads].contiguous()
    del whole, all_heads
    t0 = time.monotonic()
    want = plain(*rank)
    torch.cuda.synchronize()
    plain_s = time.monotonic() - t0
    got = kernel(*rank)
    torch.cuda.synchronize()
    pairs = [("against plain", got, want)]
    if kind == "wkv":
        pairs = [("o against plain", got[0], want[0]),
                 ("final state against plain", got[1], want[1])]
        got = got[0]
    pairs.append(("against the 64-head call's heads", got, same))
    max_err = 0.0
    for what, g, w in pairs:
        gate = "float32" if "state" in what else dtype
        err, outside = worst(g, w, allowed(w, gate))
        max_err = max(max_err, err)
        print(f"  tp rank {TP_HEADS['rank']} of {TP_HEADS['M']} "
              f"{kind} {dtype:8s} B={TP_HEADS['B']} S={TP_HEADS['S']} "
              f"H={heads.stop - heads.start} {what}: max_abs_err {err:.3e} "
              f"(tol {TOL_TEXT[gate]}), {outside} outside; equal to the "
              f"bit {bool(torch.equal(g, w))}; plain {plain_s:.2f} s")
        check(outside == 0 and math.isfinite(err),
              f"{kind} kernel on a tp rank's heads disagrees ({what}, "
              f"{dtype})")
    del rank, got, want, same
    release(torch)
    return max_err


def tp_heads_timing(torch, gen, kind, kernel, plain, card_line):
    """Device time of the kernel and its plain version on the tp rank's
    bf16 head block (``tp_heads_inputs``), beside the bound of
    ``ssd_bound_ms`` / ``wkv_bound_ms`` at that shape (no library call
    computes either)."""
    shape = TP_SSD_SHAPE if kind == "ssd" else TP_WKV_SHAPE
    bound = ssd_bound_ms if kind == "ssd" else wkv_bound_ms
    bms, by, flops, nbytes = bound(shape, "bfloat16")
    n = max(2, math.ceil(2 * L2_BYTES / nbytes))
    ins = []
    for _ in range(n):
        _, rank, _ = tp_heads_inputs(torch, gen, kind, "bfloat16")
        ins.append(rank)
        release(torch)
    ms = device_ms(torch, lambda i: kernel(*ins[i]), n, calls=16, reps=3)
    plain_ms = device_ms(torch, lambda i: plain(*ins[i]), n, calls=1,
                         reps=2)
    print(f"  {kernel.__name__} tp rank's heads: {shape[:4]} bf16: kernel "
          f"{ms * 1e3:.1f} us, plain {plain_ms * 1e3:.1f} us, no library "
          f"call; bound {bms * 1e3:.1f} us ({by}, {nbytes / 1e6:.1f} MB, "
          f"{flops / 1e9:.2f} GFLOP), {bms / ms:.3f} of it [{card_line}]")
    del ins
    release(torch)
    return {"shape": "tp_rank", "dims": list(shape[:4]),
            "dtype": "bfloat16", "ms": ms, "plain_ms": plain_ms,
            "library_ms": None, "bound_ms": bms, "bound_by": by,
            "flops": flops, "bytes": nbytes, "bound_share": bms / ms}


def decode_vs_plain(torch, name, gen):
    """The decode kernel against its plain version on ``SHAPES[name]``,
    in bf16 and fp32, with the split plan, one split (no merge launch)
    and three; raises on a disagreement, returns the largest error."""
    from repro_torch.kernels.decode_attention import kernel as K
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    shape = SHAPES[name]
    B, H, KV, S = shape[:4]
    max_err = 0.0
    for dtype in ("bfloat16", "float32"):
        q, k, v, lens, win = attention_inputs(torch, shape, dtype, gen)
        want = decode_attention_plain(q, k, v, lens, window=win)
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
    return max_err


def flash_vs_plain(torch, name, gen):
    """The flash kernel against its plain version on
    ``FLASH_SHAPES[name]``, in bf16 and fp32; raises on a disagreement,
    returns the largest error."""
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    shape = FLASH_SHAPES[name]
    causal, window = shape[6], shape[7]
    max_err = 0.0
    for dtype in ("bfloat16", "float32"):
        q, k, v = flash_inputs(torch, shape, dtype, gen)
        want = flash_attention_plain(q, k, v, causal=causal, window=window)
        got = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err, outside = worst(got, want, allowed(want, dtype))
        max_err = max(max_err, err)
        print(f"  {name:13s} {dtype:8s}: max_abs_err {err:.3e} "
              f"(tol {TOL_TEXT[dtype]}), {outside} outside")
        check(outside == 0 and math.isfinite(err),
              f"flash kernel disagrees with plain on {name}/{dtype}")
        del q, k, v, want, got
    return max_err


def decode_timing(torch, name, gen, card_line):
    """Device time of the decode kernel, its plain version and SDPA (with
    the length mask and, the lengths being full, without one: the library
    yardstick) on ``SHAPES[name]`` in bf16, beside the bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as K
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
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
    return {"shape": name, "B": B, "H": H, "KV": KV, "S": S, "D": D,
            "dtype": "bfloat16", "num_splits": ns, "ms": ms,
            "plain_ms": plain, "library_ms": lib,
            "library_masked_ms": masked, "bound_ms": bms, "bound_by": by,
            "bytes": nbytes, "achieved_GBps": nbytes / ms / 1e6,
            "bound_share": bms / ms}


def flash_timing(torch, name, gen, card_line):
    """Device time of the flash kernel, its plain version and SDPA (the
    library yardstick) on ``FLASH_SHAPES[name]`` in bf16, beside the
    bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
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
            q, k, v, attn_mask=mask,
            is_causal=causal and mask is None,
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
          f"{'causal' if causal else 'non-causal'} window={win} "
          f"bf16: kernel {ms * 1e3:.1f} us, plain "
          f"{plain * 1e3:.1f} us, sdpa "
          f"{lib * 1e3:.1f} us; bound {bms * 1e3:.1f} us ({by}, "
          f"{flops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB); kernel "
          f"at {flops / ms / 1e9:.1f} TFLOP/s, {bms / ms:.3f} of the "
          f"bound [{card_line}]")
    del ins
    release(torch)
    return {"shape": name, "B": B, "S": Sq, "H": H, "KV": KV, "D": D,
            "causal": causal, "window": win, "dtype": "bfloat16", "ms": ms,
            "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
            "bound_by": by, "flops": flops, "bytes": nbytes,
            "achieved_TFLOPs": flops / ms / 1e9, "bound_share": bms / ms}


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
    """The serve entry point on ``args``: an undisturbed run of
    ``args.requests`` requests through ``launch.serve``'s ``run``, then
    the same requests again on its engine with a hard revocation of slot
    1 and a drain that migrates the in-flight work to a second engine. The migrated requests must give the undisturbed
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
    t0 = time.monotonic()
    summary, reqs, base = serve.run(args, model, params)
    wall = time.monotonic() - t0
    expected = {r.rid: r.generated for r in reqs}
    check(all(r.done for r in reqs), "undisturbed run left work")
    for fn, per_cell in expect:
        check(fn.launches == per_cell * base.decode_cells,
              f"the undisturbed run launched {fn.__name__} {fn.launches} "
              f"times, not {per_cell} per decode cell x {base.decode_cells}")
    tps = base.tokens_decoded / wall
    # run does not time the steps one by one (paged_step_compare does)
    cell_ms = wall * 1e3 / base.decode_cells
    print(f"  {cfg.name} undisturbed: {base.tokens_decoded} tokens in "
          f"{wall:.2f} s = {tps:.1f} tokens/s, {cell_ms:.2f} ms of wall a "
          f"decode cell, {base.decode_cells} decode cells [{card_line}]")
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
    return ({"tokens_per_s": tps, "wall_ms_per_decode_cell": cell_ms,
             "decode_cells": base.decode_cells, "wall_s": wall,
             "migrated": len(migrated), "cells": cells, "tokens_equal": same,
             "tokens_replayed": replayed,
             "pages_shipped": second.pages_shipped,
             "requests_imported": second.requests_imported,
             "launches": {fn.__name__: fn.launches for fn, _ in expect}},
            expected)


def step_walls(torch, eng, n):
    """Host wall (ms) of each of ``n`` engine steps, each synchronised."""
    walls = []
    for _ in range(n):
        t0 = time.monotonic()
        eng.step()
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    return walls


def calls_profile(torch, fn, n_prof=3):
    """``n_prof`` calls of ``fn()`` under torch.profiler: (device busy ms
    a call, {kernel name: (us a call, launches a call)})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n_prof):
            fn()
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
        busy, by_name = calls_profile(torch, eng.step)
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


def reference_block_build(args):
    """``serve.build`` of ``args`` with the model's own fields at their
    defaults (``config.reference_block``: rwkv6-7b's block without Finch's
    time mix)."""
    from repro_torch.config import get_config, reference_block
    from repro_torch.models.builder import build_model
    cfg = reference_block(get_config(args.arch, reduced=args.reduced))
    model = build_model(cfg.replace(attn_impl="cuda", ssm_impl="cuda",
                                    rwkv_impl="cuda"), args.device)
    return model, model.init(model.generator(args.seed))


def forward_check(torch, model, plain_model, params, batch, expect,
                  card_line, fp32_gate=False, params32=None):
    """``Model.apply`` on one batch through the kernels (``model``) and
    through the plain paths (``plain_model``), finite logits of the right
    shape (B, S, vocab) for labels (B, S): the decoder's positions for
    encdec. ``expect`` lists (wrapper, launches, device-kernel name):
    every wrapper's count is set to 0 just before the kernel path's
    forward and read just after, and must equal its launches.

    The gate on the logits: without ``fp32_gate``, the two paths' bf16
    logits within 0.05 x max|logit|. With it, both paths also run in
    float32 (the weights cast up), where they must agree within 1e-3 x
    max|logit|, and the kernel path's bf16 logits must lie no further
    from the plain path's float32 logits, in root mean square, than 1.5x
    the plain path's own bf16 logits do: random full-width models amplify
    bf16 rounding to several percent of max|logit| on either path, so the
    bf16 gate is held against that floor, measured in the same run. The
    float32 forwards run on ``params32``: by default a float32 copy of
    ``params``; given ``params`` itself, each weight is cast at use (the
    same values, without a float32 copy of the model).

    Then two more forwards under torch.profiler, the first its warm-up
    step, the second its active one (a profile that opens on the
    forward it records has missed one of 72 flash launches, once):
    device busy time, each kernel's device time and launches (which must
    equal its launches too), and the largest kernels. Returns stats."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.serving import with_impls
    from repro_torch.tree import tree_map
    cfg = model.cfg
    B, S = batch["labels"].shape

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
    # the MoE router's aux loss is positive; the other families' zero
    check(torch.isfinite(got.float()).all().item()
          and tuple(got.shape) == (B, S, cfg.vocab_size)
          and math.isfinite(float(aux))
          and (float(aux) > 0 if cfg.family == "moe"
               else float(aux) == 0.0),
          "forward output malformed")
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
        if params32 is None:
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
    with torch.no_grad(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1,
                              repeat=1)) as prof:
        for _ in range(2):
            model.apply(params, batch)
            torch.cuda.synchronize()
            prof.step()
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
    """The kernel wrappers, whose ``launches`` count their launches."""
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.mamba_glue import conv_silu_dt, gated_rms_norm
    from repro_torch.kernels.rwkv6 import rwkv6_scan
    from repro_torch.kernels.ssd_scan import ssd_scan
    return {"decode_attention": decode_attention,
            "flash_attention": flash_attention, "ssd_scan": ssd_scan,
            "rwkv6_scan": rwkv6_scan, "conv_silu_dt": conv_silu_dt,
            "gated_rms_norm": gated_rms_norm}


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


@contextlib.contextmanager
def one_rank_group(torch):
    """A one-rank NCCL process group on the card for the block (a file
    store under ``build/``) and ``launch.mesh.single_device_mesh`` over
    it: the layouts' collectives are real NCCL calls of one rank."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import single_device_mesh
    os.makedirs(PG_DIR, exist_ok=True)
    store = os.path.join(PG_DIR, "store")
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=0, world_size=1)
    try:
        yield single_device_mesh("cuda")
    finally:
        dist.destroy_process_group()
        if os.path.exists(store):
            os.remove(store)


def spmd_train_phase(torch, card_line, train_args=TRAIN_ARGS,
                     runs=SPMD_RUNS):
    """The sharded training step at full width: the model of
    ``train_args`` (the train phase's starcoder2-3b by default; float32
    masters, bf16 compute, AdamW) and batches (global batch 2 x 1024,
    ``launch.train``'s configuration), 3 steps of the static
    ``make_train_step``, then 3 steps of
    ``make_train_step(param_shardings=..., zero1_mask=...)`` for each
    (layout, ``grad_dtype``) of ``runs`` on a one-rank NCCL mesh
    (every collective a real call of one rank): the state is each rank's
    blocks; zero1 gathers the compute copy once a step, fsdp and tp each
    layer's blocks where the layer runs (again in the remat recompute),
    tp computing the attention heads, ``ff`` and the vocabulary as the
    rank's blocks (here the whole of them) with its all-reduces and the
    vocabulary-parallel loss; the gradients reduce-scattered. Gates:
    float32 losses within 1e-5 and gradient norms within 1e-4 relative of
    the static step's, every parameter within 3e-5 + 1e-5 x |p| (the CPU
    tests' tolerances); bf16: the cosine between its and the static
    float32 parameter updates above 0.98 (the reference's
    ``test_bf16_grads_close_to_fp32``). No kernel launches (the kernels
    have no backward). Step walls, peak memory and, for the float32 runs
    of ``SPMD_COUNTED`` (two programs), the device launches of a fourth,
    profiled step and a fifth, counted one (FLOPs, collectives)."""
    from repro_torch import sharding as S
    from repro_torch.config import (OptimizerConfig, ScheduleConfig,
                                    TrainConfig, get_config)
    from repro_torch.data import ShardedDataset
    from repro_torch.launch import train as launch_train
    from repro_torch.models.axes import param_axes
    from repro_torch.models.builder import build_model
    from repro_torch.train.step import init_state, make_train_step
    from repro_torch.tree import tree_leaves, tree_map
    args = launch_train.parse_args(train_args)
    cfg = get_config(args.arch, reduced=args.reduced).replace(
        attn_impl="torch", ssm_impl="torch", rwkv_impl="torch")
    model = build_model(cfg, "cuda")
    base = TrainConfig(
        optimizer=OptimizerConfig(name=args.optimizer, lr=args.lr,
                                  base_workers=1),
        schedule=ScheduleConfig(kind="cosine", warmup_steps=20,
                                total_steps=args.steps), seed=args.seed)
    ds = ShardedDataset(cfg, global_batch=args.global_batch,
                        seq_len=args.seq_len, seed=args.seed, device="cuda")
    batches = [ds.global_batch_at(i) for i in range(SPMD_STEPS)]
    axes = param_axes(cfg)
    mask = tree_map(lambda a: "experts" not in a, axes)

    def run(tcfg, inspect, mesh=None, profiled=False):
        """SPMD_STEPS steps from the seeded masters; ``inspect(params)``
        after them, then, if ``profiled``, one step under the profiler
        and one counted (its FLOPs by ``FlopCounterMode``, its
        collectives by ``roofline.record_collectives``, for the dryrun
        phase). Returns stats."""
        shardings = None if mesh is None else S.param_shardings(
            axes, cfg, mesh, layout=tcfg.layout)
        params = model.init(model.generator(tcfg.seed), dtype=torch.float32)
        if shardings is not None:
            params = S.shard_tree(params, shardings)
        state = init_state(model, tcfg, params=params)
        del params
        step = make_train_step(model, tcfg, param_shardings=shardings,
                               zero1_mask=None if mesh is None else mask)

        def one(b):
            with S.use_mesh(mesh, tcfg.layout):
                return step(state, b)
        release(torch)
        torch.cuda.reset_peak_memory_stats()
        zero_counts()                             # the path's run starts
        losses, norms, walls = [], [], []
        for b in batches:
            t0 = time.monotonic()
            state, m = one(b)
            losses.append(float(m["loss"]))       # syncs
            norms.append(float(m["grad_norm"]))
            walls.append(time.monotonic() - t0)
        counts = read_counts()                    # and ends
        peak = torch.cuda.max_memory_allocated()
        check(all(map(math.isfinite, losses + norms))
              and not any(counts.values()),
              f"{tcfg.layout}/{tcfg.grad_dtype}: non-finite losses or "
              f"kernel launches {counts}")
        out = {"losses": losses, "grad_norms": norms, "step_s": walls,
               "peak_bytes": peak, **inspect(state.params)}
        if profiled:
            busy, by_name = calls_profile(torch, lambda: one(batches[0]), 1)
            out.update(profiled_busy_ms=busy, device_launches=round(sum(
                n for _, n in by_name.values())))
            from torch.utils.flop_counter import FlopCounterMode
            from repro_torch.roofline import record_collectives
            counter = FlopCounterMode(display=False)
            with record_collectives() as colls, counter:
                one(batches[0])
            torch.cuda.synchronize()
            out.update(counted_flops=float(counter.get_total_flops()),
                       collectives=[(c.kind, c.out_bytes, c.group)
                                    for c in colls])
        del state, step
        release(torch)
        return out

    def keep(params):
        host.update((p, t.to("cpu", copy=True))
                    for p, t in tree_leaves(params))
        return {}

    def against_static(params):
        """Worst |got - want| - 1e-5 |want| over the leaves, and the
        cosine of the updates from the seeded masters."""
        p0 = dict(tree_leaves(model.init(model.generator(base.seed),
                                         dtype=torch.float32)))
        excess, dot, nu, nw = -1.0, 0.0, 0.0, 0.0
        for path, got in tree_leaves(params):
            want = host[path].to("cuda")
            check(got.shape == want.shape, f"{path}: the 1 x 1 block "
                                           f"{tuple(got.shape)} is not the "
                                           f"leaf {tuple(want.shape)}")
            excess = max(excess, float(torch.sub(got, want).abs_().sub_(
                want.abs(), alpha=1e-5).max()))
            du, dw = (got - p0[path]).view(-1), (want - p0[path]).view(-1)
            dot += float(torch.dot(du, dw))
            nu += float(torch.dot(du, du))
            nw += float(torch.dot(dw, dw))
            del want, du, dw
        return {"param_excess": excess, "update_cosine":
                dot / math.sqrt(nu * nw)}

    def profile_line(st):
        if "device_launches" not in st:
            return "not profiled"
        return (f"profiled step {st['profiled_busy_ms']:.1f} ms busy, "
                f"{st['device_launches']} device launches")

    # the static step is the train phase's, whose fourth step it profiles
    host = {}
    static = run(base, keep)
    print(f"  static step, {cfg.name} full width, B={args.global_batch} "
          f"S={args.seq_len}: losses " + ", ".join(
              f"{x:.6f}" for x in static["losses"]) + "; steps " +
          ", ".join(f"{t:.3f}" for t in static["step_s"]) + f" s; peak "
          f"{static['peak_bytes'] / 1e9:.2f} GB [{card_line}]")
    stats = {"static": static}
    for layout, gd in runs:
        tcfg = dataclasses.replace(base, layout=layout, grad_dtype=gd)
        with one_rank_group(torch) as mesh:
            got = run(tcfg, against_static, mesh,
                      profiled=gd == "float32" and layout in SPMD_COUNTED)
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(got["losses"], static["losses"]))
        norm_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(got["grad_norms"], static["grad_norms"]))
        print(f"  {layout} {gd} on a 1 x 1 NCCL mesh: losses " + ", ".join(
            f"{x:.6f}" for x in got["losses"]) + f" (worst relative "
            f"difference {loss_rel:.2e}); grad_norm {norm_rel:.2e}; "
            f"parameters: worst |diff| - 1e-5 |p| {got['param_excess']:.2e} "
            f"(tol 3e-5); update cosine with the static float32 step "
            f"{got['update_cosine']:.6f}; steps " + ", ".join(
                f"{t:.3f}" for t in got["step_s"]) + f" s; peak "
            f"{got['peak_bytes'] / 1e9:.2f} GB; {profile_line(got)} "
            f"[{card_line}]")
        if gd == "float32":
            check(loss_rel <= 1e-5 and norm_rel <= 1e-4
                  and got["param_excess"] <= 3e-5,
                  f"{layout}: the sharded float32 step differs from the "
                  f"static one")
        else:
            check(got["update_cosine"] > 0.98, f"{layout}: bf16 gradients "
                                               f"move the parameters "
                                               f"elsewhere")
        stats[f"{layout}/{gd}"] = got
    del host
    release(torch)
    return stats


def _tie(info, card_run, layout, args, shape, wall, card_line):
    """One tie of the dryrun phase: the fake 1 x 1 cell's counted FLOPs
    and collectives (kind, count, bytes) against the card's counted step
    of ``layout``, exactly; its roofline against the measured step."""
    import collections
    from repro_torch import analytic
    from repro_torch.config import get_config
    fake = collections.Counter((k, b) for k, b, _ in info["collectives"])
    real = collections.Counter((k, b) for k, b, _ in
                               card_run["collectives"])
    print(f"  tie: fake 1 x 1 {args.arch} {layout} float32 B="
          f"{args.global_batch} S={args.seq_len}: counted FLOPs "
          f"{info['counted_flops']:.6e} on fake tensors, "
          f"{card_run['counted_flops']:.6e} on the card; collectives "
          f"{sum(fake.values())} / {sum(real.values())} "
          f"({sum(b * n for (_, b), n in fake.items()) / 1e9:.3f} / "
          f"{sum(b * n for (_, b), n in real.items()) / 1e9:.3f} GB out); "
          f"the dry-run processes took {wall:.1f} s [{card_line}]")
    check(info["counted_flops"] == card_run["counted_flops"] > 0,
          f"{layout}: the dry-run's FLOP count is not the card's")
    check(fake == real, f"{layout}: the dry-run's collectives are not the "
                        f"card's: {sorted((fake - real).items())[:4]} / "
                        f"{sorted((real - fake).items())[:4]}")
    roof = info["roofline"]
    t_bound = max(roof["t_compute"], roof["t_memory"], roof["t_collective"])
    step_s = sorted(card_run["step_s"])[len(card_run["step_s"]) // 2]
    print(f"  tie roofline ({layout}): analytic step FLOPs "
          f"{roof['hlo_flops']:.6e} = "
          f"{roof['hlo_flops'] / info['counted_flops']:.4f} x counted; "
          f"H100 t_compute {roof['t_compute'] * 1e3:.2f} ms, t_memory "
          f"{roof['t_memory'] * 1e3:.2f} ms, t_collective "
          f"{roof['t_collective'] * 1e3:.2f} ms, t_bound "
          f"{t_bound * 1e3:.2f} ms ({roof['bottleneck']}); measured step "
          f"{step_s:.3f} s (median of " + ", ".join(
              f"{t:.3f}" for t in card_run["step_s"]) + f"), t_bound / step "
          f"{t_bound / step_s:.4f}; "
          f"analytic HBM bytes {roof['hlo_bytes'] / 1e9:.2f} GB against "
          f"peak memory {card_run['peak_bytes'] / 1e9:.2f} GB (not gated) "
          f"[{card_line}]")
    check(roof["hlo_flops"] == analytic.step_flops(
        get_config(args.arch, reduced=args.reduced), shape, "full"),
        f"{layout}: the tie's analytic FLOPs")
    return {"counted_flops": info["counted_flops"],
            "card_counted_flops": card_run["counted_flops"],
            "collectives": sum(fake.values()),
            "collective_bytes": sum(b * n for (_, b), n in fake.items()),
            "analytic_flops": roof["hlo_flops"],
            "t_compute": roof["t_compute"], "t_memory": roof["t_memory"],
            "t_collective": roof["t_collective"], "t_bound": t_bound,
            "step_s": step_s, "bound_share": t_bound / step_s,
            "analytic_bytes": roof["hlo_bytes"],
            "peak_bytes": card_run["peak_bytes"]}


def dryrun_phase(torch, card_line, spmd):
    """``repro_torch.launch.dryrun`` against the card and at production
    size. The tie: spmd-train's counted float32 cells (zero1, which
    gathers once a step, and fsdp, which gathers per use), each run by
    the dry-run on a fake 1 x 1 group (a subprocess each: the fake group
    is process-wide), must count exactly the FLOPs and the collectives
    (kind, count, bytes) that the card's counted step of that layout
    counted, which makes the dry-run's counts those of the card's
    programs. Then each cell's analytic FLOPs against that count, its
    H100 roofline against the measured step and its byte model against
    the measured peak (not gated: the byte model is traffic, not a
    peak). At the same time,
    three production cells on 256 fake ranks (subprocesses of
    ``python -m repro_torch.launch.dryrun``): each writes an OK artifact
    whose analytic numbers equal a direct call of ``analytic``."""
    from repro_torch import analytic
    from repro_torch.config import SHAPES, ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch import train as launch_train
    from repro_torch.sharding import MeshView
    args = launch_train.parse_args(TRAIN_ARGS)
    for layout in SPMD_COUNTED:
        check("counted_flops" in spmd[f"{layout}/float32"],
              f"spmd-train counted no {layout} float32 step")
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    t0 = time.monotonic()
    procs = {}
    for layout in SPMD_COUNTED:
        tie_code = DRYRUN_TIE.format(src=os.path.join(ROOT, "src"),
                                     opt=args.optimizer, arch=args.arch,
                                     reduced=args.reduced, layout=layout,
                                     seq=args.seq_len,
                                     batch=args.global_batch)
        procs[("tie", layout)] = subprocess.Popen(
            [sys.executable, "-c", tie_code], cwd=ROOT, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    for arch, shape in DRYRUN_CELLS:
        procs[(arch, shape)] = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out",
             DRYRUN_DIR], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
    outs = {}
    try:
        for key, proc in procs.items():
            outs[key] = proc.communicate(timeout=300)
        wall = time.monotonic() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    for key, proc in procs.items():
        check(proc.returncode == 0, f"dryrun {key} exited "
                                    f"{proc.returncode}: "
                                    f"{outs[key][1][-2000:]}")

    out = {"wall_s": wall}
    shape = ShapeConfig("spmd-train", "train", args.seq_len,
                        args.global_batch)
    for layout in SPMD_COUNTED:
        out[f"tie/{layout}"] = _tie(
            json.loads(outs[("tie", layout)][0].strip().splitlines()[-1]),
            spmd[f"{layout}/float32"], layout, args, shape, wall, card_line)

    # the production cells
    mesh = MeshView(("data", "model"), (16, 16))
    for arch, shape_name in DRYRUN_CELLS:
        with open(os.path.join(DRYRUN_DIR,
                               f"{arch}_{shape_name}_16x16.json")) as f:
            art = json.load(f)
        cfg = get_config(arch).replace(**dryrun.PLAIN_IMPLS)
        tcfg = dryrun._tcfg(cfg)
        shape = SHAPES[shape_name]
        r = art["roofline"]
        want_bytes = analytic.step_hbm_bytes(None, cfg, shape, mesh,
                                             tcfg=tcfg).total
        check(r["hlo_flops"] == analytic.step_flops(cfg, shape, tcfg.remat)
              / 256 and r["hlo_bytes"] == want_bytes,
              f"{arch} {shape_name}: the artifact's analytic numbers")
        t_bound = max(r["t_compute"], r["t_memory"], r["t_collective"])
        print(f"  {arch} {shape_name} 16x16 on 256 fake ranks: cell "
              f"{art['t_lower_s']:.1f} s; bound {r['bottleneck']} "
              f"{t_bound * 1e3:.2f} ms (compute {r['t_compute'] * 1e3:.2f}, "
              f"memory {r['t_memory'] * 1e3:.2f}, collective "
              f"{r['t_collective'] * 1e3:.2f} ms, H100 rates); counted "
              f"{art['counted_flops']:.4e} FLOPs a rank; faithful "
              f"{art['faithful']} [{card_line}]")
        out[f"{arch}/{shape_name}"] = {
            "cell_s": art["t_lower_s"], "bottleneck": r["bottleneck"], "t_bound": t_bound,
            "counted_flops": art["counted_flops"],
            "faithful": art["faithful"]}
    return out


def tp_serve_phase(torch, model, params, card_line, forward_launches,
                   cell_launches):
    """The tp layout's sharded serving program at full width on a one-rank
    NCCL mesh: ``make_forward(model, param_shardings=...)`` of ``model``
    (bf16, the kernel paths) on the forward phase's batch (B=4, S=2048),
    then a prompt through ``make_prefill_step`` and ``TP_SERVE["steps"]``
    cells of ``make_serve_step``, both with ``param_shardings`` and
    ``cache_shardings`` and the rank's block of the cache
    (``specs.cache_block``: its rows, KV heads and recurrent heads),
    every layer's blocks gathered where used, the attention heads,
    ``ff``, vocabulary, Mamba-2 heads and RWKV-6 heads computed as the
    rank's blocks (here the whole of them) with their collectives (real
    NCCL calls of one rank), the argmax over the vocabulary blocks.
    Gates: the logits against the unsharded kernel path's within the
    bf16 gate, the greedy tokens equal to the unsharded steps', and the
    kernels' launches: ``forward_launches`` (name: count) in the forward,
    ``cell_launches`` in every cell, none of the others (counts set to 0
    just before each sharded run and read just after). Under tp the
    Mamba-2 gated norm takes its plain version (its mean of squares is
    all-reduced over the ranks), so the unsharded forward it is held to
    takes the plain norm too: the kernel's one-ulp differences in the
    norm's sum order grow through zamba2's 38 random layers to several
    percent of max|logit|, and the gate holds the sharding, not the
    kernel (phase 19 holds the kernel)."""
    from repro_torch import sharding as S
    from repro_torch.data import make_batch
    from repro_torch.kernels.mamba_glue import gated_rms_norm_plain
    from repro_torch.launch import specs
    from repro_torch.models import ssm
    from repro_torch.models.axes import param_axes
    from repro_torch.train.step import (make_forward, make_prefill_step,
                                        make_serve_step)
    from repro_torch.tree import tree_leaves
    cfg = model.cfg
    B, P, n, max_len = (TP_SERVE[k] for k in ("B", "prompt", "steps",
                                              "max_len"))
    batch = make_batch(cfg, *FORWARD_BATCH, seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (B, P), generator=gen,
                           device="cuda")

    def greedy(prefill, serve, weights, cache):
        cache = prefill(weights, cache, prompt[:, :-1], [P - 1] * B)
        tok, out, walls = prompt[:, -1:], [], []
        for _ in range(n):
            t0 = time.monotonic()
            tok, cache = serve(weights, cache, tok)
            torch.cuda.synchronize()
            walls.append(time.monotonic() - t0)
            out.append(tok)
        return torch.cat(out, 1), sorted(walls)[n // 2]

    def plain_norm(y, xh, z, D, gamma, eps):
        return gated_rms_norm_plain(y, xh, z, D, gamma, eps)
    with torch.no_grad(), patched(ssm, gated_rms_norm=plain_norm):
        want, _ = model.apply(params, batch)
    want_tok, want_wall = greedy(make_prefill_step(model),
                                 make_serve_step(model), params,
                                 model.init_cache(B, max_len))
    with one_rank_group(torch) as mesh:
        sh = S.param_shardings(param_axes(cfg), cfg, mesh, layout="tp")
        blocks = S.shard_tree(params, sh)
        split = sorted({S.entry_axes(e)[0] for _, s in tree_leaves(sh)
                        for e in s.spec if e is not None})
        forward = make_forward(model, param_shardings=sh)
        forward(blocks, batch)                # NCCL's first call sets up
        torch.cuda.synchronize()
        zero_counts()                         # the path's run starts
        t0 = time.monotonic()
        got, _ = forward(blocks, batch)
        torch.cuda.synchronize()
        fwd_s = time.monotonic() - t0
        fwd_counts = read_counts()            # and ends
        err, outside = worst(got, want, allowed(want, "bfloat16"))
        bit_equal = bool(torch.equal(got, want))
        del got, want
        whole = model.init_cache(B, max_len, device=specs.META)
        cache_sh = specs.cache_shardings(whole, mesh, cfg)
        block = specs.cache_block(cfg, B, max_len, mesh)
        kw = dict(param_shardings=sh, cache_shardings=cache_sh)
        zero_counts()                         # the path's run starts
        got_tok, got_wall = greedy(make_prefill_step(model, **kw),
                                   make_serve_step(model, **kw), blocks,
                                   model.init_cache(**block))
        serve_counts = read_counts()          # and ends
        del blocks
    cells = P - 1 + n
    print(f"  tp on a 1 x 1 NCCL mesh ({cfg.name} full width, bf16, leaves "
          f"split over {split}, cache block {block}): forward "
          f"B={FORWARD_BATCH[0]} S={FORWARD_BATCH[1]} {fwd_s * 1e3:.1f} ms, "
          f"logits against the unsharded kernel path max|diff| {err:.3e} "
          f"({outside} outside {TOL_TEXT['bfloat16']}; equal to the bit: "
          f"{bit_equal}), launches {fwd_counts}; serve B={B}: {P - 1} "
          f"prefill + {n} greedy cells, launches {serve_counts}, tokens "
          f"equal to the unsharded steps' "
          f"{bool(torch.equal(got_tok, want_tok))}; median cell "
          f"{got_wall * 1e3:.2f} ms sharded, {want_wall * 1e3:.2f} ms "
          f"unsharded (host wall) [{card_line}]")
    check(outside == 0 and math.isfinite(err),
          f"{cfg.name}: the sharded tp forward's logits differ from the "
          f"unsharded ones")
    check(torch.equal(got_tok, want_tok),
          f"{cfg.name}: the sharded tp serve step's tokens differ from the "
          f"unsharded ones")
    want_fwd = {k: forward_launches.get(k, 0) for k in fwd_counts}
    want_serve = {k: cell_launches.get(k, 0) * cells for k in serve_counts}
    check(fwd_counts == want_fwd, f"{cfg.name}: sharded forward launches "
                                  f"{fwd_counts}, expected {want_fwd}")
    check(serve_counts == want_serve, f"{cfg.name}: sharded serve launches "
                                      f"{serve_counts}, expected "
                                      f"{want_serve}")
    del batch
    release(torch)
    return {"split_axes": split, "cache_block": block,
            "forward_ms": fwd_s * 1e3, "logit_max_abs_err": err,
            "logits_bit_equal": bit_equal, "forward_launches": fwd_counts,
            "serve_cells": cells, "serve_launches": serve_counts,
            "cell_ms_sharded": got_wall * 1e3,
            "cell_ms_unsharded": want_wall * 1e3}


def seq_split_phase(torch, gen, card_line):
    """The decode kernel over a cache split on its positions, at
    zamba2-1.2b's long_500k attention shape (``SEQ_SPLIT``): for each
    case of ``SEQ_SPLIT_CASES`` and each block count, every block through
    the kernel with its ``offset`` and ``return_lse``, the partials
    merged by (m, l) (``ref.merge_partials``, the merge the model runs
    with all-reduces in place of the sums over blocks), held to the unsplit kernel call and to
    ``decode_attention_plain`` within the bf16 gate; the unsplit call's
    (m, l) held to the plain version's. Then device times at the whole
    cache: the kernel without and with the (m, l) output, its plain
    version, and SDPA without a mask (the library yardstick), beside the
    bound. Returns the row for the timing table."""
    import torch.nn.functional as F
    from repro_torch.kernels.decode_attention import kernel as K
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.decode_attention.ref import merge_partials
    B, H, KV, S, D = (SEQ_SPLIT[k] for k in ("B", "H", "KV", "S", "D"))
    q = torch.randn((B, H, D), generator=gen, device="cuda").bfloat16()
    # the model's cache layout (B, S, KV, D), read through transposed views
    k = torch.randn((B, S, KV, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    v = torch.randn((B, S, KV, D), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    max_err, launches, rows = 0.0, 0, []
    for length, window in SEQ_SPLIT_CASES:
        lens = torch.tensor([length] * B, dtype=torch.int32, device="cuda")
        whole, lse = decode_attention(q, kt, vt, lens, window=window,
                                      return_lse=True)
        plain, plse = decode_attention_plain(q, kt, vt, lens, window=window,
                                             return_lse=True)
        m_err = float((lse[0] - plse[0]).abs().max())
        l_rel = float(((lse[1] - plse[1]).abs() / plse[1]).max())
        check(m_err <= 1e-3 and l_rel <= 1e-3,
              f"the kernel's (m, l) differ from the plain version's: "
              f"{m_err:.2e}, {l_rel:.2e}")
        for n in SEQ_SPLIT["blocks"]:
            blk = S // n
            n0 = decode_attention.launches
            parts = [decode_attention(
                q, kt[:, :, i * blk:(i + 1) * blk],
                vt[:, :, i * blk:(i + 1) * blk], lens, window=window,
                offset=i * blk, return_lse=True) for i in range(n)]
            launches += decode_attention.launches - n0
            empty = sum(bool((p[1][0] == float("-inf")).all())
                        for p in parts)
            got = merge_partials(torch.stack([o for o, _ in parts]),
                                 torch.stack([ls for _, ls in parts]))
            torch.cuda.synchronize()
            e1, out1 = worst(got, whole, allowed(whole, "bfloat16"))
            e2, out2 = worst(got, plain, allowed(plain, "bfloat16"))
            max_err = max(max_err, e1, e2)
            print(f"  length {length} window {window}, {n} blocks of {blk} "
                  f"({empty} with no visible key): merged against the "
                  f"unsplit kernel max_abs_err {e1:.3e} ({out1} outside), "
                  f"against the plain version {e2:.3e} ({out2} outside; "
                  f"tol {TOL_TEXT['bfloat16']}); unsplit (m, l) against "
                  f"plain: |dm| {m_err:.2e}, |dl|/l {l_rel:.2e}")
            check(out1 == 0 and out2 == 0 and math.isfinite(e1 + e2),
                  f"the merged blocks differ at length {length} window "
                  f"{window}, {n} blocks")
            rows.append({"length": length, "window": window, "blocks": n,
                         "empty_blocks": empty, "vs_unsplit": e1,
                         "vs_plain": e2})
            del parts, got
        del whole, plain, lse, plse
    release(torch)
    lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
    ms = device_ms(torch, lambda i: decode_attention(q, kt, vt, lens), 1,
                   calls=16, reps=3)
    ms_lse = device_ms(torch, lambda i: decode_attention(
        q, kt, vt, lens, return_lse=True), 1, calls=16, reps=3)
    plain_ms = device_ms(torch, lambda i: decode_attention_plain(
        q, kt, vt, lens), 1, calls=2, reps=2)
    lib = device_ms(torch, lambda i: F.scaled_dot_product_attention(
        q[:, :, None], kt, vt), 1, calls=16, reps=3)
    bms, by, nbytes = bound_ms((B, H, KV, S, D, None, 0), "bfloat16", [S])
    ns = K.split_plan(B, KV, H, S)[0]
    print(f"  long_500k decode B={B} H={H} KV={KV} S={S} D={D} bf16 "
          f"({2 * B * S * KV * D * 2 / 1e9:.2f} GB of K and V): kernel "
          f"{ms * 1e3:.1f} us, with (m, l) {ms_lse * 1e3:.1f} us, plain "
          f"{plain_ms * 1e3:.1f} us, sdpa {lib * 1e3:.1f} us; bound "
          f"{bms * 1e3:.1f} us ({by}); kernel at "
          f"{nbytes / ms / 1e9:.3f} TB/s, {bms / ms:.3f} of the bound; "
          f"{ns} splits; {launches} block launches [{card_line}]")
    del q, k, v, kt, vt
    release(torch)
    return {"B": B, "H": H, "KV": KV, "S": S, "D": D, "dtype": "bfloat16",
            "num_splits": ns, "ms": ms, "ms_with_lse": ms_lse,
            "plain_ms": plain_ms, "library_ms": lib, "bound_ms": bms,
            "bound_by": by, "bytes": nbytes, "bound_share": bms / ms,
            "max_abs_err": max_err, "checks": rows}


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
    check(counts == {**dict.fromkeys(kernel_wrappers(), 0),
                     "flash_attention": model.cfg.num_layers},
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


# ---------------------------------------------------------------------------
# The MoE family: moonshot-v1-16b-a3b at its published widths
# ---------------------------------------------------------------------------

def moe_breakdown(torch, model, params, batch, card_line):
    """One forward under torch.profiler, with ``ffn.apply_moe`` and
    ``ffn._route`` wrapped in ``record_function`` ranges for this forward
    only. Each device kernel is charged to the CPU op that launched it,
    and so to the ranges and ops around that op: the MoE einsums (under an
    ``aten::einsum`` in the MoE FFN), the routing glue (under ``_route``:
    the top-k sort, the one-hot cumsum of positions, the ``index_add_``
    scatter; and the ``gather`` back to token order), the rest of the MoE
    FFN (router, softmax, SiLU, weighting, the shared experts, aux),
    flash (by kernel name) and the rest of the model (attention
    projections, norms, embedding, unembedding). Returns ms by class."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import ffn

    def marked(name, fn):
        def wrapper(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return wrapper

    with patched(ffn, apply_moe=marked("moe.ffn", ffn.apply_moe),
                 _route=marked("moe.route", ffn._route)):
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            model.apply(params, batch)
            torch.cuda.synchronize()
            wall = (time.monotonic() - t0) * 1e3
    events = prof.events()
    # the ranges also appear on the device's timeline, spanning their
    # kernels: only kernels count
    kern = [e for e in events if e.device_type == DeviceType.CUDA
            and e.name not in ("moe.ffn", "moe.route")]
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
    parts = {"moe_einsums": 0.0, "routing_glue": 0.0, "moe_other": 0.0}
    for e in events:
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        chain, up = [], e
        while up is not None:
            chain.append(up.name)
            up = up.cpu_parent
        if "moe.ffn" not in chain:
            continue
        ms = sum(k.duration for k in e.kernels) / 1e3
        if "moe.route" in chain or "aten::gather" in chain:
            parts["routing_glue"] += ms
        elif "aten::einsum" in chain:
            parts["moe_einsums"] += ms
        else:
            parts["moe_other"] += ms
    flash = [e for e in kern if "flash_fwd" in e.name]
    parts["flash"] = sum(e.time_range.elapsed_us() for e in flash) / 1e3
    parts["rest"] = busy - sum(parts.values())
    by_name = {}
    for e in kern:
        tot, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (tot + e.time_range.elapsed_us(), n + 1)
    print(f"  profiled forward: device busy {busy:.2f} ms of {wall:.1f} ms "
          f"wall (profiled), {len(kern)} device launches; " + ", ".join(
              f"{k} {v:.2f} ms ({v / busy:.3f})" for k, v in parts.items())
          + f"; flash launches {len(flash)} [{card_line}]")
    for name, (tot, n) in sorted(by_name.items(),
                                 key=lambda kv: -kv[1][0])[:8]:
        print(f"    {tot / 1e3:8.2f} ms  x{n:<5d} {name[:70]}")
    check(parts["moe_einsums"] > 0 and parts["routing_glue"] > 0
          and parts["rest"] > 0, f"the breakdown charged no kernel to a "
                                 f"class: {parts}")
    return {"device_busy_ms": busy, "profiled_wall_ms": wall,
            "device_launches": len(kern), "flash_launches": len(flash),
            **{f"{k}_ms": v for k, v in parts.items()}}


def moe_forward_phase(torch, serve, card_line):
    """moonshot-v1-16b-a3b at its published widths (d_model 2048, 16 heads
    = 16 KV heads of 128, 64 experts of width 1408, top-6, 2 shared
    experts, a dense first layer of width 11264, vocab 163840), B=4,
    S=2048. At a depth of 4 layers (1 dense + 3 MoE) ``forward_check``
    with its float32 gate: kernels against plain paths within 1e-3 x
    max|logit| in float32, and the bf16 kernel path no further from the
    float32 logits than 1.5x the plain bf16 path (a router's top-k flips
    on a rounding difference and moves a token by O(1), so bf16 paths
    are compared against the float32 floor). Then the whole 48 layers in
    bf16 through ``launch.serve``'s ``build`` (the weights moe-serve
    serves): finite logits, a positive aux, flash once per layer, the
    weights' bytes and peak memory, and ``moe_breakdown``. Returns the
    served model, its parameters and stats."""
    from repro_torch.config import get_config
    from repro_torch.data import make_batch
    from repro_torch.models.builder import build_model
    from repro_torch.serving import with_impls
    from repro_torch.tree import tree_leaves
    wr = kernel_wrappers()
    flash, decode = wr["flash_attention"], wr["decode_attention"]
    cfg = get_config(MOE_ARCH).replace(num_layers=MOE_REDUCED_DEPTH)
    model = build_model(cfg, "cuda")
    t0 = time.monotonic()
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    check(cfg.attn_impl == "cuda" and cfg.d_model == 2048
          and cfg.num_heads == cfg.num_kv_heads == 16 and cfg.head_dim == 128
          and (cfg.num_experts, cfg.top_k, cfg.d_ff) == (64, 6, 1408)
          and cfg.first_dense_layers == 1 and cfg.vocab_size == 163840,
          "not moonshot at its published widths")
    n_bytes = sum(t.numel() * t.element_size()
                  for _, t in tree_leaves(params))
    print(f"  {cfg.name} at depth {cfg.num_layers} (1 dense + "
          f"{cfg.num_layers - 1} MoE): weights {n_bytes / 1e9:.2f} GB "
          f"{cfg.dtype}, init {time.monotonic() - t0:.1f} s")
    batch = make_batch(cfg, *FORWARD_BATCH, seed=0)
    reduced = forward_check(
        torch, model, with_impls(model, attn_impl="torch"), params, batch,
        [(flash, cfg.num_layers, "flash_fwd"),
         (decode, 0, "decode_split_kernel")], card_line, fp32_gate=True)
    del model, params
    release(torch)

    args = serve.parse_args(MOE_SERVE_ARGS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model, params = serve.build(args)
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    cfg = model.cfg
    check(cfg.num_layers == 48 and cfg.d_model == 2048
          and cfg.attn_impl == "cuda", "not full-width moonshot")
    n_bytes = sum(t.numel() * t.element_size()
                  for _, t in tree_leaves(params))
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    weights_peak = torch.cuda.max_memory_allocated()
    print(f"  {cfg.name} full width: {cfg.num_layers} layers, "
          f"{n_params / 1e9:.3f} B parameters, weights {n_bytes / 1e9:.2f} GB "
          f"{cfg.dtype}, init {init_s:.1f} s, peak device memory "
          f"{weights_peak / 1e9:.2f} GB [{card_line}]")
    zero_counts()                                 # the path's run starts
    with torch.no_grad():
        t0 = time.monotonic()
        logits, aux = model.apply(params, batch)
        torch.cuda.synchronize()
        fwd_ms = (time.monotonic() - t0) * 1e3
    counts = read_counts()                        # and ends
    peak = torch.cuda.max_memory_allocated()
    B, S = FORWARD_BATCH
    finite = bool(torch.isfinite(logits).all())
    print(f"  full-depth forward B={B} S={S} bf16: {fwd_ms:.1f} ms wall, "
          f"launches {counts}, aux {float(aux):.4f}, logits finite "
          f"{finite}, max|logit| {float(logits.float().abs().max()):.2f}; "
          f"peak device memory {peak / 1e9:.2f} GB [{card_line}]")
    check(finite and tuple(logits.shape) == (B, S, cfg.vocab_size)
          and math.isfinite(float(aux)) and float(aux) > 0,
          "full-depth moonshot forward output malformed")
    check(counts["flash_attention"] == cfg.num_layers
          and counts["decode_attention"] == 0,
          f"full-depth moonshot forward launches {counts}, not "
          f"{cfg.num_layers} flash")
    del logits
    breakdown = moe_breakdown(torch, model, params, batch, card_line)
    del batch
    release(torch)
    return model, params, {
        "reduced_depth": reduced, "params": n_params, "weight_bytes": n_bytes,
        "init_s": init_s, "peak_after_init_bytes": weights_peak,
        "forward_peak_bytes": peak, "forward_wall_ms": fwd_ms,
        "flash_launches": counts["flash_attention"], "aux": float(aux),
        "breakdown": breakdown}


def moe_serve_phase(torch, serve, model, params, card_line):
    """``launch.serve --no-reduced --arch moonshot-v1-16b-a3b`` through its
    ``run``: 8 requests of 16 + 32 tokens, ``max_batch`` 4, ``max_len``
    512, undisturbed, then a hard revocation and a drain onto a second
    engine (the migrated tokens must equal the undisturbed ones); the
    same with the paged cache (the dense run's tokens, pages shipped);
    decode attention once per layer per decode cell (48) and no flash;
    then dense and paged decode steps in turns (wall and device-busy
    share)."""
    args = serve.parse_args(MOE_SERVE_ARGS)
    wr = kernel_wrappers()
    expect = [(wr["decode_attention"], model.cfg.num_layers),
              (wr["flash_attention"], 0)]
    dense, dense_tokens = serve_and_migrate(
        torch, serve, args, model, params, card_line, expect)
    pargs = serve.parse_args(MOE_SERVE_ARGS + PAGED_ARGS)
    paged, paged_tokens = serve_and_migrate(
        torch, serve, pargs, model, params, card_line, expect)
    check(paged_tokens == dense_tokens, "moonshot's paged engine's tokens "
                                        "differ from the dense one's")
    compare = paged_step_compare(torch, serve, model, params, card_line,
                                 ["--arch", MOE_ARCH])
    return {"serve": dense, "serve_paged": paged, "step_compare": compare}


def a2a_oracle_moe(p, x, cfg):
    """The a2a route's oracle, as ``tests/test_torch_moe_parallel.py``
    has it: the row-local dispatch of the rank's flattened (1, B*S, D)
    tokens at the a2a capacity (``ffn.a2a_capacity`` of B*S)."""
    from repro_torch.models import ffn
    b, s, d = x.shape
    out, aux = ffn._rows(p, x.reshape(1, b * s, d), cfg,
                         ffn.a2a_capacity(b * s, cfg))
    return ffn._dense_branches(p, x, out.view(b, s, d)), aux


def rows_diff(a, b):
    """(max|a - b| / max|b|, root mean square of a - b), in float32 one
    batch row at a time: full-width logits in float32 are 5.4 GB."""
    worst = top = sq = 0.0
    for i in range(a.shape[0]):
        d = a[i].float() - b[i].float()
        worst = max(worst, float(d.abs().max()))
        top = max(top, float(b[i].float().abs().max()))
        sq += float(d.pow(2).sum())
        del d
    return worst / top, math.sqrt(sq / a.numel())


def moe_ep_phase(torch, model, params, card_line):
    """The expert-parallel MoE routes on full-width moonshot (the model
    and weights moe-serve served), on a one-rank NCCL mesh: ``moe_impl``
    ``"ep"`` under layout tp and ``"a2a"`` under fsdp. ``ep`` is held to
    the row-local path, ``a2a`` to its oracle (``a2a_oracle_moe``): at a
    depth of 4 (views of the first 4 layers) in float32 (each weight cast
    at use) within 1e-3 x max|logit|, then all 48 layers in bf16 no
    further from the oracle's float32 logits, in root mean square, than
    1.5x the oracle's own bf16 logits (flash 48 times a forward). Then
    ``MOE_EP_DECODE``'s greedy decode cells through ``make_serve_step``
    under a2a (decode attention 48 times a cell), their tokens equal to
    the oracle's (at M = 1 both run the same expert products on the same
    buffers). ``ffn.moe_routes`` must show that every MoE layer took the
    route. Wall, device busy and launches of each."""
    from repro_torch import sharding as S
    from repro_torch.data import make_batch
    from repro_torch.models import ffn
    from repro_torch.serving import with_impls
    from repro_torch.train.step import make_serve_step
    from repro_torch.tree import tree_map
    cfg = model.cfg
    n_moe = cfg.num_layers - cfg.first_dense_layers
    B, S_ = FORWARD_BATCH
    batch = make_batch(cfg, B, S_, seed=0, device="cuda")
    routes = {"ep": "tp", "a2a": "fsdp"}

    def oracle(impl):
        return (patched(ffn, apply_moe=a2a_oracle_moe) if impl == "a2a"
                else contextlib.nullcontext())

    def under(mesh, layout, fn):
        with S.use_mesh(mesh, layout):
            return fn()

    stats = {}
    with one_rank_group(torch) as mesh, torch.no_grad():
        # float32 at a depth of 4: views of the first 4 layers
        depth = MOE_REDUCED_DEPTH
        p4 = dict(params, layers=tree_map(
            lambda t: t[:depth - cfg.first_dense_layers], params["layers"]))
        m4 = with_impls(model, num_layers=depth, dtype="float32")
        for impl, layout in routes.items():
            with oracle(impl):
                want = m4.apply(p4, batch)[0]
            ffn.moe_routes.clear()
            got = under(mesh, layout, lambda: with_impls(
                m4, moe_impl=impl).apply(p4, batch)[0])
            taken = dict(ffn.moe_routes)
            rel32, _ = rows_diff(got, want)
            print(f"  {impl} ({layout}) at depth {depth}, float32: logits "
                  f"against the {'oracle' if impl == 'a2a' else 'row-local'}"
                  f" path max|diff|/max|logit| {rel32:.3e} (tol 1e-3); "
                  f"routes {taken}")
            check(rel32 <= 1e-3
                  and taken == {impl: depth - cfg.first_dense_layers},
                  f"{impl} at depth {depth} in float32 disagrees or took "
                  f"routes {taken}")
            stats[f"{impl}_depth{depth}_fp32_rel"] = rel32
            del want, got
        release(torch)

        # all 48 layers in bf16
        for impl, layout in routes.items():
            with oracle(impl):
                want32 = with_impls(model, dtype="float32").apply(
                    params, batch)[0]
                plain16 = model.apply(params, batch)[0]
                _, floor = rows_diff(plain16, want32)
            kmodel = with_impls(model, moe_impl=impl)
            zero_counts()                         # the path's run starts
            ffn.moe_routes.clear()
            t0 = time.monotonic()
            got, aux = under(mesh, layout, lambda: kmodel.apply(params,
                                                                batch))
            torch.cuda.synchronize()
            wall = (time.monotonic() - t0) * 1e3
            counts, taken = read_counts(), dict(ffn.moe_routes)  # and ends
            rel16, rms16 = rows_diff(got, want32)
            agree = float((got.argmax(-1) == plain16.argmax(-1)).float()
                          .mean())
            finite = bool(torch.isfinite(got).all())
            del got, want32, plain16
            busy, by_name = calls_profile(torch, lambda: under(
                mesh, layout, lambda: kmodel.apply(params, batch)), 1)
            launches = round(sum(n for _, n in by_name.values()))
            print(f"  {impl} ({layout}) full depth B={B} S={S_} bf16: "
                  f"{wall:.1f} ms wall, {busy:.2f} ms device busy, "
                  f"{launches} device launches; kernels {counts}; routes "
                  f"{taken}; aux {float(aux):.4f}; rms diff from the "
                  f"float32 oracle {rms16:.4f}, the oracle's bf16 "
                  f"{floor:.4f} (tol 1.5x); max|diff|/max|logit| "
                  f"{rel16:.3e}; argmax agreement with the oracle's bf16 "
                  f"{agree:.4f} [{card_line}]")
            check(finite and math.isfinite(float(aux)) and float(aux) > 0,
                  f"{impl} full-depth forward output malformed")
            check(counts["flash_attention"] == cfg.num_layers
                  and counts["decode_attention"] == 0
                  and taken == {impl: n_moe},
                  f"{impl} full-depth forward launched {counts}, routes "
                  f"{taken}")
            check(rms16 <= 1.5 * floor, f"{impl} full depth in bf16: further "
                                        f"from the float32 oracle than its "
                                        f"bf16 path")
            stats[impl] = {"wall_ms": wall, "busy_ms": busy,
                           "device_launches": launches,
                           "flash_launches": counts["flash_attention"],
                           "routes": taken, "rms_vs_fp32": rms16,
                           "oracle_bf16_rms_vs_fp32": floor,
                           "rel_vs_fp32": rel16, "argmax_agreement": agree}
            release(torch)

        # greedy decode cells under a2a (S = 1: the route runs there too)
        Bd, max_len, steps = (MOE_EP_DECODE[k] for k in
                              ("B", "max_len", "steps"))
        first = batch["tokens"][:Bd, :1]

        def greedy(m, ctx, timed=False):
            step = make_serve_step(m)
            cache = m.init_cache(Bd, max_len)
            tok, toks, walls = first, [], []
            with ctx:
                for _ in range(steps):
                    t0 = time.monotonic()
                    tok, cache = step(params, cache, tok)
                    if timed:
                        torch.cuda.synchronize()
                    walls.append((time.monotonic() - t0) * 1e3)
                    toks.append(tok)
            torch.cuda.synchronize()
            return torch.cat(toks, 1), walls, cache, step

        a2a = with_impls(model, moe_impl="a2a")
        zero_counts()                             # the path's run starts
        ffn.moe_routes.clear()
        toks, walls, cache, step = greedy(a2a, S.use_mesh(mesh, "fsdp"),
                                          timed=True)
        counts, taken = read_counts(), dict(ffn.moe_routes)   # and ends
        check(counts["decode_attention"] == cfg.num_layers * steps
              and counts["flash_attention"] == 0
              and taken == {"a2a": n_moe * steps},
              f"{steps} a2a decode cells launched {counts}, routes {taken}")
        busy, by_name = calls_profile(torch, lambda: under(
            mesh, "fsdp", lambda: step(params, cache, toks[:, -1:])), 1)
        launches = round(sum(n for _, n in by_name.values()))
        wall = sorted(walls)[len(walls) // 2]
        del cache
        with oracle("a2a"):
            want = greedy(model, contextlib.nullcontext())[0]
        same = int((toks == want).all(1).sum())
        print(f"  a2a decode, B={Bd} max_len {max_len}, {steps} greedy "
              f"cells: host wall median {wall:.2f} ms (min {min(walls):.2f}),"
              f" device busy {busy:.3f} ms a cell, {launches} device "
              f"launches a cell; decode attention "
              f"{counts['decode_attention']} launches; routes {taken}; "
              f"tokens equal to the oracle's in {same}/{Bd} rows "
              f"[{card_line}]")
        check(torch.equal(toks, want), "a2a decode: tokens differ from the "
                                       "oracle's")
        stats["a2a_decode"] = {"cell_wall_ms_median": wall,
                               "cell_busy_ms": busy,
                               "cell_device_launches": launches,
                               "decode_launches": counts["decode_attention"],
                               "routes": taken, "rows_equal": same}
    del batch
    release(torch)
    return stats


# ---------------------------------------------------------------------------
# The multimodal and encoder-decoder families at their published widths
# ---------------------------------------------------------------------------

def weights_line(torch, cfg, params, init_s):
    """(parameters, bytes) of ``params``, printed with the peak device
    memory."""
    from repro_torch.tree import tree_leaves
    n_params = sum(t.numel() for _, t in tree_leaves(params))
    n_bytes = sum(t.numel() * t.element_size()
                  for _, t in tree_leaves(params))
    print(f"  {cfg.name} at depth {cfg.num_layers}: {n_params / 1e9:.3f} B "
          f"parameters, weights {n_bytes / 1e9:.2f} GB {cfg.dtype}, init "
          f"{init_s:.1f} s, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    return n_params, n_bytes


def vlm_forward_phase(torch, serve, card_line):
    """qwen2-vl-7b at its published widths (28 layers, d_model 3584, 28
    heads over 4 KV heads of 128: a GQA group of 7, d_ff 18944, vocab
    152064, M-RoPE), B=4, S=2048 from ``make_batch`` at seed 0 (484
    patch positions, a 22 x 22 grid, and 1564 text tokens). At a depth of
    4 ``forward_check`` with its float32 gate; then all 28 layers through
    ``launch.serve``'s ``build`` (the weights vlm-serve serves), gated the
    same way, the float32 forwards casting each bf16 weight at use: flash
    once per layer and the profiled breakdown. Returns the served model,
    its parameters and stats."""
    from repro_torch.config import get_config
    from repro_torch.data import make_batch
    from repro_torch.models.builder import build_model
    from repro_torch.serving import with_impls
    wr = kernel_wrappers()
    flash, decode = wr["flash_attention"], wr["decode_attention"]
    cfg = get_config(VLM_ARCH).replace(num_layers=VLM_REDUCED_DEPTH)
    check(cfg.attn_impl == "cuda" and cfg.d_model == 3584
          and (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim) == (28, 4, 128)
          and cfg.d_ff == 18944 and cfg.vocab_size == 152064
          and cfg.use_mrope, "not qwen2-vl at its published widths")
    model = build_model(cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    weights_line(torch, cfg, params, time.monotonic() - t0)
    batch = make_batch(cfg, *FORWARD_BATCH, seed=0)
    n_img = batch["patch_embeds"].shape[1]
    print(f"  batch: {n_img} patch positions + {batch['tokens'].shape[1]} "
          f"text tokens a row")
    expect = [(flash, cfg.num_layers, "flash_fwd"),
              (decode, 0, "decode_split_kernel")]
    reduced = forward_check(torch, model, with_impls(model, attn_impl="torch"),
                            params, batch, expect, card_line, fp32_gate=True)
    del model, params
    release(torch)

    args = serve.parse_args(VLM_SERVE_ARGS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model, params = serve.build(args)
    torch.cuda.synchronize()
    cfg = model.cfg
    check(cfg.num_layers == 28 and cfg.attn_impl == "cuda",
          "not full-width qwen2-vl")
    n_params, n_bytes = weights_line(torch, cfg, params,
                                     time.monotonic() - t0)
    full = forward_check(
        torch, model, with_impls(model, attn_impl="torch"), params, batch,
        [(flash, cfg.num_layers, "flash_fwd"),
         (decode, 0, "decode_split_kernel")], card_line, fp32_gate=True,
        params32=params)
    del batch
    release(torch)
    return model, params, {"reduced_depth": reduced, "full": full,
                           "params": n_params, "weight_bytes": n_bytes,
                           "flash_launches": full["kernels"][
                               "flash_attention"]["launches"]}


def vlm_serve_phase(torch, serve, model, params, card_line):
    """``launch.serve --no-reduced --arch qwen2-vl-7b`` through its
    ``run`` (text only, the dense decode cell, as the reference serves
    it): the serve phase's requests undisturbed, then a revocation and a
    drain (migrated tokens equal), again with the paged cache (the dense
    tokens, pages shipped); decode attention once per layer per cell (28)
    and no flash; then dense and paged decode steps in turns (host wall,
    device busy, launches)."""
    wr = kernel_wrappers()
    expect = [(wr["decode_attention"], model.cfg.num_layers),
              (wr["flash_attention"], 0)]
    args = serve.parse_args(VLM_SERVE_ARGS)
    dense, dense_tokens = serve_and_migrate(
        torch, serve, args, model, params, card_line, expect)
    pargs = serve.parse_args(VLM_SERVE_ARGS + PAGED_ARGS)
    paged, paged_tokens = serve_and_migrate(
        torch, serve, pargs, model, params, card_line, expect)
    check(paged_tokens == dense_tokens, "qwen2-vl's paged engine's tokens "
                                        "differ from the dense one's")
    compare = paged_step_compare(torch, serve, model, params, card_line,
                                 ["--arch", VLM_ARCH])
    return {"serve": dense, "serve_paged": paged, "step_compare": compare}


def encdec_forward_phase(torch, card_line):
    """seamless-m4t-large-v2 at its published widths and depth (24
    encoder + 24 decoder layers, d_model 1024, 16 = 16 KV heads of 64,
    d_ff 8192, vocab 256206), B=4, S=2048 from ``make_batch`` at seed 0
    (1024 frames into the encoder, 1024 decoder tokens):
    ``forward_check`` with its float32 gate at full depth (6.5 GB of
    float32 weights). Flash runs 72 times: 24 non-causal in the encoder,
    24 causal and 24 non-causal (the cross-attention) in the decoder.
    Returns the model, its bf16 parameters and stats."""
    from repro_torch.config import get_config
    from repro_torch.data import make_batch
    from repro_torch.models.builder import build_model
    from repro_torch.serving import with_impls
    wr = kernel_wrappers()
    cfg = get_config(ENCDEC_ARCH)
    check(cfg.attn_impl == "cuda" and (cfg.enc_layers, cfg.dec_layers) ==
          (24, 24) and cfg.d_model == 1024 and cfg.head_dim == 64
          and cfg.num_heads == cfg.num_kv_heads == 16
          and cfg.vocab_size == 256206,
          "not seamless at its published widths")
    model = build_model(cfg, "cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    params = model.init(model.generator(0))
    torch.cuda.synchronize()
    n_params, n_bytes = weights_line(torch, cfg, params,
                                     time.monotonic() - t0)
    batch = make_batch(cfg, *FORWARD_BATCH, seed=0)
    print(f"  batch: {batch['frame_embeds'].shape[1]} frames + "
          f"{batch['tokens'].shape[1]} decoder tokens a row")
    stats = forward_check(
        torch, model, with_impls(model, attn_impl="torch"), params, batch,
        [(wr["flash_attention"], 3 * cfg.dec_layers, "flash_fwd"),
         (wr["decode_attention"], 0, "decode_split_kernel")], card_line,
        fp32_gate=True)
    del batch
    release(torch)
    return model, params, dict(stats, params=n_params, weight_bytes=n_bytes)


def encdec_decode_phase(torch, model, params, card_line):
    """seamless decoding through its entry points: ``Model.init_cache``
    (B=4, max_len 512, enc_len 1024), ``encode_for_decode`` of the
    forward batch's frames (flash once per encoder layer: 24), then 32
    greedy steps of ``make_serve_step`` from the batch's first tokens
    (decode attention twice per decoder layer per cell, self and cross:
    48). The main path is the bf16 kernels; then the same in float32
    (each weight cast at use) through the kernels and through the plain
    paths, whose greedy tokens must be equal. Host wall and device busy
    of a decode cell."""
    from repro_torch.data import make_batch
    from repro_torch.models.transformer import encode_for_decode
    from repro_torch.serving import with_impls
    from repro_torch.train.step import make_serve_step
    cfg = model.cfg
    B, max_len, enc_len, steps = (ENCDEC_DECODE[k] for k in (
        "B", "max_len", "enc_len", "steps"))
    batch = make_batch(cfg, B, 2 * enc_len, seed=0)
    frames, start = batch["frame_embeds"], batch["tokens"][:, :1]

    def run(m, timed=False):
        """(tokens (B, steps), encode launches, decode launches, encode
        ms, decode cell walls in ms, the final cache)."""
        step = make_serve_step(m)
        cache = m.init_cache(B, max_len, enc_len=enc_len)
        zero_counts()                             # the path's run starts
        t0 = time.monotonic()
        with torch.no_grad():
            cache = encode_for_decode(params, m.cfg, frames, cache)
        torch.cuda.synchronize()
        enc_ms = (time.monotonic() - t0) * 1e3
        enc_counts = read_counts()
        zero_counts()
        tok, toks, walls = start, [], []
        for _ in range(steps):
            t0 = time.monotonic()
            tok, cache = step(params, cache, tok)
            if timed:
                torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
            toks.append(tok)
        torch.cuda.synchronize()
        return (torch.cat(toks, 1), enc_counts, read_counts(),  # and ends
                enc_ms, walls, cache)

    toks, enc_counts, dec_counts, enc_ms, walls, cache = run(model,
                                                             timed=True)
    wall = sorted(walls)[len(walls) // 2]
    check(enc_counts["flash_attention"] == cfg.enc_layers
          and enc_counts["decode_attention"] == 0,
          f"encode_for_decode launched {enc_counts}, not "
          f"{cfg.enc_layers} flash")
    check(dec_counts["decode_attention"] == 2 * cfg.dec_layers * steps
          and dec_counts["flash_attention"] == 0,
          f"{steps} decode cells launched {dec_counts}, not "
          f"{2 * cfg.dec_layers} decode attention a cell")
    check(tuple(toks.shape) == (B, steps) and bool((toks >= 0).all())
          and bool((toks < cfg.vocab_size).all())
          and torch.equal(cache["pos"], torch.full_like(cache["pos"], steps)),
          "seamless decode output malformed")
    serve_step = make_serve_step(model)
    busy, by_name = calls_profile(
        torch, lambda: serve_step(params, cache, toks[:, -1:]), 3)
    launches = sum(n for _, n in by_name.values())
    print(f"  {cfg.name} B={B} max_len {max_len} enc_len {enc_len}: "
          f"encode_for_decode {enc_ms:.1f} ms wall "
          f"({enc_counts['flash_attention']} flash launches); decode cell "
          f"host wall median {wall:.2f} ms "
          f"(min {min(walls):.2f}), device busy {busy:.3f} ms (share "
          f"{busy / wall:.3f}), {launches:.0f} device launches a cell; "
          f"decode attention {dec_counts['decode_attention']} launches in "
          f"{steps} cells [{card_line}]")
    for t, n, nm in sorted(((t, n, nm[:60]) for nm, (t, n)
                            in by_name.items()), reverse=True)[:5]:
        print(f"    {t:9.1f} us/cell  x{n:<4.0f} {nm}")
    plain16 = run(with_impls(model, attn_impl="torch"))[0]
    k32 = run(with_impls(model, dtype="float32"))[0]
    p32 = run(with_impls(model, attn_impl="torch", dtype="float32"))[0]
    same32 = int((k32 == p32).all(1).sum())
    agree16 = float((toks == plain16).float().mean())
    print(f"  greedy tokens, {steps} steps x {B} rows: float32 kernels vs "
          f"plain equal in {same32}/{B} rows; bf16 kernels vs plain "
          f"agreement {agree16:.4f}, bf16 vs float32 kernels "
          f"{float((toks == k32).float().mean()):.4f}")
    check(torch.equal(k32, p32), "seamless float32 decode: kernel and plain "
                                 "paths give other tokens")
    del cache, batch
    release(torch)
    return {"encode_ms": enc_ms, "cell_wall_ms": walls,
            "cell_wall_ms_median": wall, "cell_busy_ms": busy,
            "cell_busy_share": busy / wall, "cell_launches": launches,
            "encode_flash_launches": enc_counts["flash_attention"],
            "decode_launches": dec_counts["decode_attention"],
            "fp32_rows_equal": same32, "bf16_agreement": agree16}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2

    from repro_torch.kernels import build
    from repro_torch.kernels.decode_attention import kernel as K
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.mamba_glue import kernel as MG
    from repro_torch.kernels.mamba_glue import conv_silu_dt, gated_rms_norm
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
    glue_records = {n: {"name": n, "route": "cuda", "source": GLUE_SOURCE,
                        "replaces": GLUE_REPLACES} for n in GLUE_KERNELS}

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
                                  "rwkv6": WK.SOURCE,
                                  "mamba_glue": MG.SOURCE})
        for lib in (K, FK, SK, WK, MG):
            lib.library()
        print(f"  built five kernel sources with nvcc in "
              f"{time.monotonic() - t0:.1f}"
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
        record["max_abs_err"] = max(decode_vs_plain(torch, name, gen)
                                    for name in SHAPES)

    with phase("flash-vs-plain"):
        max_err = max(flash_vs_plain(torch, name, gen)
                      for name in FLASH_SHAPES)
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
        for dtype in ("bfloat16", "float32"):
            max_err = max(max_err, tp_heads_vs_plain(
                torch, gen, "ssd", dtype, ssd_scan, ssd_scan_plain))
        ssd_record["max_abs_err"] = max_err
        release(torch)

    with phase("glue-vs-plain"):
        for (name, shape), dtype in itertools.product(
                GLUE_SHAPES.items(), ("bfloat16", "float32")):
            for kname, u in glue_vs_plain(torch, gen, name, shape,
                                          dtype).items():
                rec = glue_records[kname]
                rec["max_ulps"] = max(rec.get("max_ulps", 0.0), u)
            release(torch)

    with phase("rwkv6-vs-plain"):
        max_err = 0.0
        for (name, shape), dtype in itertools.product(
                WKV_SHAPES.items(), ("bfloat16", "float32")):
            max_err = max(max_err, wkv_vs_plain(
                torch, gen, name, shape, dtype, rwkv6_scan, rwkv6_plain))
        for dtype in ("bfloat16", "float32"):
            max_err = max(max_err, tp_heads_vs_plain(
                torch, gen, "wkv", dtype, rwkv6_scan, rwkv6_plain))
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
        # against the unprofiled median dense decode step of serve-paged
        unprofiled = paged_stats["step_compare"]["dense"]["wall_ms_median"]
        idle = 1 - busy / unprofiled
        profile_stats = {"profiled_step_ms": step,
                         "device_busy_ms_per_step": busy,
                         "device_idle_share": idle,
                         "device_launches_per_step": len(kernels) / n_steps,
                         "decode_attention_ms_per_step": {
                             k: t for k, (t, _) in attn.items()}}
        print(f"  decode step: device busy {busy:.3f} ms of "
              f"{unprofiled:.2f} ms (unprofiled median; {step:.2f} ms "
              f"profiled), "
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
        del batch, eng, cache, other
        release(torch)

    with phase("tp-serve"):
        L = model.cfg.num_layers
        tp_serve_stats = tp_serve_phase(torch, model, params, card_line,
                                        {"flash_attention": L},
                                        {"decode_attention": L})
        # the serving weights go: training needs the card's memory
        del params, model
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
            logs, auxes = {}, {}
            for dev in ("cuda", "cpu"):
                m = build_model(pcfg, dev)
                ds = ShardedDataset(pcfg, global_batch=4, seq_len=64, seed=1,
                                    device=dev)
                tr = Trainer(m, tcfg, ds, log_every=1)
                auxes[dev] = []
                tr.fit(init_state(m, tcfg, params=params_from_numpy(
                    tree, pcfg, dev, dtype=torch.float32)), 3,
                    on_step=lambda _, mt, a=auxes[dev]: a.append(
                        float(mt["aux"])))
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
            if pcfg.family == "moe":
                # the router's aux loss is in the total: nonzero, and the
                # same on both devices
                aux_rel = max(abs(a - b) / b for a, b in
                              zip(auxes["cuda"], auxes["cpu"]))
                print(f"    aux cuda " + ", ".join(
                    f"{a:.6f}" for a in auxes["cuda"]) + " / cpu " +
                    ", ".join(f"{a:.6f}" for a in auxes["cpu"]) +
                    f"; worst relative difference {aux_rel:.2e} "
                    f"(tol 1e-4)")
                check(all(a > 0 for a in auxes["cuda"] + auxes["cpu"])
                      and aux_rel <= 1e-4,
                      f"{arch}: the router aux is zero or differs")
            parity[arch] = worst_rel

    with phase("spmd-train"):
        spmd_stats = spmd_train_phase(torch, card_line)
        spmd_stats[SPMD_RECURRENT_ARGS[2]] = spmd_train_phase(
            torch, card_line, SPMD_RECURRENT_ARGS, (("tp", "float32"),))

    with phase("dryrun"):
        dryrun_stats = dryrun_phase(torch, card_line, spmd_stats)

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
            rmodel, rparams = reference_block_build(rargs)
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
                          (conv_silu_dt, rcfg.num_layers, "conv_silu_dt"),
                          (gated_rms_norm, rcfg.num_layers,
                           "gated_rms_norm"),
                          (flash_attention, n_shared, "flash_fwd"),
                          (rwkv6_scan, 0, "wkv_token_kernel")]
            else:
                check(rcfg.num_layers == 32 and rcfg.d_model == 4096
                      and rcfg.d_ff == 14336, "not rwkv6-7b at full width")
                expect = [(rwkv6_scan, rcfg.num_layers,
                           "wkv_token_kernel"),
                          (ssd_scan, 0, "ssd_scan"),
                          (conv_silu_dt, 0, "conv_silu_dt"),
                          (gated_rms_norm, 0, "gated_rms_norm"),
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
            if rcfg.family == "hybrid":
                for n, grec in glue_records.items():
                    grec["launches"] = stats["kernels"][n]["launches"]
            recurrent[arch] = (rmodel, rparams, {"forward": stats})
            del batch, plain
            release(torch)

    with phase("tp-recurrent"):
        tp_recurrent_stats = {}
        for arch, (rmodel, rparams, _) in recurrent.items():
            rcfg = rmodel.cfg
            if rcfg.family == "hybrid":
                n_shared = num_shared_invocations(rcfg)
                # the conv kernel on the rank's [x_i, B, C]; the gated
                # norm's mean is all-reduced over the ranks: plain
                fwd = {"ssd_scan": rcfg.num_layers,
                       "conv_silu_dt": rcfg.num_layers,
                       "flash_attention": n_shared}
                cell = {"decode_attention": n_shared}
            else:
                fwd, cell = {"rwkv6_scan": rcfg.num_layers}, {}
            st = tp_serve_phase(torch, rmodel, rparams, card_line, fwd, cell)
            tp_recurrent_stats[arch] = st
            rec = ssd_record if rcfg.family == "hybrid" else wkv_record
            rec["tp_launches"] = st["forward_launches"][rec["name"]]
            if rcfg.family == "hybrid":
                for n, grec in glue_records.items():
                    grec["tp_launches"] = st["forward_launches"][n]

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

    # every earlier phase's model is gone: moonshot's 56.8 GB of bf16
    # weights leave ~20 GB of the card
    with phase("moe-forward"):
        mmodel, mparams, moe_stats = moe_forward_phase(torch, serve,
                                                       card_line)
        flash_record["moonshot_launches"] = moe_stats["flash_launches"]

    with phase("moe-serve"):
        moe_stats.update(moe_serve_phase(torch, serve, mmodel, mparams,
                                         card_line))
        record["moonshot_launches"] = moe_stats["serve"]["launches"][
            "decode_attention"]

    with phase("moe-ep"):
        moe_stats["ep"] = moe_ep_phase(torch, mmodel, mparams, card_line)
        flash_record["moonshot_ep_launches"] = moe_stats["ep"]["ep"][
            "flash_launches"]
        flash_record["moonshot_a2a_launches"] = moe_stats["ep"]["a2a"][
            "flash_launches"]
        record["moonshot_a2a_launches"] = moe_stats["ep"]["a2a_decode"][
            "decode_launches"]
        # moonshot's 56.8 GB go before the multimodal model comes
        del mmodel, mparams
        release(torch)

    with phase("vlm-forward"):
        vmodel, vparams, vlm_stats = vlm_forward_phase(torch, serve,
                                                       card_line)
        flash_record["qwen2vl_launches"] = vlm_stats["flash_launches"]

    with phase("vlm-serve"):
        vlm_stats.update(vlm_serve_phase(torch, serve, vmodel, vparams,
                                         card_line))
        record["qwen2vl_launches"] = vlm_stats["serve"]["launches"][
            "decode_attention"]
        del vmodel, vparams
        release(torch)

    with phase("encdec-forward"):
        emodel, eparams, encdec_stats = encdec_forward_phase(torch,
                                                             card_line)
        flash_record["seamless_launches"] = encdec_stats["kernels"][
            "flash_attention"]["launches"]

    with phase("encdec-decode"):
        encdec_stats["decode"] = encdec_decode_phase(torch, emodel, eparams,
                                                     card_line)
        record["seamless_launches"] = encdec_stats["decode"][
            "decode_launches"]
        flash_record["seamless_encode_launches"] = encdec_stats["decode"][
            "encode_flash_launches"]
        del emodel, eparams
        release(torch)

    with phase("decode-seq-split"):
        seq_split_stats = seq_split_phase(torch, gen, card_line)
        record["long_500k"] = {k: seq_split_stats[k] for k in (
            "ms", "ms_with_lse", "plain_ms", "library_ms", "bound_ms",
            "bound_by", "max_abs_err")}

    with phase("timing"):
        # decode: the serve cell's shape, a long cache, zamba2's decode
        # cell (H = KV = 32, D = 64), moonshot's, qwen2-vl's (G = 7) and
        # seamless's self and cross caches, all at full lengths
        timings = [decode_timing(torch, name, gen, card_line)
                   for name in ("serve", "long", "zamba2_decode", "moonshot",
                                "qwen2vl", "seamless_self",
                                "seamless_cross")]
        serve_t = timings[0]
        record.update(ms=serve_t["ms"], plain_ms=serve_t["plain_ms"],
                      bound_ms=serve_t["bound_ms"],
                      bound_by=serve_t["bound_by"],
                      library_ms=serve_t["library_ms"])

        # flash: the starcoder2 forward, a gemma3 local layer, zamba2's
        # shared block, moonshot's and qwen2-vl's forwards, seamless's
        # encoder (and cross-attention: non-causal) and decoder layers
        flash_timings = [flash_timing(torch, name, gen, card_line)
                         for name in ("forward", "gemma3_window", "zamba2",
                                      "moonshot", "qwen2vl", "seamless_enc",
                                      "seamless_dec")]
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
        ssd_record["tp_rank_row"] = ssd_timing["tp_rank"] = tp_heads_timing(
            torch, gen, "ssd", ssd_scan, ssd_scan_plain, card_line)

        # WKV: the float32 row (fused views, nonzero s0), the model's own
        # call (bf16 r, k, v and o, zero s0) and the same call at the
        # rwkv6-7b.forward-4x4096 cell's S = 4096; the record carries the
        # model's call, the main path's
        wkv_timings = [
            wkv_timing(torch, gen, name, dtype, rwkv6_scan, rwkv6_plain,
                       card_line)
            for name, dtype in (("forward", "float32"),
                                ("model", "bfloat16"),
                                ("cell", "bfloat16"))]
        glue_timings = glue_timing(torch, gen, card_line)
        for row in glue_timings:
            glue_records[row["name"]].update(
                {k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")})
        fp32_t, model_t, cell_t = wkv_timings
        wkv_tp = tp_heads_timing(torch, gen, "wkv", rwkv6_scan, rwkv6_plain,
                                 card_line)
        wkv_timings.append(wkv_tp)
        wkv_record["tp_rank_row"] = wkv_tp
        wkv_record.update(
            ms=model_t["ms"], plain_ms=model_t["plain_ms"],
            bound_ms=model_t["bound_ms"], bound_by=model_t["bound_by"],
            library_ms=None, **{f"{row}_row": {
                k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")}
                for row, t in (("float32", fp32_t), ("cell", cell_t))})
        print(json.dumps({"kernel_timings": timings,
                          "flash_timings": flash_timings,
                          "ssd_timing": ssd_timing,
                          "wkv_timings": wkv_timings,
                          "glue_timings": glue_timings,
                          "seq_split": seq_split_stats,
                          "tp_serve": tp_serve_stats,
                          "tp_recurrent": tp_recurrent_stats,
                          "serve": serve_stats, "profile": profile_stats,
                          "serve_paged": paged_stats, "fleet": fleet_stats,
                          "train": train_stats, "train_parity": parity,
                          "spmd_train": spmd_stats,
                          "dryrun": dryrun_stats,
                          "elastic": elastic_stats,
                          "checkpoint": checkpoint_stats,
                          "resnet32": resnet_stats, "gym": gym_stats,
                          "recurrent": recurrent_stats,
                          "moe": moe_stats, "vlm": vlm_stats,
                          "encdec": encdec_stats, "card": card_line}))

    print(json.dumps({"kernels": [record, flash_record, ssd_record,
                                  wkv_record, *glue_records.values()]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
