#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main paths at full width with random weights from a
seed: serving starcoder2-3b (30 layers, d_model 3072, 24 heads / 2 KV
heads, bf16) through the hand-written decode-attention CUDA kernel, its
full-sequence forward through the hand-written flash-attention CUDA
kernel, and its training step, in phases that each print their name and
``ok``:

1. environment: torch, CUDA, the card and its power limit;
2. build: compile both kernels from ``src/repro_torch`` with nvcc, one
   nvcc per source, started together;
3. kernel-vs-plain: the decode kernel against its plain PyTorch version
   on the serve shape, a long cache, a window, one KV head, ragged
   lengths (0 and past the cache), in bf16 and fp32;
4. flash-vs-plain: the flash kernel against its plain version on the
   starcoder2 forward shape, a gemma3 local layer, MQA, a ragged length,
   non-causal attention and D=64, in bf16 and fp32;
5. decode-cell: full-width decode steps with the kernel and with the
   plain version on the same cache; logits must agree;
6. serve: the serve entry point's engine answers 8 requests undisturbed, then
   again with a hard revocation of one slot and a drain that migrates
   work to a second engine; the migrated tokens must equal the
   undisturbed ones, and the kernel must have run once per layer per
   decode cell;
7. profile: one decode step under torch.profiler (device busy share);
8. forward: ``Model.apply`` on one batch of 4 x 2048 tokens with the
   flash kernel and with the plain attention; logits must agree, and the
   kernel must run once per layer; the kernel's device time per forward
   from torch.profiler;
9. train: three steps of ``python -m repro_torch.launch.train --full``
   (through its ``run``), finite losses and gradient norms, the first
   loss near ln(vocab); a fourth step under torch.profiler; then
   ``evaluate_accuracy`` of the trained weights through the flash kernel
   and through the plain attention;
10. train-parity: three ``Trainer.fit`` steps of reduced starcoder2-3b
    and gemma3-27b in float32 on the card against the same steps on the
    CPU, from the same numpy weights;
11. timing: device time of each kernel, its plain version and
    ``scaled_dot_product_attention`` (the library yardstick, which the
    port never calls) beside the kernel's bound.

Any failure raises and exits non-zero. The last lines are the kernel
records (JSON), the card's name and power limit, and
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits non-zero
without one or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
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

# name: (B, H, KV, S, D, lengths or None for full, window)
SHAPES = {
    "serve": (4, 24, 2, 512, 128, None, 0),
    "long": (8, 24, 2, 4096, 128, None, 0),
    "window": (4, 24, 2, 512, 128, [512, 300, 50, 0], 128),
    "kv1": (4, 24, 1, 512, 128, [512, 257, 33, 1], 0),
    "ragged": (4, 24, 2, 512, 128, [0, 1, 333, 700], 0),
}
# name: (B, Sq, Sk, H, KV, D, causal, window)
FLASH_SHAPES = {
    "forward": (4, 2048, 2048, 24, 2, 128, True, 0),   # starcoder2-3b
    "gemma3_window": (1, 4096, 4096, 32, 16, 128, True, 1024),
    "mqa": (2, 2048, 2048, 48, 1, 128, True, 0),
    "ragged": (2, 1000, 1000, 24, 2, 128, True, 0),
    "noncausal": (2, 1000, 1000, 24, 2, 128, False, 0),
    "d64": (2, 1024, 1024, 16, 4, 64, True, 256),
}
FORWARD_BATCH = (4, 2048)
TRAIN_ARGS = ["--full", "--arch", "starcoder2-3b", "--steps", "3",
              "--global-batch", "2", "--seq-len", "1024"]
PARITY_ARCHS = ("starcoder2-3b", "gemma3-27b")
SERVE_ARGS = ["--no-reduced", "--requests", "8", "--max-batch", "4",
              "--max-len", "512", "--prompt-len", "16",
              "--max-new-tokens", "32", "--seed", "0"]


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
    from repro_torch.launch import serve
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
                                  "flash_attention": FK.SOURCE})
        K.library()
        FK.library()
        print(f"  built both kernels with nvcc in {time.monotonic() - t0:.1f}"
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
                for splits in (K.split_plan(B, KV, H, S)[0], 1):
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
        flash_record["max_abs_err"] = max_err
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
        decode_attention.launches = 0
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
        check(decode_attention.launches == cfg.num_layers * base.decode_cells,
              "the undisturbed run did not launch the kernel once per layer "
              "per decode cell")
        tps = base.tokens_decoded / wall
        mean_step = sum(step_ms) / len(step_ms)
        print(f"  undisturbed: {base.tokens_decoded} tokens in {wall:.2f} s "
              f"= {tps:.1f} tokens/s, mean decode step {mean_step:.2f} ms "
              f"over {len(step_ms)} steps, {base.decode_cells} decode cells "
              f"[{card_line}]")
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
        cells = base.decode_cells + first.decode_cells + second.decode_cells
        same = sum(r.generated == expected[r.rid] for r in reqs)
        print(f"  revoke+drain run: slot 1 lost {lost.timing.tokens_lost} "
              f"tokens, {len(migrated)} requests migrated, tokens_replayed "
              f"{first.tokens_replayed}; tokens equal to the undisturbed "
              f"run: {same}/{len(reqs)}")
        print(f"  kernel launches {decode_attention.launches} = "
              f"{cfg.num_layers} layers x {cells} decode cells")
        check(same == len(reqs) and all(r.done for r in reqs),
              "migrated requests diverged from the undisturbed run")
        check(decode_attention.launches == cfg.num_layers * cells,
              "the main path did not run the kernel once per layer per "
              "decode cell")
        record["launches"] = decode_attention.launches
        serve_stats = {"tokens_per_s": tps, "decode_step_ms_mean": mean_step,
                       "decode_steps": len(step_ms),
                       "decode_cells": base.decode_cells, "wall_s": wall}

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
        # each wrapper call is two device launches: split pass and merge
        attn = {}                           # part -> (ms, launches) per step
        for part in ("decode_split_kernel", "decode_merge_kernel"):
            hits = [tn for nm, tn in by_name.items() if part in nm]
            attn[part] = (sum(t for t, _ in hits) / 1e3 / n_steps,
                          sum(n for _, n in hits) // n_steps)
        check(all(n == cfg.num_layers for _, n in attn.values()),
              f"decode attention device launches per step {attn}")
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
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.data import make_batch
        B, S = FORWARD_BATCH
        batch = make_batch(cfg, B, S, seed=0)
        plain_model = with_impls(model, attn_impl="torch")
        with torch.no_grad():
            want, _ = plain_model.apply(params, batch)
            torch.cuda.synchronize()
            flash_attention.launches = 0          # the path's run starts
            t0 = time.monotonic()
            got, aux = model.apply(params, batch)
            torch.cuda.synchronize()
            fwd_s = time.monotonic() - t0
            flash_launches = flash_attention.launches   # and ends
        check(flash_launches == cfg.num_layers,
              f"{flash_launches} flash launches in one forward, expected "
              f"one per layer ({cfg.num_layers})")
        flash_record["launches"] = flash_launches
        g32, w32 = got.float(), want.float()
        rel = float((g32 - w32).abs().max() / w32.abs().max())
        agree = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        check(torch.isfinite(g32).all().item()
              and tuple(got.shape) == (B, S, cfg.vocab_size)
              and float(aux) == 0.0, "forward output malformed")
        print(f"  {cfg.name} full width, B={B} S={S}: logits flash vs "
              f"plain attention max|diff|/max|logit| {rel:.3e} (tol 0.05), "
              f"argmax agreement {agree:.4f}; {flash_launches} flash "
              f"launches; forward {fwd_s * 1e3:.1f} ms [{card_line}]")
        check(rel <= 0.05, "full-width forward: flash path and plain path "
                           "disagree")
        del got, want, g32, w32
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            model.apply(params, batch)
            torch.cuda.synchronize()
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3
        flash_ev = [e for e in kern if "flash_fwd" in e.name]
        flash_fwd_ms = sum(e.time_range.elapsed_us() for e in flash_ev) / 1e3
        check(len(flash_ev) == cfg.num_layers,
              f"profiled forward ran {len(flash_ev)} flash kernels")
        print(f"  profiled forward: device busy {busy:.2f} ms, flash kernel "
              f"{flash_fwd_ms:.2f} ms over {len(flash_ev)} launches "
              f"({flash_fwd_ms / busy:.3f} of device time) [{card_line}]")
        profile_stats["forward"] = {
            "B": B, "S": S, "wall_ms": fwd_s * 1e3,
            "device_busy_ms": busy, "flash_ms": flash_fwd_ms,
            "flash_launches": len(flash_ev), "logit_rel_diff": rel,
            "argmax_agreement": agree}
        del batch, prof, kern, flash_ev
        # the serving weights go: training needs the card's memory
        del params, model, plain_model, base, first, second, eng, cache
        del other
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
                dtype="float32", attn_impl="torch")
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

    with phase("timing"):
        timings = []
        for name in ("serve", "long"):
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
            sdpa = F.scaled_dot_product_attention(
                q[:, :, None], k, v, attn_mask=masks[0], enable_gqa=True)
            # a sanity check that the yardstick computes the same function
            # (its bf16 probabilities round more than the kernel's)
            want = decode_attention_plain(q, k, v, lens)
            err, outside = worst(sdpa[:, :, 0], want,
                                 2e-2 * (1 + want.float().abs()))
            check(outside == 0, "SDPA yardstick computes another function")
            ms = device_ms(torch, lambda i: decode_attention(
                *ins[i][:4], window=win), n)
            plain = device_ms(torch, lambda i: decode_attention_plain(
                *ins[i][:4], window=win), n)
            lib = device_ms(torch, lambda i: F.scaled_dot_product_attention(
                ins[i][0][:, :, None], ins[i][1], ins[i][2],
                attn_mask=masks[i], enable_gqa=True), n)
            bms, by, nbytes = bound_ms(shape, "bfloat16", lens.tolist())
            ns = K.split_plan(B, KV, H, S)[0]
            print(f"  {name}: B={B} H={H} KV={KV} S={S} D={D} bf16, full "
                  f"lengths: kernel {ms * 1e3:.2f} us, plain "
                  f"{plain * 1e3:.2f} us, sdpa {lib * 1e3:.2f} us; bound "
                  f"{bms * 1e3:.2f} us ({by}, {nbytes / 1e6:.1f} MB), "
                  f"{ns} splits, {n} input copies [{card_line}]")
            timings.append({"shape": name, "B": B, "H": H, "KV": KV, "S": S,
                            "D": D, "dtype": "bfloat16", "num_splits": ns,
                            "ms": ms, "plain_ms": plain, "library_ms": lib,
                            "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                            "achieved_GBps": nbytes / ms / 1e6})
        serve_t = timings[0]
        record.update(ms=serve_t["ms"], plain_ms=serve_t["plain_ms"],
                      bound_ms=serve_t["bound_ms"],
                      bound_by=serve_t["bound_by"],
                      library_ms=serve_t["library_ms"])

        flash_timings = []
        for name in ("forward", "gemma3_window"):
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
                  f"{plain * 1e3:.1f} us, sdpa {lib * 1e3:.1f} us; bound "
                  f"{bms * 1e3:.1f} us ({by}, {flops / 1e9:.1f} GFLOP, "
                  f"{nbytes / 1e6:.1f} MB), kernel at "
                  f"{flops / ms / 1e9:.1f} TFLOP/s [{card_line}]")
            flash_timings.append({
                "shape": name, "B": B, "S": Sq, "H": H, "KV": KV, "D": D,
                "window": win, "dtype": "bfloat16", "ms": ms,
                "plain_ms": plain, "library_ms": lib, "bound_ms": bms,
                "bound_by": by, "flops": flops, "bytes": nbytes,
                "achieved_TFLOPs": flops / ms / 1e9})
            del ins
            release(torch)
        fwd_t = flash_timings[0]
        flash_record.update(ms=fwd_t["ms"], plain_ms=fwd_t["plain_ms"],
                            bound_ms=fwd_t["bound_ms"],
                            bound_by=fwd_t["bound_by"],
                            library_ms=fwd_t["library_ms"])
        print(json.dumps({"kernel_timings": timings,
                          "flash_timings": flash_timings,
                          "serve": serve_stats, "profile": profile_stats,
                          "train": train_stats, "train_parity": parity,
                          "card": card_line}))

    print(json.dumps({"kernels": [record, flash_record]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
