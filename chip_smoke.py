#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path, serving starcoder2-3b at full width
(30 layers, d_model 3072, 24 heads / 2 KV heads, bf16, random weights
from a seed), through the hand-written decode-attention CUDA kernel, in
phases that each print their name and ``ok``:

1. environment: torch, CUDA, the card and its power limit;
2. build: compile the kernel from ``src/repro_torch`` with nvcc;
3. kernel-vs-plain: the kernel against its plain PyTorch version on the
   serve shape, a long cache, a window, one KV head, ragged lengths (0
   and past the cache), in bf16 and fp32;
4. decode-cell: full-width decode steps with the kernel and with the
   plain version on the same cache; logits must agree;
5. serve: the serve entry point's engine answers 8 requests undisturbed, then
   again with a hard revocation of one slot and a drain that migrates
   work to a second engine; the migrated tokens must equal the
   undisturbed ones, and the kernel must have run once per layer per
   decode cell;
6. profile: one decode step under torch.profiler (device busy share);
7. timing: device time of the kernel, its plain version and
   ``scaled_dot_product_attention`` (the library yardstick, which the
   port never calls) beside the kernel's memory bound.

Any failure raises and exits non-zero. The last lines are the kernel
record (JSON), the card's name and power limit, and
``{"ok": true, "device": {...}}``. Needs one CUDA card; exits non-zero
without one or without the repository's ``src/`` beside it.
"""
from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
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

# name: (B, H, KV, S, D, lengths or None for full, window)
SHAPES = {
    "serve": (4, 24, 2, 512, 128, None, 0),
    "long": (8, 24, 2, 4096, 128, None, 0),
    "window": (4, 24, 2, 512, 128, [512, 300, 50, 0], 128),
    "kv1": (4, 24, 1, 512, 128, [512, 257, 33, 1], 0),
    "ragged": (4, 24, 2, 512, 128, [0, 1, 333, 700], 0),
}
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
    from repro_torch.launch import serve
    from repro_torch.serving import with_impls
    from repro_torch.tree import tree_leaves

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    record = {"name": "decode_attention", "route": "cuda", "source": SOURCE,
              "replaces": REPLACES}

    with phase("environment"):
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]}")
        print(f"  device {torch.cuda.get_device_name(0)} capability "
              f"{torch.cuda.get_device_capability(0)} count "
              f"{torch.cuda.device_count()}")
        print(f"  card {card_line}")

    with phase("build"):
        t0 = time.monotonic()
        build.load_library("decode_attention", [K.SOURCE], rebuild=True)
        K.library()
        print(f"  built decode_attention with nvcc in "
              f"{time.monotonic() - t0:.1f} s [{card_line}]")
        for line in build.build_log("decode_attention").splitlines():
            if "registers" in line or "spill" in line:
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
        print(json.dumps({"kernel_timings": timings, "serve": serve_stats,
                          "profile": profile_stats, "card": card_line}))

    print(json.dumps({"kernels": [record]}))
    print(card_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
