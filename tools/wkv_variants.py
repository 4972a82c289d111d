#!/usr/bin/env python3
"""Variants of the WKV CUDA kernel, checked and timed in turns on one card.

    python3 tools/wkv_variants.py [--names shipped,r8c4,...]

Builds ``src/repro_torch/kernels/rwkv6/csrc/rwkv6.cu`` as it is
("shipped") and textual variants of it (``VARIANTS``: other thread
tiles, another token block, a token loop not unrolled, one output chain
a column, no swizzle, float32's three-rounding update for bf16 input, a
fused update, and ``diag_*`` variants that give wrong results but show
what a part costs), one nvcc per variant, all started together. Each variant is held against the plain version
(``rwkv6_plain``) on a ragged shape, S = 33, D = 16 and 8192 slowly
decaying tokens, in bf16 and fp32, with ``chip_smoke.py``'s gates; the
number of elements outside them is printed, not enforced, so that a
variant that breaks the gate shows by how much. Then every variant is
timed in turns (forward order, then reversed) at rwkv6-7b's forward
shape: float32 r, k, v as views of one fused projection with a nonzero
initial state (``chip_smoke.py``'s float32 row), and the model's own
call, bf16 r, k, v and o with a zero initial state. Times are device
times per call from CUDA-graph replays over input copies that exceed
the L2 cache (``chip_smoke.device_ms``), with the SM clock sampled by
``nvidia-smi`` while they run. ``--parent FILE`` adds an earlier WKV
source with the float32-only C interface of PR 14's kernel (no dtype
argument) to the float32 row, so that the two are timed in one call. The
last line is one JSON object with every number and the card's name and
power limit.

Needs one CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import json
import os
import subprocess
import sys
import threading

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke as CS  # noqa: E402

SHIPPED = "s[i][c] = __fadd_rn(__fmul_rn(wi, s[i][c]), kv);"
BF16_UPDATE = "s[i][c] = fmaf(ki, v[c], __fmul_rn(wi, s[i][c]));"
# name: [(text in the shipped source, its replacement)]
TILE = ("constexpr int kRows = 16;", "constexpr int kCols = 4;")
VARIANTS = {
    "shipped": [],
    # other thread tiles (rows x columns of the state a thread holds)
    "r16c2": [(TILE[1], "constexpr int kCols = 2;")],
    "r8c4": [(TILE[0], "constexpr int kRows = 8;")],
    "r8c8": [(TILE[0], "constexpr int kRows = 8;"),
             (TILE[1], "constexpr int kCols = 8;")],
    "tok16": [("constexpr int kTok = 32;", "constexpr int kTok = 16;")],
    # every block starts at token 0 (no half block for the grid's second
    # half)
    "no_shift": [("gridDim.x / 2 ? kTok / 2 : 0;", "gridDim.x / 2 ? 0 : 0;")],
    "unroll1": [("#pragma unroll 2\n    for (int t = 1; t < nt; ++t)",
                 "#pragma unroll 1\n    for (int t = 1; t < nt; ++t)")],
    # w * S + k v in one FFMA: a few ulps a token away from the plain
    # version's separately rounded update
    "fma_update": [(SHIPPED, "s[i][c] = fmaf(wi, s[i][c], kv);"),
                   (BF16_UPDATE, "s[i][c] = fmaf(wi, s[i][c], ki * v[c]);")],
    # bf16 input updated as float32 is: FMUL k v, FMUL w S, FADD
    "bf16_three_roundings": [("constexpr bool kBf16 = sizeof(T) == 2;",
                              "constexpr bool kBf16 = false;")],
    # diagnostics, with wrong results: every quad's r, k, w taken from
    # the quad before's registers (no shared-memory loads of r, k, w);
    # the lane sums without their shuffles
    "diag_no_quad_lds": [
        ("nr = R4[at];", "nr = rr;"),
        ("nk = K4[at];", "nk = kk;"),
        ("nw = W4[at];", "nw = ww;")],
    "diag_no_shfl": [
        ("a[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);",
         "a[i] = keep + send;"),
        ("a[0] += __shfl_xor_sync(0xffffffffu, a[0], m);", "a[0] += a[0];")],
    # the cook without its shared-memory traffic (no conversion, c_t = 0)
    "diag_no_cook": [
        ("const float4 r4 = load4(R + e), k4 = load4(R + kTile + e);\n"
         "      *reinterpret_cast<float4*>(Rc + t * kD + slot) = r4;\n"
         "      *reinterpret_cast<float4*>(Kc + t * kD + slot) = k4;\n"
         "      *reinterpret_cast<float4*>(Wc + t * kD + slot) = load4(W + e);\n"
         "      *reinterpret_cast<float4*>(Vc + e) = load4(R + 2 * kTile + e);",
         "const float4 r4 = make_float4(e, 1.f, 1.f, 1.f), k4 = r4;")],
    # the interleaved layout without its swizzle
    "no_swizzle": [("return kGroups == 4 ? (q >> 1 & 1) * 2 : kGroups == 8 ? (q & 1) * 4 : 0;",
                    "return 0;")],
    "parts1": [("constexpr int kParts = 2;",
                "constexpr int kParts = 1;")],
    # every lane reads row group 0's r, k, w: one address a warp
    "diag_uniform_g": [("const int g = lane / kLanes;                     // row group",
                        "const int g = 0;")],
    # one block an SM (100 KB more shared memory than it needs): each
    # block's warps then have the SM to themselves, in two waves
    "diag_one_block_per_sm": [
        ("return kTile * (3 * in_size + 4)",
         "return 100000 + kTile * (3 * in_size + 4)"),
        ("static_assert(smem_bytes(4) <= 232448 / 2,", "static_assert(true,")],
}
CHECK_SHAPES = ("ragged", "s33", "d16", "slow")
TIMED = (("forward", "float32"), ("model", "bfloat16"))


def variant_source(name: str, text: str) -> str:
    for old, new in VARIANTS[name]:
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} is not in the "
                               f"source exactly once")
        text = text.replace(old, new)
    return text


def build_variants(build, names, source):
    """One nvcc per variant, all started together; {name: CDLL}."""
    from repro_torch.kernels.rwkv6 import kernel as K
    text = source.read_text()
    assert SHIPPED in text, "the update's text changed: fix VARIANTS"
    paths, libs, errors = {}, {}, {}
    for name in names:
        d = os.path.join(ROOT, "build", "wkv_variants", name)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "rwkv6.cu")
        with open(path, "w") as f:
            f.write(variant_source(name, text))
        paths[name] = path

    def one(name):
        try:
            build.load_library(f"rwkv6_{name}", [paths[name]], rebuild=True)
        except Exception as exc:              # reported below, by name
            errors[name] = exc

    threads = [threading.Thread(target=one, args=(n,)) for n in names]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name, exc in errors.items():
        raise RuntimeError(f"building variant {name} failed") from exc
    for name in names:
        lib = build.load_library(f"rwkv6_{name}", [paths[name]])
        lib.rwkv6_forward.argtypes = K.library().rwkv6_forward.argtypes
        lib.rwkv6_forward.restype = K.library().rwkv6_forward.restype
        libs[name] = lib
        print(f"  {name}:")
        for line in build.build_log(f"rwkv6_{name}").splitlines():
            if "registers" in line or "spill" in line \
                    or "Compiling entry" in line:
                print("   ", line.strip())
    return libs


class Clocks:
    """SM clock (MHz) sampled by nvidia-smi every 0.2 s while active."""

    def __init__(self):
        self.mhz, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop.wait(0.2):
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"], capture_output=True,
                text=True).stdout.split()
            if out and out[0].isdigit():
                self.mhz.append(int(out[0]))

    def stop(self):
        self._stop.set()
        self._thread.join()
        return self.mhz


def parent_scan(lib):
    """rwkv6_scan for a float32-only kernel with PR 14's C interface."""
    import torch
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rwkv6_forward.argtypes = [P] * 8 + [I] * 4 + [LL] * 15 + [P]
    lib.rwkv6_forward.restype = I

    def scan(r, k, v, w, u, s0=None):
        B, S, H, D = r.shape
        o = torch.empty((B, S, H, D), dtype=torch.float32, device=r.device)
        st = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
        err = lib.rwkv6_forward(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), s0.data_ptr() if s0 is not None else None,
            o.data_ptr(), st.data_ptr(), B, S, H, D, *r.stride()[:3],
            *k.stride()[:3], *v.stride()[:3], *w.stride()[:3],
            *o.stride()[:3], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"parent kernel: CUDA error {err}")
        return o, st
    return scan


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--names", default=",".join(VARIANTS),
                    help="comma-separated variants (default: all)")
    ap.add_argument("--parent", default=None,
                    help="an earlier WKV source with the float32-only C "
                         "interface, timed beside the variants in float32")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels.rwkv6 import kernel as K
    from repro_torch.kernels.rwkv6 import rwkv6_plain, rwkv6_scan

    names = args.names.split(",")
    card_line = CS.card()
    print(f"card {card_line}; torch {torch.__version__}", flush=True)
    libs = build_variants(build, names, K.SOURCE)
    shipped_library = K.library
    parent = None
    if args.parent:
        parent = parent_scan(build.load_library("rwkv6_parent",
                                                [args.parent], rebuild=True))

    def use(name):
        K.library = lambda: libs[name]

    gen = torch.Generator(device="cuda").manual_seed(0)
    checks = {}
    for sname, dtype in itertools.product(CHECK_SHAPES,
                                          ("bfloat16", "float32")):
        args_ = CS.wkv_inputs(torch, CS.WKV_SHAPES[sname], gen, dtype)
        want_o, want_s = rwkv6_plain(*args_)
        for name in names:
            use(name)
            got_o, got_s = rwkv6_scan(*args_)
            torch.cuda.synchronize()
            eo, no = CS.worst(got_o, want_o, CS.allowed(want_o, dtype))
            es, ns = CS.worst(got_s, want_s, CS.allowed(want_s, "float32"))
            # worst error as a share of the gate, over all elements
            ratio = float(((got_o.float() - want_o.float()).abs()
                           / CS.allowed(want_o, dtype)).max())
            checks[f"{name}/{sname}/{dtype}"] = {
                "o_err": eo, "o_outside": no, "o_worst_share": ratio,
                "state_err": es, "state_outside": ns}
            print(f"  {name:10s} {sname:6s} {dtype:8s}: o max err {eo:.3e} "
                  f"({no} outside, worst {ratio:.3f} of the gate), state "
                  f"{es:.3e} ({ns} outside)", flush=True)
            del got_o, got_s
        del args_, want_o, want_s
        CS.release(torch)

    if parent is not None:
        args_ = CS.wkv_inputs(torch, CS.WKV_SHAPES["forward"], gen)
        want_o, _ = rwkv6_plain(*args_)
        got_o, _ = parent(*args_)
        outside = CS.worst(got_o, want_o, CS.allowed(want_o, "float32"))[1]
        print(f"  parent forward float32: {outside} outside")
        del args_, want_o, got_o

    times = {f"{n}/{d}": [] for n in names for _, d in TIMED}
    clocks = Clocks()
    for sname, dtype in TIMED:
        shape = CS.WKV_SHAPES[sname]
        _, _, _, nbytes = CS.wkv_bound_ms(shape, dtype)
        n = max(2, -(-2 * CS.L2_BYTES // nbytes))
        ins = [CS.wkv_inputs(torch, shape, gen, dtype) for _ in range(n)]
        order = names + (["parent"] if parent and dtype == "float32" else [])
        for turn in (order, order[::-1]):
            for name in turn:
                fn = parent if name == "parent" else rwkv6_scan
                if name != "parent":
                    use(name)
                times.setdefault(f"{name}/{dtype}", []).append(CS.device_ms(
                    torch, lambda i: fn(*ins[i]), n, calls=16, reps=3))
        del ins
        CS.release(torch)
    mhz = clocks.stop()
    K.library = shipped_library
    print(f"device time per call, us (two turns) [{card_line}]:")
    for sname, dtype in TIMED:
        bms, by, _, _ = CS.wkv_bound_ms(CS.WKV_SHAPES[sname], dtype)
        print(f"  {sname} {dtype}: bound {bms * 1e3:.1f} us ({by})")
        for name in names + (["parent"] if parent else []):
            ts = times.get(f"{name}/{dtype}")
            if ts is None:
                continue
            print(f"    {name:10s} " + " ".join(f"{t * 1e3:7.1f}" for t in ts))
    if mhz:
        print(f"  SM clock while timing: {min(mhz)}-{max(mhz)} MHz "
              f"(median {sorted(mhz)[len(mhz) // 2]}, {len(mhz)} samples)")
    print(json.dumps({"card": card_line, "times_ms": times,
                      "sm_clock_mhz": mhz, "checks": checks}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
