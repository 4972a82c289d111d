"""rwkv6-7b's files: the reference's chunked WKV form against the
token-by-token recurrence, the spans a tiny traced run of the cell opens,
the two metrics it adds on hand-made summaries (and nothing read where
the program opens no span or launches no kernel), the WKV roofline's
symbols against the kernel's source, and faults of the time mix planted
in the program (the WKV recurrence's and ``ln_x``'s), which the cell's
comparison has to find.

The plants are module-level functions of ``set_`` (``setattr`` by
default), so that a run at full width can plant them too."""
import re
import time
import types

import pytest
import torch

import repro_torch.models.rwkv as R
from bench_port import devtrace, harness
from bench_port.reference import ssm

import bench_port_tiny as tiny

CELL = "rwkv6-7b.forward-4x4096"
SPANS = ("rwkv.tmix", "rwkv.shift", "rwkv.proj", "rwkv.scan", "rwkv.cmix")
KERNEL = harness.CHECKOUT / "src" / "repro_torch" / "kernels" / "rwkv6" \
    / "csrc" / "rwkv6.cu"
F = frozenset


def _metric(name):
    return harness.load_module(harness.ROOT / "metrics" / f"{name}.py")


@pytest.mark.parametrize("S,chunk,strong", [(37, 8, False), (64, 16, True),
                                            (5, 32, False), (70, 32, True)])
def test_wkv_chunked_is_the_recurrence(S, chunk, strong):
    g = torch.Generator().manual_seed(S)
    b, H, D = 2, 3, 4
    r, k, v = (torch.randn(b, S, H, D, generator=g, dtype=torch.float64)
               for _ in range(3))
    # log-decays down to -exp(4) (the program's clamp) when ``strong``
    top = 4.0 if strong else 0.0
    logw = -torch.exp(torch.rand(b, S, H, D, generator=g,
                                 dtype=torch.float64) * (top + 8) - 8)
    u = torch.randn(H, D, generator=g, dtype=torch.float64)
    want = ssm.wkv_sequential(r, k, v, logw, u)
    got = ssm.wkv_chunked(r, k, v, logw, u, chunk, group=3)
    assert torch.allclose(got, want, rtol=1e-10, atol=1e-10)


def test_tiny_traced_run_opens_the_rwkv_spans():
    cfg, tr = tiny.files(CELL)
    cell = harness.make_cell(harness.benchmark(), CELL, tiny.SEED, 0.2,
                             True, "cpu", time.monotonic(), cfg, tr)
    out = harness.run_mode(cell)
    n = out.units * cfg["model"]["num_layers"]
    got = {k: out.summary.spans.instances.get(k, 0) for k in SPANS}
    assert got == {"rwkv.tmix": n, "rwkv.shift": n, "rwkv.proj": 2 * n,
                   "rwkv.scan": n, "rwkv.cmix": n}
    assert all(out.summary.spans.host_s[k] > 0 for k in SPANS)


def test_wkv_roofline_symbols_are_the_kernels():
    mod = _metric("wkv_roofline.forward")
    names = set(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*"
                           r"\)\s+)?(\w+)\s*\(", KERNEL.read_text()))
    assert mod.SYMBOLS == ("wkv_token_kernel",)
    assert all(s in names for s in mod.SYMBOLS)


MODEL = {"family": "ssm", "num_layers": 32, "d_model": 4096,
         "rwkv_head_dim": 64, "dtype": "bfloat16"}
TRAFFIC = {"batch": 4, "seq_len": 4096}


def _ctx(kernels=(), spans=None, units=2):
    summary = types.SimpleNamespace(kernels=list(kernels))
    if spans is not None:
        summary.spans = spans
    return harness.Ctx(summary=summary, units=units, unit_flops=1.0,
                       window_s=1.0, chips=1, model=MODEL, traffic=TRAFFIC)


def test_wkv_roofline_reads_its_launches():
    read = _metric("wkv_roofline.forward").read
    bound = harness.counts.wkv_bound(4, 4096, 64, 64, False, "bfloat16")[0]
    launches = [("wkv_token_kernel(Params)", 4 * bound)] * 64
    other = [("nvjet_gemm", 1.0)]
    assert read(_ctx(launches + other)) == pytest.approx(25.0)
    assert read(_ctx(launches[:-1] + other)) is None     # not 2 x 32
    assert read(_ctx(other)) is None                     # no kernel ran


def _spans(instances, device_s):
    return devtrace.Spans(instances=instances,
                          host_s={k: 1.0 for k in instances},
                          device_s=device_s, idle_s={})


def test_rwkv_glue_reads_the_time_mix_outside_scan_and_proj():
    read = _metric("rwkv_glue_ms.forward").read
    sp = _spans({"rwkv.tmix": 64, "rwkv.shift": 64, "rwkv.proj": 128,
                 "rwkv.scan": 64, "rwkv.cmix": 64},
                {F({"rwkv.tmix", "rwkv.shift"}): 0.10,
                 F({"rwkv.tmix", "rwkv.proj"}): 0.50,
                 F({"rwkv.tmix", "rwkv.scan"}): 0.30,
                 F({"rwkv.tmix"}): 0.04,
                 F({"rwkv.cmix"}): 0.70, F(): 0.2})
    assert read(_ctx(spans=sp)) == pytest.approx(70.0)
    # the parent's program: no span, or a summary made without spans
    assert read(_ctx(spans=_spans({}, {F(): 1.0}))) is None
    assert read(_ctx()) is None
    assert read(_ctx(spans=sp, units=0)) is None



def _scans(set_, change):
    """Both WKV paths (the kernel's, and the sequential scan that the CPU
    and decode run) given arguments changed by ``change``."""
    for name in ("rwkv6_scan", "_wkv_scan"):
        scan = getattr(R, name)
        set_(R, name, lambda r, k, v, w, u, s, scan=scan:
             scan(*change(r, k, v, w, u), s))


def u_dropped(set_=setattr):
    """The bonus u of the current token left out of the recurrence."""
    _scans(set_, lambda r, k, v, w, u: (r, k, v, w, torch.zeros_like(u)))


def decay_one_step_late(set_=setattr):
    """Each token's state decayed by the previous token's decay."""
    _scans(set_, lambda r, k, v, w, u: (
        r, k, v, torch.cat([w[:, :1], w[:, :-1]], dim=1), u))


def ln_x_two_heads_a_group(set_=setattr):
    """``ln_x`` normalising over two heads at a time."""
    norm = R._group_norm
    set_(R, "_group_norm", lambda o, weight, bias, H, eps:
         norm(o, weight, bias, H // 2, eps))


PLANTS = (u_dropped, decay_one_step_late, ln_x_two_heads_a_group)


@pytest.mark.parametrize("plant", PLANTS)
def test_time_mix_fault_is_not_correct(monkeypatch, plant):
    cfg, tr = tiny.files(CELL)
    cell = harness.make_cell(harness.benchmark(), CELL, tiny.SEED, 0.2,
                             False, "cpu", time.monotonic(), cfg, tr)
    plant(monkeypatch.setattr)
    out = harness.run_mode(cell)
    correct, checks = harness.judge(out.compare(), harness.limits(CELL))
    assert not correct, checks
