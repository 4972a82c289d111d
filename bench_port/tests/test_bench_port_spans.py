"""The program's spans in a traced window: the reduction on a hand-made
trace (nesting, a launch on another thread, the window's edges, idle by
span, which names count as spans), the summary that carries it, the
readers on a hand-made summary, the spans a tiny cell of each mode
opens, and ``annotate_span`` free with no profiler running."""
import dataclasses
import pickle
import types

import pytest
import torch

from bench_port import devtrace, harness, spans
from repro_torch.obs import profiling

import bench_port_tiny as tiny
from test_bench_port_trace import CPU, CUDA, EVENTS, Ev, WithActivity

# EVENTS' window is 0-1000 ns: gemm 100-400 launched at 20 (thread 1),
# add_kernel 600-700 at 505 (thread 1), a copy 650-800 with no launch.
SPAN_EVENTS = [
    ("train.forward", CPU, 5, 100, "user_annotation"),
    ("attn.core", CPU, 15, 40, "user_annotation"),
    ("train.forward", CUDA, 100, 400, "gpu_user_annotation"),
    ("train.backward", CPU, 480, 900, "user_annotation"),
    # the recompute on autograd's thread while thread 1 is in the backward
    ("attn.core", CPU, 525, 540, "user_annotation", 0, 2),
    ("cudaLaunchKernel", CPU, 530, 535, "cuda_runtime", 10, 2),
    ("bwd_kernel", CUDA, 820, 900, "kernel", 10),
    # one instance before the window, one running past its end
    ("train.optimizer", CPU, -50, 10, "user_annotation"),
    ("train.optimizer", CPU, 950, 1200, "user_annotation"),
    ("cudaLaunchKernel", CPU, 960, 965, "cuda_runtime", 11),
    ("adam_kernel", CUDA, 990, 1100, "kernel", 11),
]
NS = 1e-9


def _events(cls, rows):
    return [cls(*r) for r in rows]


def _reduce(events):
    return devtrace.summarise(events).spans


@pytest.mark.parametrize("cls", [Ev, WithActivity])
def test_reduction(cls):
    sp = _reduce(_events(cls, EVENTS + SPAN_EVENTS))
    assert sp.instances == {"train.forward": 1, "attn.core": 2,
                            "train.backward": 1, "train.optimizer": 1}
    assert sp.host_s["attn.core"] == pytest.approx(40 * NS)
    assert sp.host_s["train.optimizer"] == pytest.approx(50 * NS)  # clipped
    fwd, attn = spans.TRAIN_FORWARD, spans.ATTN_CORE
    bwd, opt = spans.TRAIN_BACKWARD, spans.TRAIN_OPTIMIZER
    # the gemm in both nested spans; the backward's kernel from thread 2
    assert sp.device(attn, fwd) == pytest.approx(300 * NS)
    assert sp.device(attn) == pytest.approx(380 * NS)
    assert sp.device(bwd) == pytest.approx(180 * NS)
    assert sp.device(bwd, outside=(attn,)) == pytest.approx(100 * NS)
    assert sp.device(opt) == pytest.approx(10 * NS)          # clipped
    assert sp.device_s[devtrace.OUTSIDE] == pytest.approx(150 * NS)
    assert sum(sp.device_s.values()) == pytest.approx(640 * NS)
    # idle: 0-100 ended by the gemm, 400-600 by add, 800-820 by the
    # backward's kernel, 900-990 by the optimizer's
    assert sp.idle(fwd) == pytest.approx(100 * NS)
    assert sp.idle(bwd) == pytest.approx(220 * NS)
    assert sp.idle(attn, bwd) == pytest.approx(20 * NS)
    assert sp.idle(opt) == pytest.approx(90 * NS)
    assert devtrace.OUTSIDE not in sp.idle_s


@pytest.mark.parametrize("cls", [Ev, WithActivity])
def test_summary_unchanged_by_spans(cls):
    """The spans the summary now carries leave its other fields as they
    were: the device's copies of the annotations are no kernels, and the
    spans' kernels add only their own time, launches and gaps."""
    plain = devtrace.summarise(_events(cls, EVENTS))
    with_spans = devtrace.summarise(_events(cls, EVENTS + SPAN_EVENTS))
    assert with_spans.window_s == plain.window_s == pytest.approx(1000 * NS)
    assert with_spans.busy_s == pytest.approx(plain.busy_s + 90 * NS)
    assert [k for k, _ in with_spans.kernels] == \
        [k for k, _ in plain.kernels] + ["bwd_kernel", "adam_kernel"]
    assert dict(with_spans.device_ops) == pytest.approx(dict(
        plain.device_ops, bwd_kernel=80 * NS, adam_kernel=110 * NS))
    # a gap is named by the two innermost host ranges open on the
    # launching thread, spans among them, as before
    assert dict(with_spans.idle_gaps) == pytest.approx({
        "aten::mm > attn.core": 100 * NS,
        "train.backward > aten::add": 200 * NS,
        "attn.core": 20 * NS, "train.optimizer": 90 * NS})
    assert with_spans.breakdown() == {
        "device_ops": [list(x) for x in with_spans.device_ops],
        "idle_gaps": [list(x) for x in with_spans.idle_gaps]}
    assert plain.spans.instances == {} and with_spans.spans.instances


@pytest.mark.parametrize("name,is_span", [
    ("serve.decode", True), ("moe.route_experts", True),
    ("train.forward", True), ("kv2.page.copy", True),
    ("aten::mm", False), ("cudaLaunchKernel", False),
    ("autograd::engine::evaluate_function: MmBackward0", False),
    ("nccl:all_reduce", False), ("ProfilerStep#3", False),
    ("Optimizer.step#AdamW.step", False), ("bench.feed", False),
    ("bench.forward", False), ("forward", False), ("Train.forward", False)])
def test_span_form(name, is_span):
    """A range of the span form counts, whatever its name, and nothing
    else does: a span the program opens later is reduced with no edit."""
    assert devtrace.is_span(name) is is_span
    rows = EVENTS + [(name, CPU, 10, 60, "user_annotation"),
                     (name, CPU, 12, 58, "cpu_op", 0, 2)]
    sp = _reduce(_events(WithActivity, rows))
    assert sp.instances == ({name: 2} if is_span else {})
    if is_span:
        assert sp.device(name) == pytest.approx(300 * NS)   # the gemm
        assert sp.host_s[name] == pytest.approx(96 * NS)


def test_spans_survive_replace_and_pickle():
    """A rank's summary travels pickled and rank 0's is rebuilt with
    ``dataclasses.replace`` (``modes/train_sharded.py``): its spans stay."""
    s = devtrace.summarise(_events(WithActivity, EVENTS + SPAN_EVENTS))
    assert s.spans.instances
    moved = dataclasses.replace(s, busy_s=1.0)
    assert moved.spans == s.spans and moved.busy_s == 1.0
    back = pickle.loads(pickle.dumps(moved))
    assert back == moved and back.spans.device(spans.TRAIN_BACKWARD) == \
        s.spans.device(spans.TRAIN_BACKWARD)


def test_reduction_without_spans():
    sp = _reduce(_events(Ev, EVENTS))
    assert sp.instances == {} and sp.host_s == {}
    assert sp.device_s == {devtrace.OUTSIDE: pytest.approx(550 * NS)}
    with pytest.raises(RuntimeError, match="bench.window"):
        _reduce(_events(Ev, EVENTS[2:]))


ZAMBA = {"family": "hybrid", "num_layers": 38, "shared_attn_every": 6,
         "num_heads": 32, "num_kv_heads": 32, "head_dim": 64,
         "ssm_heads": 64, "ssm_head_dim": 64, "ssm_state": 64,
         "dtype": "bfloat16"}
FORWARD = {"batch": 8, "seq_len": 4096}
F = frozenset


def _ctx(sp, units=2, model=ZAMBA, traffic=FORWARD):
    summary = types.SimpleNamespace() if sp is None else \
        types.SimpleNamespace(spans=sp)
    return harness.Ctx(summary=summary, units=units, unit_flops=1.0,
                       window_s=1.0, chips=1, model=model, traffic=traffic)


def _spans(instances, device_s):
    return devtrace.Spans(instances=instances,
                       host_s={k: 1.0 for k in instances},
                       device_s=device_s, idle_s={})


def test_phase_readers():
    sp = _spans({"train.forward": 2, "train.backward": 2,
                 "train.optimizer": 2},
                {F({"train.forward"}): 0.6,
                 F({"train.forward", "attn.core"}): 0.2,
                 F({"train.backward", "attn.core"}): 1.0,
                 F({"train.backward"}): 1.2,
                 F({"train.optimizer"}): 0.25, F(): 0.1})
    ctx = _ctx(sp)
    assert spans.forward_ms_train(ctx) == pytest.approx(400.0)
    assert spans.backward_ms_train(ctx) == pytest.approx(1100.0)
    assert spans.optimizer_ms_train(ctx) == pytest.approx(125.0)
    assert spans.attn_core_roofline_forward(ctx) is None     # 0 instances


def test_core_readers_and_their_counts():
    windows = 38 // 6
    bound = harness.counts.flash_bound(8, 4096, 4096, 32, 32, 64, True, 0,
                                       "bfloat16")[0]
    ssd = harness.counts.ssd_bound(8, 4096, 64, 64, 64, "bfloat16")[0]
    device = {F({"attn.core"}): 2 * windows * bound * 4,       # 25%
              F({"ssm.mixer", "ssm.scan"}): 2 * 38 * ssd * 2,  # 50%
              F({"ssm.mixer", "ssm.proj"}): 0.3,
              F({"ssm.mixer"}): 0.5}
    sp = _spans({"attn.core": 2 * windows, "ssm.mixer": 76,
                 "ssm.scan": 76, "ssm.proj": 152}, device)
    ctx = _ctx(sp)
    assert spans.attn_core_roofline_forward(ctx) == pytest.approx(25.0)
    assert spans.ssd_core_roofline_forward(ctx) == pytest.approx(50.0)
    assert spans.mamba_glue_ms_forward(ctx) == pytest.approx(250.0)
    # a count that is not forwards x layers reads nothing
    for name, n in (("attn.core", 2 * windows + 1), ("ssm.scan", 75)):
        off = _spans(dict(sp.instances, **{name: n}), device)
        reader = {"attn.core": spans.attn_core_roofline_forward,
                  "ssm.scan": spans.ssd_core_roofline_forward}[name]
        assert reader(_ctx(off)) is None


@pytest.mark.parametrize("name", sorted(spans.READERS))
def test_readers_read_nothing_without_spans(name):
    read = spans.READERS[name]
    assert read(_ctx(None)) is None                  # the parent's trace
    assert read(_ctx(_spans({}, {F(): 1.0}))) is None
    assert read(_ctx(_spans({n: 1 for n in spans.NAMES},
                            {F(): 1.0}), units=0)) is None
    # a core's instances with no device time (a CPU run) read nothing
    if "roofline" in name:
        full = {n: 2 * 38 * 2 for n in spans.NAMES}
        full["attn.core"] = 2 * (38 // 6)
        full["ssm.scan"] = 2 * 38
        assert read(_ctx(_spans(full, {F(): 1.0}))) is None


def test_span_names_are_the_programs():
    """Every name a reader reads is one the program opens, and every
    span the program opens has the form the reduction takes."""
    assert set(spans.NAMES) <= set(profiling.SPANS)
    assert len(set(spans.NAMES)) == len(spans.NAMES)
    assert all(devtrace.is_span(n) for n in profiling.SPANS)


def test_annotate_span_off_enters_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda.nvtx, "range", refuse)
    a, b = profiling.annotate_span("x"), profiling.annotate_span("y")
    assert a is b
    with a, b:
        torch.ones(2).sum()


def test_annotate_span_on_records_the_name():
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate_span(profiling.ATTN_CORE):
            torch.ones(2).sum()
    names = [e.name for e in prof.events()]
    assert profiling.ATTN_CORE in names


def _figures_tool():
    return harness.load_module(harness.CHECKOUT / "tools"
                               / "span_figures.py")


def _expected(cfg, tr, units):
    """The instances a window of ``units`` opens, by name."""
    m = cfg["model"]
    if tr["mode"].startswith("train"):
        again = 2 if tr["remat"] != "none" else 1
        return {"train.forward": units, "train.backward": units,
                "train.optimizer": units,
                "attn.core": again * units * m["num_layers"]}
    if m["family"] == "hybrid":
        n = m["num_layers"]
        return {"attn.core": units * (n // m["shared_attn_every"]),
                "ssm.mixer": units * n, "ssm.scan": units * n,
                "ssm.proj": 2 * units * n}
    return {"attn.core": units * m["num_layers"]}


@pytest.mark.parametrize("name", tiny.cells())
def test_tiny_cell_spans(name):
    cfg, tr = tiny.files(name)
    line = _figures_tool().run(name, tiny.SEED, 0.2, "cpu", cfg, tr)
    got = {n: s["instances"] for n, s in line["spans"].items()
           if s["instances"]}
    assert got == _expected(cfg, tr, line["units"])
    assert all(line["spans"][n]["host_s"] > 0 for n in got)
