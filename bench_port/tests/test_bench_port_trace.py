"""The traced window's reduction on a hand-made trace: busy time, idle
gaps named by the launching host operation, kernels by name; with and
without the profiler's activity names."""
import pytest
import torch

from bench_port import devtrace

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, end, act, corr=0, thread=1):
        self._n, self._d, self._s, self._e = name, dev, start, end
        self._a, self._c, self._t = act, corr, thread

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._t

    def is_user_annotation(self):
        return self._a in ("user_annotation", "gpu_user_annotation")


class WithActivity(Ev):
    def activity_type(self):
        return self._a


EVENTS = [
    ("bench.window", CPU, 0, 1000, "user_annotation"),
    ("bench.window", CUDA, 0, 1000, "gpu_user_annotation"),
    ("aten::mm", CPU, 10, 60, "cpu_op"),
    ("cudaLaunchKernel", CPU, 20, 30, "cuda_runtime", 7),
    ("gemm_kernel(int)", CUDA, 100, 400, "kernel", 7),
    ("aten::add", CPU, 500, 520, "cpu_op"),
    ("cudaLaunchKernel", CPU, 505, 510, "cuda_runtime", 8),
    ("add_kernel", CUDA, 600, 700, "kernel", 8),
    ("Memcpy DtoD", CUDA, 650, 800, "gpu_memcpy", 9),
]


@pytest.mark.parametrize("cls", [Ev, WithActivity])
def test_summary(cls):
    s = devtrace.summarise([cls(*e) for e in EVENTS])
    assert s.window_s == pytest.approx(1000e-9)
    assert s.busy_s == pytest.approx(500e-9)       # 100-400, 600-800
    assert [k for k, _ in s.kernels] == ["gemm_kernel(int)", "add_kernel"]
    gaps = dict(s.idle_gaps)
    assert gaps["aten::mm"] == pytest.approx(100e-9)
    assert gaps["aten::add"] == pytest.approx(200e-9)
    assert gaps["after the last launch"] == pytest.approx(200e-9)
    ops = dict(s.device_ops)
    assert ops["gemm_kernel"] == pytest.approx(300e-9)
    assert ops["gpu_memcpy"] == pytest.approx(150e-9)
