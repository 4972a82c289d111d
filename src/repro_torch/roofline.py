"""Three-term roofline of a dry-run cell or a kernel, on the H100's
published rates (counterpart of ``repro.roofline``):

    compute term    = FLOPs / (peak FLOP/s)                 [per device]
    memory term     = HBM bytes / HBM bandwidth             [per device]
    collective term = wire bytes / link bandwidth           [per device]

The reference reads FLOPs and bytes from a compiled XLA module and its
collectives from the optimized HLO text. The port compiles nothing: its
dry-run (``repro_torch.launch.dryrun``) runs rank 0's step on fake
tensors and hands :func:`build_report` what it counted there, the FLOPs
``FlopCounterMode`` saw and the collectives :func:`record_collectives`
recorded. The ring-algorithm wire models per op are the reference's:

    all-reduce      2 * S * (n-1)/n        (reduce-scatter + all-gather)
    all-gather      S * (n-1)/n            (S = gathered output size)
    reduce-scatter  S * (n-1)              (S = scattered output size)
    all-to-all      S * (n-1)/n
    collective-permute  S

where n = participants per group. The HLO-text parsers are kept for the
reference's call surface; nothing in the port produces HLO.

The constants below are the one place the port keeps the card's rates:
the dry-run, ``chip_smoke.py``'s kernel bounds and the kernel rooflines
all read them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
from typing import Dict, Iterator, List, Optional, Tuple

# NVIDIA H100 SXM, dense rates without sparsity (NVIDIA's datasheet), at
# the full 700 W power limit.
PEAK_FLOPS_BF16 = 989e12          # tensor cores, bf16 / fp16
PEAK_FLOPS_FP32 = 67e12           # float32 outside the tensor cores
HBM_BW = 3.35e12                  # bytes/s, HBM3
# NVLink 4 on the H100 SXM: the datasheet's "NVLink: 900 GB/s" is both
# directions together, so 450 GB/s each way. One card cannot measure it.
# A ``pod`` axis between nodes would cross the NIC instead (~50 GB/s at
# 400 Gb/s); this single-constant model does not separate the two, as
# the reference's single ICI constant does not.
NVLINK_BW = 450e9                 # bytes/s per device, each way

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2, "f8e4m3fn": 1, "f8e5m2": 1,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4, "s16": 2, "u16": 2,
    "s8": 1, "u8": 1, "pred": 1, "c64": 8, "c128": 16,
}

# e.g.  %all-reduce.5 = f32[448,4864]{1,0} all-reduce(...), replica_groups=...
_COLL_RE = re.compile(
    r"=\s*(?:\(([^)]*)\)|(\w+\[[\d,]*\][^ ]*))\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")
_SHAPE_RE = re.compile(r"(\w+?)\[([\d,]*)\]")


def _shape_bytes(shape_str: str) -> int:
    total = 0
    for m in _SHAPE_RE.finditer(shape_str):
        dt, dims = m.group(1), m.group(2)
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def _group_size(line: str) -> int:
    m = re.search(r"replica_groups=\[(\d+),(\d+)\]", line)
    if m:                                       # iota form [ngroups, size]
        return int(m.group(2))
    m = re.search(r"replica_groups=\{\{(.*?)\}", line)
    if m:
        return len(m.group(1).split(","))
    return 2


@dataclasses.dataclass
class Collective:
    kind: str
    out_bytes: int
    group: int

    @property
    def wire_bytes(self) -> float:
        """Ring-model bytes crossing a device's links for this op; none
        over a one-rank group (which the reference's model counts as
        two ranks)."""
        if self.group == 1:
            return 0.0
        n, s = max(2, self.group), self.out_bytes
        if self.kind == "all-reduce":
            return 2 * s * (n - 1) / n
        if self.kind == "all-gather":
            return s * (n - 1) / n
        if self.kind == "reduce-scatter":
            return s * (n - 1)
        if self.kind == "all-to-all":
            return s * (n - 1) / n
        return float(s)                          # collective-permute


def parse_collectives(hlo_text: str) -> List[Collective]:
    out: List[Collective] = []
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        shape_str = m.group(1) or m.group(2)
        out.append(Collective(kind=m.group(3),
                              out_bytes=_shape_bytes(shape_str),
                              group=_group_size(line)))
    return out


# ---------------------------------------------------------------------------
# Loop-aware collective accounting (HLO text)
# ---------------------------------------------------------------------------
# A collective inside a scanned layer body executes num_layers times per
# step. Trip counts come from the HLO: find `while` ops, read the loop
# bound from the condition computation's constant, and multiply every
# collective inside the body computation (recursively).

_COMP_HDR_RE = re.compile(r"^(?:ENTRY\s+)?%?([\w\.\-]+)\s*(?:\(|\{)")
_WHILE_RE = re.compile(
    r"while\(.*?\)"
    r"(?=.*condition=%?([\w\.\-]+))(?=.*body=%?([\w\.\-]+))")
_CONST_RE = re.compile(r"constant\((\d+)\)")


def _split_computations(hlo_text: str) -> Dict[str, str]:
    comps: Dict[str, List[str]] = {}
    cur: Optional[str] = None
    entry: Optional[str] = None
    for line in hlo_text.splitlines():
        if not line.startswith(" ") and ("{" in line):
            m = _COMP_HDR_RE.match(line.strip())
            if m:
                cur = m.group(1)
                comps[cur] = []
                if line.strip().startswith("ENTRY"):
                    entry = cur
                continue
        if cur is not None:
            if line.strip() == "}":
                cur = None
            else:
                comps[cur].append(line)
    joined = {k: "\n".join(v) for k, v in comps.items()}
    if entry:
        joined["__entry__"] = joined.get(entry, "")
        joined["__entry_name__"] = entry
    return joined


def _trip_count(cond_text: str) -> int:
    consts = [int(m.group(1)) for m in _CONST_RE.finditer(cond_text)]
    return max(consts) if consts else 1


def parse_collectives_loop_aware(hlo_text: str
                                 ) -> List[Tuple[Collective, int]]:
    """[(collective, trip_multiplier)] with scan trip counts applied."""
    comps = _split_computations(hlo_text)
    entry = comps.get("__entry_name__")
    if entry is None:
        return [(c, 1) for c in parse_collectives(hlo_text)]

    mult: Dict[str, int] = {entry: 1}
    work = [entry]
    seen = set()
    while work:
        name = work.pop()
        if name in seen:
            continue
        seen.add(name)
        body_text = comps.get(name, "")
        m_here = mult.get(name, 1)
        for wm in _WHILE_RE.finditer(body_text):
            cond, body = wm.group(1), wm.group(2)
            trips = _trip_count(comps.get(cond, ""))
            mult[body] = mult.get(body, 0) or m_here * trips
            work.append(body)

    out: List[Tuple[Collective, int]] = []
    for name, m_val in mult.items():       # entry + reachable while bodies
        for c in parse_collectives(comps.get(name, "")):
            out.append((c, m_val))
    return out


# ---------------------------------------------------------------------------
# The collective recorder
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def record_collectives() -> Iterator[List[Collective]]:
    """A list that every collective ``repro_torch.sharding`` issues while
    the block runs appends a :class:`Collective` to: its kind, the bytes
    of its output and the size of the process group it ran over.
    Process-wide (the autograd engine may run a backward's collectives on
    another thread); recorders nest, each seeing every collective."""
    from repro_torch import sharding
    out: List[Collective] = []
    sharding.recorders.append(out)
    try:
        yield out
    finally:
        sharding.recorders.remove(out)


# ---------------------------------------------------------------------------
# Per-cell report
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float                 # per device
    hlo_bytes: float                 # per device
    wire_bytes: float                # per device
    model_flops: float               # 6 N D (global, useful math)
    collectives: Dict[str, Dict[str, float]]
    peak_memory_bytes: Optional[float] = None
    raw_cost_analysis: Optional[Dict[str, float]] = None
    memory_breakdown: Optional[Dict[str, float]] = None

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / PEAK_FLOPS_BF16

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / (global step FLOPs): remat/padding/redundancy
        waste."""
        total = self.hlo_flops * self.chips
        return self.model_flops / total if total else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Useful-FLOPs throughput at the bound, as a fraction of peak."""
        if self.t_bound <= 0:
            return 0.0
        return (self.model_flops / self.chips / self.t_bound) / PEAK_FLOPS_BF16

    def to_json(self) -> Dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


# ---------------------------------------------------------------------------
# Kernel-level roofline
# ---------------------------------------------------------------------------
# A single kernel's roofline needs no dry-run: the caller hands closed-form
# FLOPs and HBM bytes per (kernel, shape), and the same three-term model
# applies, at the peak of the kernel's arithmetic (``peak_flops``: bf16
# tensor cores by default, ``PEAK_FLOPS_FP32`` for float32 arithmetic).

@dataclasses.dataclass(frozen=True)
class KernelRoofline:
    flops: float                     # useful math, closed form
    hbm_bytes: float                 # mandatory HBM traffic (in + out)
    wire_bytes: float = 0.0          # 0 for single-device kernels
    peak_flops: float = PEAK_FLOPS_BF16

    @property
    def t_compute(self) -> float:
        return self.flops / self.peak_flops

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        return self.wire_bytes / NVLINK_BW

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    def achieved_fraction(self, measured_s: float) -> float:
        """Fraction of the analytic roofline the measured wall time hits."""
        if measured_s <= 0:
            return 0.0
        return self.t_bound / measured_s


def kernel_roofline(flops: float, hbm_bytes: float,
                    wire_bytes: float = 0.0,
                    peak_flops: float = PEAK_FLOPS_BF16) -> KernelRoofline:
    return KernelRoofline(flops=flops, hbm_bytes=hbm_bytes,
                          wire_bytes=wire_bytes, peak_flops=peak_flops)


def model_flops(param_count: int, active_param_count: int, tokens: int,
                kind: str) -> float:
    """6 N D (training) / 2 N D (inference) with N = active params."""
    n = active_param_count
    if kind == "train":
        return 6.0 * n * tokens
    return 2.0 * n * tokens


def build_report(*, arch: str, shape: str, mesh_name: str, chips: int,
                 counted_flops: float,
                 collectives: List[Tuple[Collective, int]], mflops: float,
                 analytic_flops: Optional[float] = None,
                 analytic_bytes: Optional[float] = None) -> RooflineReport:
    """The report of a cell from the dry-run's counts: ``counted_flops``
    (one rank's, from ``FlopCounterMode``) and ``collectives``
    (``(Collective, executions)`` pairs, as ``parse_collectives_loop_aware``
    returns them). ``analytic_flops`` (GLOBAL step FLOPs, ``analytic.py``)
    and ``analytic_bytes`` (per-device HBM traffic) replace the counts
    when given, as in the reference; the dry-run counts no bytes of its
    own, so without ``analytic_bytes`` the memory term is 0. The count
    stays in ``raw_cost_analysis``. ``peak_memory_bytes`` is None: the
    fake tensors' live bytes are not tracked."""
    hlo_flops = (analytic_flops / chips if analytic_flops is not None
                 else counted_flops)
    hlo_bytes = analytic_bytes if analytic_bytes is not None else 0.0
    by_kind: Dict[str, Dict[str, float]] = {}
    wire = 0.0
    for c, trips in collectives:
        e = by_kind.setdefault(c.kind, {"count": 0, "executions": 0,
                                        "out_bytes": 0.0, "wire_bytes": 0.0})
        e["count"] += 1
        e["executions"] += trips
        e["out_bytes"] += c.out_bytes * trips
        e["wire_bytes"] += c.wire_bytes * trips
        wire += c.wire_bytes * trips
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=hlo_flops, hlo_bytes=hlo_bytes, wire_bytes=wire,
        model_flops=mflops, collectives=by_kind, peak_memory_bytes=None,
        raw_cost_analysis={"counted_flops": float(counted_flops)})


def format_table(reports: List[RooflineReport]) -> str:
    hdr = (f"{'arch':<24}{'shape':<13}{'mesh':<10}{'t_comp(ms)':>11}"
           f"{'t_mem(ms)':>11}{'t_coll(ms)':>11}{'bound':>11}"
           f"{'useful':>8}{'roofline':>9}")
    lines = [hdr, "-" * len(hdr)]
    for r in reports:
        lines.append(
            f"{r.arch:<24}{r.shape:<13}{r.mesh:<10}"
            f"{r.t_compute*1e3:>11.2f}{r.t_memory*1e3:>11.2f}"
            f"{r.t_collective*1e3:>11.2f}{r.bottleneck:>11}"
            f"{r.useful_flops_ratio:>8.2f}{r.roofline_fraction:>9.3f}")
    return "\n".join(lines)
