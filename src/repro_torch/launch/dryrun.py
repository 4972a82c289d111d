"""Dry-run of every (arch x shape x mesh) cell on a fake 256- or 512-rank
process group (counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each cell on 512 placeholder host
devices. The port has no compiler to ask, so it runs the cell instead:
this process is rank 0 of a ``fake`` process group of the mesh's size
(``torch.distributed``'s test backend, whose collectives move nothing),
and the port's real sharded code runs on fake tensors
(``FakeTensorMode``: shapes and dtypes, no storage, no arithmetic). What
rank 0 does is counted: its FLOPs by ``FlopCounterMode`` and its
collectives by ``roofline.record_collectives``. A cell that does not
fit the sharded code (a spec that does not divide, rows that do not
split, an op that reads a fake tensor's data) fails here as it would on
the cluster. It computes nothing real and runs on the host only.

The cells:

- train: one call of ``make_train_step(model, tcfg, param_shardings=,
  zero1_mask=)`` on the rank's float32 blocks (made from
  ``models/axes.py``'s shapes and the specs, never as whole weights) and
  the global batch, of which the step takes the rank's rows; under
  ``tp`` and ``fsdp`` the step gathers per use and ``tp`` computes
  tensor-parallel;
- prefill: ``make_forward(model, param_shardings=)`` on the rank's rows,
  the same per-use program without a gradient;
- decode: one ``make_serve_step(model, param_shardings=,
  cache_shardings=)`` call on the rank's blocks (``serve_param_dtype``
  casts them) and the rank's block of the cache
  (``specs.cache_block``: its rows when the batch splits over the data
  ranks, else its block of positions of the whole batch, long_500k's
  B = 1, whose tokens every rank holds, as the reference replicates
  them; under tp its KV heads and its Mamba-2 or RWKV-6 heads), the
  decode attention merging the data ranks' partials over a
  sequence-split cache.

Every model runs the plain PyTorch paths (``attn_impl``, ``ssm_impl``
and ``rwkv_impl`` all ``"torch"``), as the reference's dry-run lowers its
default ``"xla"`` attention; the CUDA kernels cannot take fake tensors.
One piece is stood in for: the plain WKV recurrence is a Python loop
over tokens (~340 dispatches a token and layer in a training step, each
a fraction of a millisecond on fake tensors, so rwkv6's train_4k cell
ran for hours), and the dry-run replaces it by :func:`wkv_counted`, one
op of the same shapes whose counted FLOPs are the loop's.
The report's FLOPs and bytes are ``analytic.py``'s, as in the reference;
the counted FLOPs ride along (``counted_flops``). Each artifact says
whether the port's program is the reference's (``faithful``) and, if
not, why (``unfaithful_because``): every cell's is, so the list is
empty (the keys stay for the artifacts' readers).

Usage:
    python -m repro_torch.launch.dryrun --arch starcoder2-3b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both    # every cell
    python -m repro_torch.launch.dryrun --all --optimized
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback
from unittest import mock
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch import analytic
from repro_torch import sharding as S
from repro_torch.config import (ASSIGNED_ARCHS, SHAPES, ModelConfig,
                                OptimizerConfig, ShapeConfig, TrainConfig,
                                get_config, shape_applicable)
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import modality
from repro_torch.models.axes import param_axes, param_shapes
from repro_torch.models.builder import build_model
from repro_torch.roofline import (Collective, build_report, model_flops,
                                  record_collectives)
from repro_torch.train.step import (init_state, make_forward,
                                    make_serve_step, make_train_step)
from repro_torch.tree import tree_leaves, tree_map

ARTIFACT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                            "artifacts", "dryrun_torch")
PLAIN_IMPLS = dict(attn_impl="torch", ssm_impl="torch", rwkv_impl="torch")


@dataclasses.dataclass
class CellCounts:
    """What rank 0 did in a cell: its FLOPs (``FlopCounterMode``) and its
    collectives, in issue order."""
    flops: float
    collectives: List[Collective]


def wkv_counted(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                w: torch.Tensor, u: torch.Tensor,
                s0: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The dry-run's stand-in for ``rwkv6_plain``: the same inputs and
    output shapes and dtypes, the outputs differentiable in every input,
    and the FLOPs ``FlopCounterMode`` counts for the loop (whose one
    counted op, the per-token ``einsum("bhk,bhkv->bhv")``, becomes one
    einsum over every token), forward and backward. Its values are not
    the recurrence's."""
    r32, k32, v32, w32 = (t.float() for t in (r, k, v, w))
    x = (k32[..., :, None] * v32[..., None, :]) \
        * (u.float()[:, :, None] + w32[..., :, None])      # (B, S, H, D, D)
    if s0 is not None:
        x = x + s0.float()[:, None]
    o = torch.einsum("bshk,bshkv->bshv", r32, x)
    return o.to(r.dtype), x[:, -1]


def _tcfg(cfg: ModelConfig) -> TrainConfig:
    name = "momentum" if cfg.family == "resnet" else "adamw"
    return TrainConfig(optimizer=OptimizerConfig(name=name))


@contextlib.contextmanager
def fake_world(world: int):
    """A ``world``-rank ``fake`` process group, this process its rank 0,
    for the block. The group is process-global: one at a time."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _local_shape(shape, spec, mesh: S.Mesh) -> Tuple[int, ...]:
    """The shape of this rank's block of a leaf of ``shape`` under
    ``spec`` (``sharding.local_shard``'s)."""
    out = list(shape)
    for dim, entry in enumerate(spec):
        axes = S.entry_axes(entry)
        if axes:
            out[dim] //= mesh.group_size(axes)
    return tuple(out)


def _blocks(cfg: ModelConfig, shardings, mesh: S.Mesh, dtype: torch.dtype):
    """The rank's blocks of every parameter, as zeros of the current
    (fake) mode."""
    return tree_map(lambda shape, s: torch.zeros(
        _local_shape(shape, s.spec, mesh), dtype=dtype),
        param_shapes(cfg), shardings)


def _check_cache(cache, global_specs, cache_sh, mesh: S.Mesh,
                 cfg: ModelConfig, layout: str, block: Dict[str, int]
                 ) -> None:
    """The rank's cache leaves are the blocks ``cache_sh`` gives of the
    whole cache, but where ``launch/specs.py``'s docstring says
    otherwise: outside ``tp`` nothing splits over ``model``; ``conv``
    holds the rank's rows and channels [x, B, C], ``wkv`` its rows and
    heads (``block``'s ``recurrent_split``), and ``pos`` its rows."""
    whole = dict(tree_leaves(global_specs))
    spec_of = dict(tree_leaves(cache_sh))
    n, N = block["recurrent_split"], cfg.ssm_state
    for path, leaf in tree_leaves(cache):
        shape, name = whole[path].shape, path.split("/")[-1]
        spec = spec_of[path]
        if layout != "tp":
            spec = tuple(None if "model" in S.entry_axes(e) else e
                         for e in spec)
        want = list(_local_shape(shape, spec, mesh))
        if name == "conv":
            want[-3:] = [block["batch"], shape[-2],
                         (shape[-1] - 2 * N) // n + 2 * N]
        elif name == "wkv":
            want[-4:] = [block["batch"], shape[-3] // n, *shape[-2:]]
        elif name == "pos":
            want = [block["batch"]]
        if tuple(leaf.shape) != tuple(want):
            raise ValueError(f"cache leaf {path}: {tuple(leaf.shape)} is "
                             f"not the rank's block {tuple(want)} (spec "
                             f"{spec})")


def _zeros(spec: specs.TensorSpec) -> torch.Tensor:
    return torch.zeros(spec.shape, dtype=spec.dtype)


def count_cell(cfg: ModelConfig, shape: ShapeConfig, tcfg: TrainConfig,
               mesh: S.Mesh, *, serve_fsdp: bool = True,
               serve_param_dtype: Optional[str] = None,
               fake: bool = True) -> CellCounts:
    """Run rank 0's step of the cell (module docstring) and count it.
    ``fake=False`` runs the same program on real CPU tensors (zeros), for
    tests that hold the fake count to a real one."""
    model = build_model(cfg.replace(**PLAIN_IMPLS), "cpu")
    cfg = model.cfg
    layout = tcfg.layout
    axes = param_axes(cfg)
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.models import rwkv
    mode = FakeTensorMode() if fake else contextlib.nullcontext()
    counter = FlopCounterMode(display=False)
    with mode, mock.patch.object(rwkv, "_wkv_scan", wkv_counted):
        if shape.kind == "train":
            shardings = S.param_shardings(axes, cfg, mesh, layout=layout)
            state = init_state(model, tcfg, params=_blocks(
                cfg, shardings, mesh, torch.float32))
            batch = {k: _zeros(v) for k, v in
                     specs.train_batch_specs(cfg, shape).items()}
            step = make_train_step(
                model, tcfg, param_shardings=shardings,
                zero1_mask=tree_map(lambda a: "experts" not in a, axes))
            with record_collectives() as colls, counter, \
                    S.use_mesh(mesh, layout):
                step(state, batch)
        elif shape.kind == "prefill":
            shardings = S.param_shardings(axes, cfg, mesh, layout=layout)
            blocks = _blocks(cfg, shardings, mesh, torch.float32)
            rows = S.local_batch({k: _zeros(v) for k, v in
                                  specs.train_batch_specs(cfg, shape).items()},
                                 mesh, layout)
            forward = make_forward(model, param_shardings=shardings,
                                   layout=layout)
            with record_collectives() as colls, counter:
                forward(blocks, rows)
        else:
            shardings = S.param_shardings(axes, cfg, mesh, fsdp=serve_fsdp,
                                          layout=layout)
            dtype = (getattr(torch, serve_param_dtype) if serve_param_dtype
                     else torch.float32)
            blocks = _blocks(cfg, shardings, mesh, dtype)
            enc_len = (modality.encdec_split(cfg, shape.seq_len)[0]
                       if cfg.family == "encdec" else 0)
            whole = specs.cache_specs(model, cfg, shape)
            cache_sh = specs.cache_shardings(whole, mesh, cfg)
            block = specs.cache_block(cfg, shape.global_batch,
                                      shape.seq_len, mesh, layout)
            cache = model.init_cache(**block, enc_len=enc_len)
            _check_cache(cache, whole, cache_sh, mesh, cfg, layout, block)
            tokens = torch.zeros((block["batch"], 1), dtype=torch.int64)
            serve = make_serve_step(model, param_shardings=shardings,
                                    cache_shardings=cache_sh, layout=layout)
            with record_collectives() as colls, counter:
                serve(blocks, cache, tokens)
    return CellCounts(float(counter.get_total_flops()), colls)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               cfg_override: Optional[ModelConfig] = None,
               tcfg_override: Optional[TrainConfig] = None,
               serve_fsdp: bool = True,
               serve_param_dtype: Optional[str] = None,
               mesh_override: Optional[S.Mesh] = None,
               shape_override: Optional[ShapeConfig] = None
               ) -> Tuple[CellCounts, Dict]:
    """Run + count one cell. Returns (counts, info dict).

    Hillclimb knobs: tcfg_override carries layout/remat/grad_dtype;
    serve_fsdp=False pins decode params TP-only (no per-token gathers);
    mesh_override re-shapes the LOGICAL mesh (built over the current
    process group); shape_override replaces ``SHAPES[shape_name]``.
    Runs in the current process group (``fake_world``), which must have
    the mesh's size; without a mesh_override the production mesh is
    built over it."""
    shape = shape_override or SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    if not dist.is_initialized():
        raise RuntimeError("no process group: run the cell under "
                           "dryrun.fake_world(ranks)")
    world = dist.get_world_size()
    want = mesh_override.size if mesh_override is not None else chips
    if world != want:
        raise ValueError(f"the cell needs a {want}-rank process group; the "
                         f"current one has {world}")
    mesh = mesh_override or make_production_mesh(multi_pod=multi_pod,
                                                 device_type="cpu")
    chips = mesh.size
    cfg = (cfg_override or get_config(arch)).replace(**PLAIN_IMPLS)
    tcfg = tcfg_override or _tcfg(cfg)

    t0 = time.monotonic()
    counts = count_cell(cfg, shape, tcfg, mesh, serve_fsdp=serve_fsdp,
                        serve_param_dtype=serve_param_dtype)
    t_run = time.monotonic() - t0

    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind in ("train", "prefill")
                                   else 1)
    if cfg.family == "encdec" and shape.kind != "decode":
        tokens /= 2           # enc and dec halves each see half the tokens
    mflops = model_flops(cfg.param_count(), cfg.active_param_count(),
                         tokens, shape.kind)
    if mesh_override is not None:
        mesh_name = "x".join(str(mesh.shape[a]) for a in mesh.axis_names)
    else:
        mesh_name = "2x16x16" if multi_pod else "16x16"
    a_flops = analytic.step_flops(cfg, shape, remat=tcfg.remat)
    mem = analytic.step_hbm_bytes(None, cfg, shape, mesh, tcfg=tcfg,
                                  serve_fsdp=serve_fsdp)
    report = build_report(arch=arch, shape=shape.name, mesh_name=mesh_name,
                          chips=chips, counted_flops=counts.flops,
                          collectives=[(c, 1) for c in counts.collectives],
                          mflops=mflops, analytic_flops=a_flops,
                          analytic_bytes=mem.total)
    report.memory_breakdown = {
        "params": mem.params, "grads_opt": mem.grads_opt,
        "activations": mem.activations, "attn_scores": mem.attn_scores,
        "kv_cache": mem.kv_cache}
    info = {
        "arch": arch, "shape": shape.name, "mesh": mesh_name,
        "chips": chips, "kind": shape.kind,
        "layout": tcfg.layout, "remat": tcfg.remat,
        "grad_dtype": tcfg.grad_dtype,
        "serve_fsdp": serve_fsdp, "attn_impl": cfg.attn_impl,
        # the fake step's seconds; nothing is compiled
        "t_lower_s": t_run, "t_compile_s": None,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "roofline": report.to_json(),
        "memory_analysis": None,          # fake storages are not tracked
        "counted_flops": counts.flops,
        "faithful": True, "unfaithful_because": [],
    }
    return counts, info


def optimized_overrides(arch: str, shape: ShapeConfig, multi_pod: bool
                        ) -> Dict[str, Any]:
    """Best-known-config per cell kind from the reference's hillclimb.

    train: zero1 layout + bf16 grads + no remat (+ a2a EP for MoE) when
    the global batch flattens over the mesh; prefill/decode: TP-resident
    weights (no FSDP gathers), bf16 weight streaming for decode.
    """
    cfg = get_config(arch)
    chips = 512 if multi_pod else 256
    kw: Dict[str, Any] = {}
    if shape.kind == "train":
        if shape.global_batch % chips == 0:
            tcfg = TrainConfig(optimizer=OptimizerConfig(name="adamw"),
                               layout="zero1", grad_dtype="bfloat16",
                               remat="none")
            kw["tcfg_override"] = tcfg
            if cfg.family == "moe":
                kw["cfg_override"] = cfg.replace(moe_impl="a2a")
        else:
            kw["tcfg_override"] = TrainConfig(
                optimizer=OptimizerConfig(name="adamw"),
                grad_dtype="bfloat16")
            if cfg.family == "moe":
                kw["cfg_override"] = cfg.replace(moe_impl="ep")
    elif shape.kind == "prefill":
        kw["serve_fsdp"] = False            # weights TP-resident
        if cfg.family == "moe":
            kw["cfg_override"] = cfg.replace(moe_impl="ep")
    else:                                   # decode
        kw["serve_fsdp"] = False
        kw["serve_param_dtype"] = "bfloat16"
    return kw


def _write(path: str, obj: Dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def run_cells(archs, shapes, meshes, out_dir: str,
              stop_on_error: bool = False, optimized: bool = False) -> int:
    """Every applicable cell, one artifact each; returns the number of
    cells that failed. Each mesh kind runs in its own fake group (256 or
    512 ranks), made and destroyed here, with the production mesh built
    once over it."""
    os.makedirs(out_dir, exist_ok=True)
    failures = 0
    n_ok = 0
    cells = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in shapes:
            shape = SHAPES[shape_name]
            ok, reason = shape_applicable(arch, shape, cfg.family)
            if ok:
                cells.append((arch, shape))
                continue
            print(f"SKIP  {arch:24s} {shape_name:12s} -- {reason}")
            _write(os.path.join(out_dir, f"{arch}_{shape_name}_skip.json"),
                   {"arch": arch, "shape": shape_name, "skipped": True,
                    "reason": reason})
    for mesh_kind in meshes:
        multi = mesh_kind == "multi"
        mesh_name = "2x16x16" if multi else "16x16"
        with fake_world(512 if multi else 256):
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            for arch, shape in cells:
                tag = f"{arch}_{shape.name}_{mesh_name}"
                if optimized:
                    tag += "_opt"
                t0 = time.monotonic()
                try:
                    kw = (optimized_overrides(arch, shape, multi)
                          if optimized else {})
                    _, info = lower_cell(arch, shape.name, multi_pod=multi,
                                         mesh_override=mesh, **kw)
                    r = info["roofline"]
                    print(f"OK    {arch:24s} {shape.name:12s} {mesh_name:8s} "
                          f"run={info['t_lower_s']:6.1f}s "
                          f"bound={r['bottleneck']:<10s} "
                          f"t={max(r['t_compute'], r['t_memory'], r['t_collective'])*1e3:8.2f}ms "
                          f"useful={r['useful_flops_ratio']:.2f}",
                          flush=True)
                    _write(os.path.join(out_dir, tag + ".json"), info)
                    n_ok += 1
                except Exception as e:
                    failures += 1
                    print(f"FAIL  {arch:24s} {shape.name:12s} {mesh_name:8s} "
                          f"({time.monotonic()-t0:.1f}s): "
                          f"{type(e).__name__}: {str(e)[:200]}", flush=True)
                    _write(os.path.join(out_dir, tag + "_FAIL.json"),
                           {"arch": arch, "shape": shape.name,
                            "mesh": mesh_name, "error": str(e),
                            "traceback": traceback.format_exc()})
                    if stop_on_error:
                        raise
    print(f"\n{n_ok} cells OK, {failures} failed.")
    return failures


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Dry-run (arch x shape x mesh) cells on a fake process "
                    "group and write one artifact JSON per cell.")
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, help="one shape (default: all)")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true",
                    help="every assigned arch x shape")
    ap.add_argument("--out", default=os.path.abspath(ARTIFACT_DIR))
    ap.add_argument("--stop-on-error", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply the best-known per-kind config")
    args = ap.parse_args()

    archs = list(ASSIGNED_ARCHS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    failures = run_cells(archs, shapes, meshes, args.out,
                         stop_on_error=args.stop_on_error,
                         optimized=args.optimized)
    raise SystemExit(1 if failures else 0)


if __name__ == "__main__":
    main()
