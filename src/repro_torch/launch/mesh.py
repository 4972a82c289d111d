"""Mesh construction (counterpart of ``repro.launch.mesh``) over the
initialised ``torch.distributed`` process group, one rank per device.

Axis semantics:
  pod    inter-pod data parallelism -- the *transient revocation domain*:
         one pod = one revocable capacity block.
  data   intra-pod data parallelism + FSDP/ZeRO-1 shard axis.
  model  tensor parallelism (heads / d_ff / experts / vocab / ssm dims).

Every constructor wraps ``init_device_mesh`` and raises when the world
size is not the mesh's size (so ``make_production_mesh``, 256 or 512
devices, raises on any smaller world). Building a mesh is collective: every rank
calls it, and it creates the process group of every subset of the axes
(``("data",)``, ``("data", "model")``, ...) for every coordinate of the
other axes, on every rank, in one order, as ``dist.new_group`` requires.
A group's ranks are in row-major order of its axes, which is the block
order of ``repro_torch.sharding.local_shard`` and ``gather``.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import tempfile
from typing import Any, Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.config import MeshConfig
from repro_torch.sharding import Mesh

RANK_TIMEOUT = datetime.timedelta(minutes=5)


def _build(shape: Sequence[int], names: Sequence[str],
           device_type: str) -> Mesh:
    from torch.distributed.device_mesh import init_device_mesh
    shape, names = tuple(shape), tuple(names)
    if not dist.is_initialized():
        raise RuntimeError("no process group: call "
                           "torch.distributed.init_process_group first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != math.prod(shape):
        raise ValueError(f"a {dict(zip(names, shape))} mesh needs "
                         f"{math.prod(shape)} ranks; the process group has "
                         f"{world}")
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device(device_type)
    dm = init_device_mesh(device_type, shape, mesh_dim_names=names)
    coords = tuple(dm.get_coordinate())
    ids = torch.arange(world).reshape(shape)
    groups = {}
    for r in range(1, len(names) + 1):
        for subset in itertools.combinations(range(len(names)), r):
            others = [d for d in range(len(names)) if d not in subset]
            # one group per coordinate of the other axes
            for fixed in itertools.product(*(range(shape[d])
                                              for d in others)):
                index = [slice(None)] * len(names)
                for d, c in zip(others, fixed):
                    index[d] = c
                ranks = ids[tuple(index)].reshape(-1).tolist()
                group = dist.new_group(ranks)
                if rank in ranks:
                    groups[tuple(names[d] for d in subset)] = group
    return Mesh(axis_names=names, sizes=shape, device_mesh=dm,
                coords=coords, groups=groups, device=device)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _build(shape, axes, device_type)


def make_mesh(cfg: MeshConfig, device_type: str = "cuda") -> Mesh:
    """Arbitrary mesh from a MeshConfig (elastic sizes, tests)."""
    return _build(cfg.shape, cfg.axis_names, device_type)


def single_device_mesh(device_type: str = "cuda") -> Mesh:
    """A (1, 1) mesh over a one-rank process group."""
    return _build((1, 1), ("data", "model"), device_type)


def survivor_mesh(n_pods_alive: int, *, data: int = 16, model: int = 16,
                  device_type: str = "cuda") -> Mesh:
    """Mesh over the surviving pods after a revocation (elastic remesh):
    the process group is the survivors' (the caller re-initialises it
    over them), the shape logic is the reference's."""
    if n_pods_alive < 1:
        raise ValueError("no pods alive")
    if n_pods_alive == 1:
        return _build((data, model), ("data", "model"), device_type)
    return _build((n_pods_alive, data, model), ("pod", "data", "model"),
                  device_type)


def run_ranks(fn: Callable[..., Any], world: int, *args: Any,
              backend: str = "gloo", threads: int = 1) -> List[Any]:
    """``[fn(rank, *args) for rank in range(world)]``, each call in a fresh
    process of a ``world``-rank process group (``backend``, joined through
    a file store in a temporary directory, ``threads`` intra-op threads a
    rank; a collective that waits ``RANK_TIMEOUT`` raises rather than
    hangs). ``fn`` and ``args`` must pickle; so must the results, which
    come back through files. For testing mesh code on the CPU with gloo."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_rank_main, args=(world, backend, threads, tmp, fn, args),
                 nprocs=world)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]


def _rank_main(rank: int, world: int, backend: str, threads: int, tmp: str,
               fn: Callable[..., Any], args: Tuple[Any, ...]) -> None:
    torch.set_num_threads(threads)
    dist.init_process_group(backend, init_method=f"file://{tmp}/store",
                            rank=rank, world_size=world,
                            timeout=RANK_TIMEOUT)
    try:
        out = fn(rank, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{rank}.pt"))
