"""The hill-climb over the dry-run (counterpart of
``repro.launch.hillclimb``): named variants of a few chosen cells, each
run through ``dryrun.lower_cell`` on a fake process group and written
with its roofline terms to ``artifacts/hillclimb_torch/``.

Cells (the reference's, with its variants and knobs):
  A moonshot-v1-16b-a3b/train_4k   the MoE train cell, far from its
                                   roofline under the baseline layout
  B qwen2.5-14b/decode_32k         the most collective-bound serving
                                   cell; its baseline holds FSDP weights
  C starcoder2-3b/train_4k         the cell closest to the paper (a small
                                   dense model, data-parallel economics)
  D arctic-480b/decode_32k         480B-MoE serving

A variant with a ``mesh_shape`` runs on a logical (data, model) mesh of
that shape, over a fake group of its size; the others on the 16 x 16
production mesh over 256 fake ranks. A fake group is process-global, so
:func:`run_cell` opens one per world size, in turn. Each row keeps the
reference's keys (``compile_s`` is ``None``: nothing is compiled) and
adds ``run_s``, the seconds of the fake step. A variant that fails
records its error.

Usage: python -m repro_torch.launch.hillclimb [A|B|C|D|all]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import Any, Dict, List, Tuple

from repro_torch.config import (MeshConfig, OptimizerConfig, TrainConfig,
                                get_config)
from repro_torch.launch.dryrun import fake_world, lower_cell
from repro_torch.launch.mesh import make_mesh

OUT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..",
                                   "..", "artifacts", "hillclimb_torch"))
PRODUCTION = (16, 16)             # the single-pod (data, model) mesh


def tc(**kw) -> TrainConfig:
    return TrainConfig(optimizer=OptimizerConfig(name="adamw"), **kw)


# variant = (name, hypothesis, kwargs for lower_cell, plus "mesh_shape")
CELLS: Dict[str, Tuple[str, str, List[Tuple[str, str, Dict[str, Any]]]]] = {
    "A": ("moonshot-v1-16b-a3b", "train_4k", [
        ("baseline", "paper-faithful TP+FSDP; row-local MoE on the rank's "
         "experts", {}),
        ("ep_moe",
         "the row-local route sums the (B,E,C,D) dispatch buffers over the "
         "model ranks; expert parallelism combines on (B,S,D) instead: wire "
         "should drop by about E*C/S on the MoE layers",
         {"cfg_override": get_config("moonshot-v1-16b-a3b").replace(
             moe_impl="ep")}),
        ("ep_moe+bf16grad",
         "the remaining wire is the gradient reduce (fp32) and the TP "
         "all-reduces; bf16 gradients halve the reduce bytes",
         {"cfg_override": get_config("moonshot-v1-16b-a3b").replace(
             moe_impl="ep"),
          "tcfg_override": tc(grad_dtype="bfloat16")}),
        ("ep_moe+bf16grad+noremat",
         "with the wire down, the compute term carries remat's 4/3 tax; "
         "d2048 activations at 16 rows a rank fit without full remat",
         {"cfg_override": get_config("moonshot-v1-16b-a3b").replace(
             moe_impl="ep"),
          "tcfg_override": tc(grad_dtype="bfloat16", remat="none")}),
        ("a2a_zero1+noremat",
         "what remains is the Megatron activation all-reduces (attention, "
         "shared experts) and the expert-parallel combine. Flatten the "
         "batch over ALL axes (zero1: no TP, params gathered once) and ship "
         "only ROUTED tokens by all-to-all: a layer's wire drops from about "
         "3 (B,S,D) all-reduces to about 2 x T_loc x k x D x cf",
         {"cfg_override": get_config("moonshot-v1-16b-a3b").replace(
             moe_impl="a2a"),
          "tcfg_override": tc(layout="zero1", grad_dtype="bfloat16",
                              remat="none")}),
    ]),
    "B": ("qwen2.5-14b", "decode_32k", [
        ("baseline", "FSDP params all-gathered for EVERY token", {}),
        ("tp_only",
         "serving has no optimizer state: pin params TP-resident "
         "(fsdp=False), so no weight is gathered a token; the wire becomes "
         "the layers' activation all-reduces (tiny at S=1)",
         {"serve_fsdp": False}),
        ("tp_only+bf16",
         "stream bf16 weights (the dry-run's params are fp32 otherwise): "
         "halves the weight-read memory term",
         {"serve_fsdp": False, "serve_param_dtype": "bfloat16"}),
        ("mesh32x8+bf16",
         "40 heads / 8 kv-heads don't divide model=16 (attention and KV "
         "replicated). Re-mesh logically to (data=32, model=8): 40 % 8 == 0 "
         "and 8 % 8 == 0, so attention splits over the model ranks and the "
         "KV cache 256 ways; the memory a rank holds falls",
         {"serve_fsdp": False, "serve_param_dtype": "bfloat16",
          "mesh_shape": (32, 8)}),
    ]),
    "D": ("arctic-480b", "decode_32k", [
        ("baseline", "FSDP weights gathered again for every token", {}),
        ("tp_resident",
         "B's recipe: TP-resident bf16 weights; whether the rank's weights "
         "fit one card is the memory breakdown's verdict",
         {"serve_fsdp": False, "serve_param_dtype": "bfloat16"}),
        ("moe_serve_16x8",
         "one expert per rank: E=128 divides a (16,8) 128-rank serving "
         "replica; tokens go all-to-all over the FULL mesh to their "
         "experts' owners; non-expert weights TP-resident. Weights never "
         "move; the wire is routed activations only",
         {"cfg_override": get_config("arctic-480b").replace(moe_impl="a2a"),
          "tcfg_override": tc(layout="moe_serve"),
          "serve_param_dtype": "bfloat16",
          "mesh_shape": (16, 8)}),
    ]),
    "C": ("starcoder2-3b", "train_4k", [
        ("baseline", "paper-faithful megatron TP=16 + FSDP", {}),
        ("fsdp",
         "3B params over 256 ranks don't need TP; the layers' activation "
         "all-reduces ARE most of the wire. The pure-FSDP layout removes "
         "them; the wire becomes one gradient reduce-scatter and all-gather "
         "pair",
         {"tcfg_override": tc(layout="fsdp")}),
        ("fsdp+bf16grad",
         "halve the remaining gradient-reduce wire",
         {"tcfg_override": tc(layout="fsdp", grad_dtype="bfloat16")}),
        ("fsdp+bf16grad+noremat",
         "collective < compute now; drop remat's 4/3 compute tax (4096 "
         "tokens a rank x 30 layer boundaries fit in memory)",
         {"tcfg_override": tc(layout="fsdp", grad_dtype="bfloat16",
                              remat="none")}),
        ("zero1+bf16grad+noremat",
         "the per-layer FSDP gathers (forward and backward) still move "
         "about twice the bf16 params; ZeRO-1 gathers the bf16 replica ONCE "
         "a step: the wire floor is one param all-gather and one gradient "
         "reduce-scatter, and the cell turns compute-bound",
         {"tcfg_override": tc(layout="zero1", grad_dtype="bfloat16",
                              remat="none")}),
    ]),
}


def _row(arch: str, shape: str, name: str, hypothesis: str,
         kw: Dict[str, Any]) -> Dict[str, Any]:
    """One variant through ``lower_cell`` in the current fake group."""
    try:
        _, info = lower_cell(arch, shape, multi_pod=False, **kw)
    except Exception as e:                  # recorded, as the reference does
        print(f"{name:28s} FAILED: {str(e)[:160]}", flush=True)
        return {"variant": name, "hypothesis": hypothesis,
                "error": f"{type(e).__name__}: {e}"}
    r = info["roofline"]
    row = {
        "variant": name, "hypothesis": hypothesis,
        "t_compute_ms": r["t_compute"] * 1e3,
        "t_memory_ms": r["t_memory"] * 1e3,
        "t_collective_ms": r["t_collective"] * 1e3,
        "bound": r["bottleneck"],
        "useful": r["useful_flops_ratio"],
        "roofline_fraction": r["roofline_fraction"],
        "wire_GB": r["wire_bytes"] / 1e9,
        "collectives": r["collectives"],
        "memory_breakdown": r.get("memory_breakdown"),
        "compile_s": info["t_compile_s"],
        "run_s": info["t_lower_s"],
    }
    print(f"{name:28s} comp={row['t_compute_ms']:9.1f}ms "
          f"mem={row['t_memory_ms']:8.1f}ms "
          f"coll={row['t_collective_ms']:9.1f}ms "
          f"bound={row['bound']:<10s} "
          f"roofline={row['roofline_fraction']:.3f} "
          f"run={row['run_s']:.1f}s", flush=True)
    return row


def run_cell(key: str, out_dir: str = OUT) -> None:
    """Every variant of cell ``key``, in the reference's order, one fake
    group per world size; writes the rows."""
    arch, shape, variants = CELLS[key]
    os.makedirs(out_dir, exist_ok=True)
    print(f"\n##### CELL {key}: {arch} / {shape} #####", flush=True)
    shapes = [kw.get("mesh_shape", PRODUCTION) for _, _, kw in variants]
    rows: List[Dict[str, Any]] = [{} for _ in variants]
    for world in dict.fromkeys(math.prod(s) for s in shapes):
        with fake_world(world):
            meshes = {}
            for i, (name, hypothesis, kw) in enumerate(variants):
                mesh_shape = shapes[i]
                if math.prod(mesh_shape) != world:
                    continue
                kw = {k: v for k, v in kw.items() if k != "mesh_shape"}
                if mesh_shape not in meshes:
                    meshes[mesh_shape] = make_mesh(
                        MeshConfig(data=mesh_shape[0], model=mesh_shape[1]),
                        device_type="cpu")
                kw["mesh_override"] = meshes[mesh_shape]
                rows[i] = _row(arch, shape, name, hypothesis, kw)
    with open(os.path.join(out_dir, f"cell_{key}_{arch}_{shape}.json"),
              "w") as f:
        json.dump(rows, f, indent=1)


def main() -> None:
    ap = argparse.ArgumentParser(
        description="Run the hill-climb cells' variants on fake process "
                    "groups and write one JSON per cell.")
    ap.add_argument("which", nargs="?", default="all",
                    choices=sorted(CELLS) + ["all"])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    keys = list(CELLS) if args.which == "all" else [args.which]
    t0 = time.monotonic()
    for k in keys:
        run_cell(k, args.out)
    print(f"\n{len(keys)} cells in {time.monotonic() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
