"""Dry-run of every (arch × shape) cell on one H100: what one step's work
is and where its bound lies, counted without allocating anything.

For each cell this builds the model's parameters, optimizer or decode
state and inputs as ``meta`` tensors (where ``repro.launch.dryrun`` lowers
``ShapeDtypeStruct``s), runs the step function once under
``roofline.op_cost``'s counter, and records the FLOPs, bytes, kernel
records and peak live bytes with the roofline terms over the H100's peaks.
Shapes are the reference's global shapes, all on one card: many
``train_4k`` cells do not fit in 80 GB, and the record says so
(``fits_hbm``).  It sets no environment variable and runs on no device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-20b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single --out /tmp/dryrun
  PYTHONPATH=src python -m repro_torch.roofline.report /tmp/dryrun
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config.base import (
    SHAPES,
    ArchConfig,
    ShapeConfig,
    all_arch_ids,
    cell_is_runnable,
    get_config,
)
from repro_torch.launch.mesh import Mesh, make_production_mesh, model_size
from repro_torch.models.layers.moe import SpmdCtx
from repro_torch.models.model_api import build
from repro_torch.models.param import tree_abstract
from repro_torch.models.perf_flags import PerfFlags, use_flags
from repro_torch.models.transformer import model_dtype
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.optim.specs import opt_state_specs
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import analyze, model_flops_estimate
from repro_torch.roofline.op_cost import trace_cost
from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

META = torch.device("meta")


def param_dtype(cfg: ArchConfig, kind: str = "train") -> torch.dtype:
    """AdamW archs train float32 master parameters, Adafactor archs bf16;
    serving holds the model dtype."""
    if kind != "train":
        return model_dtype(cfg)
    return torch.float32 if cfg.optimizer == "adamw" else torch.bfloat16


def spmd_ctx(cfg: ArchConfig, mesh: Mesh) -> SpmdCtx:
    """One card holds one token group; the link's sibling instances are the
    mesh's model axis, as in the reference (1 on one card)."""
    n_ep = model_size(mesh)
    if cfg.moe is not None and cfg.moe.num_experts % n_ep != 0:
        n_ep = 1
    return SpmdCtx(num_groups=1, num_ep_shards=n_ep)


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def build_cell(arch_id: str, shape_name: str, mesh_name: str = "single") -> Tuple[Callable, Tuple, Dict]:
    """Returns (step function, its ``meta`` arguments, the record's facts)."""
    fn, args, meta = build_step(get_config(arch_id), SHAPES[shape_name], mesh_name)
    return fn, args, dict(meta, arch=arch_id)


def build_step(cfg: ArchConfig, shape: ShapeConfig, mesh_name: str = "single") -> Tuple[Callable, Tuple, Dict]:
    """``build_cell`` for any config and shape (the tests' reduced ones)."""
    mesh = make_production_mesh(multi_pod=mesh_name != "single")
    model = build(cfg)
    ctx = spmd_ctx(cfg, mesh)
    params = model.abstract_params(param_dtype(cfg, shape.kind))
    B, S = shape.global_batch, shape.seq_len
    dt = model_dtype(cfg)

    def extra_inputs() -> Dict[str, torch.Tensor]:
        out = {}
        if cfg.family == "encdec":
            out["frames"] = _meta((B, cfg.encoder_len, cfg.d_model), dt)
        if cfg.family == "vlm":
            out["patches"] = _meta((B, cfg.num_patches, cfg.d_model), dt)
        return out

    if shape.kind == "train":
        opt_cfg = OptimizerConfig(name=cfg.optimizer)
        fn = make_train_step(model, opt_cfg, ctx=ctx)
        state: Dict[str, Any] = {
            "params": params,
            "opt": tree_abstract(opt_state_specs(opt_cfg, model.specs())),
            "step": _meta((), torch.int32),
        }
        dk = model.dyskew_init(ctx, META)
        if dk is not None:
            state["dyskew"] = dk
        batch = dict(tokens=_meta((B, S), torch.int32), targets=_meta((B, S), torch.int32),
                     **extra_inputs())
        args: Tuple = (state, batch)
        tokens = B * S
    elif shape.kind == "prefill":
        fn = make_prefill_step(model, ctx=ctx)
        state = model.decode_state_init(B, S, device=META)
        args = (params, state, dict(tokens=_meta((B, S), torch.int32), **extra_inputs()))
        tokens = B * S
    else:  # decode
        fn = make_decode_step(model, ctx=ctx)
        state = model.decode_state_init(B, S, device=META)
        args = (params, state, _meta((B, 1), torch.int32))
        tokens = B
    meta = dict(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=hw.CHIPS_SINGLE,
        kind=shape.kind,
        model_flops=model_flops_estimate(cfg.active_param_count(), tokens, shape.kind),
        params=model.num_params(), active_params=cfg.active_param_count(),
    )
    return fn, args, meta


#: Flags the port's layers read.
FLAG_MAP = {
    "h1": "causal_skip",
    "h9": "moe_scatter_combine",
}
#: The reference's flags that steer sharding, and why one card has no use
#: for them.
SHARDING_ONLY = {
    "h2": "casts master parameters before an FSDP all-gather",
    "h3": "constrains K/V to the cache's sharding",
    "h4": "combines sequence-sharded decode attention",
    "h5": "constrains activations to a batch-sharded layout",
    "h6": "shards every weight ZeRO-3 style over the mesh",
    "h7": "keeps bf16 collectives in bf16 (an XLA compiler option)",
    "h8": "constrains gradients to the parameter sharding",
    "h10": "replicates the expert embedding axis",
    "h11": "constrains Mamba projection outputs to a batch-sharded layout",
}


def parse_flags(spec_str: str) -> PerfFlags:
    """``"h1,h9"`` → ``PerfFlags``; a sharding-only flag raises."""
    kw = {}
    for tok in spec_str.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        if tok in SHARDING_ONLY:
            raise ValueError(f"flag {tok} {SHARDING_ONLY[tok]}: it steers sharding, and one card has none")
        if tok not in FLAG_MAP:
            raise ValueError(f"unknown flag {tok!r}; known: {sorted(FLAG_MAP)}")
        kw[FLAG_MAP[tok]] = True
    return PerfFlags(**kw)


def _write(rec: Dict, out_dir: Optional[str], tag: str = "") -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def run_cell(arch_id: str, shape_name: str, mesh_name: str = "single",
             out_dir: Optional[str] = None, verbose: bool = True,
             flags: PerfFlags = PerfFlags(), tag: str = "") -> Dict:
    """Count one cell; a failure is recorded as ``FAIL`` with its traceback."""
    cfg = get_config(arch_id)
    ok, why = cell_is_runnable(cfg, SHAPES[shape_name])
    rec: Dict[str, Any] = dict(arch=arch_id, shape=shape_name, mesh=mesh_name)
    if not ok:
        rec["status"] = why
        if verbose:
            print(f"[dryrun] {arch_id} × {shape_name} × {mesh_name}: {why}", flush=True)
        _write(rec, out_dir)
        return rec

    t0 = time.time()
    try:
        with use_flags(flags):
            fn, args, meta = build_cell(arch_id, shape_name, mesh_name)
            cost = trace_cost(fn, *args)
        terms = analyze(cost, meta["chips"], meta["model_flops"])
        rec.update(meta)
        peak = cost["peak_bytes"]
        rec.update(
            status="OK",
            trace_s=round(time.time() - t0, 1),
            cost={k: cost[k] for k in ("flops", "dot_flops", "bytes", "kernels")},
            memory=dict(
                argument_bytes=cost["argument_bytes"],
                peak_bytes=peak,
                per_device_total_gb=round(peak / 1024**3, 3),
                fits_hbm=bool(peak <= hw.HBM_BYTES),
            ),
            roofline=terms.as_dict(),
        )
        if verbose:
            r = rec["roofline"]
            print(
                f"[dryrun] {arch_id} × {shape_name} × {mesh_name}: OK "
                f"trace={rec['trace_s']}s mem/dev={rec['memory']['per_device_total_gb']}GB "
                f"tc={r['t_compute_s']:.4f} tm={r['t_memory_s']:.4f} "
                f"tcoll={r['t_collective_s']:.4f} → {r['bottleneck']}",
                flush=True,
            )
    except Exception as e:  # recorded: a failing cell is a bug to fix
        rec["status"] = f"FAIL: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()
        if verbose:
            print(f"[dryrun] {arch_id} × {shape_name} × {mesh_name}: {rec['status']}", flush=True)
    _write(rec, out_dir, tag)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default="")
    ap.add_argument("--shape", type=str, default="")
    ap.add_argument("--mesh", choices=["single"], default="single",
                    help="one H100; a layout across cards is the multi-GPU slice")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="experiments/dryrun_torch")
    ap.add_argument("--flags", type=str, default="", help="comma list: h1, h9")
    ap.add_argument("--tag", type=str, default="")
    args = ap.parse_args()
    flags = parse_flags(args.flags)

    archs = all_arch_ids() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    failures = 0
    for arch in archs:
        for shape in shapes:
            rec = run_cell(arch, shape, args.mesh, out_dir=args.out, flags=flags, tag=args.tag)
            failures += str(rec.get("status", "")).startswith("FAIL")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
