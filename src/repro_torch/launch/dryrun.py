"""Dry-run of every (arch × shape × mesh) cell: what one step's work is on
a card and where its bound lies, counted without allocating anything.

For each cell this builds the model's parameters, optimizer or decode
state and inputs as ``meta`` tensors (where ``repro.launch.dryrun`` lowers
``ShapeDtypeStruct``s), runs the step function once under
``roofline.op_cost``'s counter, and records the FLOPs, bytes, kernel
records, collective records and peak live bytes with the roofline terms
over the H100's peaks.

``--mesh single`` and ``multi`` take ``repro``'s meaning: one rank of the
pod (data 16, model 16) or of two, (pod 2, data 16, model 16), traced in
this process as rank 0 of a fake process group of 256 or 512
(``launch/mesh.py::init_ranks(backend="fake")``), whose collectives on
``meta`` tensors move nothing and are counted.  The rank holds its slices
under ``make_rules`` (``repro``'s ``default_rules`` with the batch over the
data axes, and H6 / H10) and its rows of the batch, with ``spmd_ctx``'s
token groups and expert-parallel shards; its counted work is one device's, priced
over ``chips`` as ``repro`` prices its per-device module.  ``--mesh card``
traces the reference's global shapes on one H100: many ``train_4k`` cells
do not fit in its 80 GB, and the record says so (``fits_hbm``).  It sets
no environment variable and runs on no device.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-20b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --out /tmp/dryrun
  PYTHONPATH=src python -m repro_torch.roofline.report /tmp/dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.config.base import (
    SHAPES,
    ArchConfig,
    ShapeConfig,
    all_arch_ids,
    cell_is_runnable,
    get_config,
)
from repro_torch.launch.mesh import Mesh, dp_size, init_ranks, make_production_mesh, model_size
from repro_torch.models.layers.moe import SpmdCtx
from repro_torch.models.model_api import build
from repro_torch.models.param import default_rules, leaf_slices, sliced_shape, tree_leaves, tree_map
from repro_torch.models.perf_flags import PerfFlags, use_flags
from repro_torch.models.transformer import model_dtype
from repro_torch.optim.optimizers import OptimizerConfig, zip_map
from repro_torch.optim.specs import opt_state_slices, opt_state_specs
from repro_torch.roofline import hw
from repro_torch.roofline.analysis import analyze, model_flops_estimate
from repro_torch.roofline.op_cost import trace_cost
from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step

META = torch.device("meta")
MESHES = ("card", "single", "multi")
CHIPS = {"card": hw.CHIPS_SINGLE, "single": hw.CHIPS_SINGLE_POD, "multi": hw.CHIPS_MULTI_POD}


def param_dtype(cfg: ArchConfig, kind: str = "train") -> torch.dtype:
    """AdamW archs train float32 master parameters, Adafactor archs bf16;
    serving holds the model dtype."""
    if kind != "train":
        return model_dtype(cfg)
    return torch.float32 if cfg.optimizer == "adamw" else torch.bfloat16


def make_rules(cfg: ArchConfig, multi_pod: bool, fsdp_only: bool = False, h10: bool = False) -> Dict:
    """``repro``'s ``make_rules``: ``default_rules`` with the batch over the
    data axes; H10 replicates ``expert_embed``; H6 (``fsdp_only``) puts
    ``embed`` over (data, model) (with ``pod`` for two pods) and leaves
    heads, kv heads, mlp and Mamba heads whole, vocab and experts on
    ``model``.  The port's KV cache holds a rank's kv heads, so there is no
    ``kv_seq`` rule."""
    rules = default_rules(multi_pod)
    rules["batch"] = ("pod", "data") if multi_pod else ("data",)
    if h10:
        rules["expert_embed"] = None
    if fsdp_only:
        rules["embed"] = ("pod", "data", "model") if multi_pod else ("data", "model")
        for ax in ("heads", "kv_heads", "mlp", "ssm_heads"):
            rules[ax] = None
    return rules


def spmd_ctx(cfg: ArchConfig, mesh: Mesh, tokens_per_call: int = 1, batch: int = 1,
             rules: Optional[Dict] = None) -> SpmdCtx:
    """``repro``'s ``spmd_ctx`` on ``mesh``'s groups: a token group a data
    rank (one where the tokens of a call do not split), the model axis's
    expert-parallel shards (one where it does not divide the experts), and the
    batch over the data group, replicated where it does not divide the
    batch (``long_500k``: the group then only gathers FSDP's leaves)."""
    groups = dp_size(mesh)
    if tokens_per_call % groups != 0:
        groups = 1
    n_ep = model_size(mesh)
    if cfg.moe is not None and cfg.moe.num_experts % n_ep != 0:
        n_ep = 1
    split = batch % dp_size(mesh) == 0
    return SpmdCtx(num_groups=groups if split else 1, num_ep_shards=n_ep,
                   group=mesh.group if split else None, fsdp_group=None if split else mesh.group,
                   ep_group=mesh.ep_group,
                   rules=rules, pods=mesh.shape.get("pod", 1), world_group=mesh.world)


@contextlib.contextmanager
def pod_rank(mesh_name: str) -> Iterator[Mesh]:
    """Rank 0 of ``repro``'s ``mesh_name`` mesh on a fake process group
    (``card``: one process, no group), destroyed on exit."""
    if mesh_name == "card":
        yield Mesh()
        return
    shape = make_production_mesh(multi_pod=mesh_name == "multi").shape
    world = shape.get("pod", 1) * shape["data"] * shape["model"]
    mesh = init_ranks(0, world, device=META, init_method=None, backend="fake", model=shape["model"],
                      pod=shape.get("pod", 1))
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def opt_abstract(opt_cfg: OptimizerConfig, model, ctx: SpmdCtx) -> Any:
    """A rank's optimizer state as ``meta`` tensors: each leaf sliced as its
    parameter is (``opt_state_slices``)."""
    specs = model.specs()
    slices = opt_state_slices(opt_cfg, specs, tree_map(lambda p: leaf_slices(p, ctx.mesh, ctx.rules), specs))
    return zip_map(lambda p, sl: torch.empty(sliced_shape(p.shape, sl, ctx.mesh), dtype=p.dtype, device=META),
                   opt_state_specs(opt_cfg, specs), slices)


def _meta(shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def build_cell(arch_id: str, shape_name: str, mesh: Mesh = Mesh(), mesh_name: str = "card",
               fsdp_only: bool = False, h10: bool = False) -> Tuple[Callable, Tuple, Dict]:
    """Returns (step function, its ``meta`` arguments, the record's facts)
    for a rank of ``mesh`` (``pod_rank``'s)."""
    fn, args, meta = build_step(get_config(arch_id), SHAPES[shape_name], mesh, mesh_name, fsdp_only, h10)
    return fn, args, dict(meta, arch=arch_id)


def build_step(cfg: ArchConfig, shape: ShapeConfig, mesh: Mesh = Mesh(), mesh_name: str = "card",
               fsdp_only: bool = False, h10: bool = False) -> Tuple[Callable, Tuple, Dict]:
    """``build_cell`` for any config and shape (the tests' reduced ones)."""
    model = build(cfg)
    B, S = shape.global_batch, shape.seq_len
    tokens = B * S if shape.kind in ("train", "prefill") else B
    rules = make_rules(cfg, "pod" in mesh.shape, fsdp_only, h10)
    ctx = spmd_ctx(cfg, mesh, tokens, B, rules)
    rows = B // dp_size(mesh) if ctx.group is not None else B
    params = model.abstract_params(param_dtype(cfg, shape.kind), ctx)
    dt = model_dtype(cfg)

    def extra_inputs() -> Dict[str, torch.Tensor]:
        out = {}
        if cfg.family == "encdec":
            out["frames"] = _meta((rows, cfg.encoder_len, cfg.d_model), dt)
        if cfg.family == "vlm":
            out["patches"] = _meta((rows, cfg.num_patches, cfg.d_model), dt)
        return out

    if shape.kind == "train":
        opt_cfg = OptimizerConfig(name=cfg.optimizer)
        fn = make_train_step(model, opt_cfg, ctx=ctx)
        state: Dict[str, Any] = {
            "params": params,
            "opt": opt_abstract(opt_cfg, model, ctx),
            "step": _meta((), torch.int32),
        }
        dk = model.dyskew_init(ctx, META)
        if dk is not None:
            state["dyskew"] = dk
        batch = dict(tokens=_meta((rows, S), torch.int32), targets=_meta((rows, S), torch.int32),
                     **extra_inputs())
        args: Tuple = (state, batch)
    elif shape.kind == "prefill":
        fn = make_prefill_step(model, ctx=ctx)
        state = model.decode_state_init(rows, S, device=META, ctx=ctx)
        args = (params, state, dict(tokens=_meta((rows, S), torch.int32), **extra_inputs()))
    else:  # decode
        fn = make_decode_step(model, ctx=ctx)
        state = model.decode_state_init(rows, S, device=META, ctx=ctx)
        args = (params, state, _meta((rows, 1), torch.int32))
    meta = dict(
        arch=cfg.name, shape=shape.name, mesh=mesh_name, chips=CHIPS[mesh_name],
        kind=shape.kind,
        model_flops=model_flops_estimate(cfg.active_param_count(), tokens, shape.kind),
        params=model.num_params(), active_params=cfg.active_param_count(),
        mesh_shape=dict(mesh.shape), rows_a_rank=rows, num_groups=ctx.num_groups,
        params_a_rank=sum(t.numel() for t in tree_leaves(params)),
        param_bytes_a_rank=sum(t.numel() * t.element_size() for t in tree_leaves(params)),
        num_ep_shards=ctx.num_ep_shards, fsdp_only=fsdp_only, h10=h10,
    )
    return fn, args, meta


#: Flags the port's layers and train step read.
FLAG_MAP = {
    "h1": "causal_skip",
    "h2": "cast_before_gather",
    "h8": "constrain_grads",
    "h9": "moe_scatter_combine",
}
#: The reference's rule-table switches: H6 (``fsdp_only``) and H10.
RULE_FLAGS = ("h6", "h10")
#: The reference's flags with no counterpart in the port, and why.
SHARDING_ONLY = {
    "h3": "constrains K/V to the cache's sharding (a GSPMD layout hint; the port's cache holds a rank's kv heads)",
    "h4": "combines sequence-sharded decode attention (the port shards no sequence)",
    "h5": "constrains activations to a batch-sharded layout (a GSPMD layout hint; the port's batch is a rank's rows)",
    "h7": "keeps bf16 collectives in bf16 (an XLA compiler option; the port's collectives move their tensors' dtype)",
    "h11": "constrains Mamba projection outputs to a batch-sharded layout (a GSPMD layout hint)",
}


def parse_flags(spec_str: str) -> Tuple[PerfFlags, Dict[str, bool]]:
    """``"h1,h2,h6"`` → (``PerfFlags``, the rule switches ``{"fsdp_only",
    "h10"}``); a flag with no counterpart raises."""
    kw, rule = {}, {"fsdp_only": False, "h10": False}
    for tok in spec_str.split(","):
        tok = tok.strip().lower()
        if not tok:
            continue
        if tok in SHARDING_ONLY:
            raise ValueError(f"flag {tok} {SHARDING_ONLY[tok]}: it steers sharding, and the port has no counterpart")
        if tok in RULE_FLAGS:
            rule["fsdp_only" if tok == "h6" else "h10"] = True
            continue
        if tok not in FLAG_MAP:
            raise ValueError(f"unknown flag {tok!r}; known: {sorted(FLAG_MAP) + list(RULE_FLAGS)}")
        kw[FLAG_MAP[tok]] = True
    return PerfFlags(**kw), rule


def _write(rec: Dict, out_dir: Optional[str], tag: str = "") -> None:
    if not out_dir:
        return
    os.makedirs(out_dir, exist_ok=True)
    suffix = f"__{tag}" if tag else ""
    path = os.path.join(out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)


def collective_summary(records) -> Dict[str, Dict[str, int]]:
    """The op counter's collective records by kind and group size: their
    count and bytes."""
    out: Dict[str, Dict[str, int]] = {}
    for c in records:
        row = out.setdefault(f"{c['kind']} x{c['group']}", {"count": 0, "bytes": 0})
        row["count"] += 1
        row["bytes"] += c["bytes"]
    return dict(sorted(out.items()))


def run_cell(arch_id: str, shape_name: str, mesh_name: str = "single",
             out_dir: Optional[str] = None, verbose: bool = True,
             flags: PerfFlags = PerfFlags(), tag: str = "", fsdp_only: bool = False, h10: bool = False) -> Dict:
    """Count one cell on one rank of ``mesh_name`` (``MESHES``); a failure
    is recorded as ``FAIL`` with its traceback."""
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
        with use_flags(flags), pod_rank(mesh_name) as mesh:
            fn, args, meta = build_cell(arch_id, shape_name, mesh, mesh_name, fsdp_only, h10)
            cost = trace_cost(fn, *args)
        terms = analyze(cost, meta["chips"], meta["model_flops"], per_device=mesh_name != "card")
        rec.update(meta)
        peak = cost["peak_bytes"]
        rec.update(
            status="OK",
            trace_s=round(time.time() - t0, 1),
            cost={k: cost[k] for k in ("flops", "dot_flops", "bytes", "kernels")},
            collectives=collective_summary(cost["collectives"]),
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
    ap.add_argument("--mesh", choices=["card", "single", "multi", "both"], default="single",
                    help="single: a rank of (data 16, model 16); multi: of (pod 2, data 16, model 16); "
                         "both; card: the global shapes on one H100")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", type=str, default="experiments/dryrun_torch")
    ap.add_argument("--flags", type=str, default="", help="comma list: h1, h2, h6, h8, h9, h10")
    ap.add_argument("--tag", type=str, default="")
    args = ap.parse_args()
    flags, rule = parse_flags(args.flags)

    archs = all_arch_ids() if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ("single", "multi") if args.mesh == "both" else (args.mesh,)
    failures = 0
    for mesh_name in meshes:
        for arch in archs:
            for shape in shapes:
                rec = run_cell(arch, shape, mesh_name, out_dir=args.out, flags=flags, tag=args.tag, **rule)
                failures += str(rec.get("status", "")).startswith("FAIL")
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
