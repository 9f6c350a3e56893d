"""Rank processes for ``tests/test_torch_tensor_parallel.py``: each function
below is the body of one rank of a (data D, model M) mesh of gloo ranks on
the CPU, started through ``run_rank`` by
``repro_torch.launch.mesh.run_ranks`` with its arguments pickled.  The ranks
run the reference's layout less FSDP, ``param.model_rules()``: every leaf
that the rule table puts on the model axis is this rank's slice of the
reference's whole numpy parameters (``param.shard_axes`` /
``slice_shards``).  This
module imports torch and the port only (no JAX); results go back as numpy
arrays."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from torch_ep_worker import _rows
from torch_ranks_worker import flat_numpy


def run_rank(rank: int, world: int, init_method: str, model: int, job: Dict) -> Dict:
    """The bodies named by ``job``'s keys (up to a ``/``), in its order, as
    rank ``rank`` of a mesh with a model axis of ``model``."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks

    torch.set_num_threads(1)
    mesh = init_ranks(rank, world, device=torch.device("cpu"), init_method=init_method, model=model)
    try:
        return {name: globals()[name.split("/")[0]](mesh, part) for name, part in job.items()}
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- #
# Helpers
# --------------------------------------------------------------------- #


def _ctx(mesh, groups):
    from repro_torch.models.layers.moe import SpmdCtx

    return SpmdCtx(num_groups=groups, num_ep_shards=mesh.shape["model"], group=mesh.group, ep_group=mesh.ep_group)


def _sliced(mesh, tree, specs):
    """The whole numpy ``tree`` (keyed as the spec tree ``specs``) cut to
    this rank's slices under the model-only rules."""
    from repro_torch.models.param import model_rules, shard_axes, slice_shards

    return slice_shards(tree, shard_axes(specs, mesh.shape, model_rules()), mesh.shape, mesh.coords)


def _params(mesh, model, whole):
    from repro_torch.models.convert import params_from_numpy

    return params_from_numpy(_sliced(mesh, whole, model.specs()), device="cpu")


def _train_setup(mesh, job, ctx):
    from repro_torch.models.convert import state_from_numpy
    from repro_torch.models.model_api import build
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.models.param import slice_shards
    from repro_torch.train.step import train_state_axes

    model = build(job["cfg"])
    opt = OptimizerConfig(name=job.get("opt", "adamw"), warmup_steps=2, total_steps=20,
                          factored_dim_threshold=job.get("factored", 128))
    state = state_from_numpy(dict(job["state"], **slice_shards(
        {k: job["state"][k] for k in ("params", "opt")}, train_state_axes(model, opt, ctx.mesh, ctx.rules),
        ctx.mesh, ctx.coords)), device="cpu")
    return model, opt, state


def _loss_and_grads(mesh, model, params, batch, ctx, dyskew=None):
    """``Model.loss`` on this rank's rows and the gradient of every leaf,
    summed over the data group (each rank's is its share)."""
    from repro_torch import distributed
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models.convert import state_from_numpy
    from repro_torch.models.param import tree_map

    flat = flatten_with_paths(params)
    live = [v.detach().requires_grad_(True) for _, v in flat]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    dk = None if dyskew is None else state_from_numpy(dyskew, device="cpu")
    loss, aux = model.loss(tree, batch, dyskew=dk, ctx=ctx)
    grads = torch.autograd.grad(loss, live)
    summed = {k: distributed.all_sum_(g.clone(), mesh.group).numpy() for (k, _), g in zip(flat, grads)}
    return float(loss.detach()), aux, summed


# --------------------------------------------------------------------- #
# Bodies
# --------------------------------------------------------------------- #


def families(mesh, job):
    """For each config of ``job``: ``Model.loss`` and every gradient leaf on
    this rank's rows; a prefill of the prompt and ``job["decode"]`` decode
    steps fed the next true tokens (the logits of each step and the decode
    state's shapes); for the configs of ``job["control"]`` the gradients
    again with ``to_shard`` dropped on the whole leaves a rank uses for its
    share only (the tensors of ``job["control_shapes"]``)."""
    from repro_torch import distributed
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models.model_api import build

    out = {}
    for name, part in job["configs"].items():
        model = build(part["cfg"])
        ctx = _ctx(mesh, job["groups"])
        params = _params(mesh, model, part["params"])
        rows = _rows(part["inputs"], mesh)
        batch = {k: torch.from_numpy(v) for k, v in rows.items()}
        loss, aux, grads = _loss_and_grads(mesh, model, params, batch, ctx, part.get("dyskew"))
        res = {"loss": loss, "grads": grads, "metrics": {k: float(v) for k, v in aux["metrics"].items()},
               "held": {k: tuple(v.shape) for k, v in flatten_with_paths(params)}}
        prompt = part["prompt"]
        served = {k: v for k, v in batch.items() if k != "targets"}
        served["tokens"] = batch["tokens"][:, :prompt]
        B = served["tokens"].shape[0]
        with torch.no_grad():
            state = model.decode_state_init(B, batch["tokens"].shape[1], device="cpu", ctx=ctx)
            res["state_shapes"] = {k: tuple(v.shape) for k, v in flatten_with_paths(state)}
            logits, state = model.prefill(params, served, state, ctx=ctx)
            steps = [logits.numpy()]
            for t in range(prompt, prompt + job["decode"]):
                logits, state = model.decode_step(params, state, batch["tokens"][:, t:t + 1], ctx=ctx)
                steps.append(logits.numpy())
        res["serve"] = steps
        if name in job["control"]:
            real, shapes = distributed.to_shard, {tuple(s) for s in job["control_shapes"]}
            distributed.to_shard = lambda t, group: t if tuple(t.shape) in shapes else real(t, group)
            try:
                res["control_grads"] = _loss_and_grads(mesh, model, params, batch, ctx, part.get("dyskew"))[2]
            finally:
                distributed.to_shard = real
        out[name] = res
    return out


def train_steps(mesh, job):
    """``len(job["batches"])`` steps from ``job["state"]`` on this rank's
    rows of each global batch: the flat state after every step and the
    metrics."""
    from repro_torch.train.step import make_train_step

    ctx = _ctx(mesh, job["groups"])
    model, opt, state = _train_setup(mesh, job, ctx)
    step = make_train_step(model, opt, ctx=ctx)
    states, metrics = [], []
    for batch in job["batches"]:
        state, m = step(state, _rows(batch, mesh))
        states.append(flat_numpy(state))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"states": states, "metrics": metrics}


def save_checkpoint(mesh, job):
    """One train step, then a checkpoint of the state (each sliced leaf
    gathered whole over the model group) and a restore on this mesh."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train.step import make_train_step, train_state_axes

    ctx = _ctx(mesh, job["groups"])
    model, opt, state = _train_setup(mesh, job, ctx)
    state, _ = make_train_step(model, opt, ctx=ctx)(state, _rows(job["batch"], mesh))
    axes = train_state_axes(model, opt, ctx.mesh, ctx.rules)
    mgr = CheckpointManager(job["dir"], group=mesh.group, ep_group=mesh.ep_group, shards=axes)
    mgr.save(1, state, blocking=True)
    torch.distributed.barrier()
    return {"saved": flat_numpy(state), "restored": flat_numpy(mgr.restore(state))}


def restore_checkpoint(mesh, job):
    """``job["dir"]``'s checkpoint restored into a fresh state on this
    mesh: the restored flat state."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.model_api import build
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.step import train_state_axes, train_state_init

    model = build(job["cfg"])
    opt = OptimizerConfig(name="adamw", warmup_steps=2, total_steps=20)
    ctx = _ctx(mesh, job["groups"])
    axes = train_state_axes(model, opt, ctx.mesh, ctx.rules)
    like = train_state_init(model, opt, torch.Generator().manual_seed(5), ctx, "cpu")
    mgr = CheckpointManager(job["dir"], group=mesh.group, ep_group=mesh.ep_group, shards=axes)
    return {"restored": flat_numpy(mgr.restore(like))}


def counted(mesh, job):
    """For each config of ``job``: one train step and one prefill under the
    op counter, both combines for a MoE config: their collective
    records."""
    from repro_torch.models.model_api import build
    from repro_torch.models.perf_flags import PerfFlags, use_flags
    from repro_torch.roofline.op_cost import OpCounter
    from repro_torch.train.step import make_train_step

    out = {}
    for name, part in job["configs"].items():
        ctx = _ctx(mesh, 1)
        model, opt, state = _train_setup(mesh, part, ctx)
        res = {}
        for scatter in part["scatter"]:
            with use_flags(PerfFlags(moe_scatter_combine=scatter)):
                with OpCounter() as train_counter:
                    make_train_step(model, opt, ctx=ctx)(state, part["batch"])
                params = _params(mesh, model, part["params"])
                tokens = torch.from_numpy(part["batch"]["tokens"])
                decode_state = model.decode_state_init(*tokens.shape, device="cpu", ctx=ctx)
                with OpCounter() as prefill_counter, torch.no_grad():
                    model.prefill(params, {"tokens": tokens}, decode_state, ctx=ctx)
            res[scatter] = {"train": train_counter.result()["collectives"],
                            "prefill": prefill_counter.result()["collectives"]}
        out[name] = res
    return out


def raises(mesh, job):
    """The messages of what must raise under the model-only rules on this
    mesh: a kv layout whose query heads straddle kv groups, a Mamba layout
    whose heads straddle B/C groups, and a rule table naming a mesh axis
    (``pod``) that the mesh lacks."""
    import dataclasses

    from repro_torch.models.layers import mamba2
    from repro_torch.models.layers.attention import kv_heads_of
    from repro_torch.models.model_api import build
    from repro_torch.models.param import model_rules

    out = {}
    cfg = job["cfg"]
    try:
        kv_heads_of(dataclasses.replace(cfg, num_heads=24, num_kv_heads=3), 12, 3, mesh.model_rank)
    except NotImplementedError as e:
        out["kv"] = str(e)
    try:
        mamba2.mamba_heads_of(job["mamba_cfg"], 3, mesh.model_rank)
    except NotImplementedError as e:
        out["mamba"] = str(e)
    try:
        build(cfg).init(torch.Generator().manual_seed(0), device="cpu",
                        ctx=dataclasses.replace(_ctx(mesh, 1), rules=dict(model_rules(), embed=("pod", "data"))))
    except ValueError as e:
        out["fsdp"] = str(e)
    return out
