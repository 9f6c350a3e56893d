"""Rank processes for ``tests/test_torch_fsdp.py``: each function below is
the body of one rank of a (pod P, data D, model M) mesh of gloo ranks on
the CPU, started through ``run_rank`` by
``repro_torch.launch.mesh.run_ranks`` with its arguments pickled.  The
ranks run the reference's whole table, ``param.default_rules`` (FSDP of
``embed`` / ``expert_embed`` over the data axes), or its H6 / H10 forms
(``launch/dryrun.py::make_rules``): every leaf is this rank's slices of the
reference's whole numpy parameters (``param.shard_axes`` /
``slice_shards``).  This module imports torch and the port only (no JAX);
results go back as numpy arrays."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from torch_ranks_worker import flat_numpy


def run_rank(rank: int, world: int, init_method: str, model: int, pod: int, job: Dict) -> Dict:
    """The bodies named by ``job``'s keys (up to a ``/``), in its order, as
    rank ``rank`` of a mesh with a model axis of ``model`` and ``pod``
    pods."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks

    torch.set_num_threads(1)
    mesh = init_ranks(rank, world, device=torch.device("cpu"), init_method=init_method, model=model, pod=pod)
    try:
        return {name: globals()[name.split("/")[0]](mesh, part) for name, part in job.items()}
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- #
# Helpers
# --------------------------------------------------------------------- #


def rules_of(mesh_shape, switch: str = ""):
    """The rule table of ``switch`` ("": ``default_rules``, "h6", "h10")
    on a mesh of ``mesh_shape``."""
    from repro_torch.launch.dryrun import make_rules

    return make_rules(None, "pod" in mesh_shape, fsdp_only=switch == "h6", h10=switch == "h10")


def _ctx(mesh, switch=""):
    from repro_torch.launch.mesh import mesh_ctx

    return mesh_ctx(mesh, rules_of(mesh.shape, switch))


def _sliced(mesh, tree, specs, rules):
    """The whole numpy ``tree`` (keyed as the spec tree ``specs``) cut to
    this rank's slices under ``rules``."""
    from repro_torch.models.param import shard_axes, slice_shards

    return slice_shards(tree, shard_axes(specs, mesh.shape, rules), mesh.shape, mesh.coords)


def _rows(tree: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """This rank's rows of a global batch: by its index in the data
    group."""
    from repro_torch.launch.mesh import dp_size

    n = dp_size(mesh)
    b = next(iter(tree.values())).shape[0] // n
    return {k: v[mesh.data_rank * b:(mesh.data_rank + 1) * b] for k, v in tree.items()}


def _whole(mesh, flat, specs, ctx, summed):
    """Each leaf of ``flat`` ({key path: tensor}, keyed as ``specs``)
    gathered whole over the groups that slice it; a leaf not in
    ``summed`` first summed over the data group (a rank's share)."""
    from repro_torch import distributed
    from repro_torch.models.param import dp_part, shard_axes

    axes = shard_axes(specs, ctx.mesh, ctx.rules)
    out = {}
    for key, g in flat.items():
        g = g.detach().clone()
        if key not in summed:
            distributed.all_sum_(g, mesh.group)
        for dim, ax in axes.get(key, ()):
            # A fused (data, model) dimension: over the model group first.
            groups = ([mesh.ep_group] if "model" in ax else []) + ([mesh.group] if dp_part(ax) else [])
            for group in groups:
                g = distributed.gather_shards(g.movedim(dim, 0), group).movedim(0, dim)
        out[key] = g.numpy()
    return out


def _scattered(specs, ctx):
    """The key paths of the leaves sliced over the data axes."""
    from repro_torch.models.param import dp_part, shard_axes

    return {k for k, sl in shard_axes(specs, ctx.mesh, ctx.rules).items() if any(dp_part(a) for _, a in sl)}


def _loss_and_grads(mesh, model, params, batch, ctx, dyskew=None):
    """``Model.loss`` on this rank's rows and the gradient of every leaf,
    as the train step sees it (a data-sliced leaf reduce-scattered)."""
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
    return float(loss.detach()), aux, {k: g for (k, _), g in zip(flat, grads)}


# --------------------------------------------------------------------- #
# Bodies
# --------------------------------------------------------------------- #


def families(mesh, job):
    """For each config of ``job`` under ``job["switch"]``'s table:
    ``Model.loss`` on this rank's rows and every gradient leaf gathered
    whole; unless ``job["decode"]`` is None a prefill of the prompt and
    that many decode steps fed the next true tokens (each step's logits);
    the leaves' shapes on this rank; with ``job["control"]`` the data-sliced
    leaves' gradients summed over the data group once more, as a step that
    all-reduced every leaf would."""
    from repro_torch import distributed
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model_api import build

    out = {}
    for name, part in job["configs"].items():
        model = build(part["cfg"])
        ctx = _ctx(mesh, job.get("switch", ""))
        specs = model.specs()
        params = params_from_numpy(_sliced(mesh, part["params"], specs, ctx.rules), device="cpu")
        batch = {k: torch.from_numpy(v) for k, v in _rows(part["inputs"], mesh).items()}
        loss, aux, grads = _loss_and_grads(mesh, model, params, batch, ctx, part.get("dyskew"))
        scattered = _scattered(specs, ctx)
        res = {"loss": loss, "metrics": {k: float(v) for k, v in aux["metrics"].items()},
               "grads": _whole(mesh, grads, specs, ctx, scattered),
               "held": {k: tuple(v.shape) for k, v in flatten_with_paths(params)}, "scattered": sorted(scattered)}
        if job.get("control"):
            res["control_grads"] = {k: distributed.all_sum_(grads[k].detach().clone(), mesh.group).numpy()
                                    for k in sorted(scattered)}
        if job.get("decode") is not None:
            prompt = part["prompt"]
            served = {k: v for k, v in batch.items() if k != "targets"}
            served["tokens"] = batch["tokens"][:, :prompt]
            B = served["tokens"].shape[0]
            with torch.no_grad():
                state = model.decode_state_init(B, batch["tokens"].shape[1], device="cpu", ctx=ctx)
                logits, state = model.prefill(params, served, state, ctx=ctx)
                steps = [logits[:, -1:].numpy()]
                for t in range(prompt, prompt + job["decode"]):
                    logits, state = model.decode_step(params, state, batch["tokens"][:, t:t + 1], ctx=ctx)
                    steps.append(logits.numpy())
            res["serve"] = steps
        out[name] = res
    return out


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


def train_steps(mesh, job):
    """``len(job["batches"])`` steps from ``job["state"]`` on this rank's
    rows of each global batch, under ``job["switch"]``'s table and
    ``job["flags"]`` (H2, H8), with ``job["compression"]`` the int8
    reduction: this rank's flat state after every step and the metrics."""
    from repro_torch.models.perf_flags import PerfFlags, use_flags
    from repro_torch.train.step import StepConfig, make_train_step

    ctx = _ctx(mesh, job.get("switch", ""))
    model, opt, state = _train_setup(mesh, job, ctx)
    step = make_train_step(model, opt, StepConfig(grad_compression=job.get("compression", False)), ctx=ctx)
    states, metrics = [], []
    with use_flags(PerfFlags(**job.get("flags", {}))):
        for batch in job["batches"]:
            state, m = step(state, _rows(batch, mesh))
            states.append(flat_numpy(state))
            metrics.append({k: float(v) for k, v in m.items()})
    return {"states": states, "metrics": metrics}


def save_checkpoint(mesh, job):
    """One train step, then a checkpoint of the state (each sliced leaf
    gathered whole over the groups that slice it) and a restore on this
    mesh."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train.step import make_train_step, train_state_axes

    ctx = _ctx(mesh)
    model, opt, state = _train_setup(mesh, job, ctx)
    state, _ = make_train_step(model, opt, ctx=ctx)(state, _rows(job["batch"], mesh))
    axes = train_state_axes(model, opt, ctx.mesh, ctx.rules)
    mgr = CheckpointManager(job["dir"], group=mesh.group, ep_group=mesh.ep_group, shards=axes)
    mgr.save(1, state, blocking=True)
    torch.distributed.barrier()
    return {"saved": flat_numpy(state), "restored": flat_numpy(mgr.restore(state))}


def _restore(mesh, job):
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.model_api import build
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.step import train_state_axes, train_state_init

    model = build(job["cfg"])
    opt = OptimizerConfig(name="adamw", warmup_steps=2, total_steps=20)
    ctx = _ctx(mesh)
    axes = train_state_axes(model, opt, ctx.mesh, ctx.rules)
    like = train_state_init(model, opt, torch.Generator().manual_seed(5), ctx, "cpu")
    mgr = CheckpointManager(job["dir"], group=mesh.group, ep_group=mesh.ep_group, shards=axes)
    return {"restored": flat_numpy(mgr.restore(like)), "coords": mesh.coords, "shape": mesh.shape}


def restore_checkpoint(mesh, job):
    """``job["dir"]``'s checkpoint restored into a fresh state on this
    mesh, and with ``job["as_model"]`` also on a second mesh of the same
    ranks with that model axis (a new process group over
    ``job["store"]``): the restored flat states."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks

    out = {"here": _restore(mesh, job)}
    if job.get("as_model"):
        rank, world = mesh.rank, dist.get_world_size()
        dist.destroy_process_group()
        other = init_ranks(rank, world, device=torch.device("cpu"), init_method=job["store"], model=job["as_model"])
        out["there"] = _restore(other, job)
        dist.barrier()
    return out


def counted(mesh, job):
    """One train step (with and without H2) and one prefill under the op
    counter: their collective records."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.perf_flags import PerfFlags, use_flags
    from repro_torch.roofline.op_cost import OpCounter
    from repro_torch.train.step import make_train_step

    ctx = _ctx(mesh)
    model, opt, state = _train_setup(mesh, job, ctx)
    out = {}
    for h2 in (False, True):
        with use_flags(PerfFlags(cast_before_gather=h2)), OpCounter() as counter:
            make_train_step(model, opt, ctx=ctx)(state, _rows(job["batch"], mesh))
        out["train_h2" if h2 else "train"] = counter.result()["collectives"]
    params = params_from_numpy(_sliced(mesh, job["params"], model.specs(), ctx.rules), device="cpu")
    tokens = torch.from_numpy(_rows(job["batch"], mesh)["tokens"])
    decode_state = model.decode_state_init(*tokens.shape, device="cpu", ctx=ctx)
    with OpCounter() as counter, torch.no_grad():
        model.prefill(params, {"tokens": tokens}, decode_state, ctx=ctx)
    out["prefill"] = counter.result()["collectives"]
    return out
