"""Rank processes for ``tests/test_torch_expert_parallel.py``: each function
below is the body of one rank of a (data D, model M) mesh of gloo ranks on
the CPU, started through ``run_rank`` by
``repro_torch.launch.mesh.run_ranks`` with its arguments pickled.  This
module imports torch and the port only (no JAX), so a rank starts
quickly; results go back through a queue as numpy arrays.  Every rank gets
the reference's whole parameters and state as numpy arrays and keeps its
slice of the expert leaves (``param.slice_shards``): the ranks run the
experts-only layout (``param.expert_rules``); the whole rule table
is ``tests/torch_tp_worker.py``'s."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

from torch_ranks_worker import flat_numpy


def run_rank(rank: int, world: int, init_method: str, model: int, job: Dict) -> Dict:
    """The bodies named by ``job``'s keys (up to a ``/``, which tells two
    runs of one body apart), in its order, each on its own part of
    ``job``, as rank ``rank`` of a mesh with a model axis of ``model`` (the
    target of ``launch/mesh.py::run_ranks``)."""
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
    from repro_torch.models.param import expert_rules

    return SpmdCtx(num_groups=groups, num_ep_shards=mesh.shape["model"], group=mesh.group, ep_group=mesh.ep_group,
                   rules=expert_rules())


def _sliced(mesh, tree, specs):
    """The whole numpy ``tree`` (keyed as the spec tree ``specs``) cut to
    this rank's experts."""
    from repro_torch.models.param import expert_axes, slice_shards

    return slice_shards(tree, expert_axes(specs), mesh.model_rank, mesh.shape["model"])


def _rows(tree: Dict[str, np.ndarray], mesh) -> Dict[str, np.ndarray]:
    """This rank's rows of a global batch: by its DATA index."""
    d, n = mesh.data_rank, mesh.shape["data"]
    b = next(iter(tree.values())).shape[0] // n
    return {k: v[d * b:(d + 1) * b] for k, v in tree.items()}


def _train_setup(mesh, job, ctx):
    from repro_torch.models.convert import state_from_numpy
    from repro_torch.models.model_api import build
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.step import train_state_specs

    model = build(job["cfg"])
    opt = OptimizerConfig(name=job.get("opt", "adamw"), warmup_steps=2, total_steps=20)
    specs = train_state_specs(model, opt)
    state = state_from_numpy(dict(job["state"], **_sliced(mesh, {k: job["state"][k] for k in specs}, specs)),
                             device="cpu")
    return model, opt, state


class _Recording:
    """The default dispatch steps, each call's argument shapes recorded."""

    def __init__(self):
        from repro_torch.models.layers import moe

        self.calls: List[Any] = []

        def rec(name, fn):
            def call(*args):
                self.calls.append((name, [tuple(a.shape) if torch.is_tensor(a) else a for a in args]))
                return fn(*args)
            return call

        k = moe.KERNEL_OPS
        self.ops = moe.DispatchOps(rec("gating", k.gating), rec("histogram", k.histogram),
                                   rec("dispatch", k.dispatch), k.scan)


# --------------------------------------------------------------------- #
# Bodies
# --------------------------------------------------------------------- #


def moe_cases(mesh, job):
    """``moe_apply`` over ``job["steps"]`` carried steps for each case of
    ``job["cases"]`` ((groups, adaptive, scatter)), on this rank's rows of
    each global input: y, the link state and the metrics after every
    step, and the dispatch steps' calls of the first."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.layers import moe
    from repro_torch.models.perf_flags import PerfFlags, use_flags

    out = []
    for groups, adaptive, scatter in job["cases"]:
        cfg = job["cfgs"][adaptive]
        ctx = _ctx(mesh, groups)
        p = params_from_numpy(_sliced(mesh, job["params"], moe.moe_specs(cfg)), device="cpu")
        state = moe.moe_state_init(cfg, ctx, device="cpu")
        rec = _Recording()
        steps = []
        for i, x in enumerate(job["xs"]):
            ops = rec.ops if i == 0 else moe.KERNEL_OPS
            with use_flags(PerfFlags(moe_scatter_combine=scatter)):
                y, state, m = moe.moe_apply(p, torch.from_numpy(_rows({"x": x}, mesh)["x"]), cfg=cfg,
                                            state=state, ctx=ctx, ops=ops)
            steps.append({"y": y.numpy(), "state": flat_numpy(state), "metrics": {k: float(v) for k, v in m.items()}})
        out.append({"steps": steps, "calls": rec.calls, "w_gate": tuple(p["w_gate"].shape)})
    return out


def loss_grads(mesh, job):
    """``Model.loss`` and the gradient of every leaf on this rank's rows,
    the gradients summed over the data group (each rank's is its share);
    then the same with ``to_shard`` replaced by the identity (the control:
    the replicated leaves upstream of the gather lose the other shards'
    part of their gradient)."""
    from repro_torch import distributed
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models.convert import params_from_numpy, state_from_numpy
    from repro_torch.models.model_api import build
    from repro_torch.models.param import tree_map

    model = build(job["cfg"])
    ctx = _ctx(mesh, job["groups"])
    params = params_from_numpy(_sliced(mesh, job["params"], model.specs()), device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _rows(job["batch"], mesh).items()}

    def run():
        flat = flatten_with_paths(params)
        live = [v.detach().requires_grad_(True) for _, v in flat]
        it = iter(live)
        tree = tree_map(lambda _: next(it), params)
        dk = state_from_numpy(job["dyskew"], device="cpu")
        loss, aux = model.loss(tree, batch, dyskew=dk, ctx=ctx)
        grads = torch.autograd.grad(loss, live)
        summed = {k: distributed.all_sum_(g.clone(), mesh.group).numpy() for (k, _), g in zip(flat, grads)}
        return float(loss.detach()), aux, summed

    loss, aux, grads = run()
    out = {"loss": loss, "grads": grads, "dyskew": flat_numpy(aux["dyskew"]),
           "metrics": {k: float(v) for k, v in aux["metrics"].items()}}
    real = distributed.to_shard
    distributed.to_shard = lambda t, group: t
    try:
        out["control_grads"] = run()[2]
    finally:
        distributed.to_shard = real
    return out


def train_steps(mesh, job):
    """``len(job["batches"])`` steps for each microbatch count of
    ``job["microbatches"]`` from ``job["state"]``, on this rank's rows of
    each global batch: the flat state after every step and the metrics."""
    from repro_torch.train.step import StepConfig, make_train_step

    out = {}
    for nm in job["microbatches"]:
        ctx = _ctx(mesh, job["groups"])
        model, opt, state = _train_setup(mesh, job, ctx)
        step = make_train_step(model, opt, StepConfig(num_microbatches=nm), ctx)
        states, metrics = [], []
        for batch in job["batches"]:
            state, m = step(state, _rows(batch, mesh))
            states.append(flat_numpy(state))
            metrics.append({k: float(v) for k, v in m.items()})
        out[nm] = {"states": states, "metrics": metrics}
    return out


def serve(mesh, job):
    """A prefill of this rank's rows, then one decode step a token of
    ``job["feed"]`` (the same tokens as the reference's), with each combine
    of ``job["scatter"]``: the logits of every step."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model_api import build
    from repro_torch.models.perf_flags import PerfFlags, use_flags

    model = build(job["cfg"])
    ctx = _ctx(mesh, job["groups"])
    params = params_from_numpy(_sliced(mesh, job["params"], model.specs()), device="cpu")
    rows = _rows({"tokens": job["tokens"], "feed": job["feed"]}, mesh)
    out = {}
    for scatter in job["scatter"]:
        with use_flags(PerfFlags(moe_scatter_combine=scatter)):
            B, S = rows["tokens"].shape
            state = model.decode_state_init(B, S + rows["feed"].shape[1], device="cpu")
            logits, state = model.prefill(params, {"tokens": torch.from_numpy(rows["tokens"])}, state, ctx=ctx)
            steps = [logits.numpy()]
            for t in range(rows["feed"].shape[1]):
                logits, state = model.decode_step(params, state, torch.from_numpy(rows["feed"][:, t:t + 1]),
                                                  ctx=ctx)
                steps.append(logits.numpy())
        out[scatter] = steps
    return out


def save_checkpoint(mesh, job):
    """One train step, then a checkpoint of the state (the expert leaves
    gathered whole over the model group) and a restore on this mesh."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.param import expert_axes
    from repro_torch.train.step import make_train_step, train_state_specs

    ctx = _ctx(mesh, job["groups"])
    model, opt, state = _train_setup(mesh, job, ctx)
    state, _ = make_train_step(model, opt, ctx=ctx)(state, _rows(job["batch"], mesh))
    mgr = CheckpointManager(job["dir"], group=mesh.group, ep_group=mesh.ep_group,
                            shards=expert_axes(train_state_specs(model, opt)))
    mgr.save(1, state, blocking=True)
    torch.distributed.barrier()
    return {"saved": flat_numpy(state), "restored": flat_numpy(mgr.restore(state))}


def restore_checkpoint(mesh, job):
    """``job["dir"]``'s checkpoint restored into a fresh state on this
    mesh, and with ``job["as_data_only"]`` also as a mesh of the data group
    alone (no model group: whole expert leaves, as (data D, model 1) reads
    it); the restored flat states."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.models.layers.moe import SpmdCtx
    from repro_torch.models.model_api import build
    from repro_torch.models.param import expert_axes
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.step import train_state_init, train_state_specs

    model = build(job["cfg"])
    opt = OptimizerConfig(name="adamw", warmup_steps=2, total_steps=20)
    axes = expert_axes(train_state_specs(model, opt))
    ctx = _ctx(mesh, job["groups"])
    like = train_state_init(model, opt, torch.Generator().manual_seed(5), ctx, "cpu")
    out = {"restored": flat_numpy(CheckpointManager(job["dir"], group=mesh.group, ep_group=mesh.ep_group,
                                                    shards=axes).restore(like))}
    if job.get("as_data_only"):
        whole = SpmdCtx(num_groups=job["groups"], num_ep_shards=mesh.shape["model"], group=mesh.group,
                        rules=ctx.rules)
        like = train_state_init(model, opt, torch.Generator().manual_seed(5), whole, "cpu")
        out["data_only"] = flat_numpy(CheckpointManager(job["dir"], group=mesh.group).restore(like))
    return out


def counted(mesh, job):
    """One train step and one prefill under the op counter: their
    collective records, and the dispatch steps' calls of the prefill."""
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.model_api import build
    from repro_torch.roofline.op_cost import OpCounter
    from repro_torch.train.step import make_train_step

    ctx = _ctx(mesh, job["groups"])
    model, opt, state = _train_setup(mesh, job, ctx)
    step = make_train_step(model, opt, ctx=ctx)
    with OpCounter() as train_counter:
        step(state, _rows(job["batch"], mesh))
    params = params_from_numpy(_sliced(mesh, job["params"], model.specs()), device="cpu")
    tokens = _rows({"t": job["batch"]["tokens"]}, mesh)["t"]
    decode_state = model.decode_state_init(*tokens.shape, device="cpu")
    with OpCounter() as prefill_counter:
        model.prefill(params, {"tokens": torch.from_numpy(tokens)}, decode_state, ctx=ctx)
    return {"train": train_counter.result(), "prefill": prefill_counter.result()}


def raises(mesh, job):
    """The messages of what must raise on this mesh: ``num_ep_shards``
    other than the model group's size, and a model axis that does not
    divide the experts."""
    import dataclasses

    from repro_torch.models.layers import moe

    out = {}
    try:
        moe.SpmdCtx(num_ep_shards=2 * mesh.shape["model"], ep_group=mesh.ep_group)
    except ValueError as e:
        out["shards"] = str(e)
    cfg = job["cfg"]
    odd = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, num_experts=3, top_k=2))
    x = torch.zeros((2, 4, cfg.d_model))
    p = {k: torch.zeros(s.shape) for k, s in moe.moe_specs(odd).items()}
    try:
        moe.moe_apply(p, x, cfg=odd, state=moe.moe_state_init(odd, _ctx(mesh, 1), "cpu"), ctx=_ctx(mesh, 1))
    except ValueError as e:
        out["experts"] = str(e)
    return out
