"""Rank processes for ``tests/test_torch_ranks.py``: each function below is
the body of one rank of a gloo group on the CPU, started through
``run_rank`` by ``repro_torch.launch.mesh.run_ranks`` with its arguments
pickled.  This module imports torch and the port only (no
JAX), so a rank starts quickly; results go back through a queue as numpy
arrays."""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode


def flat_numpy(tree: Any) -> Dict[str, np.ndarray]:
    from repro_torch.checkpoint.manager import flatten_with_paths

    return {k: v.detach().cpu().numpy().copy() for k, v in flatten_with_paths(tree)}


class Capture(TorchDispatchMode):
    """Each ``c10d.allreduce_``'s input (copied before the call) and its
    tensors, whose results are read once the caller has waited: ``calls()``
    after the block."""

    def __init__(self) -> None:
        super().__init__()
        self._calls: List[Any] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "c10d":
            self._calls.append((func.overloadpacket.__name__, [t.detach().clone() for t in args[0]], args[0]))
        return func(*args, **(kwargs or {}))

    def calls(self) -> List[Dict[str, Any]]:
        return [{"op": op, "in": [t.numpy() for t in before], "out": [t.detach().clone().numpy() for t in after]}
                for op, before, after in self._calls]


def run_rank(rank: int, world: int, init_method: str, name: str, job: Dict) -> Dict:
    """Body ``name`` of this module as rank ``rank`` of a gloo group (the
    target of ``launch/mesh.py::run_ranks``)."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks

    torch.set_num_threads(1)
    mesh = init_ranks(rank, world, device=torch.device("cpu"), init_method=init_method)
    try:
        return globals()[name](rank, world, mesh, job)
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- #
# Bodies
# --------------------------------------------------------------------- #


def _setup(mesh, job):
    from repro_torch.models.convert import state_from_numpy
    from repro_torch.models.layers.moe import SpmdCtx
    from repro_torch.models.model_api import build
    from repro_torch.optim.optimizers import OptimizerConfig

    model = build(job["cfg"])
    opt = OptimizerConfig(name="adamw", warmup_steps=2, total_steps=20)
    ctx = SpmdCtx(num_groups=job["groups"], group=mesh.group)
    return model, opt, ctx, state_from_numpy(job["state"], device="cpu")


def _rows(batch: Dict[str, np.ndarray], rank: int, world: int) -> Dict[str, np.ndarray]:
    b = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}


def train_steps(rank, world, mesh, job):
    """``job["steps"]`` steps for each microbatch count of
    ``job["microbatches"]``, from ``job["state"]``, on this rank's rows of
    each global batch; the flat state after every step and the metrics."""
    from repro_torch.train.step import StepConfig, make_train_step

    out = {}
    for nm in job["microbatches"]:
        model, opt, ctx, state = _setup(mesh, job)
        step = make_train_step(model, opt, StepConfig(num_microbatches=nm), ctx)
        states, metrics = [], []
        for batch in job["batches"]:
            state, m = step(state, _rows(batch, rank, world))
            states.append(flat_numpy(state))
            metrics.append({k: float(v) for k, v in m.items()})
        out[nm] = {"states": states, "metrics": metrics}
    return out


def compressed(rank, world, mesh, job):
    """``allreduce_compressed`` on this rank's leaves of ``job["grads"]`` and
    ``job["residual"]``, with every ``all_reduce`` captured."""
    from repro_torch.optim.grad_compress import allreduce_compressed

    grads = {k: torch.from_numpy(v[rank]) for k, v in job["grads"].items()}
    residual = {k: torch.from_numpy(v[rank]) for k, v in job["residual"].items()}
    with Capture() as cap:
        mean, new_r = allreduce_compressed(grads, residual, mesh.group)
    return {"mean": flat_numpy(mean), "residual": flat_numpy(new_r), "calls": cap.calls()}


def counted_steps(rank, world, mesh, job):
    """One plain and one compressed train step under the op counter: the
    collective records, the totals and the link states; then two more
    compressed steps (their losses and this rank's residual)."""
    from repro_torch.roofline.op_cost import OpCounter
    from repro_torch.train.step import StepConfig, make_train_step

    out = {}
    for name, compress in (("plain", False), ("compressed", True)):
        model, opt, ctx, state = _setup(mesh, job)
        step = make_train_step(model, opt, StepConfig(grad_compression=compress), ctx)
        batches = [_rows(b, rank, world) for b in job["batches"]]
        with OpCounter() as counter:
            state, m = step(state, batches[0])
        losses = [float(m["loss"])]
        for batch in batches[1:]:
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out[name] = {"result": counter.result(), "losses": losses,
                     "dyskew": flat_numpy(state["dyskew"]),
                     "residual": flat_numpy(state.get("grad_residual", {}))}
    return out


def save_checkpoint(rank, world, mesh, job):
    """One compressed step, then a checkpoint of the state (rank 0 the
    replicated part, each rank its residual) and a restore at the same
    world size."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train.step import StepConfig, make_train_step

    model, opt, ctx, state = _setup(mesh, job)
    step = make_train_step(model, opt, StepConfig(grad_compression=True), ctx)
    state, _ = step(state, _rows(job["batches"][0], rank, world))
    mgr = CheckpointManager(job["dir"], group=mesh.group)
    mgr.save(1, state, blocking=True)
    torch.distributed.barrier(mesh.group)
    back = mgr.restore(state)
    return {"saved": flat_numpy(state), "restored": flat_numpy(back)}


def restore_checkpoint(rank, world, mesh, job):
    """Restore ``job["dir"]``'s newest checkpoint into this world's state
    (which carries a residual), then take one compressed step from it."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.train.step import StepConfig, make_train_step

    model, opt, ctx, state = _setup(mesh, job)
    # Ones where the restore must put zeros (another world size).
    state["grad_residual"] = _ones_like_params(state["params"])
    back = CheckpointManager(job["dir"], group=mesh.group).restore(state)
    step = make_train_step(model, opt, StepConfig(grad_compression=True), ctx)
    after, m = step(back, _rows(job["batches"][1], rank, world))
    return {"restored": flat_numpy(back), "loss_after": float(m["loss"])}


def one_rank_group(rank, world, mesh, job):
    """Each rank in a group of its own (``new_subgroups``): two steps of
    ``train/loop.py`` on that one-rank group and two with no group, from the
    same seed; whether the histories' losses and the final states are the
    same bits."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh
    from repro_torch.train.loop import LoopConfig, train

    own, _ = dist.new_subgroups(group_size=1)
    runs = [train(job["cfg"], job["data"], job["opt"], LoopConfig(steps=2, log_every=1), device="cpu", mesh=m)
            for m in (Mesh(sizes=(1, 1), group=own, rank=0), Mesh())]
    (a, b) = (flat_numpy(r["state"]) for r in runs)
    return {"losses": [[h["loss"] for h in r["history"]] for r in runs],
            "states_equal": sorted(a) == sorted(b) and all(np.array_equal(a[k], b[k]) for k in a)}


def several(rank, world, mesh, job):
    """The bodies named by ``job``'s keys, in its order, each on its own
    part of ``job``: one process start for all of them."""
    return {name: globals()[name](rank, world, mesh, part) for name, part in job.items()}


def _ones_like_params(params):
    from repro_torch.optim.optimizers import zip_map

    return zip_map(lambda p: torch.ones(p.shape, dtype=torch.float32), params)
