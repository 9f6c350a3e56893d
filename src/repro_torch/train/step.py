"""Training / serving step builders.

``make_train_step`` returns the training step: forward + backward +
(optionally compressed) gradient reduction over the data-parallel ranks +
global-norm clip + optimizer update + the MoE links' load averages
advanced, with optional microbatched gradient accumulation (the averages
advance once per microbatch).  The steps are plain closures: there is no compile step, and
each call runs eagerly on the device its tensors live on.

With a data-parallel group (``SpmdCtx.group``) each rank's batch is its
rows of the global batch.  With a model group (``SpmdCtx.ep_group``, the
ranks holding the same rows) each rank holds its slice of every leaf that
the rule table (``SpmdCtx.rules``) slices.  Each rank's loss has the global
value and its share of the global gradient (global denominators, in every
microbatch), so the SUM of the ranks' gradients is the gradient of
``repro``'s loss on the global batch.  A leaf sliced over the data axes
(FSDP) comes back from the forward's gather reduce-scattered: summed over
the data group already, and skipped by the step's sum.  Every other leaf
is summed over the data group only (the model group's ranks already hold
equal gradients of the replicated leaves, the layers' ``to_shard`` having
summed their parts): in float32, one ``all_reduce`` a leaf, or through
``allreduce_compressed`` with ``grad_compression``, which takes only these
leaves (the reduce-scattered ones stay in their dtype, bf16 on the wire
under H2).  The optimizer sums what reads a whole leaf over the ranks that
slice it (``optimizers.Shards``).  H2 (``cast_before_gather``) casts the
float32 leaves to bf16 on the rank's slice, before the gathers; H8
(``constrain_grads``) changes nothing, the gradients being reduce-scattered
whatever it says.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import distributed, tracing
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.ordered_sums import div
from repro_torch.models.layers.moe import KERNEL_OPS, DispatchOps, SpmdCtx
from repro_torch.models.model_api import Model
from repro_torch.models.param import dp_part, leaf_slices, tree_leaves, tree_map
from repro_torch.models.perf_flags import get_flags
from repro_torch.optim.grad_compress import allreduce_compressed, residual_init
from repro_torch.optim.optimizers import OptimizerConfig, Shards, opt_init, opt_update, zip_map
from repro_torch.optim.specs import opt_state_slices, opt_state_specs
from repro_torch.train import decode_graph


@dataclasses.dataclass(frozen=True)
class StepConfig:
    num_microbatches: int = 1
    # int8 + error-feedback reduction across the data-parallel ranks
    # (``allreduce_compressed``); it needs a data-parallel group.
    grad_compression: bool = False


def model_shards(model: Model, ctx: SpmdCtx) -> Optional[Shards]:
    """Each parameter leaf's slices under ``ctx``'s mesh and rule table
    (None without a group)."""
    if ctx.ep_group is None and ctx.data_group is None:
        return None
    mesh = ctx.mesh
    return Shards(tree_map(lambda p: leaf_slices(p, mesh, ctx.rules), model.specs()), mesh, ctx.data_group,
                  ctx.ep_group)


def _cast_before_gather(params: Any) -> Any:
    """H2: float32 leaves as bf16, on the rank's slice (the FSDP gathers
    follow in the forward), as ``repro``'s ``make_train_step`` casts."""
    return tree_map(lambda p: p.to(torch.bfloat16) if p.dtype == torch.float32 else p, params)


def train_state_init(
    model: Model, opt_cfg: OptimizerConfig, generator: torch.Generator,
    ctx: SpmdCtx = SpmdCtx(), device: DeviceLike = None,
) -> Dict:
    """Params drawn from ``generator`` (on its own device) and put on
    ``device``, each leaf that ``ctx.rules`` slices this rank's slice of it
    under a model group (``ctx.ep_group``); zero optimizer state, step 0 and fresh link
    states."""
    params = model.init(generator, device=device, ctx=ctx)
    dev = resolve_device(device)
    state = {
        "params": params,
        "opt": opt_init(opt_cfg, params, model_shards(model, ctx)),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    dk = model.dyskew_init(ctx, dev)
    if dk is not None:
        state["dyskew"] = dk
    return state


def train_state_specs(model: Model, opt_cfg: OptimizerConfig) -> Dict:
    """ParamSpec tree mirroring ``train_state_init``'s params and optimizer
    state (the step counter and link states are small and left out)."""
    pspecs = model.specs()
    return {"params": pspecs, "opt": opt_state_specs(opt_cfg, pspecs)}


def train_state_axes(model: Model, opt_cfg: OptimizerConfig, mesh, rules) -> Dict[str, Tuple]:
    """{``/``-joined key path: slices} of the leaves of
    ``train_state_specs`` that a rank of ``mesh`` holds a slice of under
    ``rules`` (``param.shard_axes``' form; the optimizer state's slices its
    parameters', ``opt_state_slices``): what ``CheckpointManager`` gathers
    and slices."""
    from repro_torch.checkpoint.manager import flatten_with_paths

    pspecs = model.specs()
    slices = tree_map(lambda p: leaf_slices(p, mesh, rules), pspecs)
    tree = {"params": slices, "opt": opt_state_slices(opt_cfg, pspecs, slices)}
    return {k: v for k, v in flatten_with_paths(tree) if v}


def batch_to(batch: Dict[str, Any], device: torch.device) -> Dict[str, torch.Tensor]:
    """numpy arrays (as ``DataPipeline`` yields them) or tensors → tensors
    on ``device``."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v)) if isinstance(v, np.ndarray) else v
        out[k] = t.to(device, non_blocking=True)
    return out


def make_grad_fn(
    model: Model, ctx: SpmdCtx = SpmdCtx(), ops: DispatchOps = KERNEL_OPS,
) -> Callable[[Dict, Dict, Any], Tuple[torch.Tensor, Dict, Dict]]:
    """grad_fn(params, batch, dyskew) -> (loss, aux, grads): the gradient of
    ``Model.loss`` in every leaf, in the leaf's dtype; loss and metrics
    detached, the new link states in ``aux["dyskew"]``."""

    def grad_fn(params, batch, dyskew):
        leaves = tree_leaves(params)
        live = [p.detach().requires_grad_(True) for p in leaves]
        it = iter(live)
        p_live = tree_map(lambda _: next(it), params)
        with torch.enable_grad():
            if get_flags().cast_before_gather:
                p_live = _cast_before_gather(p_live)
            with tracing.span("step.forward"):
                loss, aux = model.loss(p_live, batch, dyskew=dyskew, ctx=ctx, ops=ops)
            with tracing.span("step.backward"), tracing.calling_thread():
                grads = torch.autograd.grad(loss, live, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        it = iter(grads)
        aux = dict(aux, metrics={k: v.detach() for k, v in aux["metrics"].items()})
        return loss.detach(), aux, tree_map(lambda _: next(it), params)

    return grad_fn


def make_train_step(
    model: Model,
    opt_cfg: OptimizerConfig,
    step_cfg: StepConfig = StepConfig(),
    ctx: SpmdCtx = SpmdCtx(),
) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """Returns train_step(state, batch) -> (new_state, metrics).  With
    ``grad_compression`` the state carries this rank's error-feedback
    residual under ``grad_residual`` (zeros before the first step)."""
    group = ctx.group
    if step_cfg.grad_compression and group is None:
        raise NotImplementedError(
            "compressed gradient reduction needs a data-parallel group "
            "(SpmdCtx.group): one process has nothing to reduce over; "
            "ROADMAP.md queue A, 'allreduce_compressed'"
        )
    if ctx.fsdp_group is not None and group is None:
        raise ValueError("a batch replicated over the data group is served, not trained: each rank's "
                         "gradient would be summed once a rank")
    world = distributed.world_size(group)
    shards = model_shards(model, ctx)
    # The leaves sliced over the data axes: their gradients come back from
    # FSDP's reduce-scatter already summed over the data group.
    scattered = (zip_map(lambda sl: any(dp_part(axes) for _, axes in sl), shards.leaves)
                 if shards is not None else None)

    grad_fn = make_grad_fn(model, ctx)

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        dyskew = state.get("dyskew")
        batch = batch_to(batch, state["step"].device)

        nm = step_cfg.num_microbatches
        if nm == 1:
            loss, aux, grads = grad_fn(params, batch, dyskew)
            new_dyskew = aux.get("dyskew")
            metrics = aux["metrics"]
        else:
            # Gradient accumulation over microbatches in float32; the DySkew
            # links' averages advance once per microbatch.
            size = next(iter(batch.values())).shape[0] // nm
            grads = zip_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)
            dk, losses, mmetrics = dyskew, [], []
            for i in range(nm):
                mb = {k: v[i * size:(i + 1) * size] for k, v in batch.items()}
                loss_i, aux, g = grad_fn(params, mb, dk)
                grads = zip_map(lambda a, b: a + b.to(a.dtype), grads, g)
                dk = aux.get("dyskew", dk)
                losses.append(loss_i)
                mmetrics.append(aux["metrics"])
            new_dyskew = dk
            grads = zip_map(lambda g: div(g, nm), grads)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in mmetrics]).mean() for k in mmetrics[0]}

        new_residual = None
        if step_cfg.grad_compression:
            # Times the world size, a rank's share is the gradient of its
            # own rows at the global weighting: the reduction's mean of
            # those is the global gradient.  The reduce-scattered leaves
            # are left out: they are summed already, in their own dtype.
            residual = state.get("grad_residual")
            if residual is None:
                residual = residual_init(_reduced(params, scattered))
            summed, new_residual = allreduce_compressed(
                zip_map(lambda g: g.to(torch.float32) * world, _reduced(grads, scattered)), residual, group
            )
            grads = _merged(grads, summed, scattered)
        elif group is not None:
            # In place on float32 leaves: the gradients are this step's own.
            grads = zip_map(
                lambda g, done: g if done else distributed.all_sum_(g.to(torch.float32), group).to(g.dtype),
                grads, scattered if scattered is not None else zip_map(lambda g: False, grads)
            )

        with torch.no_grad(), tracing.span("step.optimizer"):
            new_params, new_opt, stats = opt_update(
                opt_cfg, grads, state["opt"], params, state["step"], shards
            )
        new_state = dict(state, params=new_params, opt=new_opt, step=state["step"] + 1)
        if new_dyskew is not None:
            new_state["dyskew"] = new_dyskew
        if new_residual is not None:
            new_state["grad_residual"] = new_residual
        metrics = dict(metrics, **stats, loss=loss)
        return new_state, metrics

    return train_step


def _reduced(tree: Any, scattered: Any) -> Any:
    """The leaves of ``tree`` still to be all-reduced (every leaf without
    ``scattered``), with their keys."""
    if scattered is None:
        return tree
    if isinstance(tree, dict):
        out = {k: _reduced(tree[k], scattered[k]) for k in sorted(tree)}
        return {k: v for k, v in out.items() if not (isinstance(v, dict) and not v)}
    return {} if scattered else tree


def _merged(grads: Any, summed: Any, scattered: Any) -> Any:
    """``grads`` with the all-reduced leaves taken from ``summed``."""
    if scattered is None:
        return summed
    if isinstance(grads, dict):
        return {k: grads[k] if k not in summed else _merged(grads[k], summed[k], scattered[k]) for k in grads}
    return grads if scattered else summed


def make_prefill_step(model: Model, ctx: SpmdCtx = SpmdCtx()):
    """prefill_step(params, state, inputs) -> (the last position's logits
    (B, 1, V), new state)."""

    def prefill_step(params, state, inputs):
        logits, new_state = model.prefill(params, inputs, state, ctx=ctx)
        return logits[:, -1:], new_state

    return prefill_step


def make_decode_step(model: Model, ctx: SpmdCtx = SpmdCtx()):
    """decode_step(params, state, token) -> (logits (B, 1, V), new state).
    On a CUDA device with no process group in ``ctx`` the step is captured
    once into a CUDA graph and replayed (``decode_graph``)."""

    def decode_step(params, state, token):
        return model.decode_step(params, state, token, ctx=ctx)

    return decode_graph.graphed(decode_step, ctx)
