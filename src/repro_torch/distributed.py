"""Collectives over a ``torch.distributed`` process group, for the layers,
the loss and the train step.

``group=None`` means one process: every function then returns its input's
value and issues nothing.  Every rank must call these in the same order
(the MoE layers' calls are issued again when remat recomputes a block in
the backward, on every rank alike).

Over the data-parallel ranks (``all_sum``, ``all_max``) each collective
runs on a detached copy, so no ``all_reduce`` is ever on a differentiable
path; ``with_local_grad`` gives a global value a local term's gradient, so
that the ranks' gradients sum to the gradient of the global value.

Over the expert-parallel ranks of a model group, ``to_shard``,
``gather_shards`` and ``sum_shards`` are differentiable, in Megatron's
conjugate pairs.  Their backwards hold because everything downstream of
them is computed alike on every rank of the group (the same tokens, the
same replicated weights), so every rank holds the same upstream gradient:
``gather_shards`` gives back this rank's slice of it (a reduce-scatter
would scale it by the group's size), and ``to_shard`` sums the partial
gradients of a replicated tensor that each rank used only for its own
shard.  ``torch.distributed.nn.functional``'s ``all_gather`` and
``all_reduce`` assume split downstream work instead and would give M times
the gradient here.

Over the data group, FSDP's ``gather_fsdp`` is the other pair: the
forward all-gathers a leaf's slices along its sliced dimension, and the
backward reduce-scatters (SUM) the gradient back to this rank's slice.
The data group's ranks hold other rows of the batch, so their gradients
of the whole leaf differ and must be summed: ``gather_shards``' backward,
which keeps this rank's rows unsummed, would drop the other ranks' parts
with no error.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
import torch.distributed as dist

Group = Optional[Any]     # a torch.distributed ProcessGroup, or None


def world_size(group: Group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank_of(group: Group) -> int:
    return 0 if group is None else dist.get_rank(group)


def _reduced(t: torch.Tensor, group: Group, op) -> torch.Tensor:
    out = t.detach().clone(memory_format=torch.contiguous_format)
    if group is not None:
        dist.all_reduce(out, op=op, group=group)
    return out


def all_sum(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of ``t`` over the group's ranks, in a new detached tensor
    (``t`` detached with no group)."""
    if group is None:
        return t.detach()
    return _reduced(t, group, dist.ReduceOp.SUM)


def all_sum_(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` summed over the group's ranks in place (no copy: for a tensor
    the caller owns, as a fresh gradient); returns ``t``."""
    if group is not None:
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


def all_max(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The element-wise maximum of ``t`` over the group's ranks, detached."""
    if group is None:
        return t.detach()
    return _reduced(t, group, dist.ReduceOp.MAX)


def with_local_grad(total: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """``total``'s value (the same bits on every rank: ``local - local`` is
    an exact zero) with ``local``'s gradient."""
    return total + (local - local.detach())


class _ToShard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _reduced(g, ctx.group, dist.ReduceOp.SUM), None


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.rank, ctx.rows = dist.get_rank(group), t.shape[0]
        t = t.contiguous()
        out = t.new_empty((dist.get_world_size(group) * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.rank * ctx.rows, ctx.rows), None


class _SumShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def to_shard(t: torch.Tensor, group: Group) -> torch.Tensor:
    """``t`` (replicated over the model group) as the input of this rank's
    shard of work: the identity forward, its gradient summed over the
    group in the backward."""
    return t if group is None else _ToShard.apply(t, group)


def gather_shards(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The ranks' ``t`` concatenated along dim 0 in rank order (one
    all-gather); the backward keeps this rank's rows of the gradient."""
    return t if group is None else _GatherShards.apply(t, group)


def sum_shards(t: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum of the ranks' partial ``t`` (one all_reduce); the backward
    passes the gradient through to each rank's part."""
    return t if group is None else _SumShards.apply(t, group)


class _GatherFsdp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, dim, group, scatter, inner, inner_rank):
        ctx.dim, ctx.scatter, ctx.inner, ctx.inner_rank = dim, scatter, inner, inner_rank
        src = t.movedim(dim, 0).contiguous()
        ctx.rows = src.shape[0]
        out = src.new_empty((dist.get_world_size(group) * ctx.rows,) + tuple(src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=group)
        return out.movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.movedim(ctx.dim, 0)
        if ctx.inner > 1:
            # The rows of this rank's model index in every data block: the
            # model group's ranks hold the same gradient.
            rest = tuple(g.shape[1:])
            g = g.reshape((-1, ctx.inner, ctx.rows) + rest)[:, ctx.inner_rank].reshape((-1,) + rest)
        g = g.contiguous()
        out = g.new_empty((ctx.rows,) + tuple(g.shape[1:]))
        dist.reduce_scatter_tensor(out, g, op=dist.ReduceOp.SUM, group=ctx.scatter)
        return out.movedim(0, ctx.dim), None, None, None, None, None


def gather_fsdp(t: torch.Tensor, dim: int, group: Group, world: Group = None) -> torch.Tensor:
    """FSDP's all-gather: the data group's slices of a leaf joined along
    ``dim`` in rank order; the backward sums the gradient over the data
    group and keeps this rank's slice (one reduce-scatter).  With ``world``
    the slices are over the fused ``(data, model)`` (H6): ``world``'s ranks
    in mesh order, the model index innermost; the backward then takes the
    rows of this rank's model index (every rank of a model group holds the
    same gradient) and reduce-scatters them over ``group``."""
    if world is None:
        return t if group is None else _GatherFsdp.apply(t, dim, group, group, 1, 0)
    inner = dist.get_world_size(world) // world_size(group)
    return _GatherFsdp.apply(t, dim, world, group, inner, dist.get_rank(world) % inner)
