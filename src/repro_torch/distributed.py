"""Sums and maxima over the data-parallel ranks of a ``torch.distributed``
process group, for the layers, the loss and the train step.

``group=None`` means one process: every function then returns its input's
value and issues nothing.  Each collective runs on a detached copy, so no
``all_reduce`` is ever on a differentiable path; ``with_local_grad`` gives
a global value a local term's gradient, so that the ranks' gradients sum to
the gradient of the global value.  Every rank must
call these in the same order (the MoE layers' calls are issued again when
remat recomputes a block in the backward, on every rank alike).
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
