"""Public wrapper for the dispatch-gather kernel, differentiable in ``x``."""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch.kernel import dispatch_gather
from repro_torch.kernels.dispatch.ref import dispatch_gather_ref


def _kernel_forward(x: torch.Tensor, src: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return dispatch_gather(x, src.to(torch.int32), valid)


def dispatch_backward(dbuf: torch.Tensor, src: torch.Tensor, valid: torch.Tensor,
                      num_tokens: int) -> torch.Tensor:
    """``dx[t]`` = the sum of ``dbuf[s]`` over the slots with ``valid[s]``
    and ``src[s] == t``, added in slot order in float32 (float64 stays
    float64) and rounded once to ``dbuf``'s type.  No atomics: the slots are
    sorted by token (stable) and each token's segment is one
    ``segment_reduce`` walk, so two runs give the same bits on either
    device.  An empty slot joins token ``s mod T`` as an exact zero, which
    keeps every segment short (one segment of all empty slots would be a
    walk of most of the buffer) and leaves every sum as it was."""
    valid = valid != 0
    slot = torch.arange(src.shape[0], device=src.device)
    key = torch.where(valid, src.to(torch.int64), slot % num_tokens)
    order = torch.argsort(key, stable=True)
    lengths = torch.zeros(num_tokens, dtype=torch.int64, device=dbuf.device)
    lengths.scatter_add_(0, key, torch.ones_like(key))
    acc = torch.promote_types(dbuf.dtype, torch.float32)
    rows = torch.where(valid[order, None], dbuf[order].to(acc), 0.0)
    sums = torch.segment_reduce(rows, "sum", lengths=lengths, axis=0, unsafe=True, initial=0.0)
    return sums.to(dbuf.dtype)


class Dispatch(torch.autograd.Function):
    """``forward(x, src, valid)`` → (S, D) buffer; backward by
    ``dispatch_backward``.  ``src`` and ``valid`` get no gradient."""

    @staticmethod
    def forward(ctx, x, src, valid, forward):
        buf = forward(x, src, valid)
        ctx.save_for_backward(src, valid)
        ctx.num_tokens = x.shape[0]
        return buf

    @staticmethod
    def backward(ctx, dbuf):
        src, valid = ctx.saved_tensors
        return dispatch_backward(dbuf, src, valid, ctx.num_tokens), None, None, None


def dispatch(x: torch.Tensor, src: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Routing-plan gather.  CUDA tensors go through the kernel (or raise);
    CPU tensors through the plain version."""
    forward = _kernel_forward if x.is_cuda else dispatch_gather_ref
    return Dispatch.apply(x, src, valid, forward)
