"""Public wrapper for fused top-k gating, differentiable in the weights."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.topk_gating.kernel import topk_gating
from repro_torch.kernels.topk_gating.ref import gate_probs, renormalise, topk_gating_ref


def _kernel_forward(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    return topk_gating(logits, k=k)


class Gating(torch.autograd.Function):
    """``forward(logits, k)`` → (w, idx), with the gradient of ``w`` taken
    through the plain softmax → gather → renormalise at the saved indices
    (the kernel writes its outputs outside autograd).  The indices get no
    gradient."""

    @staticmethod
    def forward(ctx, logits, k, forward):
        w, idx = forward(logits, k)
        ctx.save_for_backward(logits, idx)
        ctx.mark_non_differentiable(idx)
        return w, idx

    @staticmethod
    def backward(ctx, dw, _didx):
        logits, idx = ctx.saved_tensors
        with torch.enable_grad():
            leaf = logits.detach().requires_grad_(True)
            (dlogits,) = torch.autograd.grad(renormalise(gate_probs(leaf), idx), leaf, dw)
        return dlogits, None, None


def gating(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA logits go through the kernel (or raise); CPU logits through the
    plain version."""
    forward = _kernel_forward if logits.is_cuda else topk_gating_ref
    return Gating.apply(logits, k, forward)
