"""Public wrapper for the MoE combine and its backward."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.combine.kernel import moe_combine
from repro_torch.kernels.combine.kernel_bwd import moe_combine_bwd
from repro_torch.kernels.combine.ref import moe_combine_ref
from repro_torch.roofline import kernel_cost, op_cost


def _plain_backward(dy: torch.Tensor, y_flat: torch.Tensor, slot_tk: torch.Tensor,
                    gate_w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain loop's own gradient: autograd through ``moe_combine_ref``
    run again, so that CPU tensors keep the bits the loop always gave."""
    with torch.enable_grad():
        yf = y_flat.detach().requires_grad_(True)
        w = gate_w.detach().requires_grad_(True)
        d_yf, d_w = torch.autograd.grad(moe_combine_ref(yf, slot_tk, w), (yf, w), dy)
    return d_yf, d_w


class Combine(torch.autograd.Function):
    """``forward(y_flat, slot_tk, gate_w, forward, backward)`` → (T, d);
    ``backward(dy, y_flat, slot_tk, gate_w)`` → (d_y_flat, d_w): the two
    CUDA kernels, or the plain loop and its autograd gradient.  Saves
    ``y_flat``; ``slot_tk`` gets no gradient."""

    @staticmethod
    def forward(ctx, y_flat, slot_tk, gate_w, forward, backward):
        ctx.save_for_backward(y_flat, slot_tk, gate_w)
        ctx.backward_fn = backward
        return forward(y_flat, slot_tk, gate_w)

    @staticmethod
    def backward(ctx, dy):
        y_flat, slot_tk, gate_w = ctx.saved_tensors
        with op_cost.kernel(kernel_cost.moe_combine_bwd, y_flat, slot_tk):
            d_y_flat, d_w = ctx.backward_fn(dy.to(y_flat.dtype), y_flat, slot_tk, gate_w)
        return d_y_flat, None, d_w.to(gate_w.dtype), None, None


def combine(y_flat: torch.Tensor, slot_tk: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """Each token's kept picks' expert outputs, weighted: y_flat (S, d),
    slot_tk (T, k) (``S`` for a dropped pick), gate_w (T, k) → (T, d).  CUDA
    tensors go through the kernel (or raise), with its backward kernel under
    grad; CPU tensors through the plain loop, with the loop's gradient.  An
    active ``op_cost.OpCounter`` counts each kernel's record, whichever
    version runs."""
    with op_cost.kernel(kernel_cost.moe_combine, y_flat, slot_tk):
        if y_flat.is_cuda:
            slot_tk = slot_tk.to(torch.int32)
            forward, backward = moe_combine, moe_combine_bwd
        else:
            forward, backward = moe_combine_ref, _plain_backward
        if torch.is_grad_enabled() and (y_flat.requires_grad or gate_w.requires_grad):
            return Combine.apply(y_flat, slot_tk, gate_w, forward, backward)
        return forward(y_flat, slot_tk, gate_w)
