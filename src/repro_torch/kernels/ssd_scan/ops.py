"""Public wrapper for the SSD state-scan kernel and its backward."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_state_scan
from repro_torch.kernels.ssd_scan.kernel_bwd import ssd_state_scan_bwd
from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_bwd_ref, ssd_state_scan_ref


def _scan(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    return ssd_state_scan(states, decay) if states.is_cuda else ssd_state_scan_ref(states, decay)


class StateScan(torch.autograd.Function):
    """The scan with its backward: CUDA tensors go through the two kernels
    (or raise), CPU tensors through the plain versions.  Saves the prefix
    and the decays; the gradient of ``states`` comes back in the states'
    dtype, that of ``decay`` in the decays'."""

    @staticmethod
    def forward(ctx, states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
        out = _scan(states, decay)
        ctx.save_for_backward(out, decay)
        ctx.states_dtype = states.dtype
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
        out, decay = ctx.saved_tensors
        g = g.to(torch.float32).contiguous()
        if g.is_cuda:
            d_states, d_decay = ssd_state_scan_bwd(g, out, decay, ctx.states_dtype)
        else:
            d_states, d_decay = ssd_state_scan_bwd_ref(g, out, decay)
            d_states = d_states.to(ctx.states_dtype)
        return (d_states if ctx.needs_input_grad[0] else None,
                d_decay.to(decay.dtype) if ctx.needs_input_grad[1] else None)


def state_scan(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """Inter-chunk state scan.  CUDA tensors go through the kernel (or
    raise); CPU tensors through the plain version.  With grad on and an
    input that requires grad it runs as ``StateScan``, whose backward is the
    CUDA backward kernel on the card."""
    if not states.is_contiguous():
        raise ValueError("states must be contiguous")
    if decay.device != states.device:
        raise ValueError(f"states on {states.device}, decay on {decay.device}")
    if torch.is_grad_enabled() and (states.requires_grad or decay.requires_grad):
        return StateScan.apply(states, decay)
    return _scan(states, decay)
