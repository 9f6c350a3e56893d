"""Public wrapper for the SSD state-scan kernel (forward only)."""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_state_scan
from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_ref


def state_scan(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """Inter-chunk state scan.  CUDA tensors go through the kernel (or
    raise); CPU tensors through the plain version.  The scan has no
    backward: with grad on and an input that requires grad it raises,
    rather than give a result cut off from the graph."""
    if torch.is_grad_enabled() and (states.requires_grad or decay.requires_grad):
        raise NotImplementedError(
            "ssd state scan has no backward: Mamba-2 training is not ported "
            "yet (ROADMAP.md queue A, 'Mamba-2 training')"
        )
    if states.is_cuda:
        return ssd_state_scan(states, decay)
    return ssd_state_scan_ref(states, decay)
