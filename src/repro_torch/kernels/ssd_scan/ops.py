"""Public wrapper for the SSD state-scan kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.ssd_scan.kernel import ssd_state_scan
from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_ref


def state_scan(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """Inter-chunk state scan.  CUDA tensors go through the kernel (or
    raise); CPU tensors through the plain version."""
    if states.is_cuda:
        return ssd_state_scan(states, decay)
    return ssd_state_scan_ref(states, decay)
