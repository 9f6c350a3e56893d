"""Public wrapper for the dispatch-gather kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch.kernel import dispatch_gather
from repro_torch.kernels.dispatch.ref import dispatch_gather_ref


def dispatch(x: torch.Tensor, src: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Routing-plan gather.  CUDA tensors go through the kernel (or raise);
    CPU tensors through the plain version."""
    if x.is_cuda:
        return dispatch_gather(x, src.to(torch.int32), valid)
    return dispatch_gather_ref(x, src, valid)
