"""Public wrapper for the load-histogram kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.histogram.kernel import load_histogram
from repro_torch.kernels.histogram.ref import load_histogram_ref


def histogram(ids: torch.Tensor, num_dest: int) -> torch.Tensor:
    """CUDA ids go through the kernel (or raise); CPU ids through the plain
    version."""
    if ids.is_cuda:
        return load_histogram(ids.to(torch.int32), num_dest=num_dest)
    return load_histogram_ref(ids, num_dest)
