"""Public wrapper for fused top-k gating."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.topk_gating.kernel import topk_gating
from repro_torch.kernels.topk_gating.ref import topk_gating_ref


def gating(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """CUDA logits go through the kernel (or raise); CPU logits through the
    plain version."""
    if logits.is_cuda:
        return topk_gating(logits, k=k)
    return topk_gating_ref(logits, k)
