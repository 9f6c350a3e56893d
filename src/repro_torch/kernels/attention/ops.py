"""Which attention calls the kernel takes."""

from __future__ import annotations

import torch

from repro_torch.kernels.attention.kernel import DTYPES, HEAD_DIMS


def takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel computes this call, wherever the tensors lie: k
    and v bf16 or fp16 (not an int8 cache) in q's type, head width 64 or
    128, and no gradient asked of q, k or v (the kernel has no backward)."""
    return (k.dtype in DTYPES and q.dtype == k.dtype == v.dtype and q.shape[-1] in HEAD_DIMS
            and not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)))
