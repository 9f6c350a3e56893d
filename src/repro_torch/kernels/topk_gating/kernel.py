"""Launch wrapper of the CUDA top-k gating kernel (csrc/topk_gating.cu).

The MoE router's softmax→top-k→renormalize sequence runs on every token of
every MoE layer; fusing it keeps the (T, E) probability matrix out of
device memory.  One warp handles one row, see the source for the design.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: Kernel launches made through this wrapper (reset by
#: ``repro_torch.kernels.reset_launch_counts``).
launches = 0

MAX_EXPERTS = 512
MAX_K = 32
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def topk_gating(logits: torch.Tensor, *, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) float32 or bfloat16 CUDA logits → (weights (T, k) float32
    renormalised, indices (T, k) int32).  Any T; E <= 512; k <= min(E, 32)."""
    global launches
    from repro_torch.kernels import _loader

    if not logits.is_cuda:
        raise ValueError("topk_gating launches a CUDA kernel: logits must be on the GPU")
    if logits.ndim != 2:
        raise ValueError(f"logits must be (T, E), got {tuple(logits.shape)}")
    if logits.dtype not in _DTYPE_CODE:
        raise TypeError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    T, E = logits.shape
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"E={E} outside [1, {MAX_EXPERTS}]")
    if not 1 <= k <= min(E, MAX_K):
        raise ValueError(f"k={k} outside [1, min(E, {MAX_K})]")
    logits = logits.contiguous()
    w = torch.empty((T, k), dtype=torch.float32, device=logits.device)
    idx = torch.empty((T, k), dtype=torch.int32, device=logits.device)
    if T == 0:
        return w, idx
    _loader.launch(
        "dyskew_topk_gating", logits.device,
        logits.data_ptr(), w.data_ptr(), idx.data_ptr(), T, E, k,
        _DTYPE_CODE[logits.dtype],
    )
    launches += 1
    return w, idx
