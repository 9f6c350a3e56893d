"""Launch wrapper of the CUDA top-k gating kernel (csrc/topk_gating.cu).

The MoE router's softmax→top-k→renormalize sequence runs on every token of
every MoE layer; fusing it keeps the (T, E) probability matrix out of
device memory.  Where a row is a power-of-two number of 16-byte vectors (32
bf16 experts: four), a group of lanes holds it, one vector a lane, and a
warp holds several rows; other shapes take one warp per row.  See the
source for the design.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: Kernel launches made through this wrapper (reset by
#: ``repro_torch.kernels.reset_launch_counts``).
launches = 0

MAX_EXPERTS = 512
MAX_K = 32
WARP = 32
#: One load a lane on the group path.
VECTOR_BYTES = 16
#: The k the group path is built for (its rounds unroll); other k take the
#: warp path.
GROUP_KS = (1, 2, 4, 8)
PATH_WARP, PATH_GROUP = 0, 1
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def launch_shape(num_experts: int, k: int, element_size: int, aligned: bool) -> Tuple[int, int]:
    """(path, lanes a row) for logits of ``num_experts`` elements of
    ``element_size`` bytes a row, ``aligned`` if their base lies on the
    16-byte grid.

    The group path takes a row of G 16-byte vectors, G a power of two up to
    32, with k in ``GROUP_KS``: G lanes a row, 32 / G rows a warp.
    Everything else takes the warp path: 32 lanes a row."""
    row_bytes = num_experts * element_size
    lanes = row_bytes // VECTOR_BYTES
    if (aligned and k in GROUP_KS and row_bytes % VECTOR_BYTES == 0
            and 1 <= lanes <= WARP and lanes & (lanes - 1) == 0):
        return PATH_GROUP, lanes
    return PATH_WARP, WARP


def output_views(T: int, k: int, device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One (2, T, k) int32 allocation and its two halves: the weights as
    contiguous (T, k) float32 (their bits in ``buf[0]``) and the ids as
    contiguous (T, k) int32 (``buf[1]``), the layout the kernel writes."""
    buf = torch.empty((2, T, k), dtype=torch.int32, device=device)
    bits, idx = buf.unbind(0)
    return buf, bits.view(torch.float32), idx


def topk_gating(logits: torch.Tensor, *, k: int,
                general: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) float32 or bfloat16 CUDA logits → (weights (T, k) float32
    renormalised, indices (T, k) int32).  Any T; E <= 512; k <= min(E, 32).

    ``general`` takes the warp path whatever the shape, so that the two
    paths can be compared on the same input."""
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
    buf, w, idx = output_views(T, k, logits.device)
    if T == 0:
        return w, idx
    aligned = not general and logits.data_ptr() % VECTOR_BYTES == 0
    _loader.launch(
        "dyskew_topk_gating", logits.device,
        logits.data_ptr(), buf.data_ptr(), T, E, k, _DTYPE_CODE[logits.dtype],
        *launch_shape(E, k, logits.element_size(), aligned),
    )
    launches += 1
    return w, idx
