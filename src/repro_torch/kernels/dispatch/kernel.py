"""Launch wrapper of the CUDA dispatch-gather kernel (csrc/dispatch.cu).

Given activations ``x`` (T, D), a slot→source-token map ``src`` (S,) and a
slot validity mask, produce the dispatch buffer (S, D) with invalid slots
zeroed.  This is the hot inner loop of DySkew's redistribution: the
(E, C_buf, d) MoE dispatch buffer is built from this primitive.  A
persistent grid of warps walks the slots, keeps the rows of ``x`` in L2
while the buffer streams past it, and never reads ``x`` for an empty slot,
see the source.
"""

from __future__ import annotations

import functools

import torch

#: Kernel launches made through this wrapper (reset by
#: ``repro_torch.kernels.reset_launch_counts``).
launches = 0

#: Warps in a block of csrc/dispatch.cu (kWarpsPerBlock), one slot each at a time.
WARPS_PER_BLOCK = 8
#: Resident blocks per SM the kernel is built for (kMinBlocksPerSm).
BLOCKS_PER_SM = 4


def launch_blocks(num_slots: int, sm_count: int) -> int:
    """The persistent grid: enough blocks to fill every SM with
    ``BLOCKS_PER_SM`` blocks, and never more than give each warp a slot."""
    need = -(-num_slots // WARPS_PER_BLOCK)
    return max(1, min(need, sm_count * BLOCKS_PER_SM))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def dispatch_gather(x: torch.Tensor, src: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """x (T, D) CUDA, any element type; src (S,) int32 in [0, T); valid (S,)
    bool, or any type where non-zero means filled.  Returns (S, D)."""
    global launches
    from repro_torch.kernels import _loader

    if not (x.is_cuda and src.is_cuda and valid.is_cuda):
        raise ValueError("dispatch_gather launches a CUDA kernel: all inputs must be on the GPU")
    if x.ndim != 2 or src.ndim != 1 or valid.shape != src.shape:
        raise ValueError(
            f"expected x (T, D), src (S,), valid (S,); got {tuple(x.shape)}, "
            f"{tuple(src.shape)}, {tuple(valid.shape)}"
        )
    if src.dtype != torch.int32:
        raise TypeError(f"src must be int32, got {src.dtype}")
    T, D = x.shape
    S = src.shape[0]
    if T < 1 or D < 1:
        raise ValueError(f"x must be non-empty, got {tuple(x.shape)}")
    x = x.contiguous()
    src = src.contiguous()
    if valid.dtype != torch.bool:
        valid = valid != 0
    valid = valid.contiguous()
    out = torch.empty((S, D), dtype=x.dtype, device=x.device)
    if S == 0:
        return out
    _loader.launch(
        "dyskew_dispatch_gather", x.device,
        x.data_ptr(), src.data_ptr(), valid.data_ptr(), out.data_ptr(),
        S, T, D * x.element_size(),
        launch_blocks(S, _sm_count(x.device.index)),
    )
    launches += 1
    return out
