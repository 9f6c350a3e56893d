"""Launch wrapper of the CUDA SSD state-scan kernel (csrc/ssd_state_scan.cu).

The chunked SSD algorithm of Mamba-2 reduces each chunk to an (H, P, N)
state contribution and a per-head decay; chaining them is a recurrence over
chunks, ``h_c = decay_c * h_{c-1} + s_c``, and this kernel writes the state
entering every chunk in one pass.  A thread walks the chunks for four
consecutive elements with the running state in registers, see the source.
"""

from __future__ import annotations

import torch

#: Kernel launches made through this wrapper (reset by
#: ``repro_torch.kernels.reset_launch_counts``).
launches = 0

_STATE_DTYPES = (torch.float32, torch.bfloat16)


def ssd_state_scan(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """states (C, H, P, N) float32 or bfloat16, contiguous; decay (C, H) of
    any float type, on the same GPU.  Returns (C, H, P, N) float32: the
    exclusive prefix, ``out[0] == 0``.  Any C, H, P, N."""
    global launches
    from repro_torch.kernels import _loader

    if states.ndim != 4 or decay.ndim != 2 or tuple(decay.shape) != tuple(states.shape[:2]):
        raise ValueError(
            f"expected states (C, H, P, N) and decay (C, H); got "
            f"{tuple(states.shape)}, {tuple(decay.shape)}"
        )
    if states.dtype not in _STATE_DTYPES:
        raise TypeError(f"states must be float32 or bfloat16, got {states.dtype}")
    if not decay.is_floating_point():
        raise TypeError(f"decay must be a float tensor, got {decay.dtype}")
    if not states.is_contiguous():
        # A copy of the (C, H, P, N) contributions would cost as much as the
        # scan itself: the caller lays them out in this order.
        raise ValueError("states must be contiguous")
    if not (states.is_cuda and decay.is_cuda):
        raise ValueError("ssd_state_scan launches a CUDA kernel: all inputs must be on the GPU")
    if decay.device != states.device:
        raise ValueError(f"states on {states.device}, decay on {decay.device}")
    C, H, P, N = states.shape
    decay = decay.to(torch.float32).contiguous()
    out = torch.empty(states.shape, dtype=torch.float32, device=states.device)
    if out.numel() == 0:
        return out
    _loader.launch(
        "dyskew_ssd_state_scan", states.device,
        states.data_ptr(), decay.data_ptr(), out.data_ptr(), C, H, P * N,
        int(states.dtype == torch.bfloat16),
    )
    launches += 1
    return out
