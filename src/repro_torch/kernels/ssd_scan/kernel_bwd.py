"""Launch wrapper of the CUDA backward of the SSD state scan
(``dyskew_ssd_state_scan_bwd`` in csrc/ssd_state_scan.cu).

Given the prefix's gradient, the forward's prefix and the decays, one
launch walks the chunks from the last down with the adjoint in registers and
writes ``d_states``, and a second, small one sums ``d_decay`` from per-block
partials in a fixed order (no atomics: the same bits every run).  Both
launches count as one call of the kernel.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: Calls of the backward kernel made through this wrapper (reset by
#: ``repro_torch.kernels.reset_launch_counts``).
launches = 0

#: Threads a block in the source: a block covers ``THREADS`` elements of a
#: plane on the scalar path and four times that on the vector path, so the
#: scratch for the per-block partials is sized for the scalar path.
THREADS = 256

_STATE_DTYPES = (torch.float32, torch.bfloat16)


def ssd_state_scan_bwd(
    g: torch.Tensor, out: torch.Tensor, decay: torch.Tensor,
    states_dtype: torch.dtype = torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """g, out: (C, H, P, N) float32 contiguous (the prefix's gradient and the
    prefix), decay (C, H) of any float type, on one GPU.  Returns
    ``(d_states (C, H, P, N) in states_dtype, d_decay (C, H) float32)``.
    Any C, H, P, N."""
    global launches
    from repro_torch.kernels import _loader

    if g.ndim != 4 or tuple(out.shape) != tuple(g.shape) or tuple(decay.shape) != tuple(g.shape[:2]):
        raise ValueError(
            f"expected g and out (C, H, P, N) and decay (C, H); got "
            f"{tuple(g.shape)}, {tuple(out.shape)}, {tuple(decay.shape)}"
        )
    if g.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError(f"g and out must be float32, got {g.dtype} and {out.dtype}")
    if states_dtype not in _STATE_DTYPES:
        raise TypeError(f"states must be float32 or bfloat16, got {states_dtype}")
    if not decay.is_floating_point():
        raise TypeError(f"decay must be a float tensor, got {decay.dtype}")
    if not (g.is_contiguous() and out.is_contiguous()):
        raise ValueError("g and out must be contiguous")
    if not (g.is_cuda and out.is_cuda and decay.is_cuda):
        raise ValueError("ssd_state_scan_bwd launches a CUDA kernel: all inputs must be on the GPU")
    if not (out.device == g.device == decay.device):
        raise ValueError(f"g on {g.device}, out on {out.device}, decay on {decay.device}")
    C, H, P, N = g.shape
    decay = decay.to(torch.float32).contiguous()
    d_states = torch.empty(g.shape, dtype=states_dtype, device=g.device)
    if g.numel() == 0:
        return d_states, torch.zeros((C, H), dtype=torch.float32, device=g.device)
    d_decay = torch.empty((C, H), dtype=torch.float32, device=g.device)
    partial = torch.empty(C * H * -(-P * N // THREADS), dtype=torch.float32, device=g.device)
    _loader.launch(
        "dyskew_ssd_state_scan_bwd", g.device,
        g.data_ptr(), out.data_ptr(), decay.data_ptr(), d_states.data_ptr(),
        d_decay.data_ptr(), partial.data_ptr(), C, H, P * N,
        int(states_dtype == torch.bfloat16),
    )
    launches += 1
    return d_states, d_decay
