"""Launch wrapper of the CUDA backward of the MoE combine
(``dyskew_moe_combine_bwd`` in csrc/combine.cu).

A warp takes one token: it reads the token's gradient once, stores
``w[t, j] * dy[t]`` into the slot of each kept pick (a slot has at most one
pick, so no atomics) and sums each pick's gradient ``<dy[t], y_flat[slot]>``
in a fixed order; warps past the last token write zeros into the slots no
pick owns.  Every row of the slots' gradient is written once in the one
launch, and two runs give the same bits.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels.combine.kernel import check_inputs

#: Kernel launches made through this wrapper (reset by
#: ``repro_torch.kernels.reset_launch_counts``).
launches = 0

#: Unowned slots a zeroing warp writes (kZeroRows in the source).
ZERO_ROWS = 16


def moe_combine_bwd(
    dy: torch.Tensor, y_flat: torch.Tensor, slot_tk: torch.Tensor, gate_w: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dy (T, d) the gradient of the combine's output; y_flat, slot_tk and
    gate_w as ``moe_combine`` takes them (a kept slot appears once).
    Returns ``(d_y_flat (S, d) in y_flat's type, d_w (T, k) float32)``."""
    global launches
    from repro_torch.kernels import _loader

    check_inputs(y_flat, slot_tk, gate_w)
    (S, d), (T, k) = y_flat.shape, slot_tk.shape
    if tuple(dy.shape) != (T, d) or dy.dtype != y_flat.dtype:
        raise ValueError(f"dy must be ({T}, {d}) {y_flat.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    if dy.device != y_flat.device:
        raise ValueError(f"dy on {dy.device}, y_flat on {y_flat.device}")
    dy, y_flat = dy.contiguous(), y_flat.contiguous()
    slot_tk, gate_w = slot_tk.contiguous(), gate_w.contiguous()
    # The slots a kept pick owns; a dropped pick marks the extra byte S.
    owned = torch.zeros(S + 1, dtype=torch.bool, device=y_flat.device)
    owned.index_fill_(0, slot_tk.reshape(-1).to(torch.int64), True)
    d_y_flat = torch.empty((S, d), dtype=y_flat.dtype, device=y_flat.device)
    d_w = torch.empty((T, k), dtype=torch.float32, device=y_flat.device)
    if T == 0 and S == 0:
        return d_y_flat, d_w
    _loader.launch(
        "dyskew_moe_combine_bwd", y_flat.device,
        dy.data_ptr(), y_flat.data_ptr(), slot_tk.data_ptr(), gate_w.data_ptr(), owned.data_ptr(),
        d_y_flat.data_ptr(), d_w.data_ptr(), T, S, d, k, int(y_flat.dtype == torch.bfloat16),
    )
    launches += 1
    return d_y_flat, d_w
