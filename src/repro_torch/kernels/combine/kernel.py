"""Launch wrapper of the CUDA MoE combine (``dyskew_moe_combine`` in
csrc/combine.cu).

Each token's output is the sum of its kept picks' expert outputs, weighted
by their gate weights: ``y[t] = sum_j w[t, j] * y_flat[slot[t, j]]``, in
float32 in pick order, rounded once to ``y_flat``'s type.  A dropped pick
(slot ``S``) is never read.  A warp sums one piece of one token's row; the
width of a piece follows the number of tokens and the row's size
(``launch_shape``), see the source.
"""

from __future__ import annotations

import functools

import torch

#: Kernel launches made through this wrapper (reset by
#: ``repro_torch.kernels.reset_launch_counts``).
launches = 0

#: Warps in a block of csrc/combine.cu (kWarpsPerBlock), one work item each.
WARPS_PER_BLOCK = 8
#: Picks a token at most (kMaxTopK): lane j holds pick j's slot and weight.
MAX_TOP_K = 32
WARP = 32
VECTOR_BYTES = 16
#: Warps a launch should give every SM before pieces are made narrower.
WARPS_PER_SM = 16
_DTYPES = (torch.float32, torch.bfloat16)


def launch_shape(num_tokens: int, row_bytes: int, sm_count: int) -> int:
    """16-byte vectors a lane takes in a piece of a row: 4 (a 2 KB piece)
    where the tokens' pieces give every SM ``WARPS_PER_SM`` warps, else the
    widest of 2 and 1 that does, else 1 (the most pieces)."""
    vecs = -(-row_bytes // VECTOR_BYTES)
    for u in (4, 2):
        if num_tokens * -(-vecs // (WARP * u)) >= sm_count * WARPS_PER_SM:
            return u
    return 1


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def check_inputs(y_flat: torch.Tensor, slot_tk: torch.Tensor, gate_w: torch.Tensor) -> None:
    """The combine's inputs, for both kernels: shapes, types, one GPU."""
    if y_flat.ndim != 2 or slot_tk.ndim != 2 or tuple(gate_w.shape) != tuple(slot_tk.shape):
        raise ValueError(
            f"expected y_flat (S, d), slot_tk (T, k) and gate_w (T, k); got "
            f"{tuple(y_flat.shape)}, {tuple(slot_tk.shape)}, {tuple(gate_w.shape)}"
        )
    if y_flat.dtype not in _DTYPES:
        raise TypeError(f"y_flat must be float32 or bfloat16, got {y_flat.dtype}")
    if slot_tk.dtype != torch.int32:
        raise TypeError(f"slot_tk must be int32, got {slot_tk.dtype}")
    if gate_w.dtype != torch.float32:
        raise TypeError(f"gate_w must be float32, got {gate_w.dtype}")
    if not 1 <= slot_tk.shape[1] <= MAX_TOP_K:
        raise ValueError(f"top-k must be in [1, {MAX_TOP_K}], got {slot_tk.shape[1]}")
    if y_flat.shape[1] < 1 or y_flat.shape[0] >= 2**31:
        raise ValueError(f"y_flat must have rows of at least one element and under 2^31 slots, "
                         f"got {tuple(y_flat.shape)}")
    if not (y_flat.is_cuda and slot_tk.is_cuda and gate_w.is_cuda):
        raise ValueError("the combine launches a CUDA kernel: all inputs must be on the GPU")
    if not (y_flat.device == slot_tk.device == gate_w.device):
        raise ValueError(f"y_flat on {y_flat.device}, slot_tk on {slot_tk.device}, gate_w on {gate_w.device}")


def moe_combine(y_flat: torch.Tensor, slot_tk: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """y_flat (S, d) float32 or bfloat16, slot_tk (T, k) int32 (a slot in
    [0, S), or S for a dropped pick), gate_w (T, k) float32, on one GPU.
    Returns y (T, d) in y_flat's type."""
    global launches
    from repro_torch.kernels import _loader

    check_inputs(y_flat, slot_tk, gate_w)
    (S, d), (T, k) = y_flat.shape, slot_tk.shape
    y_flat, slot_tk, gate_w = y_flat.contiguous(), slot_tk.contiguous(), gate_w.contiguous()
    y = torch.empty((T, d), dtype=y_flat.dtype, device=y_flat.device)
    if T == 0:
        return y
    _loader.launch(
        "dyskew_moe_combine", y_flat.device,
        y_flat.data_ptr(), slot_tk.data_ptr(), gate_w.data_ptr(), y.data_ptr(), T, S, d, k,
        int(y_flat.dtype == torch.bfloat16),
        launch_shape(T, d * y_flat.element_size(), _sm_count(y_flat.device.index)),
    )
    launches += 1
    return y
