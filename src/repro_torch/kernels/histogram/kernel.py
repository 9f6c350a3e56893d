"""Launch wrapper of the CUDA load-histogram kernel (csrc/histogram.cu).

Every DySkew decision consumes per-destination load counts — expert loads
in the MoE dispatch, per-shard token counts in the data path.  This kernel
computes ``counts[e] = |{i : ids[i] == e}|`` for E destinations with
per-block shared-memory bins merged by integer atomics, see the source.
"""

from __future__ import annotations

import torch

#: Kernel launches made through this wrapper (reset by
#: ``repro_torch.kernels.reset_launch_counts``).
launches = 0

MAX_DEST = 12288


def load_histogram(ids: torch.Tensor, *, num_dest: int) -> torch.Tensor:
    """(N,) int32 CUDA ids → (num_dest,) float32 counts.  Any N."""
    global launches
    from repro_torch.kernels import _loader

    if not ids.is_cuda:
        raise ValueError("load_histogram launches a CUDA kernel: ids must be on the GPU")
    if ids.ndim != 1:
        raise ValueError(f"ids must be (N,), got {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if not 1 <= num_dest <= MAX_DEST:
        raise ValueError(f"num_dest={num_dest} outside [1, {MAX_DEST}]")
    ids = ids.contiguous()
    # The integer bins the blocks merge into.  Freed on return, which is safe:
    # the allocator hands the block out again only to work queued behind this
    # launch on the same stream.
    scratch = torch.empty((num_dest,), dtype=torch.int32, device=ids.device)
    out = torch.empty((num_dest,), dtype=torch.float32, device=ids.device)
    _loader.launch(
        "dyskew_load_histogram", ids.device,
        ids.data_ptr(), scratch.data_ptr(), out.data_ptr(), ids.numel(), num_dest,
    )
    launches += 1
    return out
