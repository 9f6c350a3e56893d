"""Launch wrapper of the CUDA load-histogram kernel (csrc/histogram.cu).

Every DySkew decision consumes per-destination load counts — expert loads
in the MoE dispatch, per-shard token counts in the data path.  This kernel
computes ``counts[e] = |{i : ids[i] == e}|`` for E destinations in one
launch: one block for few ids, else one thread-block cluster whose blocks
merge their shared-memory bins through distributed shared memory, see the
source.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: Kernel launches made through this wrapper (reset by
#: ``repro_torch.kernels.reset_launch_counts``).
launches = 0

MAX_DEST = 12288
#: Up to this many ids one block counts them all: a cluster's launch and its
#: two barriers cost more than one block's extra loads below it (measured on
#: an H100, see PERF.md).
SINGLE_BLOCK_MAX = 32768
#: Ids per block of a cluster, and the most blocks in one (csrc/histogram.cu's
#: kMaxCluster, above the portable 8).
IDS_PER_CLUSTER_BLOCK = 8192
MAX_CLUSTER = 16
MAX_THREADS = 1024


def launch_shape(n: int, num_dest: int) -> Tuple[int, int]:
    """(cluster_blocks, threads) for ``n`` ids over ``num_dest`` bins.

    Up to ``SINGLE_BLOCK_MAX`` ids: one block, with a thread for every four
    ids (one 16-byte vector) or for every bin, whichever is more, at least
    256 and at most 1024.  Above: one cluster of 1024-thread blocks, a block
    for every ``IDS_PER_CLUSTER_BLOCK`` ids, at most ``MAX_CLUSTER``."""
    if n <= SINGLE_BLOCK_MAX:
        want = max(-(-n // 4), num_dest, 256)
        return 1, min(MAX_THREADS, -(-want // 32) * 32)
    return min(MAX_CLUSTER, -(-n // IDS_PER_CLUSTER_BLOCK)), MAX_THREADS


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
    out = torch.empty((num_dest,), dtype=torch.float32, device=ids.device)
    _loader.launch(
        "dyskew_load_histogram", ids.device,
        ids.data_ptr(), out.data_ptr(), ids.numel(), num_dest,
        *launch_shape(ids.numel(), num_dest),
    )
    launches += 1
    return out
