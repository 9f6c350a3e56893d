"""Launch wrapper of the CUDA attention forward (``dyskew_attention_fwd`` in
csrc/attention.cu).

``out[b, i, h] = sum_j p[i, j] v[b, j, h // G]``, ``p`` the softmax over the
kept keys of ``hd ** -0.5 * <q[b, i, h], k[b, j, h // G]>``: keys ``j <
kv_len``, and where causal those with ``j <= q_offset + i``.  The scores
stay float32 in registers with a running maximum and sum; the
probabilities are rounded to the working type for the product with v.  A
block takes 128 queries of one head and streams 64 keys at a time, see the
source.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

#: Kernel launches made through this wrapper (reset by
#: ``repro_torch.kernels.reset_launch_counts``).
launches = 0

#: The head widths and working types the kernel is built for.
HEAD_DIMS = (64, 128)
DTYPES = (torch.bfloat16, torch.float16)
#: Queries a block (kBlockM in csrc/attention.cu).
BLOCK_Q = 128
_LOG2E = 1.0 / math.log(2.0)


def _fits(t: torch.Tensor) -> bool:
    """Readable in place: the head width contiguous, every other stride a
    whole number of 16-byte pieces."""
    return t.stride(-1) == 1 and all(s % 8 == 0 for s in t.stride()[:-1])


def attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                  q_offset: int = 0, kv_len: Optional[int] = None) -> torch.Tensor:
    """q (B, Sq, H, hd); k, v (B, Skv, K, hd) with K dividing H (query head h
    reads kv head h // (H // K)); all bf16 or all fp16 on one GPU, hd 64 or
    128.  k and v are read in place through their strides (a KV cache's
    first ``kv_len`` positions).  Returns (B, Sq, H, hd), contiguous."""
    global launches
    from repro_torch.kernels import _loader

    if q.ndim != 4 or k.ndim != 4 or tuple(k.shape) != tuple(v.shape):
        raise ValueError(f"expected q (B, Sq, H, hd) and k, v (B, Skv, K, hd); got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    (B, Sq, H, hd), (_, Skv, K, _) = q.shape, k.shape
    if k.shape[0] != B or k.shape[3] != hd or K < 1 or H % K != 0:
        raise ValueError(f"q {tuple(q.shape)} does not match k and v {tuple(k.shape)}")
    if q.dtype not in DTYPES or not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q, k and v must all be bfloat16 or all float16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"the kernel is built for head widths {HEAD_DIMS}, got {hd}")
    kv_len = Skv if kv_len is None else kv_len
    if not isinstance(kv_len, int) or not isinstance(q_offset, int):
        raise TypeError("q_offset and kv_len must be Python ints")
    if not 1 <= kv_len <= Skv or q_offset < 0:
        raise ValueError(f"kv_len {kv_len} must lie in [1, {Skv}], q_offset {q_offset} must be >= 0")
    if B * Sq * H >= 2**31:
        raise ValueError(f"B * Sq * H = {B * Sq * H} rows of the output: at most 2**31 - 1")
    if not (q.is_cuda and k.is_cuda and v.is_cuda):
        raise ValueError("the attention kernel launches a CUDA kernel: all inputs must be on the GPU")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if not all(_fits(t) and t.data_ptr() % 16 == 0 for t in (q, k, v)):
        raise ValueError("q, k and v must have the head width contiguous, their other strides multiples "
                         "of 8 elements and their bases on a 16-byte boundary")
    out = torch.empty((B, Sq, H, hd), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    _loader.launch(
        "dyskew_attention_fwd", q.device,
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, H, H // K, hd,
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), q_offset, kv_len, int(causal),
        hd ** -0.5 * _LOG2E, int(q.dtype == torch.float16),
    )
    launches += 1
    return out
