"""Gradient compression with error feedback: symmetric per-tensor int8 with
the quantization residual carried to the next step (1-bit-Adam style).

``allreduce_compressed`` is the int8 all-reduce over the data-parallel ranks
of a ``torch.distributed`` group (``repro`` reduces over a mesh axis): the
shared scale is the maximum over the ranks, the int8 payload is what is
summed (as int32, which cannot overflow below 2^23 ranks), and each rank
carries its own quantization residual to the next step.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch import distributed
from repro_torch.optim.optimizers import unzip, zip_map


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8 quantization. Returns (q, scale)."""
    g32 = g.to(torch.float32)
    amax = torch.max(torch.abs(g32))
    scale = torch.clamp(amax / 127.0, min=1e-12)
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def residual_init(params: Any) -> Any:
    return zip_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_with_feedback(grads: Any, residual: Any) -> Tuple[Any, Any, Any]:
    """Returns (quantized tree, scales tree, new residual tree).

    new_residual = (g + residual) - dequant(quant(g + residual))
    """
    def one(g, r):
        corrected = g.to(torch.float32) + r
        q, s = quantize_int8(corrected)
        return q, s, corrected - dequantize_int8(q, s)

    return unzip(zip_map(one, grads, residual), grads, 3)


def allreduce_compressed(grads: Any, residual: Any, group: distributed.Group) -> Tuple[Any, Any]:
    """int8 all-reduce over ``group`` with error feedback.

    Scales are max-reduced so all ranks dequantize identically (one
    ``all_reduce`` MAX of every leaf's amax); each leaf's int8 payload is
    summed as int32.  Returns (mean gradients float32, new residual), in
    ``repro``'s order of casts.
    """
    corrected = zip_map(lambda g, r: g.to(torch.float32) + r, grads, residual)
    leaves = []
    zip_map(leaves.append, corrected)         # zip_map's order of leaves
    amax = distributed.all_max(torch.stack([torch.max(torch.abs(c)) for c in leaves]), group)
    n = torch.tensor(float(distributed.world_size(group)), dtype=torch.float32, device=amax.device)
    scales = iter(torch.clamp(amax / 127.0, min=1e-12).unbind(0))

    def one(c):
        scale = next(scales)
        q = torch.clamp(torch.round(c / scale), -127, 127).to(torch.int8)
        new_r = c - q.to(torch.float32) * scale
        summed = distributed.all_sum_(q.to(torch.int32), group)
        return summed.to(torch.float32) * scale / n, new_r

    return unzip(zip_map(one, corrected), corrected, 2)
