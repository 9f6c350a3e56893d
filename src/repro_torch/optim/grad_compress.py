"""Gradient compression with error feedback: symmetric per-tensor int8 with
the quantization residual carried to the next step (1-bit-Adam style).

``repro.optim.grad_compress`` also has ``allreduce_compressed``, the int8
all-reduce over a mesh axis; it waits for the multi-GPU slice (ROADMAP.md
queue A).  What is here works on one device.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch

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
