"""The precision of the reference's matrix products.

``Precision(None)`` leaves every operand in float32 (the reference).  The
control runs the same code with each operand of each product rounded to the
precision below the one the configuration states, products accumulated in
float32 as the tensor cores accumulate:

- ``fp8``: float8 e4m3 with one scale a tensor (amax to 448, the usual
  recipe); under autograd the gradient passes through rounded to e5m2 with
  its own scale.
- ``bf16``: bfloat16 both ways (the step below float32 on a CPU, which has
  no TF32).

Norms, softmaxes, the scan's decays and the optimizer stay in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

_FP8 = {"fwd": (torch.float8_e4m3fn, 448.0), "bwd": (torch.float8_e5m2, 57344.0)}


def _round(x: torch.Tensor, mode: str, way: str) -> torch.Tensor:
    if mode == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    dtype, top = _FP8[way]
    amax = x.detach().abs().amax().to(torch.float32)
    scale = torch.where(amax > 0, top / amax, torch.ones_like(amax))
    return ((x * scale).to(dtype).to(x.dtype) / scale).to(x.dtype)


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mode):
        ctx.mode = mode
        return _round(x, mode, "fwd")

    @staticmethod
    def backward(ctx, g):
        return _round(g, ctx.mode, "bwd"), None


class Precision:
    def __init__(self, mode: Optional[str] = None):
        if mode not in (None, "bf16", "fp8"):
            raise ValueError(f"no control precision {mode!r}")
        self.mode = mode

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.mode is None:
            return x
        return _Rounded.apply(x, self.mode)

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        return torch.einsum(eq, *[self(o) for o in ops])
