"""Plain PyTorch version of the dispatch gather."""

from __future__ import annotations

import torch


def dispatch_gather_ref(x: torch.Tensor, src: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(T, D) × (S,) × (S,) → (S, D); invalid slots zeroed."""
    rows = x[src.to(torch.int64)]
    return rows * (valid != 0).to(x.dtype)[:, None]
