"""Plain PyTorch version of fused top-k gating."""

from __future__ import annotations

from typing import Tuple

import torch


def topk_gating_ref(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) logits → ((T, k) float32 renormalised weights, (T, k) int32
    expert ids), in descending order of probability.  float64 logits stay
    float64 (for ``gradcheck``).

    ``torch.topk`` promises no order among equal values, and the router
    must send a tie to the lower expert id, so the k picks are taken by a
    stable descending sort: equal probabilities keep their index order.
    """
    probs = gate_probs(logits)
    order = torch.argsort(probs, dim=-1, descending=True, stable=True)
    idx = order[..., :k]
    return renormalise(probs, idx), idx.to(torch.int32)


def gate_probs(logits: torch.Tensor) -> torch.Tensor:
    """The router's softmax in float32 (float64 stays float64)."""
    return torch.softmax(logits.to(torch.promote_types(logits.dtype, torch.float32)), dim=-1)


def renormalise(probs: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The picks' probabilities, gathered at ``idx`` and renormalised to sum
    to 1, as the reference does after its top-k."""
    w = torch.gather(probs, -1, idx.to(torch.int64))
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
