"""Plain PyTorch version of fused top-k gating."""

from __future__ import annotations

from typing import Tuple

import torch


def topk_gating_ref(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) logits → ((T, k) float32 renormalised weights, (T, k) int32
    expert ids), in descending order of probability.

    ``torch.topk`` promises no order among equal values, and the router
    must send a tie to the lower expert id, so the k picks are taken by a
    stable descending sort: equal probabilities keep their index order.
    """
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    order = torch.argsort(probs, dim=-1, descending=True, stable=True)
    idx = order[..., :k]
    w = torch.gather(probs, -1, idx)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    return w, idx.to(torch.int32)
