"""AdamW as the configuration states it, worked out again.

The learning rate warms up linearly over ``warmup_steps`` (zero at step 0)
and decays on a cosine to ``min_lr_frac`` of ``lr`` by ``total_steps``.
The gradient is clipped to a global norm of ``grad_clip`` first.  Moments
are float32; the update is done in float32 and written back in the
parameter's own type (the configuration keeps no float32 master copy).
After ``OptimizerConfig`` and ``adamw_update`` in
``src/repro_torch/optim/optimizers.py`` at commit a36dd41.
"""

from __future__ import annotations

import math
from typing import Dict

import torch


def lr_at(opt: Dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    prog = min(max((step - opt["warmup_steps"]) / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def clip(grads: Dict[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
    norm = torch.sqrt(sum(torch.sum(g.to(torch.float32) ** 2) for g in grads.values()))
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return {k: g * scale for k, g in grads.items()}


@torch.no_grad()
def adamw(opt: Dict, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
          m: Dict[str, torch.Tensor], v: Dict[str, torch.Tensor], step: int) -> None:
    """One update, in place: ``params`` keep their type, ``m`` and ``v``
    float32.  ``grads`` are clipped already."""
    lr = lr_at(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    bc1, bc2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
    for k, p in params.items():
        g = grads[k].to(torch.float32)
        m[k].mul_(b1).add_((1 - b1) * g)
        v[k].mul_(b2).add_((1 - b2) * g * g)
        p32 = p.to(torch.float32)
        delta = (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + opt["eps"]) + opt["weight_decay"] * p32
        p.copy_((p32 - lr * delta).to(p.dtype))
