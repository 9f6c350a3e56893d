"""The MoE layer's link and capacity rule, as the configuration states them.

A plain copy of what ``src/repro_torch/models/layers/moe.py`` (``capacities``,
``moe_dyskew_config``, the effective capacity) and
``src/repro_torch/core/state_machine.py`` (``tick`` under
``Policy.EAGER_SNOWPARK``) decide at commit a36dd41, worked out again here.

One link instance per expert-parallel shard, carried across a training
run's steps (a serving call starts a fresh one).  The eager policy
distributes from its first tick on; the §III.B heavy-row guard would stop it
only for batches that are sparse (density under 4096 × 0) AND made of large
rows (at least ``inf`` bytes), which token rows never are, so the
idle-time conjunct of the guard is not needed here.  While a shard
distributes, its experts get load-proportional capacities inside the same
budget, from an exponential average of the expert loads; a static shard
keeps the uniform capacity.  A pick is kept when its rank among its
expert's picks, in token order, is under that expert's capacity.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

INIT, DISTRIBUTING, LOCAL_TERMINAL, DISTRIBUTED_TERMINAL = 0, 3, 4, 5
TARGET_BATCH_DENSITY = 4096.0
MIN_BATCH_DENSITY_FRAC = 0.0
HEAVY_ROW_BYTES = float("inf")


def capacities(capacity_factor: float, tokens: int, top_k: int, experts: int, adaptive: bool) -> Tuple[int, int]:
    """(uniform capacity, buffer capacity with the link's 2x headroom)."""
    c_static = max(1, int(capacity_factor * tokens * top_k / experts))
    return c_static, c_static * (2 if adaptive else 1)


def link_init(shards: int, experts: int, device) -> Dict[str, torch.Tensor]:
    return {"state": torch.full((shards,), INIT, dtype=torch.int32, device=device),
            "ema": torch.full((experts,), 1.0 / experts, dtype=torch.float32, device=device)}


def tick(link: Dict[str, torch.Tensor], loads: torch.Tensor, d_model: int, adaptive: bool):
    """One tick on this call's expert loads (E,) float32: (new link, the
    shards' distribute mask)."""
    shards = link["state"].shape[0]
    shard_loads = loads.reshape(shards, -1).sum(dim=-1)
    state = link["state"]
    if adaptive:
        new = torch.where(state == INIT, torch.full_like(state, DISTRIBUTING), state)
        sparse = (shard_loads > 0) & (shard_loads < TARGET_BATCH_DENSITY * MIN_BATCH_DENSITY_FRAC)
        large = torch.full_like(sparse, 2.0 * d_model >= HEAVY_ROW_BYTES)
        new = torch.where((state == DISTRIBUTING) & sparse & large, torch.full_like(state, LOCAL_TERMINAL), new)
    else:
        new = torch.where(state == INIT, torch.full_like(state, LOCAL_TERMINAL), state)
    distribute = (new == DISTRIBUTING) | (new == DISTRIBUTED_TERMINAL)
    total = torch.clamp(loads.sum(), min=1.0)
    ema = 0.9 * link["ema"] + 0.1 * loads / total
    return {"state": new, "ema": ema}, distribute


def expert_capacity(ema: torch.Tensor, distribute: torch.Tensor, c_static: int, c_buf: int) -> torch.Tensor:
    """(E,) int64 capacities: load-proportional (half-to-even rounding)
    where the expert's shard distributes, else uniform."""
    E = ema.shape[0]
    adaptive = torch.clamp(torch.round(ema * E * c_static), 1, c_buf).to(torch.int64)
    shard_of = torch.arange(E, device=ema.device) // (E // distribute.shape[0])
    return torch.where(distribute[shard_of], adaptive, torch.full_like(adaptive, c_static))


def kept(picks: torch.Tensor, cap: torch.Tensor) -> torch.Tensor:
    """(T, k) expert ids → (T, k) bool: each expert keeps its first
    ``cap[e]`` picks in token order."""
    flat = picks.reshape(-1).to(torch.int64)
    E = cap.shape[0]
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=E)
    start = torch.cumsum(counts, 0) - counts
    rank = torch.arange(flat.numel(), device=flat.device) - start[flat[order]]
    keep = torch.empty_like(flat, dtype=torch.bool)
    keep[order] = rank < cap[flat[order]]
    return keep.reshape(picks.shape)
