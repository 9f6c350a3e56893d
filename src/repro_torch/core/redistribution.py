"""Routing planners: how redistributed rows are assigned to destinations.

The paper's *previous* solution — static round-robin across all Python
interpreter processes (§II.B, Fig. 1) — is kept as the legacy baseline.
DySkew routes by observed load instead.  Three planners:

  round_robin   — the legacy static strategy (baseline in every benchmark).
  lpt_greedy    — Longest-Processing-Time greedy: sort items by estimated
                  cost descending, assign each to the least-loaded
                  destination (exact greedy, one step per item).
  zigzag        — vectorized near-LPT: sort descending, snake the sorted
                  items across destinations (no loop; O(n log n), the
                  default for large item counts).

All planners accept a per-destination eligibility mask so the same code
expresses the paper's self-skip ablation (§III.B 'Forced Remote
Distribution') and locality restrictions.

Everything runs on the device of the tensors it is given and never waits
for it: shapes do not depend on the data.  Sorts are stable (the reference's
are), so tied costs keep item order, and loads are summed in item order
(``ordered_sums.scatter_add``), so the card and the host give the same
plan.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.ordered_sums import scatter_add

_NEG = -1e30

IntLike = Union[int, torch.Tensor]


def _eligible_ids(eligible: torch.Tensor, fill: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The eligible destination ids in increasing order, padded to (n,) with
    ``fill`` (a fixed-shape ``nonzero``), and the count of eligible ones."""
    n = eligible.shape[0]
    ids = torch.argsort(torch.logical_not(eligible).to(torch.int8), stable=True)
    count = torch.sum(eligible.to(torch.int32))
    pos = torch.arange(n, device=eligible.device)
    ids = torch.where(pos < count, ids, torch.full_like(ids, fill))
    return ids.to(torch.int32), count


def _scatter_set(order: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``zeros.at[order].set(values)`` for a permutation ``order``."""
    out = torch.empty_like(values)
    out[order] = values
    return out


def round_robin(
    num_items: int,
    num_instances: int,
    offset: IntLike = 0,
    eligible: Optional[torch.Tensor] = None,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Legacy static assignment: item k → (offset + k) mod n over eligible
    destinations. With a full eligibility mask this is exactly Fig. 1.
    Runs on ``eligible``'s device, else on ``device``."""
    dev = eligible.device if eligible is not None else resolve_device(device)
    off = torch.as_tensor(offset, dtype=torch.int32).to(dev)
    idx = torch.arange(num_items, dtype=torch.int32, device=dev) + off
    if eligible is None:
        return idx % num_instances
    # Map the cyclic index into the compacted eligible set.
    elig_ids, count = _eligible_ids(eligible, fill=num_instances - 1)
    n_elig = torch.clamp(count, min=1)
    return elig_ids[(idx % n_elig).long()]


def lpt_greedy(
    costs: torch.Tensor,
    num_instances: int,
    base_loads: Optional[torch.Tensor] = None,
    eligible: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact LPT greedy. Returns (dest, final_loads).

    Sequential in the number of items (a few launches per item); use for
    moderate item counts (requests, batches) — tokens should use
    :func:`zigzag`.
    """
    n = num_instances
    dev = costs.device
    loads = (
        torch.zeros((n,), dtype=torch.float32, device=dev)
        if base_loads is None else base_loads.to(torch.float32).clone()
    )
    mask = (
        torch.zeros((n,), dtype=torch.float32, device=dev)
        if eligible is None
        else torch.where(  # +1e30 for ineligible
            eligible,
            torch.zeros((), dtype=torch.float32, device=dev),
            torch.full((), -_NEG, dtype=torch.float32, device=dev),
        )
    )
    order = torch.argsort(-costs, stable=True)
    sorted_costs = costs[order].to(torch.float32)

    num_items = costs.shape[0]
    dests_sorted = torch.empty((num_items,), dtype=torch.int64, device=dev)
    for i in range(num_items):
        # argmin returns the first minimum, as jnp.argmin does; one item
        # lands on one slot, so the add has no order to keep.
        d = torch.argmin(loads + mask).reshape(1)
        loads.scatter_add_(0, d, sorted_costs[i:i + 1])
        dests_sorted[i:i + 1] = d
    dest = _scatter_set(order, dests_sorted.to(torch.int32))
    return dest, loads


def zigzag(
    costs: torch.Tensor,
    num_instances: int,
    base_loads: Optional[torch.Tensor] = None,
    eligible: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized near-LPT ('boustrophedon') assignment.

    Sort items by cost descending; walk destinations 0..n-1, n-1..0, ... so
    each pass pairs a heavy item with the destination that got a light one
    on the previous pass.  Ineligible destinations are excised by mapping
    the snake over the compacted eligible set.  Destination ranks are
    rotated by the rank of each destination's base load so pre-loaded
    instances receive the lighter items first.
    """
    n = num_instances
    dev = costs.device
    num_items = costs.shape[0]
    order = torch.argsort(-costs, stable=True)

    if eligible is None:
        elig_ids = torch.arange(n, dtype=torch.int32, device=dev)
        ne = torch.full((), n, dtype=torch.int32, device=dev)
    else:
        elig_ids, count = _eligible_ids(eligible, fill=0)
        ne = torch.clamp(count, min=1)

    k = torch.arange(num_items, dtype=torch.int32, device=dev)
    pass_idx = torch.div(k, ne, rounding_mode="floor")
    pos = k % ne
    snaked = torch.where(pass_idx % 2 == 0, pos, ne - 1 - pos).long()

    if base_loads is not None:
        # Least-loaded eligible destination should receive the heaviest item.
        loads_e = base_loads[elig_ids.long()]
        if eligible is not None:
            slot = torch.arange(n, device=dev)
            loads_e = torch.where(slot < ne, loads_e, torch.full_like(loads_e, float("inf")))
        rank = torch.argsort(torch.argsort(loads_e, stable=True), stable=True)
        inv = torch.argsort(rank, stable=True)
        snaked = inv[snaked]

    dest_sorted = elig_ids[snaked]
    dest = _scatter_set(order, dest_sorted)

    loads0 = (
        torch.zeros((n,), dtype=torch.float32, device=dev)
        if base_loads is None else base_loads.to(torch.float32)
    )
    final_loads = scatter_add(loads0, dest, costs.to(torch.float32))
    return dest, final_loads


def eligibility_mask(
    num_instances: int,
    self_id: IntLike,
    self_skip: bool,
    device: DeviceLike = None,
) -> torch.Tensor:
    """Destination eligibility for a given producer.

    ``self_skip=True`` reproduces the generalized framework's forced-remote
    behavior; ``False`` is the paper's Snowpark optimization (local worker is
    a valid destination → no self-exclusion bias)."""
    dev = resolve_device(device)
    mask = torch.ones((num_instances,), dtype=torch.bool, device=dev)
    if self_skip:
        mask[torch.as_tensor(self_id).to(dev).long()] = False
    return mask


def local_assignment(
    num_items: int, self_id: IntLike, device: DeviceLike = None
) -> torch.Tensor:
    """The default 1:1 producer→consumer link: everything stays local."""
    dev = resolve_device(device)
    sid = torch.as_tensor(self_id, dtype=torch.int32).to(dev)
    return sid.expand(num_items).clone()


def makespan(dest: torch.Tensor, costs: torch.Tensor, num_instances: int) -> torch.Tensor:
    """Max per-destination load — the quantity skew mitigation minimizes."""
    zeros = torch.zeros((num_instances,), dtype=torch.float32, device=costs.device)
    loads = scatter_add(zeros, dest, costs.to(torch.float32))
    return torch.max(loads)
