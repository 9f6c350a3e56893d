"""AdaptiveLink — the paper's adaptive data link, as a reusable primitive.

Ties together the per-instance state machines (`state_machine`), the skew
models (`skew_models`), the routing planners (`redistribution`) and the
on-device cost gate (`admission.admit_redistribution`) for the generic
setting:

    n producer instances each hold a set of work items; each item has an
    estimated cost (seconds of downstream compute) and a size (bytes to
    move it).  Once per tick the link decides, per instance, whether that
    instance keeps its items local or redistributes them, and — if so —
    where each item goes.

This host-level orchestration is used directly by the data pipeline
(items = packed sequences) and the serving scheduler (items = requests).
The MoE layer re-uses the state machine in its own on-device form (see
`repro_torch.models.layers.moe`).

Everything here is functionally pure and shape-static: one step runs on the
link's device without waiting for it.  Per-producer and per-destination
loads are summed in item order (``ordered_sums.scatter_add``), so the plan
on the card is the plan on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import admission, redistribution, state_machine
from repro_torch.core.ordered_sums import scatter_add, sum_windows
from repro_torch.core.types import DySkewConfig, RoutingPlan, link_state_init


@dataclasses.dataclass(frozen=True)
class AdaptiveLinkConfig:
    dyskew: DySkewConfig = dataclasses.field(default_factory=DySkewConfig)
    cost: admission.CostModelConfig = dataclasses.field(
        default_factory=admission.CostModelConfig
    )
    # Estimated per-item compute used for batch-density normalization when a
    # producer holds zero items this tick.
    num_instances: int = 8


class AdaptiveLink:
    """Functional adaptive link over ``num_instances`` sibling instances,
    with its state and plans on ``device`` (``None``: the GPU)."""

    def __init__(self, config: AdaptiveLinkConfig, device: DeviceLike = None):
        self.config = config
        self.n = config.num_instances
        self.device = resolve_device(device)

    def init_state(self) -> Dict[str, Any]:
        return link_state_init(self.n, self.config.dyskew, self.device)

    # ------------------------------------------------------------------ #

    def _per_producer_metrics(
        self,
        item_costs: torch.Tensor,
        item_sizes: torch.Tensor,
        item_producer: torch.Tensor,
        item_valid: torch.Tensor,
    ) -> Dict[str, torch.Tensor]:
        zeros = torch.zeros((self.n,), dtype=torch.float32, device=self.device)
        w = item_valid.to(torch.float32)
        rows = scatter_add(zeros, item_producer, w)
        sync = scatter_add(zeros, item_producer, w * item_costs.to(torch.float32))
        byts = scatter_add(zeros, item_producer, w * item_sizes.to(torch.float32))
        # One tick == one ingest batch per producer → density = rows/batch.
        density = rows
        bytes_per_row = torch.where(
            rows > 0, byts / torch.clamp(rows, min=1.0), torch.zeros_like(rows)
        )
        return dict(
            rows=rows, sync=sync, density=density, bytes_per_row=bytes_per_row
        )

    def step(
        self,
        link: Dict[str, Any],
        item_costs: torch.Tensor,
        item_sizes: torch.Tensor,
        item_producer: torch.Tensor,
        item_valid: Optional[torch.Tensor] = None,
    ) -> Tuple[Dict[str, Any], RoutingPlan]:
        """One link tick.

        Args:
          link: carried state from :meth:`init_state`.
          item_costs: (num_items,) estimated downstream compute seconds.
          item_sizes: (num_items,) bytes to move each item.
          item_producer: (num_items,) int32 owning instance per item.
          item_valid: (num_items,) bool; padding slots are False.

        Every tensor lies on the link's device.  Returns
        (new_link_state, RoutingPlan).
        """
        cfg = self.config.dyskew
        n = self.n
        dev = self.device
        num_items = item_costs.shape[0]
        if item_valid is None:
            item_valid = torch.ones((num_items,), dtype=torch.bool, device=dev)
        producer = item_producer.to(torch.int32)
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        costs_f32 = item_costs.to(torch.float32)

        per = self._per_producer_metrics(
            item_costs, item_sizes, producer, item_valid
        )

        link, distribute = state_machine.tick(
            link,
            cfg,
            rows_this_tick=per["rows"],
            sync_time_this_tick=per["sync"],
            batch_density=per["density"],
            bytes_per_row=per["bytes_per_row"],
        )

        # ---- Routing plan -------------------------------------------- #
        item_distributes = torch.logical_and(distribute[producer.long()], item_valid)
        plan_costs = torch.where(item_distributes, costs_f32, zero)

        # Base load: cost that is pinned to its producer (non-moving items).
        pinned = torch.logical_and(item_valid, torch.logical_not(item_distributes))
        zeros_n = torch.zeros((n,), dtype=torch.float32, device=dev)
        base_loads = scatter_add(zeros_n, producer, torch.where(pinned, costs_f32, zero))

        dest_moved, loads_after = redistribution.zigzag(
            plan_costs, n, base_loads=base_loads
        )
        if cfg.self_skip:
            # Forced-remote ablation: an item may not land on its producer.
            collide = dest_moved == producer
            dest_moved = torch.where(collide, (dest_moved + 1) % n, dest_moved)

        dest = torch.where(item_distributes, dest_moved, producer).to(torch.int32)

        # ---- Cost gate ------------------------------------------------ #
        valid_costs = torch.where(item_valid, costs_f32, zero)
        loads_before = scatter_add(zeros_n, producer, valid_costs)
        moved = torch.logical_and(dest != producer, item_valid)
        bytes_moved = sum_windows(
            torch.where(moved, item_sizes.to(torch.float32), zero)
        )
        items_moved = torch.sum(moved.to(torch.int32))
        loads_planned = scatter_add(zeros_n, dest, valid_costs)
        ok, saved, t_move = admission.admit_redistribution(
            loads_before, loads_planned, bytes_moved, items_moved,
            self.config.cost,
        )
        dest = torch.where(ok, dest, producer).to(torch.int32)

        plan = RoutingPlan(
            dest=dest,
            distribute=torch.logical_and(distribute, ok),
            est_bytes_moved=torch.where(ok, bytes_moved, zero),
            est_time_saved=torch.where(ok, saved, zero),
        )
        return link, plan


def apply_plan_host(items: Any, plan: RoutingPlan, num_instances: int) -> List[list]:
    """Host-side helper: bucket items by destination (python lists).

    For the simulator and data pipeline; a multi-device path moves data
    with an all-to-all instead.
    """
    dest = plan.dest.cpu().numpy()
    return [
        [items[i] for i in np.nonzero(dest == d)[0]] for d in range(num_instances)
    ]
