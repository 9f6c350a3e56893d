"""Core types for the DySkew adaptive data link.

The paper models each data-link instance as an independent state machine
(Fig. 2) progressing through four phases.  States and policies are integers
so the whole machine is a handful of elementwise tensor operations that run
on the device beside the model, and the carried link state is a plain dict
of tensors with the same keys, shapes and dtypes as in ``repro``.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Dict, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device


class LinkState(enum.IntEnum):
    """States of the adaptive-link state machine (paper §III.A, Fig. 2).

    Phase 1: INIT — link configured with its policy, before data flows.
    Phase 2: DECIDING — processing locally while the skew model evaluates.
    Phase 3: DRAINING — intermediate: finish in-flight batch/file boundaries
             before committing to distributed mode.
    Phase 4: LOCAL_TERMINAL / DISTRIBUTED_TERMINAL — committed modes.
             DISTRIBUTING is the active distributed state reachable before a
             terminal commit in looping configurations.
    """

    INIT = 0
    DECIDING = 1
    DRAINING = 2
    DISTRIBUTING = 3
    LOCAL_TERMINAL = 4
    DISTRIBUTED_TERMINAL = 5

    @property
    def is_terminal(self) -> bool:
        return self in (LinkState.LOCAL_TERMINAL, LinkState.DISTRIBUTED_TERMINAL)

    @property
    def routes_remote(self) -> bool:
        """Whether a link in this state sends rows to remote instances."""
        return self in (LinkState.DISTRIBUTING, LinkState.DISTRIBUTED_TERMINAL)


NUM_STATES = len(LinkState)


class Policy(enum.IntEnum):
    """Redistribution policy declared by the consumer operator (§III.A).

    NEVER          — rows never leave the local instance (ordering / local
                     state dependencies).
    LATE           — default: process locally, redistribute only once the
                     skew model fires (N strikes).
    EARLY          — redistribute immediately; observation phase skipped.
    EAGER_SNOWPARK — the paper's Snowpark policy: EARLY + row-size/batch-
                     density guard (§III.B) + no self-skipping.
    """

    NEVER = 0
    LATE = 1
    EARLY = 2
    EAGER_SNOWPARK = 3


class SkewModelKind(enum.IntEnum):
    ROW_PERCENTAGE = 0   # Eq. (1)
    IDLE_TIME = 1
    SYNC_TIME_SLOPE = 2  # Eq. (2)


@dataclasses.dataclass(frozen=True)
class DySkewConfig:
    """Static configuration of the adaptive link (hashable)."""

    policy: Policy = Policy.LATE
    skew_model: SkewModelKind = SkewModelKind.ROW_PERCENTAGE
    # Eq. (1)/(2) threshold θ: instance i is skewed when
    #   metric_i * theta > mean(metric_{-i}).
    theta: float = 0.5
    # N-strikes framework: N consecutive detections before redistribution.
    n_strikes: int = 3
    # Idle-time model: a sibling is idle if it received no row/signal for
    # `idle_grace` ticks; skew fires when >= `idle_sibling_frac` of siblings
    # are idle while we are busy.
    idle_grace: int = 2
    idle_sibling_frac: float = 0.5
    # Sync-time-slope model: sliding window length (measurements).
    slope_window: int = 8
    # Row Size Model (§III.B): target batch density (rows/batch) and the
    # low-density trigger. Paper: normal batches carry thousands of rows;
    # heavy-row batches drop density by >99 %.
    target_batch_density: float = 4096.0
    min_batch_density_frac: float = 0.01
    # A batch counts as 'heavy-row' only if density collapsed BECAUSE rows
    # are large (>= heavy_row_bytes); small end-of-stream remainder batches
    # must not trip the guard.
    heavy_row_bytes: float = 1e6
    # Whether the local instance is a valid redistribution destination.
    # Paper §III.B removes the self-skipping logic for Snowpark.
    self_skip: bool = False
    # Looping: terminal states may re-enter DECIDING (non-looping default).
    looping: bool = False
    # Cost model: refuse a redistribution whose estimated transfer time
    # exceeds `cost_gate` × the estimated compute time saved.
    cost_gate: float = 1.0

    @property
    def min_batch_density(self) -> float:
        return self.target_batch_density * self.min_batch_density_frac

    def replace(self, **kw: Any) -> "DySkewConfig":
        return dataclasses.replace(self, **kw)


def link_metrics_zeros(
    num_instances: int, slope_window: int, device: DeviceLike = None
) -> Dict[str, torch.Tensor]:
    """Per-instance runtime metrics observed by the skew models.

    A dict of tensors shaped (num_instances, ...) so one program holds every
    sibling's view (the paper's 'state machines can observe the state of
    sibling instances').
    """
    n = num_instances
    dev = resolve_device(device)

    def zeros(*shape: int) -> torch.Tensor:
        return torch.zeros(shape, dtype=torch.float32, device=dev)

    return {
        # Cumulative rows processed by each instance (row-percentage model).
        "rows": zeros(n),
        # Ticks since each instance last received a row/signal (idle model).
        "idle_ticks": zeros(n),
        # Sliding window of per-tick synchronous processing time (slope model),
        # newest entry last.
        "sync_window": zeros(n, slope_window),
        # Rows per batch observed this tick (Row Size Model).
        "batch_density": zeros(n),
        # Bytes per row observed this tick (Row Size Model / cost model).
        "bytes_per_row": zeros(n),
    }


def link_state_init(
    num_instances: int,
    config: DySkewConfig,
    device: DeviceLike = None,
) -> Dict[str, Any]:
    """Initial carried state for `num_instances` sibling link instances."""
    n = num_instances
    dev = resolve_device(device)
    return {
        "state": torch.full((n,), int(LinkState.INIT), dtype=torch.int32, device=dev),
        "strikes": torch.zeros((n,), dtype=torch.int32, device=dev),
        "metrics": link_metrics_zeros(n, config.slope_window, dev),
        # Count of redistribution transitions committed (telemetry; feeds the
        # production-rollout benchmark's '% of queries redistributed').
        "transitions": torch.zeros((n,), dtype=torch.int32, device=dev),
        "tick": torch.zeros((), dtype=torch.int32, device=dev),
    }


@dataclasses.dataclass
class RoutingPlan:
    """Result of a redistribution decision for one tick.

    ``dest`` maps each work item to a destination instance; ``distribute``
    is the per-instance boolean saying whether that producer is in a
    remote-routing state this tick.
    """

    dest: torch.Tensor          # (num_items,) int32 destination instance ids
    distribute: torch.Tensor    # (num_instances,) bool
    est_bytes_moved: Optional[torch.Tensor] = None  # scalar, cost-model telemetry
    est_time_saved: Optional[torch.Tensor] = None   # scalar, cost-model telemetry
