"""Batched adaptive-link driver: ONE call ticks every tenant.

The per-tenant `AdaptiveLinkSim` in `repro_torch.sim.engine` pays one
tick call per tenant per metrics tick, so the tick overhead of
`MultiQuerySimulator.run` grows linearly with the number of concurrent
queries and dominates the event loop at N≳64 tenants.  This module holds
the scaling fix: all tenants' link state is stacked into a single
``(T, n)`` dict of tensors on the device (T tenants × n sibling link
instances) and the whole fleet advances through ONE
`state_machine.tick_many` call per shared virtual-time tick.

Key properties:

  * Fixed-capacity padding.  ``BatchedLinkSim`` rounds its tenant
    capacity up to a power of two and masks the unused rows, as the
    reference does to share compiled ticks across suites; the padded
    rows never advance and never distribute.
  * Inactive-row masking.  A (T,) ``active`` mask freezes the state of
    tenants that have not arrived yet (or have drained) bit-for-bit and
    forces their distribute mask to False — the event loop keeps ONE
    shared tick cadence and simply masks who participates.
  * Bit-exact rows.  Every sibling reduction of `tick_many` runs over
    the last axis in index order, so row ``i`` of the stacked tick is
    bit-identical to the unbatched `AdaptiveLinkSim` call fed the same
    inputs.  Combined with on-grid arrivals (every member's arrival an
    exact value of the group's chained tick grid — identical arrivals
    are the trivial case), the whole multi-link group ticks at precisely
    its per-tenant instants, which is why the engine's auto default
    batches such groups without disturbing the legacy equivalence bar;
    see `engine._arrivals_on_grid` for the envelope check.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import state_machine
from repro_torch.core.types import DySkewConfig, link_state_init
from repro_torch.models.convert import state_from_numpy
from repro_torch.models.param import tree_map


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length() if x > 1 else 1


def _stacked_link_state(
    capacity: int, n: int, cfg: DySkewConfig, device: torch.device
) -> Dict[str, Any]:
    """(T, ...) stack of `types.link_state_init` trees on ``device``: one
    row per tenant slot, same leaves and dtypes by construction (derived
    from the canonical tree, so a new metric leaf cannot silently desync
    the batched layout).  Valid because every leaf of the initial state
    is zero (LinkState.INIT == 0)."""
    template = link_state_init(n, cfg, "cpu")
    stacked = tree_map(
        lambda x: np.zeros((capacity,) + tuple(x.shape), x.numpy().dtype), template
    )
    return state_from_numpy(stacked, device)


class BatchedLinkSim:
    """Host-side wrapper advancing the link state machines of T tenants
    (each with n sibling producer link instances) in ONE call on
    ``device`` (``None``: the GPU).

    The drop-in batched counterpart of `engine.AdaptiveLinkSim`: tenant
    row ``i`` of a tick is bit-identical to what an independent
    `AdaptiveLinkSim` fed the same per-tick inputs would produce, and
    rows masked inactive do not advance at all.
    """

    def __init__(
        self, cfg: DySkewConfig, n: int, num_tenants: int, device: DeviceLike = None
    ):
        self.cfg = cfg
        self.n = n
        self.num_tenants = num_tenants
        self.device = resolve_device(device)
        # Padded to a power of two, as the reference pads to share compiles.
        self.capacity = _next_pow2(num_tenants)
        self.state = _stacked_link_state(self.capacity, n, cfg, self.device)

    def _pad(self, x: np.ndarray, dtype) -> torch.Tensor:
        """Cast on the host, pad to the capacity, then move: the inputs
        reach the device already float32 (or bool), as in the reference."""
        t = len(x)
        if t == self.capacity:
            out = np.array(x, dtype)   # a copy: x may be a read-only view
        else:
            out = np.zeros((self.capacity,) + np.shape(x)[1:], dtype)
            out[:t] = x
        return torch.from_numpy(out).to(self.device)

    def tick(
        self,
        rows: np.ndarray,      # (T, n) float
        sync: np.ndarray,      # (T, n) float
        density: np.ndarray,   # (T, n) float
        bpr: np.ndarray,       # (T, n) float
        signal: np.ndarray,    # (T, n) or (n,) bool
        active: np.ndarray,    # (T,) bool
    ) -> np.ndarray:
        """Advance the active tenants one tick; returns the (T, n) bool
        distribute mask (False rows for inactive tenants)."""
        t = self.num_tenants
        signal = np.asarray(signal, bool)
        if signal.ndim == 1:
            signal = np.broadcast_to(signal, (t, self.n))
        self.state, distribute = state_machine.tick_many(
            self.state,
            self.cfg,
            rows_this_tick=self._pad(rows, np.float32),
            sync_time_this_tick=self._pad(sync, np.float32),
            batch_density=self._pad(density, np.float32),
            bytes_per_row=self._pad(bpr, np.float32),
            signal_this_tick=self._pad(signal, bool),
            active=self._pad(active, bool),
        )
        return distribute.cpu().numpy()[:t]

    @property
    def states(self) -> np.ndarray:
        return self.state["state"].cpu().numpy()[:self.num_tenants]

    @property
    def transitions(self) -> np.ndarray:
        return self.state["transitions"].cpu().numpy()[:self.num_tenants]

    @property
    def ticks(self) -> np.ndarray:
        """Per-tenant count of (unmasked) ticks applied."""
        return self.state["tick"].cpu().numpy()[:self.num_tenants]
