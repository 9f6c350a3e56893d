"""The adaptive-link state machine (paper §III.A, Fig. 2).

Each link instance is an independent state machine; the redistribution policy
selects which transitions are reachable.  The machine is vectorized over
instances (last axis, n) and expressed with `torch.where`, so one call
advances every sibling on the device without a host round trip, and any
leading axes are independent sibling groups.

Transitions implemented (red default path + policy-gated paths):

  NEVER:            INIT → LOCAL_TERMINAL
  LATE (default):   INIT → DECIDING --N-strikes--> DRAINING → DISTRIBUTING
                    → DISTRIBUTED_TERMINAL            (non-looping commit)
                    DISTRIBUTING --N clean ticks--> DECIDING   (looping only)
  EARLY:            INIT → DISTRIBUTING → DISTRIBUTED_TERMINAL
  EAGER_SNOWPARK:   INIT → DISTRIBUTING (eager; stays adaptive)
                    DISTRIBUTING --heavy-rows & not-skewed--> LOCAL_TERMINAL
                    (the §III.B Row-Size-Model intervention)

The DRAINING state is the paper's 'intermediate state': in the engine it
completes in-flight file boundaries; in our synchronous setting it consumes
exactly one tick, which models the one-batch drain delay and keeps the
trace shape-stable.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core import skew_models
from repro_torch.core.types import DySkewConfig, LinkState, Policy


def routes_remote(state: torch.Tensor) -> torch.Tensor:
    """Per-instance bool: does this state send rows to remote instances?"""
    return torch.logical_or(
        state == int(LinkState.DISTRIBUTING),
        state == int(LinkState.DISTRIBUTED_TERMINAL),
    )


def is_terminal(state: torch.Tensor) -> torch.Tensor:
    return torch.logical_or(
        state == int(LinkState.LOCAL_TERMINAL),
        state == int(LinkState.DISTRIBUTED_TERMINAL),
    )


def _goto(cond: torch.Tensor, target: LinkState, otherwise: torch.Tensor) -> torch.Tensor:
    return torch.where(cond, torch.full_like(otherwise, int(target)), otherwise)


def _advance_never(state: torch.Tensor) -> torch.Tensor:
    return _goto(state == int(LinkState.INIT), LinkState.LOCAL_TERMINAL, state)


def _advance_late(
    state: torch.Tensor,
    fire: torch.Tensor,
    clean_fire: torch.Tensor,
    looping: bool,
) -> torch.Tensor:
    s = state
    # INIT → DECIDING
    out = _goto(s == int(LinkState.INIT), LinkState.DECIDING, s)
    # DECIDING → DRAINING on N-strikes fire
    out = _goto(
        torch.logical_and(s == int(LinkState.DECIDING), fire),
        LinkState.DRAINING,
        out,
    )
    # DRAINING → DISTRIBUTING (one-tick drain)
    out = _goto(s == int(LinkState.DRAINING), LinkState.DISTRIBUTING, out)
    if looping:
        # DISTRIBUTING → DECIDING after N consecutive clean ticks
        out = _goto(
            torch.logical_and(s == int(LinkState.DISTRIBUTING), clean_fire),
            LinkState.DECIDING,
            out,
        )
    else:
        # Non-looping: commit after one distributing tick.
        out = _goto(
            s == int(LinkState.DISTRIBUTING), LinkState.DISTRIBUTED_TERMINAL, out
        )
    return out


def _advance_early(state: torch.Tensor) -> torch.Tensor:
    s = state
    out = _goto(s == int(LinkState.INIT), LinkState.DISTRIBUTING, s)
    out = _goto(
        s == int(LinkState.DISTRIBUTING), LinkState.DISTRIBUTED_TERMINAL, out
    )
    return out


def _advance_eager_snowpark(state: torch.Tensor, heavy: torch.Tensor) -> torch.Tensor:
    s = state
    out = _goto(s == int(LinkState.INIT), LinkState.DISTRIBUTING, s)
    # §III.B: not skewed AND batch density collapsed → disable redistribution.
    out = _goto(
        torch.logical_and(s == int(LinkState.DISTRIBUTING), heavy),
        LinkState.LOCAL_TERMINAL,
        out,
    )
    return out


def advance(
    link: Dict[str, Any],
    config: DySkewConfig,
) -> Dict[str, Any]:
    """Advance every sibling instance's state machine by one tick.

    ``link`` is the dict from ``types.link_state_init`` whose ``metrics``
    have already been updated for this tick (see
    ``skew_models.update_metrics``).  Returns a new dict; nothing is
    updated in place.
    """
    state = link["state"]
    strikes = link["strikes"]
    metrics = link["metrics"]

    skewed_now = skew_models.detect_skew(metrics, config)
    fire, skew_strikes = skew_models.apply_n_strikes(
        skewed_now, strikes, config.n_strikes
    )
    # Strikes only accumulate while the machine is actively DECIDING —
    # INIT is 'before data processing begins' (paper phase 1).
    deciding = state == int(LinkState.DECIDING)
    fire = torch.logical_and(fire, deciding)
    # Clean-tick counter for looping fallback shares the strike register:
    # while DISTRIBUTING we count *clean* ticks instead of skewed ones.
    distributing = state == int(LinkState.DISTRIBUTING)
    clean_now = torch.logical_not(skewed_now)
    zero = torch.zeros_like(strikes)
    clean_strikes = torch.where(clean_now, strikes + 1, zero).to(strikes.dtype)
    clean_fire = clean_strikes >= config.n_strikes
    new_strikes = torch.where(
        deciding,
        skew_strikes,
        torch.where(distributing, clean_strikes, zero),
    )

    heavy = skew_models.heavy_row_disable(metrics, config)

    policy = config.policy
    if policy == Policy.NEVER:
        new_state = _advance_never(state)
    elif policy == Policy.LATE:
        new_state = _advance_late(state, fire, clean_fire, config.looping)
    elif policy == Policy.EARLY:
        new_state = _advance_early(state)
    elif policy == Policy.EAGER_SNOWPARK:
        new_state = _advance_eager_snowpark(state, heavy)
    else:  # pragma: no cover - config validation
        raise ValueError(f"unknown policy {policy!r}")

    became_remote = torch.logical_and(
        torch.logical_not(routes_remote(state)), routes_remote(new_state)
    )
    transitions = link["transitions"] + became_remote.to(torch.int32)

    return {
        "state": new_state.to(torch.int32),
        "strikes": new_strikes,
        "metrics": metrics,
        "transitions": transitions,
        "tick": link["tick"] + 1,
    }


def tick(
    link: Dict[str, Any],
    config: DySkewConfig,
    *,
    rows_this_tick: torch.Tensor,
    sync_time_this_tick: torch.Tensor,
    batch_density: torch.Tensor,
    bytes_per_row: torch.Tensor,
    signal_this_tick: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, Any], torch.Tensor]:
    """Full per-tick update: metrics ingest + state-machine advance.

    Returns (new_link_state, distribute_mask) where ``distribute_mask`` is
    the per-instance bool for 'this producer routes remotely this tick'.
    """
    metrics = skew_models.update_metrics(
        link["metrics"],
        rows_this_tick=rows_this_tick,
        sync_time_this_tick=sync_time_this_tick,
        batch_density=batch_density,
        bytes_per_row=bytes_per_row,
        signal_this_tick=signal_this_tick,
    )
    link = dict(link, metrics=metrics)
    new_link = advance(link, config)
    return new_link, routes_remote(new_link["state"])


def _keep_inactive(new: Any, old: Any, active: torch.Tensor) -> Any:
    if isinstance(new, dict):
        return {k: _keep_inactive(new[k], old[k], active) for k in new}
    m = active.reshape((-1,) + (1,) * (new.ndim - 1))
    return torch.where(m, new, old)


def tick_many(
    link: Dict[str, Any],
    config: DySkewConfig,
    *,
    rows_this_tick: torch.Tensor,
    sync_time_this_tick: torch.Tensor,
    batch_density: torch.Tensor,
    bytes_per_row: torch.Tensor,
    signal_this_tick: Optional[torch.Tensor] = None,
    active: Optional[torch.Tensor] = None,
) -> Tuple[Dict[str, Any], torch.Tensor]:
    """:func:`tick` batched over a leading tenant axis: ONE call advances T
    independent sibling groups (one per concurrent query/tenant).

    ``link`` is the :func:`tick` dict with every leaf stacked to a
    leading (T, ...) axis — (T, n) vectors, (T, n, W) sync windows, (T,)
    tick counters — and all metric/signal inputs are (T, n).  ``active``
    is an optional (T,) bool: inactive rows (tenants that have not arrived
    yet, or have drained) keep their prior state bit-for-bit and report an
    all-False distribute mask, so callers can pad a fixed-capacity state
    stack and mask the unused slots.

    Every sibling reduction in :func:`tick` runs over the last axis (sums
    over n, window sums over W), so the stacked call is :func:`tick` itself
    on (T, n) inputs and each row gets what the unbatched call would give
    it.
    """
    if signal_this_tick is None:
        signal_this_tick = torch.zeros_like(rows_this_tick, dtype=torch.bool)
    new_link, distribute = tick(
        link,
        config,
        rows_this_tick=rows_this_tick,
        sync_time_this_tick=sync_time_this_tick,
        batch_density=batch_density,
        bytes_per_row=bytes_per_row,
        signal_this_tick=signal_this_tick,
    )
    if active is not None:
        new_link = _keep_inactive(new_link, link, active)
        distribute = torch.logical_and(distribute, active[:, None])
    return new_link, distribute
