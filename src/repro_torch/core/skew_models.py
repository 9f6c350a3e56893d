"""Skew-detection models (paper §III.A) + the Row Size Model (§III.B).

All models consume the sibling-observable metrics dict produced by
``repro_torch.core.types.link_metrics_zeros`` and return a per-instance
boolean ``skewed`` vector.  Every sibling reduction runs over the last
axis, so the same functions serve one sibling group, shape (n,), and a
stack of independent groups, shape (T, n), without a batching transform.

The N-strikes framework wraps any model: skew must be detected N consecutive
ticks before a redistribution transition is allowed, which suppresses
transient fluctuations (paper: 'reduces sensitivity to transient
fluctuations and avoids false positives').

Every float sum adds in index order and every division by a count is
rounded once (``ordered_sums``), as XLA does on the host for these short
axes, so the card, the host and ``repro`` reach the same bits.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.core.ordered_sums import div, sum_all, sum_last
from repro_torch.core.types import DySkewConfig, SkewModelKind


def _mean_of_others(x: torch.Tensor) -> torch.Tensor:
    """mean(x_{-i}) for every i over the last axis, shape-preserving.

    With n==1 there are no siblings; returns +inf so no instance ever
    reports skew against an empty sibling set.
    """
    n = x.shape[-1]
    if n <= 1:
        return torch.full_like(x, float("inf"))
    total = sum_last(x, keepdim=True)
    return div(total - x, n - 1)


def row_percentage_skew(metrics: Dict[str, torch.Tensor], theta: float) -> torch.Tensor:
    """Eq. (1):  R_i · θ > mean(R_{-i}).

    θ ∈ (0, 1]; smaller θ demands a larger imbalance before firing
    (θ = 0.5 fires when an instance holds >2× the sibling-average rows).
    """
    rows = metrics["rows"]
    return rows * theta > _mean_of_others(rows)


def idle_time_skew(
    metrics: Dict[str, torch.Tensor],
    idle_grace: float,
    idle_sibling_frac: float,
) -> torch.Tensor:
    """Idle-time model: instance i is skewed if it is busy while a
    threshold fraction of its siblings sit idle.

    'An instance is considered idle if it has not received a row or signal
    for a configurable period. If the number of idle siblings exceeds a
    threshold, the current instance is considered skewed.'
    Directly measures resource under-utilization — the model the paper calls
    most effective for UDF-like variable per-row costs.
    """
    idle = metrics["idle_ticks"] >= idle_grace            # (..., n)
    n = idle.shape[-1]
    if n <= 1:
        return torch.zeros_like(idle)
    idle_f = idle.to(torch.float32)
    total_idle = sum_last(idle_f, keepdim=True)
    idle_siblings = total_idle - idle_f                   # excludes self
    threshold = idle_sibling_frac * (n - 1)
    busy = torch.logical_not(idle)
    return torch.logical_and(busy, idle_siblings >= threshold)


def sync_slope(window: torch.Tensor) -> torch.Tensor:
    """Least-squares slope of each instance's sync-time window.

    window: (..., n, W) cumulative-sync-time samples, newest last.
    Returns (..., n).
    """
    w = window.shape[-1]
    t = torch.arange(w, dtype=torch.float32, device=window.device)
    t = t - div(sum_all(t), w)
    denom = sum_all(t * t)
    centered = window - div(sum_last(window, keepdim=True), w)
    return sum_last(centered * t) / torch.clamp(denom, min=1e-9)


def sync_time_slope_skew(metrics: Dict[str, torch.Tensor], theta: float) -> torch.Tensor:
    """Eq. (2):  dS_i/dt · θ ≥ mean(dS_{-i}/dt).

    Compares the *rate of change* of synchronous time across siblings over a
    sliding window — accelerating imbalance, not absolute imbalance.
    """
    slopes = sync_slope(metrics["sync_window"])
    others = _mean_of_others(slopes)
    # Guard: a flat window (all slopes ~0) must not fire.
    active = slopes > 1e-9
    return torch.logical_and(slopes * theta >= others, active)


def detect_skew(metrics: Dict[str, torch.Tensor], config: DySkewConfig) -> torch.Tensor:
    """Dispatch to the configured model. Returns (..., n) bool."""
    kind = config.skew_model
    if kind == SkewModelKind.ROW_PERCENTAGE:
        return row_percentage_skew(metrics, config.theta)
    if kind == SkewModelKind.IDLE_TIME:
        return idle_time_skew(metrics, config.idle_grace, config.idle_sibling_frac)
    if kind == SkewModelKind.SYNC_TIME_SLOPE:
        return sync_time_slope_skew(metrics, config.theta)
    raise ValueError(f"unknown skew model {kind!r}")


def apply_n_strikes(
    skewed_now: torch.Tensor, strikes: torch.Tensor, n_strikes: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """N-strikes hysteresis.

    Returns (fire, new_strikes): ``fire`` is True once an instance has
    accumulated N *consecutive* detections; a single clean tick resets the
    counter.
    """
    new_strikes = torch.where(
        skewed_now, strikes + 1, torch.zeros_like(strikes)
    ).to(strikes.dtype)
    fire = new_strikes >= n_strikes
    return fire, new_strikes


def batch_density_heavy_rows(
    metrics: Dict[str, torch.Tensor], config: DySkewConfig
) -> torch.Tensor:
    """Row Size Model (§III.B): heavy-row detection via batch density.

    'While Snowflake typically targets thousands of rows per batch, this
    density drops by over 99 % when processing large objects.'
    Returns per-instance bool: batches are pathologically sparse AND rows
    are actually large → redistribution overhead likely exceeds the
    benefit.  The row-size conjunct keeps ordinary small remainder batches
    from tripping the guard.
    """
    density = metrics["batch_density"]
    observed = density > 0.0  # density 0 = no batch seen yet; not evidence
    sparse = torch.logical_and(observed, density < config.min_batch_density)
    large_rows = metrics["bytes_per_row"] >= config.heavy_row_bytes
    return torch.logical_and(sparse, large_rows)


def heavy_row_disable(
    metrics: Dict[str, torch.Tensor], config: DySkewConfig
) -> torch.Tensor:
    """The §III.B intervention: if NOT skewed (idle-time model) AND batch
    density below threshold → the state machine should transition to the
    local terminal state, disabling redistribution for this link.
    """
    skewed = idle_time_skew(metrics, config.idle_grace, config.idle_sibling_frac)
    heavy = batch_density_heavy_rows(metrics, config)
    return torch.logical_and(torch.logical_not(skewed), heavy)


def update_metrics(
    metrics: Dict[str, torch.Tensor],
    rows_this_tick: torch.Tensor,
    sync_time_this_tick: torch.Tensor,
    batch_density: torch.Tensor,
    bytes_per_row: torch.Tensor,
    signal_this_tick: Optional[torch.Tensor] = None,
) -> Dict[str, torch.Tensor]:
    """Advance the sibling-observable metrics by one tick.

    All arguments are (..., n) vectors for the n sibling instances.
    ``signal_this_tick`` marks instances that are active without receiving
    rows (the paper counts an instance idle only if it got *no row or
    signal*); a worker mid-row is busy, not idle.  Returns new tensors; the
    input dict is left as it was.
    """
    rows = metrics["rows"] + rows_this_tick
    received = rows_this_tick > 0
    if signal_this_tick is not None:
        received = torch.logical_or(received, signal_this_tick)
    idle_ticks = torch.where(
        received, torch.zeros_like(metrics["idle_ticks"]), metrics["idle_ticks"] + 1.0
    )
    # Slide the sync window; store *cumulative* sync time so the slope model
    # sees rates of change (Eq. 2 uses dS/dt of cumulative S).
    prev_cum = metrics["sync_window"][..., -1]
    new_cum = prev_cum + sync_time_this_tick
    sync_window = torch.cat(
        [metrics["sync_window"][..., 1:], new_cum[..., None]], dim=-1
    )
    return {
        "rows": rows,
        "idle_ticks": idle_ticks,
        "sync_window": sync_window,
        "batch_density": batch_density.to(torch.float32),
        "bytes_per_row": bytes_per_row.to(torch.float32),
    }
