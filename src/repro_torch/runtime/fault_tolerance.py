"""Fault-tolerant training runtime: heartbeats, failure detection,
straggler mitigation, elastic recovery.

Scale design (1000+ nodes): a lightweight coordinator tracks per-host
heartbeats; detection reuses the paper's skew machinery —

  * the **idle-time model** flags hosts that stopped reporting
    (failure candidates),
  * the **sync-time-slope model** flags hosts whose step time is
    accelerating away from siblings (stragglers) *before* they fail —
    DySkew's Eq. (2) applied to step latencies instead of rows,
  * N-strikes hysteresis suppresses transient network blips exactly as it
    suppresses transient row-count skew.

On detection the runtime (a) excludes the host, (b) rebuilds the mesh from
survivors (elastic), (c) restores from the latest checkpoint (the
CheckpointManager's elastic restore reshards to the new mesh).  In this
container the hosts are simulated actors driven by an injectable clock so
every policy is unit-testable.

The coordinator's bookkeeping is host numpy; the metric update and the
window slopes run on ``device`` (float32 in, numpy back out each tick).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import skew_models
from repro_torch.core.types import DySkewConfig, SkewModelKind, link_metrics_zeros


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    heartbeat_interval: float = 10.0      # s
    missed_beats_dead: int = 3            # idle-time grace (ticks)
    straggler_theta: float = 0.5          # Eq. (2) θ over step-time slopes
    n_strikes: int = 3
    slope_window: int = 8
    min_hosts: int = 2                    # refuse to shrink below


@dataclasses.dataclass
class HostState:
    host_id: int
    last_beat: float = 0.0
    cum_step_time: float = 0.0
    alive: bool = True


class FaultTolerantRuntime:
    """Coordinator-side failure/straggler detector + elastic remesh."""

    def __init__(
        self,
        num_hosts: int,
        cfg: FaultConfig = FaultConfig(),
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.hosts: Dict[int, HostState] = {
            h: HostState(h) for h in range(num_hosts)
        }
        self.strikes = np.zeros(num_hosts, np.int32)
        self.metrics = {
            k: np.array(v.cpu().numpy()) for k, v in link_metrics_zeros(
                num_hosts, cfg.slope_window, self.device
            ).items()
        }
        self.excluded: Set[int] = set()
        self.events: List[Tuple[float, str, int]] = []

    # ---------------- heartbeat ingestion ---------------- #

    def heartbeat(self, host: int, now: float, step_time: float) -> None:
        hs = self.hosts[host]
        hs.last_beat = now
        hs.cum_step_time += step_time

    # ---------------- periodic evaluation ---------------- #

    def tick(self, now: float) -> Dict[str, List[int]]:
        """Run one detection tick. Returns {'failed': [...], 'stragglers': [...]}."""
        cfg = self.cfg
        n = len(self.hosts)
        active = [h for h in sorted(self.hosts) if h not in self.excluded]

        rows = np.zeros(n, np.float32)
        sync = np.zeros(n, np.float32)
        signal = np.zeros(n, bool)
        for h, hs in self.hosts.items():
            fresh = (now - hs.last_beat) < cfg.heartbeat_interval * 1.5
            rows[h] = 1.0 if fresh else 0.0
            signal[h] = fresh
            sync[h] = hs.cum_step_time

        def dev(a: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(a).to(self.device)

        metrics = skew_models.update_metrics(
            {k: dev(v) for k, v in self.metrics.items()},
            rows_this_tick=dev(rows),
            sync_time_this_tick=dev(
                sync - np.asarray(self.metrics["sync_window"])[:, -1]
            ),
            batch_density=dev(rows),
            bytes_per_row=torch.zeros(n, dtype=torch.float32, device=self.device),
            signal_this_tick=dev(signal),
        )
        self.metrics = {k: np.array(v.cpu().numpy()) for k, v in metrics.items()}

        failed = [
            h for h in active
            if self.metrics["idle_ticks"][h] >= cfg.missed_beats_dead
        ]

        # Straggler: Eq. (2) on cumulative step-time slopes with N-strikes.
        slopes = skew_models.sync_slope(metrics["sync_window"]).cpu().numpy()
        mask = np.array([h in active for h in range(n)])
        others_mean = np.where(
            mask.sum() > 1,
            (slopes[mask].sum() - slopes) / max(mask.sum() - 1, 1),
            np.inf,
        )
        skewed = mask & (slopes * cfg.straggler_theta >= others_mean) & (
            slopes > 1e-9
        )
        self.strikes = np.where(skewed, self.strikes + 1, 0).astype(np.int32)
        stragglers = [
            h for h in active
            if self.strikes[h] >= cfg.n_strikes and h not in failed
        ]

        for h in failed:
            self.events.append((now, "failed", h))
        for h in stragglers:
            self.events.append((now, "straggler", h))
        return {"failed": failed, "stragglers": stragglers}

    # ---------------- elastic membership ------------------ #

    def exclude(self, hosts: List[int]) -> List[int]:
        """Remove hosts; returns the surviving host list (new mesh members)."""
        for h in hosts:
            if len(self.hosts) - len(self.excluded) <= self.cfg.min_hosts:
                break
            self.excluded.add(h)
            self.hosts[h].alive = False
            self.strikes[h] = 0
        return self.survivors()

    def survivors(self) -> List[int]:
        return [h for h in sorted(self.hosts) if h not in self.excluded]

    def rejoin(self, host: int, now: float) -> None:
        """A replaced/recovered host joins back (elastic scale-up)."""
        self.excluded.discard(host)
        hs = self.hosts[host]
        hs.alive = True
        hs.last_beat = now
        self.metrics["idle_ticks"][host] = 0.0
        # Clear the detection history, or the host flaps: leftover
        # strikes plus the pre-exclusion accelerating sync window would
        # re-flag it as a straggler on its first tick back.  Flattening
        # the window to the current cumulative step time makes the slope
        # zero AND keeps tick()'s `sync - window[:, -1]` delta correct
        # for the next heartbeat.
        self.strikes[host] = 0
        self.metrics["sync_window"][host, :] = hs.cum_step_time

    def mesh_shape(self, chips_per_host: int = 4) -> Tuple[int, int]:
        """The elastic mesh over the CURRENT survivor set — what the
        remesh after an exclusion/rejoin produces.  The simulator logs
        this at every membership change (``last_fault_stats['mesh_log']``)
        so fault scenarios record the mesh trajectory alongside recovery
        accounting."""
        return elastic_mesh_shape(
            len(self.survivors()), chips_per_host
        )


def elastic_mesh_shape(num_hosts: int, chips_per_host: int = 4) -> Tuple[int, int]:
    """Largest (data, model) mesh from surviving hosts: model axis fixed at
    16 where possible, data axis from whatever host count survived."""
    if num_hosts <= 0 or chips_per_host <= 0:
        # 0 hosts used to reach `chips // model` with model == 0
        # (ZeroDivisionError); an empty mesh is a caller error.
        raise ValueError(
            f"mesh needs at least one host and one chip per host, got "
            f"num_hosts={num_hosts}, chips_per_host={chips_per_host}"
        )
    chips = num_hosts * chips_per_host
    model = 16 if chips >= 16 else chips
    data = max(chips // model, 1)
    return (data, model)
