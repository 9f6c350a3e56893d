"""Deterministic fault injection for the simulator event loop.

A `FaultSchedule` is DATA, not a process: every fault the engine will
inject — worker crashes, spot preemptions with advance notice, transient
slowdowns, NIC degradations — is fixed before `MultiQuerySimulator.run`
pops its first event, either declared explicitly per scenario or drawn
once from the seeded hazard process in :func:`hazard_schedule`.  The
engine consumes the schedule as first-class heap events (FAIL /
PREEMPT_NOTICE / RECOVER) and never consults randomness while the loop
runs, so the repo's determinism contract holds with faults on exactly as
it does with faults off: same schedule + same tenants ⇒ bit-identical
trajectory, including every detection, retry and recovery.

Event semantics (see `sim/engine.py` for the full recovery path):

  crash       — the worker dies at ``time`` with NO warning.  Its
                in-flight service chunk is lost (the partial service is
                wasted spend), its queued rows freeze, and nothing is
                recovered until the heartbeat/idle-time detector notices
                the silence.  ``duration`` < inf means a replacement
                instance takes the slot at ``time + duration``.
  preempt     — spot preemption WITH notice: at ``time`` the scheduler
                learns the instance is going away (routing stops
                immediately, the instance keeps draining its queue), and
                at ``time + notice`` the plug is pulled — whatever it
                could not finish recovers at that instant, no heartbeat
                wait.  ``duration`` counts from the pull, like crash.
  slowdown    — the worker serves ``factor``× slower for ``duration``
                seconds (applied per service chunk at chunk start).  The
                stretch is visible to siblings through completions, which
                is what the N-strikes sync-slope straggler detector keys
                on.
  nic_degrade — ``worker`` names a NODE: its uplink occupancy stretches
                by ``factor`` for ``duration`` seconds.

``retry_base`` / ``retry_cap`` parameterize the sender-side retry loop:
a transfer that lands on a dead/draining/excluded destination bounces to
the least-backlogged eligible worker after ``min(base * 2**attempt,
cap)`` seconds of backoff (attempts counted per failed destination).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

#: Event kind names (the engine switches on these).
CRASH = "crash"
PREEMPT = "preempt"
SLOWDOWN = "slowdown"
NIC_DEGRADE = "nic_degrade"
FAULT_KINDS = (CRASH, PREEMPT, SLOWDOWN, NIC_DEGRADE)

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault.  ``worker`` is a worker index for
    crash/preempt/slowdown and a NODE index for nic_degrade."""

    time: float
    kind: str
    worker: int
    #: crash/preempt: seconds until a replacement rejoins (inf = never);
    #: slowdown/nic_degrade: length of the degraded window.
    duration: float = _INF
    #: preempt only: advance warning between the notice and the pull.
    notice: float = 0.0
    #: slowdown: service-time multiplier; nic_degrade: occupancy
    #: multiplier.  Ignored for crash/preempt.
    factor: float = 4.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; expected one of "
                f"{FAULT_KINDS}"
            )
        if not (self.time >= 0.0 and np.isfinite(self.time)):
            raise ValueError(f"fault time must be finite >= 0: {self.time}")
        if self.worker < 0:
            raise ValueError(f"fault worker/node must be >= 0: {self.worker}")
        if not self.duration > 0.0:
            raise ValueError(f"fault duration must be > 0: {self.duration}")
        if self.notice < 0.0:
            raise ValueError(f"preempt notice must be >= 0: {self.notice}")
        if self.kind in (SLOWDOWN, NIC_DEGRADE) and not self.factor >= 1.0:
            raise ValueError(
                f"{self.kind} factor must be >= 1 (a speedup is not a "
                f"fault): {self.factor}"
            )


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """A replayable set of fault events plus the sender retry knobs.

    An EMPTY schedule is the contract-critical case: the engine treats
    ``FaultSchedule()`` exactly like ``faults=None`` — not a single new
    branch executes, so the legacy rtol-1e-9 equivalence pin and the
    policy digest pins are untouched.
    """

    events: Tuple[FaultEvent, ...] = ()
    #: Capped exponential backoff for transfers bounced off a
    #: dead/draining destination: ``min(retry_base * 2**attempt,
    #: retry_cap)`` seconds.
    retry_base: float = 1e-3
    retry_cap: float = 64e-3

    def __post_init__(self):
        object.__setattr__(
            self, "events",
            tuple(sorted(self.events, key=lambda e: e.time)),
        )
        if not self.retry_base > 0.0:
            raise ValueError(f"retry_base must be > 0: {self.retry_base}")
        if self.retry_cap < self.retry_base:
            raise ValueError(
                f"retry_cap {self.retry_cap} < retry_base {self.retry_base}"
            )

    def __bool__(self) -> bool:
        return bool(self.events)

    def validate(self, num_workers: int, num_nodes: int) -> None:
        """Raise if any event targets a worker/node outside the cluster."""
        for e in self.events:
            limit = num_nodes if e.kind == NIC_DEGRADE else num_workers
            what = "node" if e.kind == NIC_DEGRADE else "worker"
            if e.worker >= limit:
                raise ValueError(
                    f"fault event at t={e.time} targets {what} {e.worker} "
                    f"but the cluster has {limit}"
                )

    def injected_counts(self) -> Dict[str, int]:
        """Events by kind (telemetry for ``last_fault_stats``)."""
        out = {k: 0 for k in FAULT_KINDS}
        for e in self.events:
            out[e.kind] += 1
        return out


def hazard_schedule(
    seed: int,
    num_workers: int,
    num_nodes: int,
    horizon: float,
    crash_rate: float = 0.0,
    preempt_rate: float = 0.0,
    slowdown_rate: float = 0.0,
    nic_rate: float = 0.0,
    mttr: float = 1.0,
    notice: float = 0.05,
    slow_factor: float = 4.0,
    nic_factor: float = 4.0,
    min_live: int = 2,
    start: float = 0.0,
) -> FaultSchedule:
    """Draw a replayable schedule from a seeded merged Poisson hazard.

    Rates are events/second over the whole cluster; event times are the
    merged process's exponential inter-arrivals, kinds are drawn
    proportionally to their rates, targets uniformly.  Repair times
    (``duration``) are exponential with mean ``mttr``.  All randomness is
    consumed HERE, at construction, from ``np.random.default_rng(seed)``
    — the same seed always yields the identical schedule, and the engine
    draws nothing at run time.

    ``min_live`` is a liveness floor baked into the draw: a crash or
    preemption whose outage would leave fewer than ``min_live`` workers
    simultaneously up is suppressed (the draw is still consumed, so the
    remaining events are unchanged).  This keeps hazard-generated
    scenarios inside the regime the recovery layer — and
    `FaultConfig.min_hosts` — is specified for.
    """
    total = crash_rate + preempt_rate + slowdown_rate + nic_rate
    if total <= 0.0 or horizon <= 0.0:
        return FaultSchedule()
    rng = np.random.default_rng(seed)
    probs = np.asarray(
        [crash_rate, preempt_rate, slowdown_rate, nic_rate]
    ) / total
    events: List[FaultEvent] = []
    down: List[Tuple[float, float]] = []
    t = start
    while True:
        t += float(rng.exponential(1.0 / total))
        if t >= start + horizon:
            break
        kind = FAULT_KINDS[int(rng.choice(4, p=probs))]
        dur = float(rng.exponential(mttr)) + 1e-6
        if kind == NIC_DEGRADE:
            events.append(FaultEvent(
                time=t, kind=kind, worker=int(rng.integers(num_nodes)),
                duration=dur, factor=nic_factor,
            ))
            continue
        w = int(rng.integers(num_workers))
        if kind == SLOWDOWN:
            events.append(FaultEvent(
                time=t, kind=kind, worker=w, duration=dur,
                factor=slow_factor,
            ))
            continue
        t_down = t + (notice if kind == PREEMPT else 0.0)
        t_up = t_down + dur
        overlapping = sum(1 for s, e in down if s < t_up and e > t_down)
        if overlapping >= max(num_workers - min_live, 0):
            continue  # draw consumed, fault suppressed (liveness floor)
        down.append((t_down, t_up))
        events.append(FaultEvent(
            time=t, kind=kind, worker=w, duration=dur,
            notice=(notice if kind == PREEMPT else 0.0),
        ))
    return FaultSchedule(events=tuple(events))


def default_sim_fault_config():
    """`FaultConfig` scaled to simulator time: query latencies are
    O(seconds), so heartbeats tick every 20 virtual ms and a silent
    worker is declared dead after ~2 missed windows — detection latency
    stays well under typical SLO targets while the N-strikes straggler
    hysteresis keeps its paper defaults."""
    from repro_torch.runtime.fault_tolerance import FaultConfig

    return FaultConfig(
        heartbeat_interval=0.02,
        missed_beats_dead=2,
        straggler_theta=0.5,
        n_strikes=3,
        slope_window=8,
        min_hosts=2,
    )
