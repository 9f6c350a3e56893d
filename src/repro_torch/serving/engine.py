"""Serving engine: continuous batching across replicas with a DySkew
request scheduler.

Request-level instantiation of the paper (DESIGN.md §3.4): requests are
rows, model replicas are workers, and per-replica state machines decide
when to rebalance.  The Row Size Model maps to KV-cache bytes: migrating a
long-context request's KV *is* moving a 100 GB row, so the cost gate
prices migrations at cache size over interconnect bandwidth while fresh
requests (no KV yet) are always cheap to (re)place — the eager path.

The engine here runs the scheduler against simulated replica clocks (the
same discrete-time style as repro_torch.sim).  The replicas' clocks are
host numpy; the one tensor site is ``ServingScheduler.rebalance``'s
``AdaptiveLink.step``, which runs on the scheduler's ``device``
(``None`` = the GPU, as every entry point of the port).

Multi-tenant serving: requests carry a ``tenant`` class index and
``ServeConfig.tenant_weights`` turns on the shared weighted fair-share
admission layer (`repro_torch.core.admission.FairShareAdmission`) — the same
deficit-round-robin planner the multi-tenant simulator uses — pacing each
class's entry into the decode batches, with MIGRATED KV bytes (the ones
that actually crossed the interconnect) charged on the Row-Size-Model
NIC lane at the request's next admission.

Request timeline (honest accounting): a request materializes KV only by
PREFILLING — after it enters a decode batch, its prompt is processed at
``prefill_rate`` before any decode progress accrues — so ``kv_bytes``
reports the KV that actually exists (prefilled prompt + generated
tokens), fresh queued requests are free to move (the eager path), and a
migrated request is in transit for ``migration_latency + kv_bytes /
interconnect_bw`` simulated seconds before it can be scheduled again.
``migrated_gb`` therefore counts only KV that was really transferred.

SLO layer: ``ServeConfig.slo_targets`` declares per-tenant-class
deadlines (seconds from arrival); with ``deadline_aware=True`` decode
admission runs through `repro_torch.core.admission.DeadlineAwareAdmission`
(EDF credit boost as slack runs out), and ``preemption=True`` lets an
urgent queued request displace a running slot of an over-share tenant —
the victim re-queues with its KV intact (so moving it later costs real
bytes and real transit time).  Per-tenant results then include SLO
attainment and p99 tardiness.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

import torch

from repro_torch._device import DeviceLike
from repro_torch.core import AdaptiveLink, AdaptiveLinkConfig, BatchAdmission, CostModelConfig
from repro_torch.core.admission import (
    DeadlineAwareAdmission,
    DeadlineConfig,
    FairShareAdmission,
    FairShareConfig,
)
from repro_torch.core.policy import PolicyContext, StrategyConfig
from repro_torch.core.types import DySkewConfig, Policy

#: Historical scheduler names, mapped onto the shared policy registry
#: (`repro_torch.core.policy`): round_robin is the static per-row cycle and
#: least_loaded is the registry's 'none' policy, whose fresh-row
#: placement is least-loaded (placing a new request is not
#: redistributing).  Any registered policy name works directly.
_SCHEDULER_ALIASES = {"round_robin": "static_rr", "least_loaded": "none"}


@dataclasses.dataclass
class Request:
    rid: int
    prompt_len: int
    max_new_tokens: int
    arrival: float
    tenant: int = 0          # fair-share tenant class (see ServeConfig)
    # runtime fields
    replica: int = -1
    generated: int = 0       # whole tokens emitted (integral by invariant)
    progress: float = 0.0    # fractional decode progress, in tokens
    prefilled: int = 0       # prompt tokens with materialized KV
    pf_progress: float = 0.0  # fractional prefill progress, in tokens
    available_at: float = 0.0  # in transit (migrating) until this time
    nic_debt: float = 0.0    # KV bytes moved over the NIC, not yet billed
    deadline: float = float("inf")  # absolute SLO deadline (set by engine)
    preemptions: int = 0     # times this request lost its decode slot
    done_at: float = -1.0

    @property
    def kv_len(self) -> int:
        # Only MATERIALIZED KV counts: prefilled prompt + generated
        # tokens.  A request that never prefilled carries no KV — its
        # migration is free and moves zero bytes (the seed engine charged
        # the full prompt here, billing KV that was never built).
        return self.prefilled + self.generated

    def kv_bytes(self, bytes_per_token: float) -> float:
        return self.kv_len * bytes_per_token


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    num_replicas: int = 4
    max_batch: int = 8                  # decode slots per replica
    prefill_rate: float = 80_000.0      # tokens/s per replica
    decode_rate: float = 3_000.0        # tokens/s per replica (full batch)
    kv_bytes_per_token: float = 2 * 64 * 8 * 128 * 2.0  # L*K*hd*2B (bf16)
    interconnect_bw: float = 50e9       # ICI
    migration_latency: float = 2e-3
    # Placement policy: any name in the `repro_torch.core.policy` registry
    # (dyskew | none | static_rr | p2c | key_affinity | hillclimb | ...)
    # plus the historical aliases round_robin / least_loaded.  Unknown
    # names raise ValueError when the scheduler is built.
    scheduler: str = "dyskew"
    # Weighted fair-share admission across tenant classes (None = off):
    # requests carry a `tenant` index into these weights, and entry into
    # a replica's decode batch is paced by the shared
    # `repro_torch.core.admission.FairShareAdmission` planner (the same layer
    # the multi-tenant simulator uses), with the KV bytes a request
    # actually moved over the interconnect as the Row Size Model
    # NIC-lane charge.
    tenant_weights: Optional[Tuple[float, ...]] = None
    # Per-tenant-class SLO targets (seconds from arrival to completion;
    # None entries = no deadline for that class).  Length must match
    # ``tenant_weights`` when both are set.
    slo_targets: Optional[Tuple[Optional[float], ...]] = None
    # Upgrade fair-share admission to the deadline-aware planner (EDF
    # credit boost; requires tenant_weights + slo_targets).
    deadline_aware: bool = False
    # Allow urgent queued requests to preempt a running decode slot of an
    # over-share tenant (requires deadline_aware).
    preemption: bool = False
    deadline_cfg: DeadlineConfig = DeadlineConfig()
    # Simulated-time budget: runs longer than this stop and REPORT the
    # truncation (the seed engine silently broke, making a stuck run
    # indistinguishable from a finished one).
    max_sim_s: float = 3600.0


class ServingScheduler:
    """Places new requests and (optionally) migrates queued ones."""

    def __init__(self, cfg: ServeConfig, seed: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        n = cfg.num_replicas
        # Resolve the placement policy through the shared registry —
        # unknown scheduler names fail HERE, not by silently falling
        # through to least-loaded.
        kind = _SCHEDULER_ALIASES.get(cfg.scheduler, cfg.scheduler)
        self.policy = StrategyConfig(kind=kind).make_policy(PolicyContext(
            num_workers=n,
            rng=np.random.default_rng(seed),
            network_bandwidth=cfg.interconnect_bw,
            per_row_serialize=cfg.migration_latency,
        ))
        self.link = AdaptiveLink(AdaptiveLinkConfig(
            dyskew=DySkewConfig(
                policy=Policy.EAGER_SNOWPARK,
                # Row Size Model: requests whose KV exceeds this are 'heavy
                # rows' — migration must clear the cost gate.
                heavy_row_bytes=64e6,
                target_batch_density=cfg.max_batch * 4.0,
                min_batch_density_frac=0.25,
            ),
            cost=CostModelConfig(
                link_bandwidth=cfg.interconnect_bw,
                per_item_overhead=cfg.migration_latency,
            ),
            num_instances=n,
        ), device=device)
        self.link_state = self.link.init_state()
        # Shared per-batch admission planner (same guards the simulator and
        # the data pipeline use): prices queued-request migrations.
        self.admission = BatchAdmission(self.link.config.dyskew)

    def place(self, req: Request, load_tokens: np.ndarray) -> int:
        """Choose a replica for a NEW request (no KV yet → free to move).

        Delegates to the policy's single-row placement: static_rr uses
        the current slot then advances (replica 0 must receive the first
        request — a seed bug skipped it), none/dyskew place least-loaded
        by outstanding token estimate (dyskew's eager zero-size row
        always clears the gate), stochastic policies draw from their
        injected RNG stream.
        """
        return int(self.policy.place_one(load_tokens))

    def rebalance(
        self,
        queued: List[Request],
        load_tokens: np.ndarray,
    ) -> Dict[int, int]:
        """DySkew pass over QUEUED (not yet running) requests.

        Returns {rid: new_replica}. Queued requests that already prefilled
        on a replica carry KV; the cost gate decides if moving pays off.
        """
        # Only link-consuming policies (class flag, same hook the
        # simulator's tick machinery asks) run the rebalance pass.
        if not self.policy.uses_link or not queued:
            return {}
        dev = self.link.device
        costs = np.array(
            [r.max_new_tokens / self.cfg.decode_rate for r in queued],
            np.float32,
        )
        sizes = np.array(
            [r.kv_bytes(self.cfg.kv_bytes_per_token) for r in queued],
            np.float32,
        )
        producer = np.array([max(r.replica, 0) for r in queued], np.int32)
        self.link_state, plan = self.link.step(
            self.link_state,
            torch.from_numpy(costs).to(dev), torch.from_numpy(sizes).to(dev),
            torch.from_numpy(producer).to(dev),
        )
        dest = plan.dest.cpu().numpy()
        # Per-request cost gate via the shared admission planner: a queued
        # request whose KV transfer costs more than the straggler time its
        # move would save stays put (heavy-KV 'rows' must not thrash).
        moves: Dict[int, int] = {}
        n = self.cfg.num_replicas
        for r, d, cost, size in zip(queued, dest, costs, sizes):
            if int(d) == r.replica:
                continue
            dec = self.admission.admit_move(
                float(size), 1, float(cost), n,
                self.cfg.interconnect_bw, self.cfg.migration_latency,
            )
            if dec.admit:
                moves[r.rid] = int(d)
        return moves


class ServingEngine:
    """Simulated multi-replica continuous-batching engine."""

    def __init__(self, cfg: ServeConfig, seed: int = 0, device: DeviceLike = None):
        self.cfg = cfg
        self.sched = ServingScheduler(cfg, seed=seed, device=device)
        self.rng = np.random.default_rng(seed)

    def _make_planner(self) -> Optional[FairShareAdmission]:
        """Fair-share admission over tenant classes: requests = rows, a
        decode slot = the pool resource, KV bytes = the NIC-lane charge.
        ``deadline_aware`` upgrades to the EDF-boosted planner (per-class
        ``slo_targets`` become admission deadlines).  Built fresh per run
        — the planner is stateful (deficits, in-service counts) like the
        queues it paces."""
        cfg = self.cfg
        if cfg.deadline_aware and not cfg.tenant_weights:
            raise ValueError(
                "deadline_aware requires tenant_weights (the deadline-"
                "aware planner is an upgrade of the fair-share layer)"
            )
        if cfg.preemption and not cfg.deadline_aware:
            raise ValueError(
                "preemption requires deadline_aware (victims are picked "
                "by the deadline-aware planner)"
            )
        if not cfg.tenant_weights:
            return None
        fs = FairShareConfig(
            quantum_rows=float(cfg.max_batch),
            quantum_bytes=64e6,
            heavy_row_bytes=64e6,
        )
        if cfg.deadline_aware:
            if not cfg.slo_targets:
                raise ValueError(
                    "deadline_aware requires slo_targets (otherwise the "
                    "SLO layer would be silently inert)"
                )
            if len(cfg.slo_targets) != len(cfg.tenant_weights):
                raise ValueError(
                    f"slo_targets length {len(cfg.slo_targets)} != "
                    f"tenant_weights length {len(cfg.tenant_weights)}"
                )
            return DeadlineAwareAdmission(
                list(cfg.tenant_weights),
                list(cfg.slo_targets),
                fs,
                cfg.deadline_cfg,
            )
        return FairShareAdmission(list(cfg.tenant_weights), fs)

    def run(self, requests: List[Request]) -> Dict:
        cfg = self.cfg
        n = cfg.num_replicas
        queues: List[List[Request]] = [[] for _ in range(n)]
        running: List[List[Request]] = [[] for _ in range(n)]
        t = 0.0
        done: List[Request] = []
        pending = sorted(requests, key=lambda r: r.arrival)
        if cfg.slo_targets:
            for r in pending:
                slo = (
                    cfg.slo_targets[r.tenant]
                    if r.tenant < len(cfg.slo_targets) else None
                )
                r.deadline = (
                    r.arrival + slo if slo is not None else float("inf")
                )
        i = 0
        migrations = 0
        migrated_bytes = 0.0
        migration_delay_s = 0.0
        preemptions = 0
        truncated = False
        dt = 10e-3
        planner = self._make_planner()
        dl = planner if isinstance(planner, DeadlineAwareAdmission) else None

        def load_tokens() -> np.ndarray:
            out = np.zeros(n)
            for rep in range(n):
                out[rep] = sum(
                    r.prompt_len + r.max_new_tokens - r.generated
                    for r in queues[rep] + running[rep]
                )
            return out

        def admit(r: Request) -> bool:
            if planner is None:
                return True
            # NIC lane: bill the KV bytes this request actually moved
            # over the interconnect since its last admission (set at
            # migration time) — NOT its resident KV.  A fresh request
            # and a preempted request re-entering on the same replica
            # moved nothing and charge nothing.
            nic = r.nic_debt
            if dl is None:
                ok = planner.try_admit(r.tenant, 1, nic, nic)
            else:
                ok = dl.try_admit(
                    r.tenant, 1, nic, nic, deadline=r.deadline, now=t
                )
            if ok:
                r.nic_debt = 0.0
            return ok

        while i < len(pending) or any(queues) or any(running):
            # admit arrivals
            while i < len(pending) and pending[i].arrival <= t:
                r = pending[i]
                r.replica = self.sched.place(r, load_tokens())
                queues[r.replica].append(r)
                i += 1
            # periodic DySkew rebalance of queued work (requests still in
            # transit from a previous migration cannot move again yet)
            moves = self.sched.rebalance(
                [r for q in queues for r in q if r.available_at <= t],
                load_tokens(),
            )
            if moves:
                # Detach movers first, append after: appending to a queue
                # that is iterated later in the same pass re-visits the
                # moved request and loops forever (moves to higher replicas).
                moved = []
                for rep in range(n):
                    stay = []
                    for r in queues[rep]:
                        if moves.get(r.rid, rep) != rep:
                            migrations += 1
                            # Only MATERIALIZED KV is transferred: zero
                            # for a never-prefilled request (free eager
                            # move), real bytes for preempted requests
                            # carrying prefill + generated KV — and the
                            # move costs simulated transit time either
                            # way (latency + bytes over the interconnect).
                            kv = r.kv_bytes(cfg.kv_bytes_per_token)
                            migrated_bytes += kv
                            r.nic_debt += kv
                            delay = (
                                cfg.migration_latency
                                + kv / cfg.interconnect_bw
                            )
                            r.available_at = t + delay
                            migration_delay_s += delay
                            r.replica = moves[r.rid]
                            moved.append(r)
                        else:
                            stay.append(r)
                    queues[rep] = stay
                for r in moved:
                    queues[r.replica].append(r)
            # run each replica for dt
            for rep in range(n):
                # Fill decode slots; with fair share on, each queued
                # request must clear its tenant's deficit first.  Blocked
                # requests are skipped (not head-of-line blocking) and
                # retried next step once completions earn credit.
                qi = 0
                while len(running[rep]) < cfg.max_batch and qi < len(queues[rep]):
                    r = queues[rep][qi]
                    if r.available_at > t or not admit(r):
                        qi += 1
                        continue
                    running[rep].append(queues[rep].pop(qi))
                # Slot preemption: an urgent queued request (slack inside
                # the horizon) may displace a running request of an
                # over-share tenant with a later (or no) deadline.  The
                # victim re-queues at the head with its KV intact and
                # must re-clear fair share; the planner transfers one
                # slot of credit to the urgent tenant.
                if (
                    cfg.preemption and dl is not None
                    and len(running[rep]) >= cfg.max_batch and queues[rep]
                ):
                    horizon = cfg.deadline_cfg.urgency_horizon
                    urgent = min(
                        (
                            r for r in queues[rep]
                            if r.available_at <= t
                            and r.deadline - t < horizon
                        ),
                        key=lambda r: (r.deadline, r.rid),
                        default=None,
                    )
                    # Dry-run probe: displace a victim only if the urgent
                    # admission WOULD succeed with the transferred slot
                    # of credit — otherwise the freed slot would idle and
                    # the refunded victim would be thrashed every step.
                    if urgent is not None and not dl.would_admit(
                        urgent.tenant, 1, urgent.nic_debt, urgent.nic_debt,
                        deadline=urgent.deadline, now=t, rows_advance=1.0,
                    ):
                        urgent = None
                    if urgent is not None:
                        over = {
                            q for q, _ in dl.preempt_candidates(
                                protect=(urgent.tenant,)
                            )
                        }
                        victim = max(
                            (
                                v for v in running[rep]
                                if v.tenant in over
                                and v.deadline > urgent.deadline
                            ),
                            key=lambda v: (
                                v.deadline,
                                v.max_new_tokens - v.generated,
                                v.rid,
                            ),
                            default=None,
                        )
                        if victim is not None:
                            running[rep].remove(victim)
                            victim.preemptions += 1
                            queues[rep].insert(0, victim)
                            dl.preempt_transfer(
                                victim.tenant, urgent.tenant, 1
                            )
                            preemptions += 1
                            if admit(urgent):
                                queues[rep].remove(urgent)
                                running[rep].append(urgent)
                if not running[rep]:
                    continue
                # Prefill first: prompt KV is materialized at
                # prefill_rate (FIFO across the replica's unprefilled
                # slots); only prefilled requests accrue decode progress.
                pf_budget = cfg.prefill_rate * dt
                decoders = []
                for r in running[rep]:
                    if r.prefilled < r.prompt_len:
                        if pf_budget > 0.0:
                            take = min(
                                pf_budget, r.prompt_len - r.pf_progress
                            )
                            r.pf_progress += take
                            pf_budget -= take
                            if r.pf_progress >= r.prompt_len - 1e-9:
                                r.pf_progress = float(r.prompt_len)
                            r.prefilled = min(
                                int(r.pf_progress), r.prompt_len
                            )
                    if r.prefilled >= r.prompt_len:
                        decoders.append(r)
                if not decoders:
                    continue
                # decode_rate shared across the DECODING slots
                per_slot = cfg.decode_rate * dt / len(decoders)
                still = []
                for r in running[rep]:
                    if r.prefilled < r.prompt_len:
                        still.append(r)
                        continue
                    # Tokens are integral: accumulate fractional decode
                    # progress separately and clamp `generated` so
                    # kv_len/kv_bytes keep whole-token semantics.
                    r.progress += per_slot
                    r.generated = min(int(r.progress), r.max_new_tokens)
                    if r.generated >= r.max_new_tokens:
                        r.done_at = t + dt
                        done.append(r)
                        if planner is not None:
                            planner.on_complete(r.tenant, 1)
                    else:
                        still.append(r)
                running[rep] = still
            t += dt
            if t > cfg.max_sim_s:
                # Out of simulated-time budget: stop and SAY so — the
                # seed engine silently broke here, reporting a truncated
                # run as if it had completed.
                truncated = True
                break

        lat = np.array([r.done_at - r.arrival for r in done])
        incomplete = (
            (len(pending) - i)
            + sum(len(q) for q in queues)
            + sum(len(b) for b in running)
        )
        out = {
            "completed": len(done),
            "mean_latency": float(lat.mean()) if len(lat) else 0.0,
            "p99_latency": float(np.percentile(lat, 99)) if len(lat) else 0.0,
            "migrations": migrations,
            "migrated_gb": migrated_bytes / float(2 ** 30),
            "migration_delay_s": migration_delay_s,
            "preemptions": preemptions,
            "truncated": truncated,
            "incomplete": incomplete,
            "makespan": t,
        }
        if planner is not None:
            per_tenant: Dict[int, Dict[str, float]] = {}
            nan = float("nan")
            slo_met_all = slo_total_all = 0
            # Unfinished requests whose deadline has already passed are
            # definitive MISSES — counting only completions would let a
            # truncated run report better attainment than a finished one.
            unfinished = (
                pending[i:]
                + [r for q in queues for r in q]
                + [r for b in running for r in b]
            )
            for tid in range(len(cfg.tenant_weights)):
                tl = np.array(
                    [r.done_at - r.arrival for r in done if r.tenant == tid]
                )
                entry: Dict[str, float] = {
                    "completed": int(len(tl)),
                    "mean_latency": float(tl.mean()) if len(tl) else 0.0,
                    "p99_latency": (
                        float(np.percentile(tl, 99)) if len(tl) else 0.0
                    ),
                }
                slo = (
                    cfg.slo_targets[tid]
                    if cfg.slo_targets and tid < len(cfg.slo_targets)
                    else None
                )
                if slo is not None:
                    overdue = sum(
                        1 for r in unfinished
                        if r.tenant == tid and r.deadline <= t
                    )
                    denom = len(tl) + overdue
                    if denom:
                        met = tl <= slo
                        entry["slo_attainment"] = float(met.sum()) / denom
                        # Tardiness is measurable only for completions.
                        entry["p99_tardiness"] = (
                            float(np.percentile(np.maximum(tl - slo, 0.0),
                                                99))
                            if len(tl) else nan
                        )
                        entry["slo_overdue_incomplete"] = overdue
                        slo_met_all += int(met.sum())
                        slo_total_all += denom
                    else:
                        entry["slo_attainment"] = nan
                        entry["p99_tardiness"] = nan
                per_tenant[tid] = entry
            out["per_tenant"] = per_tenant
            if slo_total_all:
                out["slo_attainment"] = slo_met_all / slo_total_all
        return out
