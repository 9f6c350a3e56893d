"""Shared admission planning for DySkew redistribution and tenancy.

Two planners live here, both host-side and dependency-light:

:class:`BatchAdmission` — the three per-batch guards every DySkew
call-site needs before it may move work off its producer:

  density guard — the Row Size Model (§III.B): a batch whose density
      collapsed *because rows are huge* stays local unless enough sibling
      interpreters are idle to make the move worthwhile;
  cost gate     — goal 3 (§I): refuse a redistribution whose estimated
      transfer time exceeds the estimated straggler time saved;
  self-skip     — destination eligibility for the §III.B forced-remote
      ablation (the producer — or its whole node — is excluded).

:class:`DeadlineAwareAdmission` — the SLO layer on top of
:class:`FairShareAdmission`: per-tenant SLO targets translate pending
work into absolute deadlines, an earliest-deadline-first credit boost
relaxes the admission threshold as slack runs out (the full charge still
lands on the deficit, so long-run throughput shares stay weighted), EDF
ordering of parked-work release, and a :meth:`preempt_candidates` /
:meth:`preempt_transfer` API that names admitted-but-unstarted work of
over-share tenants to displace in favour of an urgent tenant.

:class:`AutoscalePolicy` — hysteresis warehouse autoscaling: grow the
interpreter pool (whole workers) when backlog per active worker or SLO
attainment degrades, shrink when the pool runs light, with a cooldown
between actions.  Pure decision logic — the simulator/serving engines
own the actual pool rescaling.

:class:`FairShareAdmission` — a weighted deficit-round-robin admission
layer for multi-tenant execution over ONE shared virtual warehouse.
Tenants carry priority weights; the planner paces each tenant's entry
into the shared interpreter pool (rows lane) and onto the shared NIC
(bytes lane, cost-gated per the Row Size Model: only batches whose
bytes-per-row clears ``heavy_row_bytes`` are charged network budget).
It is consumed by the multi-tenant simulator (`repro_torch.sim.engine`), the
serving scheduler (`repro_torch.serving.engine`) and the multi-tenant data
pipeline (`repro_torch.data.pipeline`).

Invariants:

  * One formula set.  Historically `sim/engine.py`, `serving/engine.py`
    and `data/pipeline.py` each re-implemented the per-batch gating by
    hand; they now all call :class:`BatchAdmission`.  The cost-gate
    arithmetic (:func:`transfer_seconds`, :func:`straggler_savings`,
    :func:`cost_gate_admits`) is written with plain operators only, so
    it is polymorphic over Python floats, numpy arrays AND torch
    tensors — the on-device gate ``AdaptiveLink.step`` consults
    (:class:`CostModelConfig` / :func:`admit_redistribution`, below)
    runs the same functions on its tensors rather than re-stating them.
  * Determinism.  Neither planner draws randomness; given the same call
    sequence they return the same decisions, which is what lets the
    simulator's equivalence pins and the replay harness's process-pool
    fan-out stay reproducible.
  * Starvation-freedom.  :class:`FairShareAdmission` guarantees every
    backlogged tenant is eventually admitted: deficits are credited to
    all live tenants on every completed service quantum, deficits are
    capped, and a tenant at its cap is always admissible.  When nothing
    is in service the planner admits unconditionally (work conservation
    — the pool is never idled while work waits).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from repro_torch.core.types import DySkewConfig


@dataclasses.dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of a per-batch admission check (telemetry-friendly)."""

    admit: bool
    reason: str = "ok"      # ok | density_guard | cost_gate
    est_transfer: float = 0.0
    est_saved: float = 0.0


def transfer_seconds(
    bytes_moved,
    rows_moved,
    bandwidth,
    per_row_overhead,
):
    """Estimated seconds to move ``rows_moved`` rows of ``bytes_moved``
    total bytes over a link (serialization priced per row).

    Polymorphic: operands may be Python floats, numpy arrays or torch
    tensors."""
    return bytes_moved / bandwidth + rows_moved * per_row_overhead


def straggler_savings(est_row_cost, rows_moved, num_instances):
    """Estimated straggler seconds removed by spreading ``rows_moved``
    rows (of opaque estimated cost) across ``num_instances`` workers.

    Polymorphic over floats / numpy / torch for the scalar operands."""
    return est_row_cost * rows_moved * (1.0 - 1.0 / max(num_instances, 1))


def cost_gate_admits(est_saved, est_transfer, cost_gate):
    """The cost-gate predicate: admit iff the estimated straggler time
    saved strictly clears ``cost_gate`` times the estimated transfer
    time.  Written with plain operators so the SAME implementation runs
    on Python floats (simulator hot loop), numpy arrays, and torch
    tensors (:func:`admit_redistribution` inside ``AdaptiveLink.step``).
    """
    return est_saved > cost_gate * est_transfer


# --------------------------------------------------------------------- #
# On-device redistribution gate (paper goal #3)
# --------------------------------------------------------------------- #
#
# The cost-aware gate as consumed from inside a link step: it prices a
# candidate redistribution in seconds on both sides —
#
#   transfer_time = bytes_moved / link_bandwidth
#                 + items_moved * per_item_overhead    (serialize / RPC)
#   time_saved    = current_makespan - balanced_makespan
#
# and admits iff time_saved > cost_gate * transfer_time.  In the
# simulator the 'network' is the NIC.  Everything below is written with
# plain operators and ``.max()``, so the SAME code runs on host numpy
# arrays and on torch tensors on any device — one formula set with the
# host-side planners above, which is what keeps the on-device gate from
# drifting.


@dataclasses.dataclass(frozen=True)
class CostModelConfig:
    link_bandwidth: float = 50e9     # bytes/s: the reference's modelled link
    per_item_overhead: float = 5e-6  # s per moved item (serialize+route)
    cost_gate: float = 1.0           # admit iff saved > gate * transfer


def balance_benefit(loads_before, loads_after):
    """Makespan reduction (seconds of straggler time removed), clamped
    at zero.  Polymorphic over numpy arrays and torch tensors."""
    d = loads_before.max() - loads_after.max()
    return d * (d > 0)


def admit_redistribution(
    loads_before,
    loads_after,
    bytes_moved,
    items_moved,
    cfg: CostModelConfig,
):
    """Full on-device gate decision.

    Returns ``(admit?, est_time_saved, est_transfer_time)``; operands may
    be numpy arrays or torch tensors (``AdaptiveLink.step`` passes the
    tensors of its device).  On tensors the bandwidth divides as a tensor
    of the operands' device: CUDA multiplies by the reciprocal of a Python
    number, which would round differently from the host."""
    saved = balance_benefit(loads_before, loads_after)
    if isinstance(bytes_moved, torch.Tensor):
        dev = bytes_moved.device
        bytes_f32 = bytes_moved.to(torch.float32)
        items_f32 = items_moved.to(device=dev, dtype=torch.float32)
        bandwidth = torch.full((), cfg.link_bandwidth, dtype=torch.float32, device=dev)
    else:
        bytes_f32 = np.asarray(bytes_moved).astype(np.float32)
        items_f32 = np.asarray(items_moved).astype(np.float32)
        bandwidth = cfg.link_bandwidth
    t_move = transfer_seconds(
        bytes_f32, items_f32, bandwidth, cfg.per_item_overhead,
    )
    return cost_gate_admits(saved, t_move, cfg.cost_gate), saved, t_move


class BatchAdmission:
    """The DySkew admission guards, bound to one :class:`DySkewConfig`.

    ``enable_density_guard`` / ``enable_cost_gate`` exist for the paper's
    ablations; a disabled guard admits everything.
    """

    def __init__(
        self,
        cfg: DySkewConfig,
        *,
        enable_density_guard: bool = True,
        enable_cost_gate: bool = True,
    ):
        self.cfg = cfg
        self.enable_density_guard = enable_density_guard
        self.enable_cost_gate = enable_cost_gate

    # -- Row Size Model (§III.B) ------------------------------------- #

    def density_guard_blocks(
        self,
        num_rows: int,
        bytes_per_row: float,
        idle_sibling_frac: Union[float, Callable[[], float]] = 0.0,
    ) -> bool:
        """True → keep the batch local: density collapsed because rows are
        heavy and siblings are not idle enough to justify moving them.

        ``idle_sibling_frac`` may be a callable so callers can defer the
        (O(n)) sibling scan until the cheap size checks have passed.
        """
        cfg = self.cfg
        if not (
            self.enable_density_guard
            and num_rows < cfg.min_batch_density
            and bytes_per_row >= cfg.heavy_row_bytes
        ):
            return False
        frac = idle_sibling_frac() if callable(idle_sibling_frac) else idle_sibling_frac
        return frac < cfg.idle_sibling_frac

    # -- Cost gate (§I goal 3) ---------------------------------------- #

    def cost_gate_blocks(self, est_saved: float, est_transfer: float) -> bool:
        """True → the move is refused: savings do not clear the gate."""
        if not self.enable_cost_gate:
            return False
        return not cost_gate_admits(est_saved, est_transfer, self.cfg.cost_gate)

    def admit_move(
        self,
        bytes_moved: float,
        rows_moved: int,
        est_row_cost: float,
        num_instances: int,
        bandwidth: float,
        per_row_overhead: float,
    ) -> AdmissionDecision:
        """Full cost-gate decision for a candidate redistribution."""
        t_move = transfer_seconds(
            bytes_moved, rows_moved, bandwidth, per_row_overhead
        )
        saved = straggler_savings(est_row_cost, rows_moved, num_instances)
        if self.cost_gate_blocks(saved, t_move):
            return AdmissionDecision(False, "cost_gate", t_move, saved)
        return AdmissionDecision(True, "ok", t_move, saved)

    # -- Self-skip eligibility (§III.B forced-remote) ------------------ #

    def eligible_destinations(
        self,
        num_instances: int,
        producer: int,
        node_of: Optional[Callable[[int], int]] = None,
    ) -> np.ndarray:
        """Bool mask of valid destinations for ``producer``.

        With ``self_skip`` unset (the paper's Snowpark optimization) every
        instance is eligible.  With it set, the producer is excluded — or,
        when ``node_of`` is given, every interpreter on the producer's
        node (Fig. 1: redistribution targets *other* VW nodes).
        """
        mask = np.ones(num_instances, bool)
        if not self.cfg.self_skip:
            return mask
        if node_of is None:
            mask[producer] = False
        else:
            own = node_of(producer)
            for w in range(num_instances):
                if node_of(w) == own:
                    mask[w] = False
        return mask


# --------------------------------------------------------------------- #
# Fair-share multi-tenant admission (weighted deficit round robin)
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class FairShareConfig:
    """Tuning for :class:`FairShareAdmission`.

    ``quantum_rows`` / ``quantum_bytes`` set the DRR round size: every
    time that many rows complete service, one round of credit is dealt to
    the live tenants in proportion to their weights.  ``burst_quanta``
    caps how many rounds of unspent credit a tenant may bank (its burst
    allowance).  ``heavy_row_bytes`` is the Row Size Model threshold for
    the NIC lane: only batches at or above it are charged byte budget —
    light rows ride the interpreter-pool lane alone.  ``None`` charges
    every batch's bytes.
    """

    quantum_rows: float = 64.0
    quantum_bytes: float = 32e6
    burst_quanta: float = 4.0
    heavy_row_bytes: Optional[float] = None


class FairShareAdmission:
    """Weighted deficit-round-robin admission over a shared pool + NIC.

    Each tenant ``q`` holds two deficit counters — rows (interpreter-pool
    slots) and bytes (NIC budget).  Admitting a batch deducts its charge;
    completed service credits every live tenant's deficits in proportion
    to its weight (one round per completed quantum), so admission
    throughput converges to weighted fair shares under contention while
    idle capacity is never reserved:

      * if nothing is in service, any request is admitted immediately
        (work conservation);
      * deficits are capped at ``burst_quanta`` rounds, and a tenant at
        its cap is ALWAYS admissible — together with per-quantum credits
        this makes starvation impossible for positive weights.

    Callers integrate in one of two modes:

      park/release — `try_admit` at each arrival; park rejected work and
          retry (in `release_order`) after calling `on_complete` for
          finished service.  Used by the simulator and serving engine.
      DRR pick — `pick_next(costs)` selects which tenant's next work item
          to serve, classic deficit-round-robin.  Used by the data
          pipeline to interleave per-tenant document streams.
    """

    def __init__(
        self,
        weights: Sequence[float],
        cfg: FairShareConfig = FairShareConfig(),
    ):
        if not len(weights):
            raise ValueError("need at least one tenant weight")
        if any(w <= 0 for w in weights):
            raise ValueError(f"tenant weights must be positive: {weights}")
        self.cfg = cfg
        self.weights = [float(w) for w in weights]
        self.nq = len(self.weights)
        self.live = [True] * self.nq
        # A tenant is 'backlogged' from its first refused admission until
        # its next successful one; credit is dealt over the backlogged set
        # (falling back to all live tenants when nobody is waiting), so no
        # credit evaporates at an idle tenant's cap — the aggregate
        # admission rate tracks the completion rate (work conservation).
        self.backlogged = [False] * self.nq
        # Start saturated: fair-share pacing only bites under contention.
        self.deficit_rows = [self._cap_rows(q) for q in range(self.nq)]
        self.deficit_bytes = [self._cap_bytes(q) for q in range(self.nq)]
        self.outstanding_rows = [0.0] * self.nq
        self._total_outstanding = 0.0
        self._round_acc = 0.0
        self._cursor = 0
        # Telemetry.
        self.admitted = [0] * self.nq
        self.deferred = [0] * self.nq
        self.lost_rows = [0.0] * self.nq
        self.readmitted_rows = [0] * self.nq

    # -- weighted shares ------------------------------------------------ #

    def share_of(self, q: int) -> float:
        """Tenant ``q``'s normalized weight among live tenants.  Used for
        the deficit caps, so a tenant's burst allowance is stable whether
        or not it is currently waiting."""
        if not self.live[q]:
            return 0.0
        total = sum(w for w, a in zip(self.weights, self.live) if a)
        return self.weights[q] / total if total > 0 else 0.0

    def _credit_share(self, q: int) -> float:
        """Tenant ``q``'s share of each dealt credit round: normalized
        over the BACKLOGGED live tenants when anyone is waiting (so no
        credit evaporates at an idle tenant's cap and aggregate admission
        tracks the completion rate), else over all live tenants."""
        if not self.live[q]:
            return 0.0
        any_backlogged = any(
            b and a for b, a in zip(self.backlogged, self.live)
        )
        if any_backlogged and not self.backlogged[q]:
            return 0.0
        total = sum(
            w for w, a, b in zip(self.weights, self.live, self.backlogged)
            if a and (b or not any_backlogged)
        )
        return self.weights[q] / total if total > 0 else 0.0

    def _cap_rows(self, q: int) -> float:
        return self.cfg.burst_quanta * self.cfg.quantum_rows * max(
            self.share_of(q), 1e-9
        )

    def _cap_bytes(self, q: int) -> float:
        return self.cfg.burst_quanta * self.cfg.quantum_bytes * max(
            self.share_of(q), 1e-9
        )

    def deactivate(self, q: int) -> None:
        """Tenant ``q`` finished: stop dealing it credit; survivors'
        shares grow accordingly."""
        self.live[q] = False
        self.backlogged[q] = False

    # -- park/release mode --------------------------------------------- #

    def _nic_charge(self, nbytes: float, bytes_per_row: float) -> float:
        """Row Size Model cost-gating of the NIC lane: light rows are an
        interpreter-pool concern only; heavy rows also consume network
        budget (they are what saturates the uplink — §III.B).

        This is an admission-time ESTIMATE: admission runs before routing
        decides how many of the batch's bytes actually cross the NIC, so
        a heavy batch that ends up staying local is still charged.  The
        bias is conservative (network budget is reserved, never
        exceeded) and symmetric across tenants with similar workloads."""
        hv = self.cfg.heavy_row_bytes
        if hv is not None and bytes_per_row < hv:
            return 0.0
        return nbytes

    def _admissible(
        self,
        q: int,
        rows: int,
        charge_b: float,
        boost_r: float = 0.0,
        boost_b: float = 0.0,
        rows_advance: float = 0.0,
    ) -> bool:
        """Pure threshold test (no mutation): would ``rows``/``charge_b``
        clear admission now?  ``rows_advance`` hypothesizes extra row
        credit (capped) — the preemption dry-run probe, so engines can
        check an admission WOULD succeed before displacing victims."""
        if self._total_outstanding <= 0.0:
            return True
        dr = min(self.deficit_rows[q] + rows_advance, self._cap_rows(q))
        ok_rows = dr + boost_r >= rows or dr >= self._cap_rows(q)
        ok_bytes = (
            charge_b == 0.0
            or self.deficit_bytes[q] + boost_b >= charge_b
            or self.deficit_bytes[q] >= self._cap_bytes(q)
        )
        return ok_rows and ok_bytes

    def _admit_checked(
        self,
        q: int,
        rows: int,
        nbytes: float,
        bytes_per_row: float,
        boost_r: float = 0.0,
        boost_b: float = 0.0,
    ) -> bool:
        """The ONE copy of the park-or-admit body, shared with
        :class:`DeadlineAwareAdmission` (which passes its EDF boosts;
        the base planner's boosts are zero).  The boost relaxes only the
        admission THRESHOLD — the charge always lands in full."""
        charge_b = self._nic_charge(nbytes, bytes_per_row)
        if self._total_outstanding > 0.0:
            if not self._admissible(q, rows, charge_b, boost_r, boost_b):
                self.deferred[q] += 1
                self.backlogged[q] = True
                return False
        # Charge in full, carrying debt (negative deficit) when the batch
        # exceeds the banked credit — standard DRR accounting.  Without
        # the debt, a tenant submitting oversized batches via the
        # saturation rule would be systematically undercharged and exceed
        # its weighted share.
        self.deficit_rows[q] -= rows
        self.deficit_bytes[q] -= charge_b
        self.outstanding_rows[q] += rows
        self._total_outstanding += rows
        self.admitted[q] += 1
        self.backlogged[q] = False
        return True

    def try_admit(
        self, q: int, rows: int, nbytes: float, bytes_per_row: float = 0.0
    ) -> bool:
        """Admit ``rows``/``nbytes`` of tenant ``q`` now, or refuse.

        On True the charge is deducted and the work counts as in-service
        until :meth:`on_complete`.  On False nothing is deducted — park
        the work and retry after the next completion.
        """
        return self._admit_checked(q, rows, nbytes, bytes_per_row)

    def on_complete(self, q: int, rows: int) -> None:
        """Report ``rows`` of tenant ``q`` finishing service.  Credits one
        DRR round to every live tenant per completed ``quantum_rows``."""
        take = min(float(rows), self.outstanding_rows[q])
        self.outstanding_rows[q] -= take
        self._total_outstanding = max(self._total_outstanding - take, 0.0)
        self._round_acc += rows
        qr, qb = self.cfg.quantum_rows, self.cfg.quantum_bytes
        while self._round_acc >= qr:
            self._round_acc -= qr
            for a in range(self.nq):
                if not self.live[a]:
                    continue
                s = self._credit_share(a)
                if s <= 0.0:
                    continue
                self.deficit_rows[a] = min(
                    self.deficit_rows[a] + qr * s, self._cap_rows(a)
                )
                self.deficit_bytes[a] = min(
                    self.deficit_bytes[a] + qb * s, self._cap_bytes(a)
                )

    def on_lost(self, q: int, rows: int, refund: bool = False) -> None:
        """Report ``rows`` of tenant ``q`` LOST from service (worker
        crash/preemption) or withdrawn (straggler migration) before
        completing.

        The rows are retired from the in-service ledger — they will never
        reach :meth:`on_complete`, and without retirement the ledger
        never drains and work-conserving admission wedges.  With
        ``refund=False`` (failure) the original charge STANDS: the spend
        physically happened, and the re-admission of the recovered rows
        is charged again — that second charge is the tenant's retry debt.
        With ``refund=True`` (the SYSTEM chose to displace the rows, e.g.
        a straggler drain) the row charge is credited back up to the cap,
        mirroring :meth:`DeadlineAwareAdmission.preempt_transfer`.
        """
        take = min(float(rows), self.outstanding_rows[q])
        self.outstanding_rows[q] -= take
        self._total_outstanding = max(self._total_outstanding - take, 0.0)
        self.lost_rows[q] += take
        if refund:
            self.deficit_rows[q] = min(
                self.deficit_rows[q] + take, self._cap_rows(q)
            )
        elif self.live[q]:
            # The recovered rows will be back asking for admission.
            self.backlogged[q] = True

    def try_readmit(
        self,
        q: int,
        rows: int,
        deadline: Optional[float] = None,
        now: float = 0.0,
    ) -> bool:
        """Admit recovered rows re-entering after a loss.  Same gate and
        same charge as fresh work — recovery is paid for, not free — but
        no NIC charge: the re-fetch transfer is modeled (and paid) by the
        engine's recovery routing, and the bytes were already billed at
        original admission.  ``deadline``/``now`` are accepted for
        signature compatibility with the deadline-aware subclass and
        ignored here."""
        ok = self.try_admit(q, rows, 0.0, 0.0)
        if ok:
            self.readmitted_rows[q] += rows
        return ok

    def release_order(self) -> List[int]:
        """Round-robin order in which parked tenants should retry
        :meth:`try_admit` after a completion; the cursor advances one
        position per call so ties rotate fairly."""
        order = [(self._cursor + i) % self.nq for i in range(self.nq)]
        self._cursor = (self._cursor + 1) % self.nq
        return order

    # -- DRR pick mode -------------------------------------------------- #

    def pick_next(self, costs: Sequence[Optional[float]]) -> int:
        """Classic deficit round robin: pick the tenant whose head-of-line
        item (``costs[q]``; None = no item) should be served next.

        Each visit deals the visited tenant one weighted quantum; the
        first tenant whose deficit covers its item cost wins and pays.
        Terminates because every full rotation strictly grows every
        candidate's deficit.
        """
        cand = [
            q for q in range(self.nq)
            if costs[q] is not None and self.live[q]
        ]
        if not cand:
            raise ValueError("pick_next: no live tenant has a pending item")
        total_w = sum(self.weights[q] for q in cand)
        # Hard bound on rotations: enough for the costliest item even at
        # the smallest weighted quantum (plus slack); beyond it, serve the
        # largest-deficit candidate rather than loop.
        min_gain = self.cfg.quantum_rows * min(
            self.weights[q] / total_w for q in cand
        )
        max_cost = max(float(costs[q]) for q in cand)
        max_visits = (int(max_cost / max(min_gain, 1e-12)) + 2) * self.nq
        for _ in range(max_visits):
            q = self._cursor
            self._cursor = (self._cursor + 1) % self.nq
            if q not in cand:
                continue
            self.deficit_rows[q] += (
                self.cfg.quantum_rows * self.weights[q] / total_w
            )
            if self.deficit_rows[q] >= float(costs[q]):
                self.deficit_rows[q] -= float(costs[q])
                self.admitted[q] += 1
                return q
        q = max(cand, key=lambda a: self.deficit_rows[a])
        # Charge the served item like the normal path does (carrying debt)
        # — zeroing the deficit here let a tenant with oversized items
        # earn a free reset every time the rotation bound tripped,
        # systematically exceeding its weighted share.
        self.deficit_rows[q] -= float(costs[q])
        self.admitted[q] += 1
        return q


# --------------------------------------------------------------------- #
# SLO layer: deadline-aware admission + warehouse autoscaling
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class DeadlineConfig:
    """Tuning for :class:`DeadlineAwareAdmission`.

    ``urgency_horizon`` is the slack (seconds to deadline) below which the
    EDF credit boost ramps in: at slack >= horizon the planner behaves
    exactly like weight-only fair share, at slack <= 0 the boost is at
    its ``boost_quanta`` maximum.  ``preempt_headroom`` is the multiple
    of a tenant's weighted share of in-service rows beyond which it is
    named a preemption candidate (1.0 = any over-share tenant; higher =
    only clearly-over tenants).
    """

    urgency_horizon: float = 1.0
    boost_quanta: float = 2.0
    preempt_headroom: float = 1.25


class DeadlineAwareAdmission(FairShareAdmission):
    """Per-tenant SLO targets + EDF credit boost over weighted DRR.

    Each tenant may declare an SLO target (seconds from a work item's
    arrival to its completion).  Callers pass the item's absolute
    ``deadline`` and the current virtual ``now`` to :meth:`try_admit`;
    under contention the admission threshold is relaxed by a boost that
    grows linearly as slack shrinks inside ``urgency_horizon`` — but the
    FULL charge still lands on the tenant's deficit (debt), so admitted
    throughput still converges to the weighted shares over time; the
    boost only reorders WHO gets through while the deadline is live.

    Three additions over the base planner:

      * EDF release ordering — :meth:`release_order` sorts the parked
        tenants by earliest refused deadline (stable w.r.t. the base
        round-robin rotation, so tenants without deadlines keep rotating
        fairly behind the urgent ones).
      * :meth:`preempt_candidates` — names tenants whose in-service rows
        exceed ``preempt_headroom`` times their weighted share of the
        total (most-over-share first): their admitted-but-unstarted work
        is what an engine may re-park to make room for an urgent tenant.
      * :meth:`preempt_transfer` — the bookkeeping for one preemption:
        the victim's re-parked rows leave service (their charge is
        refunded, since re-admission will charge them again) and the
        urgent tenant's row deficit is advanced by the same amount
        (capped), which is what makes its retry admissible.

    Starvation-freedom is inherited: boosts and advances only ever ADD
    admissibility, deficits stay capped, and a tenant at its cap remains
    always admissible, so every backlogged tenant — with or without an
    SLO — is still eventually served.
    """

    def __init__(
        self,
        weights: Sequence[float],
        slo_targets: Sequence[Optional[float]],
        cfg: FairShareConfig = FairShareConfig(),
        deadline_cfg: DeadlineConfig = DeadlineConfig(),
    ):
        super().__init__(weights, cfg)
        if len(slo_targets) != self.nq:
            raise ValueError(
                f"slo_targets length {len(slo_targets)} != tenant count "
                f"{self.nq}"
            )
        self.slo_targets = [
            None if s is None else float(s) for s in slo_targets
        ]
        self.dcfg = deadline_cfg
        inf = float("inf")
        #: Earliest deadline among each tenant's currently-refused offers
        #: (inf = none pending); drives the EDF release order.
        self.pending_deadline = [inf] * self.nq
        # Telemetry.
        self.preempted_rows = [0.0] * self.nq
        self.boost_admits = [0] * self.nq

    # -- EDF credit boost ---------------------------------------------- #

    def _urgency(self, deadline: Optional[float], now: float) -> float:
        """0 (relaxed) → 1 (at/past deadline) inside the horizon."""
        if deadline is None or deadline == float("inf"):
            return 0.0
        h = max(self.dcfg.urgency_horizon, 1e-12)
        u = 1.0 - (deadline - now) / h
        return min(max(u, 0.0), 1.0)

    def try_admit(
        self,
        q: int,
        rows: int,
        nbytes: float,
        bytes_per_row: float = 0.0,
        deadline: Optional[float] = None,
        now: float = 0.0,
    ) -> bool:
        u = self._urgency(deadline, now)
        s = max(self.share_of(q), 1e-9)
        boost_r = u * self.dcfg.boost_quanta * self.cfg.quantum_rows * s
        boost_b = u * self.dcfg.boost_quanta * self.cfg.quantum_bytes * s
        contended = self._total_outstanding > 0.0
        boosted = (
            contended and boost_r > 0.0 and self.deficit_rows[q] < rows
        )
        # One shared park-or-admit body (the base class's), with the EDF
        # boosts relaxing the threshold; the full charge still lands.
        if not self._admit_checked(
            q, rows, nbytes, bytes_per_row, boost_r, boost_b
        ):
            if deadline is not None and deadline < self.pending_deadline[q]:
                self.pending_deadline[q] = deadline
            return False
        if boosted:
            self.boost_admits[q] += 1
        self.pending_deadline[q] = float("inf")
        return True

    def would_admit(
        self,
        q: int,
        rows: int,
        nbytes: float,
        bytes_per_row: float = 0.0,
        deadline: Optional[float] = None,
        now: float = 0.0,
        rows_advance: float = 0.0,
    ) -> bool:
        """Dry-run of :meth:`try_admit` (no state touched):
        ``rows_advance`` hypothesizes the row credit a preemption could
        transfer, so an engine can verify the urgent admission WOULD
        succeed before it displaces any victim's work."""
        u = self._urgency(deadline, now)
        s = max(self.share_of(q), 1e-9)
        return self._admissible(
            q, rows, self._nic_charge(nbytes, bytes_per_row),
            u * self.dcfg.boost_quanta * self.cfg.quantum_rows * s,
            u * self.dcfg.boost_quanta * self.cfg.quantum_bytes * s,
            rows_advance,
        )

    def try_readmit(
        self,
        q: int,
        rows: int,
        deadline: Optional[float] = None,
        now: float = 0.0,
    ) -> bool:
        """Recovered-row re-admission with the EDF boost: rows lost near
        a deadline re-enter with the same urgency relaxation a fresh
        urgent batch would get (the full retry charge still lands)."""
        ok = self.try_admit(q, rows, 0.0, 0.0, deadline=deadline, now=now)
        if ok:
            self.readmitted_rows[q] += rows
        return ok

    def release_order(self) -> List[int]:
        """EDF first: parked tenants with earlier refused deadlines come
        before later/deadline-free ones; ties keep the base round-robin
        rotation (the sort is stable), so no-SLO tenants still rotate."""
        order = super().release_order()
        return sorted(order, key=lambda q: self.pending_deadline[q])

    # -- preemption ----------------------------------------------------- #

    def preempt_candidates(
        self, protect: Sequence[int] = ()
    ) -> List[Tuple[int, float]]:
        """Over-share tenants whose in-service rows exceed
        ``preempt_headroom`` × their weighted share of total in-service
        rows.  Returns ``(tenant, excess_rows)`` pairs, most-over-share
        first (ties by tenant index); ``protect`` tenants are skipped."""
        tot = self._total_outstanding
        if tot <= 0.0:
            return []
        skip = set(protect)
        out: List[Tuple[int, float]] = []
        for q in range(self.nq):
            if q in skip or not self.live[q]:
                continue
            fair = self.dcfg.preempt_headroom * self.share_of(q) * tot
            excess = self.outstanding_rows[q] - fair
            if excess > 0.0:
                out.append((q, excess))
        out.sort(key=lambda t: -t[1])
        return out

    def preempt_transfer(self, victim: int, urgent: int, rows: float) -> None:
        """Account one preemption of ``rows`` admitted-but-unstarted rows
        from ``victim`` in favour of ``urgent`` (see class docstring)."""
        take = min(float(rows), self.outstanding_rows[victim])
        self.outstanding_rows[victim] -= take
        self._total_outstanding = max(self._total_outstanding - take, 0.0)
        # Refund the victim (its re-parked rows will be charged again on
        # re-admission) and advance the urgent tenant by the same amount.
        self.deficit_rows[victim] = min(
            self.deficit_rows[victim] + take, self._cap_rows(victim)
        )
        self.deficit_rows[urgent] = min(
            self.deficit_rows[urgent] + take, self._cap_rows(urgent)
        )
        self.preempted_rows[victim] += take
        self.backlogged[victim] = True


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Tuning for :class:`AutoscalePolicy`.

    The pool grows by ``step`` whole workers when queued rows per active
    worker exceed ``backlog_high`` — or when running SLO attainment sags
    below ``attainment_low`` while any backlog exists — and shrinks when
    backlog per worker falls under ``backlog_low`` with attainment
    healthy.  ``interval`` is the decision cadence (virtual seconds) and
    ``cooldown`` the minimum time between two resizes (the hysteresis
    that stops flapping).  ``min_workers``/``max_workers`` bound the pool
    (engines clamp ``max_workers`` to the physical cluster).
    """

    min_workers: int = 8
    max_workers: int = 1 << 30
    backlog_high: float = 64.0
    backlog_low: float = 8.0
    attainment_low: float = 0.9
    step: int = 4
    interval: float = 0.25
    cooldown: float = 0.5


class AutoscalePolicy:
    """Deterministic hysteresis autoscaler (decision logic only).

    Engines call :meth:`decide` on a fixed cadence with the observed
    backlog and (optionally) the running SLO attainment; the returned
    worker count is what the pool should be rescaled to.  No randomness,
    no wall clock — the same observation sequence always produces the
    same resize sequence, preserving the engines' determinism contract.
    """

    def __init__(self, cfg: AutoscaleConfig):
        self.cfg = cfg
        self._last_resize = -float("inf")
        #: (now, old, new) log of every applied resize (telemetry).
        self.resizes: List[Tuple[float, int, int]] = []

    def decide(
        self,
        now: float,
        active: int,
        backlog_rows: float,
        attainment: Optional[float] = None,
    ) -> int:
        c = self.cfg
        if now - self._last_resize < c.cooldown:
            return active
        per = backlog_rows / max(active, 1)
        target = active
        if per > c.backlog_high or (
            attainment is not None
            and attainment < c.attainment_low
            and backlog_rows > 0.0
        ):
            target = active + c.step
        elif per < c.backlog_low and (
            attainment is None or attainment >= c.attainment_low
        ):
            target = active - c.step
        target = min(max(target, c.min_workers), c.max_workers)
        if target != active:
            self._last_resize = now
            self.resizes.append((now, active, target))
        return target
