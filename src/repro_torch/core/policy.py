"""Pluggable redistribution policies: the strategy seam shared by the
simulator, the serving engine and the data pipeline.

The paper's comparison — legacy static round-robin vs DySkew's adaptive
per-link redistribution — used to live as string ``kind ==`` branches
inside ``repro_torch.sim.engine``; this module extracts the seam so a new
placement policy is a ~100-line plugin instead of an engine patch.

Contract
--------
A :class:`RedistributionPolicy` observes per-link state (per-destination
outstanding backlog, the tenant's opaque per-row cost estimate, the
adaptive link's distribute mask when it consumes one) and proposes
per-destination row counts for each batch.  All randomness comes from the
injected ``PolicyContext.rng`` stream (ab-sim pattern), so stochastic
policies are bit-reproducible run-to-run for a fixed seed, and the
deterministic built-ins consult no RNG at all.  Cost/admission guards do
NOT fork per policy: the generic :meth:`RedistributionPolicy.route` wraps
every proposal with the shared `repro_torch.core.admission.BatchAdmission`
planner (density guard before proposing, cost gate after), the same
guards the serving engine and data pipeline apply.

Engines resolve policies BY NAME through the registry
(:func:`register_policy` / :func:`resolve_policy`); an unresolvable name
raises ``ValueError`` at :class:`StrategyConfig` construction instead of
silently behaving like ``none``.  Capability flags are CLASS attributes —
the simulator's fast paths ask the policy, not a string, whether their
closed forms apply:

  * ``uses_link`` — the policy consumes the adaptive-link state machine:
    the engine creates/ticks link instances (batched-tick groups included)
    and pushes each tick's distribute mask via :meth:`set_link_mask`.
  * ``never_redistributes`` — every row provably stays on its producer,
    which is what licenses the engine's closed-form 'none' fast path.
  * ``drain_safe`` — policy state changes only inside :meth:`route`, so
    once every arrival has been routed nothing the policy could do can
    change the result; this is what licenses the closed-form drain.  A
    policy that mutates observable state on any other trigger must clear
    this flag, and the engine will replay the heap to exhaustion.
  * ``batched_waterfill`` — the proposal is exactly a waterfill over
    :meth:`spread_backlog`, so the engine's coalesced same-instant
    arrival run may plan it through one ``waterfill_counts_many`` call
    (bit-identical to the scalar path by shared repair).
  * ``pays_decision_overhead`` — the engine charges
    ``StrategyConfig.decision_overhead`` per routed batch (the legacy
    static strategies historically paid none).

Registering a new policy::

    @register_policy
    class MyPolicy(RedistributionPolicy):
        name = "mine"
        def propose(self, producer, k, backlog, unit):
            counts = np.zeros(len(backlog), np.int64)
            counts[int(np.argmin(backlog))] = k   # conservation: sum == k
            return counts

    StrategyConfig(kind="mine")            # simulator
    ServeConfig(scheduler="mine")          # serving placement
    DataConfig(placement="mine")           # data-pipeline sharding

Conservation invariant: ``propose`` returns either ``None`` (keep the
whole batch on its producer) or an ``(n,)`` int64 vector of
per-destination row counts summing EXACTLY to ``k`` with zero rows on
non-finite (+inf-masked: decommissioned or self-skip-ineligible)
destinations.  ``tests/test_policy_interface.py`` property-checks every
registered policy against this.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, Dict, List, Optional, Sequence, Tuple, Type

import numpy as np

from repro_torch.core.admission import BatchAdmission
from repro_torch.core.types import DySkewConfig, Policy


# --------------------------------------------------------------------- #
# Waterfill routing math (shared by the sim engine and the policies)
# --------------------------------------------------------------------- #


def _waterfill_repair(
    bl: np.ndarray, counts: np.ndarray, diff: int, finite: np.ndarray,
    unit: float,
) -> np.ndarray:
    """Repair the floor rounding of a closed-form waterfill in place.

    Shared verbatim between the scalar :func:`waterfill_counts` and the
    batched :func:`waterfill_counts_many` (which calls it per row needing
    repair), so the two are bit-identical by construction — including the
    argmax/argsort tie-breaking that a re-implementation would have to
    replicate exactly.
    """
    while diff > 0:
        # Trim one item at a time from the currently most-loaded bin —
        # bulk-trimming a single bin un-levels the fill (hypothesis-found).
        loads = np.where(counts > 0, bl + counts * unit, -np.inf)
        d = int(np.argmax(loads))
        counts[d] -= 1
        diff -= 1
    if diff < 0:
        order = np.argsort(np.where(finite, bl + counts * unit, np.inf))
        ne = int(finite.sum())
        i = 0
        while diff < 0:
            counts[order[i % ne]] += 1
            diff += 1
            i += 1
    return counts


def waterfill_counts(backlog: np.ndarray, k: int, unit: float) -> np.ndarray:
    """Assign ``k`` unit-cost rows to bins so resulting loads are as level
    as possible (vectorized least-backlog greedy for identical costs).

    The continuous water level is solved in closed form (with the j lowest
    backlogs submerged, level_j = (k*unit + sum of those backlogs) / j; the
    true level is the largest j consistent with its own submerged set) and
    the integer counts are floored from it, so no bisection loop is needed;
    the trim/top-up passes of `_waterfill_repair` fix the floor rounding
    exactly.
    """
    n = len(backlog)
    finite = np.isfinite(backlog)
    out = np.zeros(n, np.int64)
    if k == 0:
        return out
    if not finite.any():
        out[0] = k
        return out
    bl = backlog.copy()
    blf = np.sort(bl[finite])
    levels = (k * unit + np.cumsum(blf)) / np.arange(1, len(blf) + 1)
    j = int(np.nonzero(levels >= blf)[0][-1])  # always valid at j=0
    counts = np.floor(np.maximum(levels[j] - bl, 0.0) / unit)
    counts[~finite] = 0
    counts = counts.astype(np.int64)
    diff = int(counts.sum()) - k
    if diff:
        counts = _waterfill_repair(bl, counts, diff, finite, unit)
    return counts


def waterfill_counts_many(
    backlogs: np.ndarray, ks: np.ndarray, units: np.ndarray
) -> np.ndarray:
    """:func:`waterfill_counts` batched over a leading axis: row ``b`` of
    the (B, n) result equals ``waterfill_counts(backlogs[b], ks[b],
    units[b])`` bit-for-bit.

    The closed-form level is solved for every row at once (one (B, n)
    sort + cumsum instead of B scalar calls; rows pad their non-finite
    backlogs with +inf so the sorted prefix — and hence the cumsum prefix
    the level formula reads — matches the scalar compacted sort exactly),
    and the rank-based trim/top-up repair runs only on the rows whose
    floored counts missed ``k`` — through the SAME `_waterfill_repair`
    the scalar path uses, so tie-breaking cannot drift.
    """
    bl = np.asarray(backlogs, np.float64)
    B, n = bl.shape
    ks = np.asarray(ks, np.int64)
    units = np.asarray(units, np.float64)
    finite = np.isfinite(bl)
    ne = finite.sum(axis=1)
    out = np.zeros((B, n), np.int64)
    live = (ks > 0) & (ne > 0)
    # Degenerate rows: k == 0 → all zeros; no finite bin → everything on
    # bin 0 (same as the scalar fallback).
    none_finite = (ks > 0) & (ne == 0)
    out[none_finite, 0] = ks[none_finite]
    if not live.any():
        return out
    padded = np.where(finite, bl, np.inf)
    blf = np.sort(padded, axis=1)
    with np.errstate(invalid="ignore"):
        levels = (
            ks[:, None] * units[:, None] + np.cumsum(blf, axis=1)
        ) / np.arange(1, n + 1)
        cond = (levels >= blf) & (np.arange(n) < ne[:, None])
    j = n - 1 - np.argmax(cond[:, ::-1], axis=1)  # last True per row
    level = levels[np.arange(B), j]
    with np.errstate(invalid="ignore"):
        counts = np.floor(
            np.maximum(level[:, None] - bl, 0.0) / units[:, None]
        )
    counts[~finite] = 0.0
    counts[~live] = 0.0
    counts = counts.astype(np.int64)
    diffs = counts.sum(axis=1) - np.where(live, ks, 0)
    for b in np.flatnonzero(diffs):
        counts[b] = _waterfill_repair(
            bl[b], counts[b], int(diffs[b]), finite[b], float(units[b])
        )
    out[live] = counts[live]
    return out


# --------------------------------------------------------------------- #
# Policy context and registry
# --------------------------------------------------------------------- #


def _no_mask() -> Optional[np.ndarray]:
    return None


def _default_est() -> float:
    return 1e-3


def _no_outstanding() -> Sequence[float]:
    raise RuntimeError(
        "PolicyContext.outstanding was not supplied — only the simulator "
        "seam (RedistributionPolicy.route) reads it; standalone contexts "
        "(serving placement, data sharding, property tests) use propose/"
        "place_one/assign, which take the backlog explicitly"
    )


def _no_idle(_p: int) -> float:
    return 0.0


@dataclasses.dataclass
class PolicyContext:
    """What a policy may observe, supplied by the host engine.

    The live views are zero-arg callables because the engine locals they
    read (cost estimate, outstanding backlog, autoscale masks) are
    reassigned during a run — a policy must always see the current value.
    ``rng`` is the injected randomness stream: the host derives it from
    its own seed (the simulator spawns one child stream per tenant), so
    a stochastic policy is reproducible for a fixed seed without ever
    touching global numpy state.
    """

    num_workers: int
    # Seeded default: a context built without an explicit stream must
    # still be reproducible run-to-run (an argless default_rng() here
    # once handed every standalone context — serving placement tests,
    # ad-hoc policy probes — a fresh OS-entropy stream).
    rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(0)
    )
    node_of: Callable[[int], int] = staticmethod(lambda w: 0)
    network_bandwidth: float = 1.25e9
    per_row_serialize: float = 2e-6
    # Live engine views (see class docstring).
    est_row_cost: Callable[[], float] = staticmethod(_default_est)
    outstanding: Callable[[], Sequence[float]] = staticmethod(
        _no_outstanding
    )
    idle_sibling_frac: Callable[[int], float] = staticmethod(_no_idle)
    #: Boolean (n,) mask of ROUTABLE workers (commissioned ∧ live ∧ not
    #: draining/excluded), or None when the whole pool is eligible.
    #: Under faults the engine composes worker liveness into this view,
    #: so every mask-aware policy is fault-aware for free.
    active_mask: Callable[[], Optional[np.ndarray]] = staticmethod(_no_mask)
    #: Int ids of routable workers (None = whole pool eligible).
    active_ids: Callable[[], Optional[np.ndarray]] = staticmethod(_no_mask)
    #: Fault layer: boolean (n,) liveness-only mask (True = the worker is
    #: up and accepting rows, independent of autoscale commissioning), or
    #: None when no fault schedule is active.  Most policies should use
    #: ``active_mask``, which already folds this in; ``live_mask`` lets a
    #: policy distinguish "decommissioned" from "dead/draining".
    live_mask: Callable[[], Optional[np.ndarray]] = staticmethod(_no_mask)


_REGISTRY: Dict[str, Type["RedistributionPolicy"]] = {}


def register_policy(
    cls: Type["RedistributionPolicy"],
) -> Type["RedistributionPolicy"]:
    """Class decorator: register ``cls`` under its ``name`` attribute."""
    name = cls.name
    if not name:
        raise ValueError(f"{cls.__name__} has no `name` to register under")
    if name in _REGISTRY:
        raise ValueError(
            f"redistribution policy {name!r} is already registered "
            f"({_REGISTRY[name].__name__})"
        )
    _REGISTRY[name] = cls
    return cls


def resolve_policy(name: str) -> Type["RedistributionPolicy"]:
    """Look a policy class up by registry name; unknown names raise
    ``ValueError`` (the silent-fallthrough bug this registry replaces:
    an unmatched ``kind`` string used to behave like ``none``)."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown redistribution policy {name!r}; registered: "
            f"{sorted(_REGISTRY)}"
        ) from None


def available_policies() -> List[str]:
    """Sorted names of every registered policy (the tournament roster)."""
    return sorted(_REGISTRY)


# --------------------------------------------------------------------- #
# Strategy configuration (resolves a policy through the registry)
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class StrategyConfig:
    kind: str = "dyskew"              # any registered policy name
    dyskew: DySkewConfig = dataclasses.field(
        default_factory=lambda: DySkewConfig(policy=Policy.EAGER_SNOWPARK)
    )
    # Metrics-subsystem cadence: state machines tick every `tick_interval`
    # seconds of virtual time.
    tick_interval: float = 50e-3
    # Adaptive-decision CPU overhead charged per routed batch (metrics
    # sampling + state machine + waterfill in the VW worker thread). The
    # legacy static strategy pays none.
    decision_overhead: float = 200e-6
    # EMA horizon for the opaque per-row cost estimate.
    cost_ema: float = 0.2
    # Disable the per-batch admission guards (ablations).
    enable_density_guard: bool = True
    enable_cost_gate: bool = True
    # Free-form per-policy tuning knobs as (name, value) pairs (a tuple
    # keeps the config hashable); read via `param`.
    params: Tuple[Tuple[str, float], ...] = ()

    def __post_init__(self):
        # Fail at CONSTRUCTION, not deep inside a run: an unknown kind
        # used to fall through every engine branch and silently behave
        # like 'none'.
        resolve_policy(self.kind)

    def param(self, name: str, default: float) -> float:
        for k, v in self.params:
            if k == name:
                return v
        return default

    def admission(self) -> BatchAdmission:
        """The shared `repro_torch.core` admission planner for this strategy."""
        return BatchAdmission(
            self.dyskew,
            enable_density_guard=self.enable_density_guard,
            enable_cost_gate=self.enable_cost_gate,
        )

    def policy_class(self) -> Type["RedistributionPolicy"]:
        return resolve_policy(self.kind)

    def make_policy(self, ctx: PolicyContext) -> "RedistributionPolicy":
        """One policy instance per (tenant, run) — policies are stateful
        (round-robin counters, tuning state, eligibility caches)."""
        return resolve_policy(self.kind)(self, ctx)


# --------------------------------------------------------------------- #
# The policy interface
# --------------------------------------------------------------------- #


class RedistributionPolicy:
    """Base class: a per-tenant, per-run placement policy.

    Subclasses usually implement only :meth:`propose` (pure placement
    math) and inherit the guarded :meth:`route` seam, the single-row
    :meth:`place_one` placement (serving) and the whole-batch
    :meth:`assign` sharding (data pipeline).  See the module docstring
    for the capability flags and the conservation contract.
    """

    #: Registry name (class attribute; set by subclasses).
    name: ClassVar[str] = ""
    #: Consumes the adaptive-link state machine (tick cadence + mask).
    uses_link: ClassVar[bool] = False
    #: Provably keeps every row on its producer (closed-form 'none' hook).
    never_redistributes: ClassVar[bool] = False
    #: State changes only inside `route` (closed-form drain hook).
    drain_safe: ClassVar[bool] = True
    #: Proposal is a pure waterfill over `spread_backlog` (coalesced-run
    #: batched planning hook).
    batched_waterfill: ClassVar[bool] = False
    #: Engine charges `StrategyConfig.decision_overhead` per routed batch.
    pays_decision_overhead: ClassVar[bool] = True
    #: Consults the injected RNG stream.
    stochastic: ClassVar[bool] = False

    def __init__(self, strategy: StrategyConfig, ctx: PolicyContext):
        self.strategy = strategy
        self.ctx = ctx
        # The shared per-batch admission planner (density guard / cost
        # gate / self-skip eligibility) — guards do not fork per policy.
        self.admission = strategy.admission()
        self.link_mask: List[bool] = [False] * ctx.num_workers
        self._elig: Dict[int, np.ndarray] = {}

    # -- pure placement math (reused by serving, data, and tests) ------ #

    def propose(
        self, producer: int, k: int, backlog: np.ndarray, unit: float
    ) -> Optional[np.ndarray]:
        """Per-destination row counts for ``k`` rows from ``producer``.

        ``backlog`` is the observed per-destination load in seconds with
        ineligible destinations masked to +inf; ``unit`` is the estimated
        seconds per row.  Returns ``None`` (keep the batch local) or an
        (n,) int64 counts vector summing exactly to ``k`` with zero on
        non-finite destinations.
        """
        return None

    def place_one(self, backlog: np.ndarray, producer: int = -1) -> int:
        """Destination of a single fresh row/request (the serving
        engine's eager placement).  Default: least loaded."""
        bl = np.asarray(backlog, np.float64)
        return int(np.argmin(np.where(np.isfinite(bl), bl, np.inf)))

    def assign(
        self, costs: np.ndarray, producers: np.ndarray, n: int
    ) -> np.ndarray:
        """Destination per item for a whole batch with known per-item
        costs (the data pipeline's sharding step).  Default: sequential
        `place_one` against the running backlog."""
        costs = np.asarray(costs, np.float64)
        producers = np.asarray(producers, np.int64)
        backlog = np.zeros(n, np.float64)
        out = np.empty(len(costs), np.int64)
        for i in range(len(costs)):
            d = self.place_one(backlog, producer=int(producers[i]))
            out[i] = d
            backlog[d] += costs[i]
        return out

    # -- shared guard pipeline (the BatchAdmission planner) ------------ #

    def density_blocks(self, producer: int, batch) -> bool:
        """Row Size Model admission guard (§III.B): low batch density +
        no skew benefit visible → keep the heavy rows local."""
        bpr = batch.total_bytes / max(batch.num_rows, 1)
        return self.admission.density_guard_blocks(
            batch.num_rows, bpr,
            lambda: self.ctx.idle_sibling_frac(producer),
        )

    def admits(self, producer: int, batch, dests: np.ndarray) -> bool:
        """Cost gate (§I goal 3): refuse when estimated movement time
        exceeds estimated straggler savings."""
        if not self.strategy.enable_cost_gate:
            return True
        moving = dests != producer
        dec = self.admission.admit_move(
            float(batch.sizes[moving].sum()), int(moving.sum()),
            self.ctx.est_row_cost(), self.ctx.num_workers,
            self.ctx.network_bandwidth, self.ctx.per_row_serialize,
        )
        return dec.admit

    def eligible(self, producer: int) -> np.ndarray:
        """Self-skip eligibility mask for ``producer`` (cached — the
        mask depends only on topology)."""
        m = self._elig.get(producer)
        if m is None:
            m = self.admission.eligible_destinations(
                self.ctx.num_workers, producer, self.ctx.node_of
            )
            self._elig[producer] = m
        return m

    def spread_backlog(self, producer: int, out_vec) -> np.ndarray:
        """The waterfill input: outstanding rows × estimated row cost,
        with decommissioned (autoscale) and self-skip-ineligible
        destinations masked to +inf.  ``out_vec`` is the live
        outstanding list (scalar path) or a planner's shadow copy."""
        bl = np.asarray(out_vec) * self.ctx.est_row_cost()
        act = self.ctx.active_mask()
        if act is not None:
            # Decommissioned workers are ineligible destinations.
            bl = np.where(act, bl, np.inf)
        lv = self.ctx.live_mask()
        if lv is not None:
            # Dead/draining/excluded workers are ineligible too.  The
            # simulator folds liveness into active_mask already; this
            # guards hosts that supply the two views independently.
            bl = np.where(lv, bl, np.inf)
        if self.strategy.dyskew.self_skip:
            # Forced-remote ablation (§III.B): the producer must bypass
            # its own node's interpreters entirely (Fig. 1 —
            # redistribution targets interpreters on *other* VW nodes),
            # leaving local CPU idle.
            bl = np.where(self.eligible(producer), bl, np.inf)
        return bl

    def spread_unit(self) -> float:
        return max(self.ctx.est_row_cost(), 1e-9)

    # -- the simulator seam -------------------------------------------- #

    def wants_spread(self, producer: int, batch) -> bool:
        """Cheap pre-proposal check: False keeps the batch local without
        computing a plan.  The coalesced-run planner consults this too."""
        return not self.density_blocks(producer, batch)

    def route(
        self, producer: int, batch, now: float
    ) -> Optional[np.ndarray]:
        """Per-ROW destinations for one batch, or None to keep it local.

        The generic guard pipeline around :meth:`propose` — density
        guard, proposal over the masked backlog, cost gate — shared by
        every policy that does not override it (the legacy static_rr
        pays no guards and overrides).
        """
        if not self.wants_spread(producer, batch):
            return None
        counts = self.propose(
            producer, batch.num_rows,
            self.spread_backlog(producer, self.ctx.outstanding()),
            self.spread_unit(),
        )
        if counts is None:
            return None
        dests = np.repeat(np.arange(self.ctx.num_workers), counts)
        if len(dests) != batch.num_rows:
            raise ValueError(
                f"policy {self.name!r} broke conservation: proposed "
                f"{len(dests)} rows for a {batch.num_rows}-row batch"
            )
        if not self.admits(producer, batch, dests):
            return None
        return dests

    def paces_spread(self, producer: int) -> bool:
        """Flow-control hook: True → the producer paces against the
        least-backlogged eligible destination (it can spread), False →
        against its own worker's backlog (it routes locally)."""
        return not self.never_redistributes

    def set_link_mask(self, mask: List[bool]) -> None:
        """Engine push of the adaptive link's distribute mask after each
        metrics tick (only called when ``uses_link``)."""
        self.link_mask = mask


# --------------------------------------------------------------------- #
# Built-in policies (the three ported engine strategies)
# --------------------------------------------------------------------- #


@register_policy
class NonePolicy(RedistributionPolicy):
    """Default 1:1 link — no redistribution, ever.  Rows stay on their
    producer; a fresh row with NO producer (serving placement) goes to
    the least-loaded worker (the eager free path — placing is not
    redistributing)."""

    name = "none"
    never_redistributes = True
    pays_decision_overhead = False

    def route(self, producer, batch, now):
        return None

    def paces_spread(self, producer):
        return False

    def assign(self, costs, producers, n):
        return np.asarray(producers, np.int64).copy()


@register_policy
class StaticRRPolicy(RedistributionPolicy):
    """The legacy Snowpark solution (paper §II.B, Fig. 1): per-row
    round-robin across all interpreters from the start — oblivious to
    backlog, density and cost, and paying no guards and no decision
    overhead (it makes no decision)."""

    name = "static_rr"
    pays_decision_overhead = False

    def __init__(self, strategy, ctx):
        super().__init__(strategy, ctx)
        self._rr = 0

    def route(self, producer, batch, now):
        # Bit-exact port of the engine's static_rr branch: cyclic per-ROW
        # destinations (row i → slot (rr+i) mod n), cycling only the
        # commissioned workers under autoscale.  Guards don't apply.
        k = batch.num_rows
        ids = self.ctx.active_ids()
        if ids is None:
            dests = (self._rr + np.arange(k)) % self.ctx.num_workers
        else:
            dests = ids[(self._rr + np.arange(k)) % len(ids)]
        self._rr += k
        return dests

    def propose(self, producer, k, backlog, unit):
        # Counts form of the same cycle over the eligible destinations
        # (serving/data reuse; the simulator takes `route`).
        ids = np.flatnonzero(np.isfinite(np.asarray(backlog, np.float64)))
        if not len(ids):
            return None
        counts = np.bincount(
            ids[(self._rr + np.arange(k)) % len(ids)],
            minlength=len(backlog),
        ).astype(np.int64)
        self._rr += k
        return counts

    def place_one(self, backlog, producer=-1):
        # One row is the k=1 case of propose: the next destination of the
        # cycle, which advances it by one.
        counts = self.propose(producer, 1, backlog, 0.0)
        if counts is None:
            raise ValueError("static_rr: no eligible destination")
        return int(np.flatnonzero(counts)[0])


@register_policy
class DySkewPolicy(RedistributionPolicy):
    """The paper's adaptive link: redistribute only when the per-link
    state machine's distribute mask says the producer is skewed, by
    waterfilling the batch over observed backlog, behind the density
    guard and cost gate."""

    name = "dyskew"
    uses_link = True
    batched_waterfill = True

    def wants_spread(self, producer, batch):
        return self.link_mask[producer] and not self.density_blocks(
            producer, batch
        )

    def paces_spread(self, producer):
        # Flow control follows the link: while the mask says the producer
        # routes locally, it paces against its own worker's backlog.
        return self.link_mask[producer]

    def propose(self, producer, k, backlog, unit):
        return waterfill_counts(backlog, k, unit)


# --------------------------------------------------------------------- #
# New policies (landed through the seam, ≲150 LoC each)
# --------------------------------------------------------------------- #


@register_policy
class PowerOfTwoPolicy(RedistributionPolicy):
    """Power-of-two-choices sampling: probe two uniformly random eligible
    destinations per batch and send the whole batch to the less loaded —
    the classic O(1)-state load balancer (exponential improvement over
    one random choice).  All randomness comes from the injected
    `PolicyContext.rng`, so a fixed seed reproduces the trajectory."""

    name = "p2c"
    stochastic = True

    def propose(self, producer, k, backlog, unit):
        bl = np.asarray(backlog, np.float64)
        ids = np.flatnonzero(np.isfinite(bl))
        if not len(ids):
            return None
        if len(ids) == 1:
            d = int(ids[0])
        else:
            a, b = self.ctx.rng.choice(len(ids), size=2, replace=False)
            # Lower backlog wins; tie → the first sample.
            d = int(ids[a] if bl[ids[a]] <= bl[ids[b]] else ids[b])
        counts = np.zeros(len(bl), np.int64)
        counts[d] = k
        return counts

    def place_one(self, backlog, producer=-1):
        counts = self.propose(producer, 1, backlog, 1.0)
        return int(np.argmax(counts))


@register_policy
class KeyAffinityPolicy(RedistributionPolicy):
    """Key-affinity / locality-aware placement: keep as many rows as the
    balanced water level (plus a slack allowance) permits on their
    producer, and spill only the excess — preferring same-node
    destinations by penalizing remote backlogs.  Minimizes rows moved
    off their producer subject to staying near-level.

    Knobs (via ``StrategyConfig.params``): ``affinity_slack`` — extra
    local rows allowed as a fraction of the batch (default 0.25);
    ``affinity_remote_penalty`` — row-equivalents added to off-node
    backlogs when spilling (default 8)."""

    name = "key_affinity"

    def propose(self, producer, k, backlog, unit):
        bl = np.asarray(backlog, np.float64)
        n = len(bl)
        finite = np.isfinite(bl)
        if not finite.any():
            return None
        counts = np.zeros(n, np.int64)
        spill = k
        if 0 <= producer < n and finite[producer]:
            level_counts = waterfill_counts(bl, k, unit)
            slack = int(self.strategy.param("affinity_slack", 0.25) * k)
            keep = min(k, int(level_counts[producer]) + slack)
            counts[producer] = keep
            spill = k - keep
        if spill:
            pen = self.strategy.param("affinity_remote_penalty", 8.0) * unit
            node = self.ctx.node_of
            home = node(producer) if 0 <= producer < n else -1
            off_node = np.asarray(
                [node(w) != home for w in range(n)], bool
            )
            spilled = waterfill_counts(
                np.where(off_node, bl + pen, bl), spill, unit
            )
            counts += spilled
        return counts

    def place_one(self, backlog, producer=-1):
        bl = np.asarray(backlog, np.float64)
        finite = np.isfinite(bl)
        if 0 <= producer < len(bl) and finite[producer]:
            fin = bl[finite]
            # Affinity: stay home unless the producer is clearly above
            # the mean load.
            if bl[producer] <= float(fin.mean()) + float(fin.std()):
                return producer
        return super().place_one(bl, producer)


@register_policy
class HillClimbPolicy(RedistributionPolicy):
    """Online hill-climbing: one scalar knob — the spread fraction θ of
    each batch that leaves the producer (the rest stays local) — tuned
    from per-link state.  Every ``hc_adjust_every`` routed batches the
    policy compares the smoothed backlog imbalance (max − mean, in row
    units) against the previous window and keeps walking θ in the same
    direction if the imbalance improved, else reverses — classic
    hill-climbing on a live objective.  Deterministic: the observations
    come from the routing trajectory, not an RNG.

    Knobs (via ``StrategyConfig.params``): ``hc_theta0`` (initial spread
    fraction, default 0.5), ``hc_step`` (θ step, default 0.15),
    ``hc_adjust_every`` (batches per adjustment, default 8)."""

    name = "hillclimb"

    def __init__(self, strategy, ctx):
        super().__init__(strategy, ctx)
        self.theta = float(strategy.param("hc_theta0", 0.5))
        self._step = float(strategy.param("hc_step", 0.15))
        self._every = max(int(strategy.param("hc_adjust_every", 8)), 1)
        self._dir = 1.0
        self._ema = 0.0
        self._prev = float("inf")
        self._routes = 0

    def _observe(self, bl_finite: np.ndarray, unit: float) -> None:
        imb = float(bl_finite.max() - bl_finite.mean()) / max(unit, 1e-9)
        self._ema = 0.8 * self._ema + 0.2 * imb
        self._routes += 1
        if self._routes % self._every == 0:
            if self._ema > self._prev:
                self._dir = -self._dir    # got worse → reverse course
            self.theta = float(np.clip(
                self.theta + self._dir * self._step, 0.0, 1.0
            ))
            self._prev = self._ema

    def propose(self, producer, k, backlog, unit):
        bl = np.asarray(backlog, np.float64)
        finite = np.isfinite(bl)
        if not finite.any():
            return None
        self._observe(bl[finite], unit)
        counts = np.zeros(len(bl), np.int64)
        keep = 0
        if 0 <= producer < len(bl) and finite[producer]:
            keep = k - int(round(self.theta * k))
            counts[producer] = keep
        spill = k - keep
        if spill:
            counts += waterfill_counts(bl, spill, unit)
        return counts
