"""Multi-stage UDF pipelines: skew that PROPAGATES.

Every other scenario in `repro_torch.sim` is a single operator stage.  Real
Snowpark workloads are DAGs where one UDF's skewed output becomes the
next stage's skewed input — the regime Reshape (adaptive result-aware
skew handling) and Lachesis (partitioning for UDF-centric DAGs) target.
This module chains `MultiQuerySimulator` stages through inter-stage
shuffles while preserving per-row lineage, so skew amplification and
attenuation are measurable stage by stage:

  * :class:`StageSpec` — one UDF operator stage: a per-stage cost/size
    model over the row KEYS, an output fanout + key transform (the UDF's
    result shape), a redistribution `StrategyConfig` resolved through
    the `repro_torch.core.policy` registry, and the exchange mode feeding the
    NEXT stage.
  * :class:`PipelineSimulator` — runs the stages in sequence.  Stage k
    executes all tenants concurrently on the shared cluster (one
    `MultiQuerySimulator.run` with ``trace_placement=True``); each
    tenant's stage-(k+1) arrival is its stage-k completion (a blocking
    exchange, like a sort/aggregate barrier), and the shuffle builds the
    next stage's per-producer streams from the traced per-row worker
    placements.

Two exchange modes, two skew mechanisms:

  ``worker`` — output rows are produced where their parent row ran, so
      the next stage's input partition IS this stage's placement: a
      stage that redistributed well hands the next stage balanced input
      (skew attenuates), a stage that didn't hands its skew downstream
      (skew propagates).
  ``hash`` — output rows are hash-partitioned on their (transformed)
      key: placement history is erased, but key collisions concentrate
      rows (a groupby onto few groups AMPLIFIES skew regardless of how
      well the previous stage balanced).

Modeling note: the exchange is a per-tenant barrier, so cross-tenant
contention is modeled within each stage (tenants share workers/NICs in
virtual time) but a tenant's stage k+1 never overlaps another tenant's
stage k — stages run in separate simulator invocations, with arrivals
carrying the absolute virtual-time offsets across them.

Determinism: every random quantity (keys, costs, sizes, fanout) comes
from a locally constructed ``np.random.default_rng`` seeded by
``(pipeline seed, stage, tenant)``, so two same-seed runs are
bit-identical end to end (pinned by tests/test_pipeline.py).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.admission import FairShareConfig
from repro_torch.core.types import DySkewConfig, Policy, SkewModelKind
from repro_torch.sim.engine import (
    Batch,
    ClusterConfig,
    MultiQuerySimulator,
    QueryResult,
    StrategyConfig,
    TenantQuery,
)

#: Knuth multiplicative hash — decorrelates key values from worker ids
#: so hash partitioning is uniform unless keys genuinely collide.
_HASH_MULT = np.int64(2654435761)
_HASH_MASK = np.int64((1 << 31) - 1)


def hash_partition(keys: np.ndarray, n_workers: int) -> np.ndarray:
    """Deterministic hash partitioning of int keys onto workers."""
    k = np.asarray(keys, np.int64)
    return ((k * _HASH_MULT) & _HASH_MASK) % n_workers


def zipf_keys(
    n_rows: int, num_keys: int, alpha: float, rng: np.random.Generator
) -> np.ndarray:
    """``n_rows`` keys drawn from a Zipf(alpha) popularity distribution
    over ``num_keys`` distinct key values (alpha<=0 = uniform)."""
    if num_keys <= 0:
        raise ValueError("num_keys must be positive")
    if alpha <= 0.0:
        return rng.integers(0, num_keys, n_rows).astype(np.int64)
    probs = 1.0 / np.arange(1, num_keys + 1, dtype=np.float64) ** alpha
    probs /= probs.sum()
    return rng.choice(num_keys, size=n_rows, p=probs).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One UDF operator stage of a pipeline.

    The per-row model functions all take ``(keys, rng)`` and return an
    array aligned with ``keys``; they MUST be pure functions of their
    arguments (the rng is seeded per (pipeline seed, stage, tenant)) so
    pipelines replay deterministically.

      cost_fn   — per-row UDF seconds (default: lognormal around
                  ``mean_row_cost`` with ``cost_sigma``);
      size_fn   — per-row bytes (default: constant ``row_bytes``);
      fanout_fn — output rows per input row, int >= 0 (default: 1);
      key_fn    — transform applied to the OUTPUT rows' keys (default:
                  identity).  Collapsing transforms (``k % 8``) model
                  skew-amplifying groupbys; rekeying transforms model
                  skew-attenuating explodes.

    ``shuffle`` is the exchange feeding the NEXT stage (ignored for the
    last stage): ``"worker"`` keeps output rows on the worker that
    produced them, ``"hash"`` repartitions by transformed key.
    """

    name: str
    # Distribute-Late + idle-time detection + LOOPING link: the
    # UDF-stage configuration.  Idle-time because §III.A calls it the
    # most effective model for variable per-row costs (row-percentage
    # triggers on transient arrival imbalance and spreads even balanced
    # stages); looping because a continuously-fed exchange needs
    # multi-wave redistribution — the non-looping link fires once and
    # goes terminal with most of the stage still arriving.  Note
    # `override_strategy` switches only the KIND, so the dyskew arm of
    # an A/B keeps this detection config.
    strategy: StrategyConfig = dataclasses.field(
        default_factory=lambda: StrategyConfig(
            kind="dyskew",
            dyskew=DySkewConfig(
                policy=Policy.LATE,
                skew_model=SkewModelKind.IDLE_TIME,
                n_strikes=2,
                looping=True,
            ),
            tick_interval=4e-3,
        )
    )
    shuffle: str = "hash"              # exchange AFTER this stage
    mean_row_cost: float = 4e-4        # seconds of UDF compute per row
    cost_sigma: float = 0.5            # lognormal sigma (cost skew)
    row_bytes: float = 512.0
    cost_fn: Optional[Callable] = None
    size_fn: Optional[Callable] = None
    fanout_fn: Optional[Callable] = None
    key_fn: Optional[Callable] = None
    #: Explicit inter-batch arrival gap; None (default) models the
    #: upstream exchange as a backpressured scan feeding ``feed_factor``x
    #: faster than the workers drain in aggregate (same model as
    #: `replay.scan_arrival_gap`) — rows must still be ARRIVING while
    #: skew detection runs, or distribute-late has nothing left to move.
    arrival_gap: Optional[float] = None
    feed_factor: float = 2.0
    batch_rows: int = 64

    def __post_init__(self):
        if self.shuffle not in ("worker", "hash"):
            raise ValueError(
                f"unknown shuffle mode {self.shuffle!r} "
                "(expected 'worker' or 'hash')"
            )

    def costs(self, keys: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.cost_fn is not None:
            return np.asarray(self.cost_fn(keys, rng), np.float64)
        mu = np.log(self.mean_row_cost) - 0.5 * self.cost_sigma ** 2
        return rng.lognormal(mu, self.cost_sigma, len(keys))

    def sizes(self, keys: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.size_fn is not None:
            return np.asarray(self.size_fn(keys, rng), np.float64)
        return np.full(len(keys), float(self.row_bytes))

    def fanout(self, keys: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        if self.fanout_fn is None:
            return np.ones(len(keys), np.int64)
        fan = np.asarray(self.fanout_fn(keys, rng), np.int64)
        if fan.shape != keys.shape or (len(fan) and fan.min() < 0):
            raise ValueError(
                f"stage {self.name!r}: fanout_fn must return one count "
                ">= 0 per input row"
            )
        return fan

    def transform_keys(
        self, keys: np.ndarray, rng: np.random.Generator
    ) -> np.ndarray:
        if self.key_fn is None:
            return keys
        out = np.asarray(self.key_fn(keys, rng), np.int64)
        if out.shape != keys.shape:
            raise ValueError(
                f"stage {self.name!r}: key_fn must return one key per "
                "output row"
            )
        return out


@dataclasses.dataclass(frozen=True)
class PipelineInput:
    """One tenant's source table for stage 0: ``n_rows`` rows whose keys
    follow a Zipf(``zipf_alpha``) popularity over ``num_keys`` distinct
    values, partitioned onto producers by ``partition`` ('hash' — hot
    keys pile onto one producer, the classic skewed scan — or 'rr',
    round-robin balanced)."""

    name: str
    n_rows: int = 4096
    num_keys: int = 512
    zipf_alpha: float = 1.1
    partition: str = "hash"            # hash | rr
    weight: float = 1.0
    arrival: float = 0.0

    def __post_init__(self):
        if self.partition not in ("hash", "rr"):
            raise ValueError(
                f"unknown partition mode {self.partition!r} "
                "(expected 'hash' or 'rr')"
            )


@dataclasses.dataclass
class _RowSet:
    """A tenant's live row population between stages (the lineage)."""

    keys: np.ndarray        # (m,) int64
    producers: np.ndarray   # (m,) int64 — worker holding each row
    arrival: float          # virtual time the rows become available


@dataclasses.dataclass
class StageReport:
    """Everything measurable about one executed stage."""

    name: str
    strategy: str
    results: List[QueryResult]          # per tenant
    arrivals: List[float]               # per tenant (absolute)
    completions: List[float]            # per tenant (absolute)
    rows_in: List[int]                  # per tenant
    bytes_in: List[float]               # per tenant
    input_rows_per_worker: np.ndarray   # (n,) summed over tenants
    busy_per_worker: np.ndarray         # (n,) summed over tenants
    makespan: float                     # max completion - min arrival


@dataclasses.dataclass
class PipelineResult:
    stages: List[StageReport]
    makespan: float             # end-to-end: last completion - first arrival
    stage_makespan_sum: float   # sum of per-stage makespans
    rows_out: List[int]         # per tenant, after the last stage's fanout


class PipelineSimulator:
    """Chain :class:`MultiQuerySimulator` stages through blocking
    exchanges, preserving per-row (tenant, key, placement) lineage.

    ``strategy_override`` replaces EVERY stage's redistribution strategy
    (the per-stage A/B knob: same pipeline, same seeds, different
    policy).  ``fair_share``/``batch_ticks`` forward to each stage's
    engine invocation unchanged, and so does ``device`` (where the
    stages' link state ticks; ``None``: the GPU).
    """

    def __init__(
        self,
        cluster: ClusterConfig,
        stages: Sequence[StageSpec],
        seed: int = 0,
        fair_share: Optional[FairShareConfig] = None,
        batch_ticks: Optional[bool] = None,
        strategy_override: Optional[StrategyConfig] = None,
        device: DeviceLike = None,
    ):
        if not stages:
            raise ValueError("a pipeline needs at least one stage")
        self.device = resolve_device(device)
        self.cluster = cluster
        self.stages = list(stages)
        self.seed = seed
        self.fair_share = fair_share
        self.batch_ticks = batch_ticks
        self.strategy_override = strategy_override

    # -- deterministic sub-seeds ------------------------------------- #

    def stage_seed(self, k: int) -> int:
        """Engine seed for stage ``k`` (feeds the per-tenant policy RNG
        streams) — mixed so distinct (pipeline seed, stage) pairs get
        distinct, reproducible streams."""
        return int(
            np.random.SeedSequence([self.seed, k]).generate_state(1)[0]
        )

    def _rng(self, k: int, tenant: int, lane: int) -> np.random.Generator:
        return np.random.default_rng([self.seed, k, tenant, lane])

    # -- stage construction (public: the differential pin replays it) - #

    def initial_rows(self, inputs: Sequence[PipelineInput]) -> List[_RowSet]:
        """Materialize every tenant's stage-0 row population."""
        n = self.cluster.num_workers
        rows = []
        for ti, inp in enumerate(inputs):
            rng = self._rng(0, ti, lane=0)
            keys = zipf_keys(inp.n_rows, inp.num_keys, inp.zipf_alpha, rng)
            if inp.partition == "hash":
                prod = hash_partition(keys, n)
            else:
                prod = np.arange(inp.n_rows, dtype=np.int64) % n
            rows.append(_RowSet(
                keys=keys, producers=prod, arrival=float(inp.arrival),
            ))
        return rows

    def stage_tenants(
        self,
        k: int,
        rows: Sequence[_RowSet],
        inputs: Sequence[PipelineInput],
    ) -> List[TenantQuery]:
        """Build stage ``k``'s engine tenants from the live row sets.
        Batches carry contiguous lineage ids (0..m-1 per tenant) so the
        engine's placement trace aligns with the row arrays."""
        stage = self.stages[k]
        strategy = self.strategy_override or stage.strategy
        tenants = []
        for ti, rs in enumerate(rows):
            rng = self._rng(k, ti, lane=1)
            costs = stage.costs(rs.keys, rng)
            sizes = stage.sizes(rs.keys, rng)
            streams = self._build_streams(rs.producers, costs, sizes,
                                          stage.batch_rows)
            gap = stage.arrival_gap
            if gap is None:
                # Backpressured exchange feed: batches spread over the
                # ideal (balanced) stage duration, feed_factor-x faster
                # than aggregate drain.
                ideal = float(costs.sum()) / self.cluster.num_workers
                nbatches = max(len(costs) // stage.batch_rows, 1)
                gap = ideal / (stage.feed_factor * nbatches)
            tenants.append(TenantQuery(
                name=f"{inputs[ti].name}@{stage.name}",
                streams=streams,
                strategy=strategy,
                arrival=rs.arrival,
                arrival_gap=gap,
                weight=inputs[ti].weight,
            ))
        return tenants

    def _build_streams(
        self, producers: np.ndarray, costs: np.ndarray, sizes: np.ndarray,
        batch_rows: int,
    ) -> List[List[Batch]]:
        n = self.cluster.num_workers
        streams: List[List[Batch]] = []
        for p in range(n):
            idx = np.flatnonzero(producers == p)
            stream: List[Batch] = []
            for i in range(0, len(idx), batch_rows):
                sel = idx[i:i + batch_rows]
                stream.append(Batch(
                    costs=costs[sel].copy(),
                    sizes=sizes[sel].copy(),
                    ids=sel.astype(np.int64),
                ))
            streams.append(stream)
        return streams

    # -- the pipeline loop ------------------------------------------- #

    def run(self, inputs: Sequence[PipelineInput]) -> PipelineResult:
        if not inputs:
            raise ValueError("a pipeline run needs at least one input")
        n = self.cluster.num_workers
        rows = self.initial_rows(inputs)
        first_arrival = min(rs.arrival for rs in rows)
        reports: List[StageReport] = []
        for k, stage in enumerate(self.stages):
            tenants = self.stage_tenants(k, rows, inputs)
            sim = MultiQuerySimulator(
                self.cluster,
                fair_share=self.fair_share,
                batch_ticks=self.batch_ticks,
                trace_placement=True,
                seed=self.stage_seed(k),
                device=self.device,
            )
            results = sim.run(tenants)
            placements = sim.last_placement
            in_per_worker = np.zeros(n, np.int64)
            busy = np.zeros(n)
            completions = []
            for ti, rs in enumerate(rows):
                if len(rs.producers):
                    in_per_worker += np.bincount(rs.producers, minlength=n)
                busy += np.asarray(results[ti].per_worker_busy)
                completions.append(rs.arrival + results[ti].latency)
            arrivals = [rs.arrival for rs in rows]
            reports.append(StageReport(
                name=stage.name,
                strategy=(self.strategy_override or stage.strategy).kind,
                results=results,
                arrivals=arrivals,
                completions=completions,
                rows_in=[len(rs.keys) for rs in rows],
                bytes_in=[
                    float(sum(b.total_bytes for s in t.streams for b in s))
                    for t in tenants
                ],
                input_rows_per_worker=in_per_worker,
                busy_per_worker=busy,
                makespan=max(completions) - min(arrivals),
            ))
            # ---- exchange: this stage's output -> next stage's input --
            rows = [
                self._exchange(k, stage, ti, rs, placements[ti],
                               completions[ti])
                for ti, rs in enumerate(rows)
            ]
        last = max(
            reports[-1].completions[ti] for ti in range(len(inputs))
        )
        return PipelineResult(
            stages=reports,
            makespan=last - first_arrival,
            stage_makespan_sum=float(sum(r.makespan for r in reports)),
            rows_out=[len(rs.keys) for rs in rows],
        )

    def _exchange(
        self,
        k: int,
        stage: StageSpec,
        ti: int,
        rs: _RowSet,
        placement: Optional[np.ndarray],
        completion: float,
    ) -> _RowSet:
        """Apply stage ``k``'s UDF result shape (fanout + key transform)
        to tenant ``ti``'s rows and repartition for the next stage."""
        n = self.cluster.num_workers
        m = len(rs.keys)
        if m == 0:
            return _RowSet(
                keys=np.empty(0, np.int64),
                producers=np.empty(0, np.int64),
                arrival=completion,
            )
        if placement is None or (placement < 0).any():
            raise RuntimeError(
                f"stage {stage.name!r}: incomplete placement trace — "
                "a routed row was never recorded (engine bug)"
            )
        rng = self._rng(k, ti, lane=2)
        fan = stage.fanout(rs.keys, rng)
        child_keys = stage.transform_keys(np.repeat(rs.keys, fan), rng)
        if stage.shuffle == "worker":
            producers = np.repeat(placement[:m], fan)
        else:
            producers = hash_partition(child_keys, n)
        return _RowSet(
            keys=child_keys, producers=producers, arrival=completion,
        )


def override_strategy(
    stages: Sequence[StageSpec], kind: str, **replace_kw
) -> List[StageSpec]:
    """Copy ``stages`` with every stage's strategy switched to registry
    policy ``kind`` (other strategy knobs preserved) — the per-stage A/B
    helper the benches use."""
    return [
        dataclasses.replace(
            s,
            strategy=dataclasses.replace(s.strategy, kind=kind, **replace_kw),
        )
        for s in stages
    ]
