"""Synthetic workload generators for the paper's evaluation scenarios.

Snowflake's customer workloads are proprietary; we generate synthetic
workloads with matched *skew characteristics* and verify the paper's
qualitative claims (see DESIGN.md §8).  Two independent skew axes:

  partition skew — rows concentrated on few producers (uneven scan
                   partitioning; the classic case), controlled by a Zipf
                   exponent / hot-partition fraction;
  cost skew      — heavy-tailed per-row UDF cost (lognormal sigma), the
                   'arbitrary user code' effect of §I.

Beyond per-query profiles, this module also generates multi-tenant
*traffic*: open-loop arrival processes (:class:`ArrivalProcess` /
:func:`arrival_times` — Poisson and on/off burst-modulated Poisson,
where query arrival times do NOT react to completions, the regime tail
latency must be measured in), cross-tenant interference scenarios
(:func:`skew_interference_suite`, :func:`priority_class_suite`) for the
fair-share admission studies in `sim/replay.py`, the mixed-SLO-class
overload mix (:func:`slo_suite`) for the deadline-aware admission /
preemption / autoscale studies, and the hundreds-of-tenants scaling mix
(:func:`many_tenants_suite`) that exercises the batched-tick engine
path.

Invariants:

  * Determinism.  Every generator is a pure function of its (profile,
    seed) arguments via a locally constructed ``np.random.default_rng``
    — no global RNG state — so replay comparisons (legacy vs DySkew, fair
    share on vs off) see IDENTICAL streams and arrival schedules, and
    the process-pool fan-out in `sim/replay.py` (``REPRO_BENCH_WORKERS``)
    returns the same results as a serial run.
  * Batches are immutable.  :func:`generate_query_cached` memoizes and
    shares `Batch` objects across strategy arms; nothing may mutate
    ``costs``/``sizes`` (the engine only reads views of them).
  * Batching matches §III.B.  The scan caps batches by rows AND bytes,
    so huge rows collapse observed batch density exactly as the Row Size
    Model expects — keep both caps when adding profiles.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np

from repro_torch.core.types import Policy
from repro_torch.sim.engine import Batch


@dataclasses.dataclass(frozen=True)
class QueryProfile:
    name: str
    n_rows: int = 20_000
    mean_row_cost: float = 2e-3       # seconds of UDF compute per row
    cost_sigma: float = 0.5           # lognormal sigma (cost skew)
    partition_alpha: float = 0.0      # Zipf exponent over producers (0 = uniform)
    hot_fraction: float = 0.0         # extra mass pinned to producer 0
    row_bytes: float = 512.0
    row_bytes_sigma: float = 0.3
    batch_rows: int = 128             # scan batching target (row count)
    batch_bytes_target: float = 16e6  # scan batching target (bytes)
    udf: bool = True                  # Snowpark UDF operator present?
    # §II.B: the legacy static round-robin 'cannot be safely applied' where
    # data locality is required for correctness; the legacy system falls
    # back to the default 1:1 link for such queries. DySkew's per-link
    # state machines handle them (Distribute-Late + intermediate states).
    locality_constrained: bool = False
    # Redistribution policy declared by the consumer operator (§III.A).
    policy: Policy = Policy.EAGER_SNOWPARK


def _partition_rows(
    rng: np.random.Generator, n_rows: int, n_producers: int,
    alpha: float, hot_fraction: float,
) -> np.ndarray:
    """Row → producer assignment with the requested skew."""
    if alpha <= 0.0 and hot_fraction <= 0.0:
        return rng.integers(0, n_producers, n_rows)
    probs = np.ones(n_producers)
    if alpha > 0.0:
        probs = 1.0 / np.arange(1, n_producers + 1) ** alpha
    probs = probs / probs.sum()
    if hot_fraction > 0.0:
        probs = (1.0 - hot_fraction) * probs
        probs[0] += hot_fraction
    # Randomize which physical producer is 'hot' to avoid positional bias.
    perm = rng.permutation(n_producers)
    return perm[rng.choice(n_producers, size=n_rows, p=probs)]


def generate_query(
    profile: QueryProfile, n_producers: int, seed: int
) -> List[List[Batch]]:
    """Materialize one query's per-producer batch streams."""
    rng = np.random.default_rng(seed)
    owner = _partition_rows(
        rng, profile.n_rows, n_producers, profile.partition_alpha,
        profile.hot_fraction,
    )
    mu = np.log(profile.mean_row_cost) - 0.5 * profile.cost_sigma**2
    costs = rng.lognormal(mu, profile.cost_sigma, profile.n_rows)
    smu = np.log(profile.row_bytes) - 0.5 * profile.row_bytes_sigma**2
    sizes = rng.lognormal(smu, profile.row_bytes_sigma, profile.n_rows)

    # The scan batches rows per producer, capped by rows AND bytes — huge
    # rows collapse the observed batch density exactly as in §III.B.
    # Batch boundaries are found with one prefix-sum + searchsorted per
    # batch; only genuinely byte-bound batches (heavy rows) fall back to
    # the exact sequential accumulation.
    streams: List[List[Batch]] = []
    target = profile.batch_bytes_target
    batch_rows = profile.batch_rows
    for p in range(n_producers):
        idx = np.nonzero(owner == p)[0]
        cs, sz = costs[idx], sizes[idx]
        m = len(idx)
        csum = np.concatenate(([0.0], np.cumsum(sz)))
        stream: List[Batch] = []
        i = 0
        while i < m:
            limit = min(batch_rows, m - i)
            fit = int(np.searchsorted(csum, csum[i] + target, side="right")) - 1 - i
            if fit >= limit:
                take = limit
            else:
                # Byte cap binds before the row cap: accumulate row by row
                # (few rows — these are §III.B heavy-row batches).
                take, acc = 0, 0.0
                while (
                    take < limit
                    and (take == 0 or acc + sz[i + take] <= target)
                ):
                    acc += sz[i + take]
                    take += 1
            stream.append(Batch(costs=cs[i:i + take].copy(),
                                sizes=sz[i:i + take].copy()))
            i += take
        streams.append(stream)
    return streams


@functools.lru_cache(maxsize=32)
def generate_query_cached(
    profile: QueryProfile, n_producers: int, seed: int
) -> List[List[Batch]]:
    """Memoized :func:`generate_query` for A/B comparisons that replay the
    same streams under several strategies (the batches are treated as
    immutable everywhere).  ``QueryProfile`` is frozen, hence hashable."""
    return generate_query(profile, n_producers, seed)


# --------------------------------------------------------------------- #
# Paper-evaluation workload suites
# --------------------------------------------------------------------- #


def customer_replay_suite(num_queries: int = 150, seed: int = 7) -> List[QueryProfile]:
    """Fig. 3: ~150 replayed customer queries, mixed skew levels.

    Mix: ~1/3 well-balanced, ~1/3 partition-skewed, ~1/3 cost-skewed (with
    overlap), spanning 2 decades of per-row cost.  About 30 % of queries
    are locality-constrained (the legacy static round-robin could not be
    applied to them — §II.B); DySkew runs them with the Distribute-Late
    policy instead.
    """
    rng = np.random.default_rng(seed)
    out = []
    for q in range(num_queries):
        r = rng.random()
        alpha = 0.0
        hot = 0.0
        sigma = 0.4
        constrained = False
        n_rows = int(rng.integers(6_000, 24_000))
        if r < 0.55:
            # Balanced bulk — includes the biggest (P99-setting) queries.
            n_rows = int(rng.integers(12_000, 30_000))
            sigma = float(rng.uniform(0.3, 0.8))
        elif r < 0.80:
            alpha = float(rng.uniform(0.1, 0.3))  # partition skew (mild)
            hot = float(rng.uniform(0.005, 0.02))
            constrained = bool(rng.random() < 0.35)
        else:
            sigma = float(rng.uniform(1.0, 1.8))  # cost skew (heavy tail)
            if rng.random() < 0.4:
                alpha = float(rng.uniform(0.1, 0.4))
        out.append(
            QueryProfile(
                name=f"cust_{q:03d}",
                n_rows=n_rows,
                mean_row_cost=float(10 ** rng.uniform(-3.3, -2.4)),
                cost_sigma=sigma,
                partition_alpha=alpha,
                hot_fraction=hot,
                row_bytes=float(10 ** rng.uniform(2.0, 3.5)),
                locality_constrained=constrained,
            )
        )
    return out


#: Fig. 4 — TPCx-BB: 30 queries; Q10 and Q19 run sentiment-analysis-style
#: UDFs over review text with heavily skewed groupings; the other UDF
#: queries are comparatively balanced.
def tpcxbb_suite(seed: int = 11) -> List[QueryProfile]:
    rng = np.random.default_rng(seed)
    suite = []
    for q in range(1, 31):
        if q == 10:   # sentiment UDF over skewed review groups; the complex
            # plan is locality-constrained, so the legacy static round-robin
            # could not be applied (§II.B) — DySkew runs Distribute-Late.
            suite.append(QueryProfile(
                name="q10", n_rows=24_000, mean_row_cost=4e-3, cost_sigma=1.4,
                partition_alpha=0.0, hot_fraction=0.045, row_bytes=2_000,
                locality_constrained=True,
            ))
        elif q == 19:  # review-sentiment UDF, store-returns skew
            suite.append(QueryProfile(
                name="q19", n_rows=18_000, mean_row_cost=3e-3, cost_sigma=1.4,
                partition_alpha=0.0, hot_fraction=0.026, row_bytes=1_500,
                locality_constrained=True,
            ))
        else:
            suite.append(QueryProfile(
                name=f"q{q:02d}",
                n_rows=int(rng.integers(8_000, 16_000)),
                mean_row_cost=float(10 ** rng.uniform(-3.5, -2.8)),
                cost_sigma=0.4,
                partition_alpha=0.0,
                hot_fraction=float(rng.uniform(0.0, 0.02)),
                row_bytes=800.0,
            ))
    return suite


def production_mix(num_queries: int = 200, seed: int = 23) -> List[QueryProfile]:
    """Fig. 5: production Snowpark population.

    The redistribution policy is declared per consumer operator (§III.A):
    ~30 % of the population are Snowpark UDF operators running Eager, ~55 %
    run the generalized Distribute-Late default (fires only when skew is
    detected), and ~15 % declare Never (ordering / local-state deps).
    'Applied' — the paper's 37.6 % — counts queries that actually moved a
    meaningful fraction of rows."""
    rng = np.random.default_rng(seed)
    out = []
    for q in range(num_queries):
        r = rng.random()
        pol = rng.random()
        if pol < 0.25:
            policy, constrained = Policy.EAGER_SNOWPARK, False
        elif pol < 0.80:
            policy, constrained = Policy.LATE, bool(rng.random() < 0.4)
        else:
            policy, constrained = Policy.NEVER, False
        if r < 0.30:  # skewed — redistribution should engage
            out.append(QueryProfile(
                name=f"prod_skew_{q:03d}",
                n_rows=int(rng.integers(10_000, 24_000)),
                mean_row_cost=float(10 ** rng.uniform(-3.0, -2.2)),
                cost_sigma=float(rng.uniform(0.9, 1.8)),
                partition_alpha=float(rng.uniform(0.2, 0.6)),
                hot_fraction=float(rng.uniform(0.02, 0.07)),
                policy=policy, locality_constrained=constrained,
            ))
        elif r < 0.90:  # balanced bulk work — Late never fires
            out.append(QueryProfile(
                name=f"prod_bal_{q:03d}",
                n_rows=int(rng.integers(6_000, 12_000)),
                mean_row_cost=float(10 ** rng.uniform(-3.6, -3.0)),
                cost_sigma=0.3,
                policy=policy, locality_constrained=constrained,
            ))
        else:  # heavy-row blob processing — density guard territory
            out.append(QueryProfile(
                name=f"prod_blob_{q:03d}",
                n_rows=int(rng.integers(24, 64)),
                mean_row_cost=float(10 ** rng.uniform(-1.5, -0.7)),
                cost_sigma=0.4,
                row_bytes=float(10 ** rng.uniform(7.5, 8.5)),  # 30–300 MB rows
                batch_rows=4096,
                policy=policy, locality_constrained=constrained,
            ))
    return out


def multi_tenant_suite(num_tenants: int = 8, seed: int = 41) -> List[QueryProfile]:
    """Concurrent-tenant mix for the shared-cluster scenario: a couple of
    heavily skewed 'noisy neighbour' queries interleaved with balanced
    bread-and-butter queries, sized so neighbours genuinely overlap.

    About one tenant in four is skewed (partition + cost skew); the rest
    are balanced.  All are Snowpark UDF operators (Eager policy) unless
    locality-constrained, mirroring the production population of Fig. 5.
    """
    rng = np.random.default_rng(seed)
    out = []
    for q in range(num_tenants):
        if q % 4 == 0:  # noisy neighbour: hot producer + heavy-tailed cost
            out.append(QueryProfile(
                name=f"tenant_skew_{q:02d}",
                n_rows=int(rng.integers(6_000, 10_000)),
                mean_row_cost=float(10 ** rng.uniform(-3.0, -2.6)),
                cost_sigma=float(rng.uniform(1.2, 1.8)),
                partition_alpha=float(rng.uniform(0.8, 1.5)),
                hot_fraction=float(rng.uniform(0.15, 0.35)),
            ))
        else:
            out.append(QueryProfile(
                name=f"tenant_bal_{q:02d}",
                n_rows=int(rng.integers(3_000, 6_000)),
                mean_row_cost=float(10 ** rng.uniform(-3.4, -3.0)),
                cost_sigma=float(rng.uniform(0.3, 0.6)),
            ))
    return out


def skew_interference_suite(
    num_tenants: int = 4, seed: int = 53
) -> List[QueryProfile]:
    """Cross-tenant skew-interference study: ONE aggressor — a large query
    with a hot producer and heavy-tailed per-row cost, exactly the shape
    that monopolizes interpreter pools and the NIC — sharing the cluster
    with small, balanced, latency-sensitive victims.

    The interesting measurements are the victims' tail latency and the
    Jain's fairness index across tenants, with and without the
    fair-share admission layer (see `sim/replay.py`).
    """
    rng = np.random.default_rng(seed)
    out = [QueryProfile(
        name="aggressor_00",
        n_rows=12_000,
        mean_row_cost=3e-3,
        cost_sigma=1.6,
        partition_alpha=1.2,
        hot_fraction=0.30,
        row_bytes=4_000.0,
    )]
    for q in range(1, num_tenants):
        out.append(QueryProfile(
            name=f"victim_{q:02d}",
            n_rows=int(rng.integers(1_500, 3_000)),
            mean_row_cost=float(10 ** rng.uniform(-3.4, -3.0)),
            cost_sigma=float(rng.uniform(0.3, 0.5)),
        ))
    return out


def many_tenants_suite(
    num_tenants: int = 256, seed: int = 71
) -> List[Tuple[QueryProfile, float]]:
    """Hundreds-of-tenants open-loop mix: the scale regime (128–512
    concurrent queries on one warehouse) where per-tenant state-machine
    tick dispatch dominates the event loop and the batched
    `repro_torch.sim.batched_link.BatchedLinkSim` path is required.

    Each tenant is deliberately small (a few hundred rows) so the
    interesting cost is *breadth* — hundreds of live link state machines
    ticking — not per-query depth.  One tenant in eight is a skewed
    noisy neighbour; weights are uniform (the fair-share layer is
    orthogonal to this scaling study).  Returns (profile, weight) pairs
    for `replay.open_loop_tenants`, which cycles arrivals over them.
    """
    rng = np.random.default_rng(seed)
    out: List[Tuple[QueryProfile, float]] = []
    for q in range(num_tenants):
        if q % 8 == 0:  # sparse noisy neighbours keep links firing
            out.append((QueryProfile(
                name="many_skew",
                n_rows=int(rng.integers(480, 768)),
                mean_row_cost=float(10 ** rng.uniform(-2.7, -2.4)),
                cost_sigma=float(rng.uniform(1.0, 1.5)),
                partition_alpha=float(rng.uniform(0.6, 1.2)),
                hot_fraction=float(rng.uniform(0.10, 0.25)),
                batch_rows=64,
            ), 1.0))
        else:
            out.append((QueryProfile(
                name="many_bal",
                n_rows=int(rng.integers(256, 512)),
                mean_row_cost=float(10 ** rng.uniform(-3.0, -2.7)),
                cost_sigma=float(rng.uniform(0.3, 0.6)),
                batch_rows=64,
            ), 1.0))
    return out


def slo_suite(
    seed: int = 67,
) -> List[Tuple[QueryProfile, float, Optional[float]]]:
    """Mixed SLO classes for the deadline-aware admission study under
    open-loop overload:

      gold   — small, balanced, latency-critical interactive queries with
               a TIGHT deadline (and a high fair-share weight);
      silver — medium queries with a loose deadline;
      bulk   — larger skewed batch queries with NO deadline (weight 1),
               the background pressure the SLO classes contend with.

    Returns (profile, weight, slo_target_seconds) triples for
    `replay.open_loop_tenants`; targets are seconds from a query's
    arrival to its last-row completion.  The interesting comparison
    (`bench_multi_tenant.py --slo`) is weight-only fair share vs
    deadline-aware admission (± preemption, ± autoscale) on gold/silver
    attainment and p99 tardiness while the warehouse is offered more
    load than it can serve.
    """
    rng = np.random.default_rng(seed)
    out: List[Tuple[QueryProfile, float, Optional[float]]] = []
    for i in range(3):
        out.append((QueryProfile(
            name="gold",
            n_rows=int(rng.integers(900, 1_500)),
            mean_row_cost=float(10 ** rng.uniform(-3.4, -3.1)),
            cost_sigma=float(rng.uniform(0.3, 0.5)),
        ), 4.0, 0.5))
    for i in range(2):
        out.append((QueryProfile(
            name="silver",
            n_rows=int(rng.integers(2_000, 3_200)),
            mean_row_cost=float(10 ** rng.uniform(-3.2, -2.9)),
            cost_sigma=float(rng.uniform(0.4, 0.7)),
        ), 2.0, 2.0))
    for i in range(3):
        out.append((QueryProfile(
            name="bulk",
            n_rows=int(rng.integers(4_000, 7_000)),
            mean_row_cost=float(10 ** rng.uniform(-3.0, -2.6)),
            cost_sigma=float(rng.uniform(1.0, 1.6)),
            partition_alpha=float(rng.uniform(0.6, 1.2)),
            hot_fraction=float(rng.uniform(0.10, 0.25)),
        ), 1.0, None))
    return out


def faults_suite(
    seed: int = 73,
) -> List[Tuple[QueryProfile, float, Optional[float]]]:
    """SLO classes for the fault-injection economics study
    (`bench_multi_tenant.py --faults`): the same gold/silver/bulk shape
    as :func:`slo_suite` but drawn from its own seed, sized so that a
    worker crash mid-run voids a visible slice of in-service rows.  The
    study crosses these tenants with `sim.faults.hazard_schedule`
    failure rates to trace cost-per-SLO — worker-seconds spent (wasted
    + re-executed service included) per deadline met — across
    policies × failure rates × autoscale on/off.
    """
    rng = np.random.default_rng(seed)
    out: List[Tuple[QueryProfile, float, Optional[float]]] = []
    for i in range(3):
        out.append((QueryProfile(
            name="gold",
            n_rows=int(rng.integers(900, 1_500)),
            mean_row_cost=float(10 ** rng.uniform(-3.4, -3.1)),
            cost_sigma=float(rng.uniform(0.3, 0.5)),
        ), 4.0, 0.6))
    for i in range(2):
        out.append((QueryProfile(
            name="silver",
            n_rows=int(rng.integers(2_000, 3_200)),
            mean_row_cost=float(10 ** rng.uniform(-3.2, -2.9)),
            cost_sigma=float(rng.uniform(0.4, 0.7)),
        ), 2.0, 2.5))
    for i in range(2):
        out.append((QueryProfile(
            name="bulk",
            n_rows=int(rng.integers(3_500, 6_000)),
            mean_row_cost=float(10 ** rng.uniform(-3.0, -2.6)),
            cost_sigma=float(rng.uniform(0.9, 1.5)),
            partition_alpha=float(rng.uniform(0.6, 1.2)),
            hot_fraction=float(rng.uniform(0.10, 0.25)),
        ), 1.0, None))
    return out


def priority_class_suite(seed: int = 61) -> List[Tuple[QueryProfile, float]]:
    """Two priority classes for the open-loop fair-share scenario:

      gold — small, balanced, latency-sensitive interactive queries
             (high fair-share weight);
      bulk — larger, skewed batch queries (low weight), the background
             pressure gold must be isolated from.

    Returns (profile, weight) pairs; `replay.open_loop_tenants` cycles
    arrivals over them.
    """
    rng = np.random.default_rng(seed)
    out: List[Tuple[QueryProfile, float]] = []
    for i in range(3):
        out.append((QueryProfile(
            name="gold",
            n_rows=int(rng.integers(1_200, 2_000)),
            mean_row_cost=float(10 ** rng.uniform(-3.3, -3.0)),
            cost_sigma=float(rng.uniform(0.3, 0.5)),
        ), 8.0))
    for i in range(3):
        out.append((QueryProfile(
            name="bulk",
            n_rows=int(rng.integers(4_000, 7_000)),
            mean_row_cost=float(10 ** rng.uniform(-3.0, -2.6)),
            cost_sigma=float(rng.uniform(1.0, 1.6)),
            partition_alpha=float(rng.uniform(0.6, 1.2)),
            hot_fraction=float(rng.uniform(0.10, 0.25)),
        ), 1.0))
    return out


# --------------------------------------------------------------------- #
# Open-loop arrival processes
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ArrivalProcess:
    """An open-loop query arrival process: timestamps are generated ahead
    of time and do NOT react to completions (no closed-loop think time),
    so queueing delay compounds into the latency tail under overload —
    the regime elastic engines are judged in.

      poisson — homogeneous Poisson stream at ``rate`` arrivals/s;
      burst   — on/off modulated Poisson (a 2-state MMPP): baseline
                ``rate`` in the off state, ``rate * burst_factor`` during
                bursts; burst durations are exponential with mean
                ``mean_burst_s`` and cover ``burst_fraction`` of time.
    """

    kind: str = "poisson"          # poisson | burst
    rate: float = 2.0              # arrivals/s (baseline state)
    burst_factor: float = 8.0
    burst_fraction: float = 0.25
    mean_burst_s: float = 2.0


def arrival_times(
    process: ArrivalProcess, num_arrivals: int, seed: int
) -> np.ndarray:
    """Materialize ``num_arrivals`` open-loop arrival timestamps."""
    rng = np.random.default_rng(seed)
    if process.kind == "poisson":
        return np.cumsum(rng.exponential(1.0 / process.rate, num_arrivals))
    if process.kind != "burst":
        raise ValueError(f"unknown arrival process kind: {process.kind!r}")
    f = min(max(process.burst_fraction, 1e-6), 1 - 1e-6)
    mean_off_s = process.mean_burst_s * (1.0 - f) / f
    times: List[float] = []
    t, on = 0.0, False
    while len(times) < num_arrivals:
        dur = rng.exponential(process.mean_burst_s if on else mean_off_s)
        r = process.rate * (process.burst_factor if on else 1.0)
        a = t + rng.exponential(1.0 / r)
        while a < t + dur and len(times) < num_arrivals:
            times.append(a)
            a += rng.exponential(1.0 / r)
        t += dur
        on = not on
    return np.asarray(times)


def heavy_rows_case(row_gb: float = 2.0, n_rows: int = 48) -> QueryProfile:
    """§III.B regression case: large objects (high-res images / JSON blobs);
    ~100 GB total moved unnecessarily by unguarded eager redistribution."""
    return QueryProfile(
        name="heavy_rows",
        n_rows=n_rows,
        mean_row_cost=80e-3,     # real but modest compute per blob
        cost_sigma=0.3,
        partition_alpha=0.0,     # NO skew — redistribution has no benefit
        row_bytes=row_gb * 1e9,
        row_bytes_sigma=0.05,
        batch_rows=4096,
    )


def self_skip_case() -> QueryProfile:
    """§III.B forced-remote study: mild skew on a small cluster, where
    skipping the local worker wastes local CPU and network."""
    return QueryProfile(
        name="self_skip",
        n_rows=12_000,
        mean_row_cost=2e-3,
        cost_sigma=0.8,
        partition_alpha=0.3,
        hot_fraction=0.04,
        row_bytes=64_000.0,   # sizeable rows: forced-remote NIC cost shows
    )


# ------------------------------------------------------------------ #
# Multi-stage pipeline suite (skew that propagates across stages)
# ------------------------------------------------------------------ #
#
# Stage model functions are module-level (not lambdas) so scenario
# definitions stay introspectable and the suite can be rebuilt
# identically anywhere.  Each is a pure function of (keys, rng).


def _explode_fanout(keys: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Nested-document explode: 0-4 child rows per parent."""
    return rng.integers(0, 5, len(keys))


def _rekey_wide(keys: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Re-key exploded children onto a wide key space (decorrelates from
    the parent key — the shuffle after this attenuates inherited skew)."""
    return keys * 37 + rng.integers(0, 64, len(keys))


def _collapse_groups(keys: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Groupby onto FEW groups: most keys spread over 61 buckets, but a
    hot slice of the key space collapses onto one bucket — the hash
    exchange after this concentrates that bucket on a single worker no
    matter how balanced the previous stage left its output."""
    out = keys % 61
    out[keys % 3 == 0] = 3          # ~1/3 of the key space piles up
    return out


def _agg_row_sizes(keys: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Aggregation-stage row widths: the hot collapsed group carries
    compact pre-aggregated partials, the long tail carries wide
    payloads.  This is the byte asymmetry where blanket round-robin
    spreading pays heavy NIC for rows that were never skewed, while
    adaptive redistribution moves only the (cheap) hot-group overflow."""
    return np.where(keys == 3, 1024.0, 524288.0)


def _hot_key_cost(keys: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Per-row UDF cost with a 4x-hot key slice (value skew on top of
    partition skew, §II's compound case)."""
    cost = rng.lognormal(np.log(3e-4), 0.4, len(keys))
    cost[keys % 5 == 0] *= 4.0
    return cost


def pipeline_suite(quick: bool = False):
    """Chained-stage pipeline scenarios for the skew-propagation study:
    ``(name, stages, inputs)`` triples consumed by
    `repro_torch.sim.pipeline.PipelineSimulator` (strategies per stage are
    defaults — the bench overrides them per A/B arm).

      fanout_explode    — parse→explode with rekeying: inherited skew
                          ATTENUATES through the wide rehash.
      groupby_attenuate — skewed scan whose 'worker' exchange hands the
                          next stage whatever balance (or skew) the
                          stage-0 redistribution policy achieved.
      collision_chain   — balanced map feeding a collapsing groupby:
                          the hash exchange AMPLIFIES skew mid-pipeline,
                          then a 'worker' exchange propagates whatever
                          the reduce stage did about it.
      etl_chain         — 4-stage mix of all three mechanisms.

    ``quick`` shrinks row counts ~4x for CI smoke runs."""
    from repro_torch.sim.pipeline import PipelineInput, StageSpec

    r = 4 if quick else 1

    def rows(n: int) -> int:
        return max(n // r, 256)

    fanout_explode = (
        "fanout_explode",
        [
            StageSpec(name="parse", shuffle="hash", mean_row_cost=3e-4,
                      fanout_fn=_explode_fanout, key_fn=_rekey_wide,
                      row_bytes=2048.0),
            StageSpec(name="transform", mean_row_cost=2e-4),
        ],
        [
            PipelineInput(name="docs", n_rows=rows(3000), num_keys=256,
                          zipf_alpha=1.3),
        ],
    )
    groupby_attenuate = (
        "groupby_attenuate",
        [
            StageSpec(name="scan_udf", shuffle="worker", mean_row_cost=4e-4,
                      cost_fn=_hot_key_cost, row_bytes=8192.0),
            StageSpec(name="reduce", mean_row_cost=3e-4),
        ],
        [
            PipelineInput(name="events", n_rows=rows(4000), num_keys=128,
                          zipf_alpha=1.5),
            PipelineInput(name="dims", n_rows=rows(1200), num_keys=512,
                          zipf_alpha=0.0, partition="rr"),
        ],
    )
    collision_chain = (
        "collision_chain",
        [
            StageSpec(name="map", shuffle="hash", mean_row_cost=2.5e-4,
                      key_fn=_collapse_groups, row_bytes=2048.0),
            StageSpec(name="groupby", shuffle="worker", mean_row_cost=6e-4,
                      cost_sigma=0.3, size_fn=_agg_row_sizes),
            StageSpec(name="score", mean_row_cost=2e-4),
        ],
        [
            PipelineInput(name="facts", n_rows=rows(5000), num_keys=4096,
                          zipf_alpha=0.0, partition="rr"),
        ],
    )
    etl_chain = (
        "etl_chain",
        [
            StageSpec(name="ingest", shuffle="hash", mean_row_cost=2e-4,
                      fanout_fn=_explode_fanout, key_fn=_rekey_wide,
                      row_bytes=4096.0),
            StageSpec(name="enrich", shuffle="hash", mean_row_cost=3e-4,
                      key_fn=_collapse_groups, row_bytes=8192.0),
            StageSpec(name="aggregate", shuffle="worker", mean_row_cost=5e-4,
                      cost_fn=_hot_key_cost, row_bytes=2048.0),
            StageSpec(name="export", mean_row_cost=1.5e-4),
        ],
        [
            PipelineInput(name="stream_a", n_rows=rows(2500), num_keys=512,
                          zipf_alpha=1.2),
            PipelineInput(name="stream_b", n_rows=rows(1500), num_keys=1024,
                          zipf_alpha=0.0, partition="rr"),
        ],
    )
    return [fanout_explode, groupby_attenuate, collision_chain, etl_chain]
