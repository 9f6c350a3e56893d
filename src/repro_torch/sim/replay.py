"""Replay harness: run workload suites under competing strategies and
aggregate the statistics the paper reports (mean / P99 latency deltas,
utilization, redistribution-applied fraction), plus the multi-tenant
traffic studies: closed-loop staggered tenants, open-loop Poisson/burst
streams with priority classes, per-class p50/p99/p999 tails and Jain's
fairness index over per-tenant slowdowns.

Every entry point takes ``device`` (``None``: the GPU; ``"cpu"``), where
the simulators' link state ticks.  It travels to pool workers as a string:
the pool is ``spawn``, so each worker starts from a fresh import and opens
its own CUDA context (a forked child could not use the parent's)."""

from __future__ import annotations

import dataclasses
import multiprocessing
import warnings
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core.admission import (
    AutoscaleConfig,
    DeadlineConfig,
    FairShareConfig,
)
from repro_torch.core.types import DySkewConfig, Policy, SkewModelKind
from repro_torch.sim.engine import (
    ClusterConfig,
    MultiQuerySimulator,
    QueryResult,
    Simulator,
    StrategyConfig,
    TenantQuery,
)
from repro_torch.sim.workload import (
    ArrivalProcess,
    QueryProfile,
    arrival_times,
    generate_query,
    generate_query_cached,
)

# Strategy resolution for the legacy-vs-DySkew A/B the paper evaluates:
#
#   legacy: static round-robin for queries where it is safe; the default
#           1:1 link for locality-constrained queries (§II.B: the static
#           solution 'cannot be safely applied to all Snowpark UDF use
#           cases').
#   dyskew: the adaptive link with the query's declared policy (Eager for
#           ordinary Snowpark UDFs, Distribute-Late for
#           locality-constrained plans, Never where ordering forbids it).


def legacy_strategy(prof: QueryProfile) -> StrategyConfig:
    if prof.locality_constrained or prof.policy == Policy.NEVER:
        return StrategyConfig(kind="none")
    return StrategyConfig(kind="static_rr")


def dyskew_strategy(prof: QueryProfile) -> StrategyConfig:
    policy = prof.policy
    if prof.locality_constrained and policy == Policy.EAGER_SNOWPARK:
        policy = Policy.LATE
    model = (
        SkewModelKind.IDLE_TIME
        if policy in (Policy.LATE, Policy.EAGER_SNOWPARK)
        else SkewModelKind.ROW_PERCENTAGE
    )
    return StrategyConfig(
        kind="dyskew",
        dyskew=DySkewConfig(policy=policy, skew_model=model, n_strikes=2),
    )


def default_strategies() -> Dict[str, StrategyConfig]:
    return {
        "none": StrategyConfig(kind="none"),
        "static_rr": StrategyConfig(kind="static_rr"),
        "dyskew": StrategyConfig(
            kind="dyskew",
            dyskew=DySkewConfig(policy=Policy.EAGER_SNOWPARK, idle_grace=2),
        ),
    }


@dataclasses.dataclass
class SuiteResult:
    strategy: str
    results: List[QueryResult]

    @property
    def latencies(self) -> np.ndarray:
        return np.array([r.latency for r in self.results])

    def mean_latency(self) -> float:
        return float(self.latencies.mean())

    def p(self, q: float) -> float:
        return float(np.percentile(self.latencies, q))

    def mean_utilization(self) -> float:
        return float(np.mean([r.utilization for r in self.results]))

    def applied_fraction(self) -> float:
        return float(np.mean([r.redistribution_applied for r in self.results]))


def scan_arrival_gap(
    prof: QueryProfile, cluster: ClusterConfig, feed_factor: float = 2.0
) -> float:
    """Backpressured-scan model: batches arrive spread over the query's
    ideal (perfectly balanced) duration, `feed_factor`x faster than the
    workers can drain them in aggregate."""
    ideal = prof.n_rows * prof.mean_row_cost / cluster.num_workers
    nbatches = max(prof.n_rows // min(prof.batch_rows, prof.n_rows), 1)
    return ideal / (feed_factor * nbatches)


def _device_name(device: DeviceLike) -> str:
    """The device as a string a spawned worker can rebuild; resolving it
    here raises in the caller, not in a worker, when there is no GPU."""
    return str(resolve_device(device))


def _run_one_query(
    task: Tuple[QueryProfile, ClusterConfig, StrategyConfig, int, int, float, str],
) -> QueryResult:
    """One (profile, strategy) simulation — top-level so suite runs can
    fan out across a process pool."""
    prof, cluster, st, sim_seed, gen_seed, gap, device = task
    sim = Simulator(cluster, st, seed=sim_seed, device=device)
    batches = generate_query_cached(prof, cluster.num_workers, seed=gen_seed)
    return sim.run_query(batches, arrival_gap=gap)


_POOL: Optional[ProcessPoolExecutor] = None
_POOL_WORKERS = 0


def _get_pool(workers: int) -> ProcessPoolExecutor:
    """Lazily-created shared pool — spawned workers pay the torch import
    once per process, not once per suite."""
    global _POOL, _POOL_WORKERS
    if _POOL is None or _POOL_WORKERS < workers:
        if _POOL is not None:
            # Reap the replaced pool's processes before spawning the
            # larger one — wait=False here leaked live spawned workers
            # for the rest of the run.
            _POOL.shutdown(wait=True)
        ctx = multiprocessing.get_context("spawn")
        _POOL = ProcessPoolExecutor(max_workers=workers, mp_context=ctx)
        _POOL_WORKERS = workers
    return _POOL


def _discard_pool() -> None:
    """Drop the cached pool after a failure so the next `_map_queries`
    call rebuilds a fresh one.  Keeping the broken executor cached made a
    single failure permanent: every later suite re-raised inside ``map``,
    warned, and silently degraded to the serial path for the remainder of
    the process."""
    global _POOL, _POOL_WORKERS
    if _POOL is not None:
        try:
            _POOL.shutdown(wait=False, cancel_futures=True)
        except Exception:
            pass  # the executor may already be unusable/broken
    _POOL = None
    _POOL_WORKERS = 0


def _map_queries(
    tasks: List[Tuple], workers: Optional[int]
) -> List[QueryResult]:
    """Run simulation tasks, optionally on a 'spawn' process pool.

    Queries are independent, so results are deterministic regardless of
    ``workers``; any pool failure (restricted sandboxes) falls back to the
    serial path for THIS call and discards the broken pool, so the next
    call gets a fresh executor instead of inheriting the failure.
    """
    if workers and workers > 1 and len(tasks) > 1:
        try:
            # Small chunks: per-query cost varies by >10x, so fine-grained
            # scheduling beats lower dispatch overhead.  Even-sized chunks
            # keep run_ab's interleaved legacy/dyskew pairs in the same
            # worker process, so its per-process stream cache hits.
            chunk = max(len(tasks) // (workers * 10), 1)
            chunk += chunk % 2
            return list(
                _get_pool(workers).map(_run_one_query, tasks, chunksize=chunk)
            )
        except Exception as e:  # pool infra failure (spawn blocked, OOM-killed worker)
            _discard_pool()
            warnings.warn(
                f"simulation pool failed ({type(e).__name__}: {e}); "
                "re-running suite serially (pool reset for the next call)",
                RuntimeWarning,
            )
    return [_run_one_query(t) for t in tasks]


def _warm_worker() -> bool:
    """No-op task that forces a spawned worker to pay its heavy imports."""
    return True


def _surface_warm_failure(future) -> None:
    """Done-callback for warm-up tasks: a worker that crashes during the
    warm-import used to be silently dropped (futures discarded) and
    resurfaced later as an opaque suite failure — surface it now."""
    if future.cancelled():
        # Pool torn down (e.g. _discard_pool after a map failure) before
        # the warm task ran: not a worker crash, nothing to surface —
        # and future.exception() would raise CancelledError here.
        return
    exc = future.exception()
    if exc is not None:
        warnings.warn(
            f"pool warm-up worker failed ({type(exc).__name__}: {exc}); "
            "parallel replay may fall back to serial",
            RuntimeWarning,
        )


def warm_pool(workers: Optional[int]) -> list:
    """Kick off worker-process startup (torch import) in the background so
    it overlaps the caller's own setup.  Non-blocking; best-effort.  The
    warm-up futures are collected (and returned, mainly for tests): the
    first crash is surfaced as a RuntimeWarning instead of being
    swallowed."""
    futures: list = []
    if workers and workers > 1:
        try:
            pool = _get_pool(workers)
            for _ in range(workers):
                f = pool.submit(_warm_worker)
                f.add_done_callback(_surface_warm_failure)
                futures.append(f)
        except Exception:
            pass
    return futures


def run_suite(
    profiles: Sequence[QueryProfile],
    cluster: ClusterConfig,
    strategy: StrategyConfig,
    seed: int = 0,
    per_query_strategy: Optional[Dict[str, StrategyConfig]] = None,
    feed_factor: float = 2.0,
    workers: Optional[int] = None,
    device: DeviceLike = None,
) -> SuiteResult:
    dev = _device_name(device)
    tasks = []
    for i, prof in enumerate(profiles):
        st = strategy
        if per_query_strategy and prof.name in per_query_strategy:
            st = per_query_strategy[prof.name]
        gap = scan_arrival_gap(prof, cluster, feed_factor)
        tasks.append((prof, cluster, st, seed + i, seed * 1000 + i, gap, dev))
    return SuiteResult(
        strategy=strategy.kind, results=_map_queries(tasks, workers)
    )


def improvement(base: float, new: float) -> float:
    """Positive = new is faster, as a fraction of base."""
    return (base - new) / base


def compare_suites(
    profiles: Sequence[QueryProfile],
    cluster: ClusterConfig,
    strategies: Dict[str, StrategyConfig],
    seed: int = 0,
    device: DeviceLike = None,
) -> Dict[str, SuiteResult]:
    return {
        name: run_suite(profiles, cluster, st, seed=seed, device=device)
        for name, st in strategies.items()
    }


def run_ab(
    profiles: Sequence[QueryProfile],
    cluster: ClusterConfig,
    seed: int = 0,
    feed_factor: float = 2.0,
    workers: Optional[int] = None,
    device: DeviceLike = None,
) -> Dict[str, SuiteResult]:
    """The paper's A/B: legacy system vs DySkew, with per-query strategy
    resolution (locality constraints, declared policies)."""
    dev = _device_name(device)
    arms = (("legacy", legacy_strategy), ("dyskew", dyskew_strategy))
    # Both arms in ONE submission (no pool idle at the barrier), with the
    # two arms of each query adjacent so a pool worker re-uses the cached
    # generated streams for the pair.
    tasks = []
    for i, prof in enumerate(profiles):
        gap = scan_arrival_gap(prof, cluster, feed_factor)
        for name, resolve in arms:
            tasks.append(
                (prof, cluster, resolve(prof), seed + i, seed * 1000 + i, gap, dev)
            )
    results = _map_queries(tasks, workers)
    return {
        name: SuiteResult(strategy=name, results=results[j::len(arms)])
        for j, (name, _) in enumerate(arms)
    }


# ------------------------------------------------------------------ #
# Multi-tenant replay (concurrent queries on one shared cluster)
# ------------------------------------------------------------------ #


def staggered_tenants(
    profiles: Sequence[QueryProfile],
    cluster: ClusterConfig,
    resolve: Callable[[QueryProfile], StrategyConfig],
    seed: int = 0,
    stagger_frac: float = 0.25,
    feed_factor: float = 2.0,
) -> List[TenantQuery]:
    """Materialize one tenant per profile with arrivals staggered by
    ``stagger_frac`` of the mean ideal query duration, so neighbouring
    queries genuinely overlap on the shared cluster."""
    ideals = [
        p.n_rows * p.mean_row_cost / cluster.num_workers for p in profiles
    ]
    stagger = stagger_frac * float(np.mean(ideals)) if ideals else 0.0
    tenants = []
    for i, prof in enumerate(profiles):
        tenants.append(TenantQuery(
            name=prof.name,
            streams=generate_query(prof, cluster.num_workers,
                                   seed=seed * 1000 + i),
            strategy=resolve(prof),
            arrival=i * stagger,
            arrival_gap=scan_arrival_gap(prof, cluster, feed_factor),
        ))
    return tenants


def run_multi_tenant_ab(
    profiles: Sequence[QueryProfile],
    cluster: ClusterConfig,
    seed: int = 0,
    stagger_frac: float = 0.25,
    feed_factor: float = 2.0,
    fair_share: Optional[FairShareConfig] = None,
    weights: Optional[Sequence[float]] = None,
    device: DeviceLike = None,
) -> Dict[str, SuiteResult]:
    """Legacy vs DySkew with all ``profiles`` running CONCURRENTLY as
    tenants of one shared cluster (same streams, same arrival schedule).
    ``fair_share``/``weights`` switch on the weighted admission layer."""
    out: Dict[str, SuiteResult] = {}
    for name, resolve in (("legacy", legacy_strategy), ("dyskew", dyskew_strategy)):
        tenants = staggered_tenants(
            profiles, cluster, resolve, seed=seed,
            stagger_frac=stagger_frac, feed_factor=feed_factor,
        )
        if weights is not None:
            if len(weights) != len(tenants):
                raise ValueError(
                    f"weights length {len(weights)} != tenant count "
                    f"{len(tenants)}"
                )
            for t, w in zip(tenants, weights):
                t.weight = float(w)
        results = MultiQuerySimulator(
            cluster, fair_share=fair_share, device=device
        ).run(tenants)
        out[name] = SuiteResult(strategy=name, results=results)
    return out


# ------------------------------------------------------------------ #
# Open-loop traffic (Poisson / burst arrivals, priority classes)
# ------------------------------------------------------------------ #


def jain_fairness(values: Sequence[float]) -> float:
    """Jain's fairness index (sum x)^2 / (n * sum x^2): 1.0 = perfectly
    even, 1/n = one value holds everything.

    An empty or all-zero set (e.g. a run in which no query of a priority
    class completed) has no defined fairness — there is nothing to share —
    and returns NaN rather than crashing on the 0/0 or masquerading as
    perfectly fair.  NaN propagates visibly through aggregations, which
    is the point: a report showing NaN says 'no completions', not 1.0."""
    x = np.asarray(list(values), dtype=np.float64)
    if len(x) == 0 or not np.any(x):
        return float("nan")
    return float(x.sum() ** 2 / (len(x) * (x ** 2).sum()))


def tenant_class(t: TenantQuery) -> str:
    """Class key of an open-loop tenant (name is '<class>#<arrival_idx>'
    for generated traffic; standalone tenants are their own class)."""
    return t.name.split("#", 1)[0]


def ideal_latency(t: TenantQuery, cluster: ClusterConfig) -> float:
    """Perfectly-balanced lower bound: total hidden UDF seconds spread
    over every interpreter in the warehouse."""
    total_cost = sum(float(b.costs.sum()) for s in t.streams for b in s)
    return total_cost / cluster.num_workers


def open_loop_rate(
    profiles: Sequence[QueryProfile], cluster: ClusterConfig,
    load: float = 0.7,
) -> float:
    """Arrival rate (queries/s) that offers ``load`` fraction of the
    cluster's aggregate service capacity, for the given query mix."""
    work = [p.n_rows * p.mean_row_cost for p in profiles]
    return load * cluster.num_workers / float(np.mean(work))


def open_loop_tenants(
    specs: Sequence[Tuple],
    cluster: ClusterConfig,
    resolve: Callable[[QueryProfile], StrategyConfig],
    process: ArrivalProcess,
    num_queries: int,
    seed: int = 0,
    feed_factor: float = 2.0,
    grid_align: Optional[float] = None,
) -> List[TenantQuery]:
    """Materialize an open-loop query stream: ``num_queries`` arrivals at
    :func:`arrival_times` timestamps, cycling over ``specs`` —
    (profile, fair-share weight) pairs, e.g. from
    `workload.priority_class_suite`, or (profile, weight, slo_target)
    triples, e.g. from `workload.slo_suite` (the target becomes each
    arrival's `TenantQuery.slo_target`, seconds from arrival).  Each
    arrival is an independent tenant (fresh streams, own link state)
    named '<profile>#<index>'.

    ``grid_align`` snaps every arrival down onto the chained float grid
    ``0, I, I+I, ...`` of that step — the engine's metrics subsystem
    quantizes observation to tick boundaries anyway, and arrivals that
    sit exactly on a shared tick grid put the whole fleet inside the
    PROVEN batched-tick equivalence envelope (`sim/engine.py`'s
    ``_arrivals_on_grid``), so `MultiQuerySimulator`'s auto default
    drives hundreds of link tenants through one coalesced tick
    per cadence while staying bit-identical to the per-tenant path.
    The grid values are built by the same chained additions the engine's
    grid-tick event walks, so the float equality is exact by
    construction, not approximate."""
    times = arrival_times(process, num_queries, seed=seed + 977)
    if grid_align is not None and num_queries:
        step = float(grid_align)
        kmax = int(np.floor(float(times.max()) / step)) + 1
        chain = np.empty(kmax + 1)
        t = 0.0
        for k in range(kmax + 1):
            chain[k] = t
            t += step
        idx = np.searchsorted(chain, times, side="right") - 1
        times = chain[np.clip(idx, 0, kmax)]
    tenants: List[TenantQuery] = []
    for i in range(num_queries):
        spec = specs[i % len(specs)]
        prof, weight = spec[0], spec[1]
        slo = spec[2] if len(spec) > 2 else None
        tenants.append(TenantQuery(
            name=f"{prof.name}#{i:03d}",
            streams=generate_query(prof, cluster.num_workers,
                                   seed=seed * 1000 + i),
            strategy=resolve(prof),
            arrival=float(times[i]),
            arrival_gap=scan_arrival_gap(prof, cluster, feed_factor),
            weight=weight,
            slo_target=slo,
        ))
    return tenants


def summarize_open_loop(
    tenants: Sequence[TenantQuery],
    results: Sequence[QueryResult],
    cluster: ClusterConfig,
    fault_stats: Optional[Dict[str, object]] = None,
) -> Dict[str, object]:
    """Aggregate an open-loop run into the numbers the multi-tenant bench
    reports: per-class latency percentiles (p50/p99/p999) + mean
    slowdown, Jain's fairness index over per-tenant slowdowns
    (latency / perfectly-balanced ideal; equal slowdowns = fair), and —
    for tenants that declare an `slo_target` — per-class SLO attainment
    (fraction of completed queries whose latency met the deadline) and
    p99 tardiness (seconds past the deadline, 0 when met).

    Honest economics: ``worker_seconds_spent`` is every second a worker
    was busy — including service voided by a crash (from
    ``fault_stats['wasted_service_s']`` when supplied) and the charged
    re-execution after it — and ``cost_per_slo`` divides that spend by
    the SLO-met count, so a policy that buys attainment by burning
    workers is visible on the frontier next to one that meets the same
    deadlines cheaply."""
    classes: Dict[str, List[Tuple[float, float]]] = {}
    # Per class: met flags (incl. never-completed = missed) and the
    # tardiness samples of COMPLETED queries only.
    slo_by_class: Dict[str, Dict[str, list]] = {}
    slowdowns: List[float] = []
    slo_met = slo_total = 0
    for t, r in zip(tenants, results):
        cls = classes.setdefault(tenant_class(t), [])
        sb = (
            slo_by_class.setdefault(
                tenant_class(t), {"met": [], "tard": []}
            )
            if t.slo_target is not None else None
        )
        if r is None:
            # Tenant did not complete (aborted/partial run): its class
            # still appears in the report, with n=0 and NaN latency
            # stats — but a deadline it can no longer meet is a MISS,
            # not a gap in the books (otherwise a truncated run looks
            # better than one that finished its work).
            if sb is not None:
                sb["met"].append(False)
                slo_total += 1
            continue
        ideal = max(ideal_latency(t, cluster), 1e-12)
        sd = r.latency / ideal
        slowdowns.append(sd)
        cls.append((r.latency, sd))
        if sb is not None:
            met = r.latency <= t.slo_target
            sb["met"].append(met)
            sb["tard"].append(max(r.latency - t.slo_target, 0.0))
            slo_total += 1
            slo_met += int(met)
    nan = float("nan")
    per_class: Dict[str, Dict[str, float]] = {}
    for name, vals in sorted(classes.items()):
        lat = np.array([v[0] for v in vals])
        sds = np.array([v[1] for v in vals])
        # A class with zero completed queries reports NaN percentiles
        # (np.percentile on an empty array raises) — NaN means 'no
        # completions to measure', same convention as jain_fairness.
        empty = len(vals) == 0
        per_class[name] = {
            "n": len(vals),
            "p50": nan if empty else float(np.percentile(lat, 50)),
            "p99": nan if empty else float(np.percentile(lat, 99)),
            "p999": nan if empty else float(np.percentile(lat, 99.9)),
            "mean": nan if empty else float(lat.mean()),
            "mean_slowdown": nan if empty else float(sds.mean()),
        }
        if name in slo_by_class:
            sb = slo_by_class[name]
            per_class[name]["slo_attainment"] = (
                float(np.mean(sb["met"])) if sb["met"] else nan
            )
            # Tardiness is measurable only for completed queries.
            per_class[name]["p99_tardiness"] = (
                float(np.percentile(np.array(sb["tard"]), 99))
                if sb["tard"] else nan
            )
    # Worker-seconds actually spent: useful service billed to every
    # tenant, plus (with faults) the partial service crashes voided —
    # re-executed rows bill their second pass through per_worker_busy,
    # so wasted + billed is the true spend, never double-counted.
    worker_seconds = float(sum(
        float(np.asarray(r.per_worker_busy).sum())
        for r in results if r is not None
    ))
    if fault_stats is not None:
        worker_seconds += float(fault_stats.get("wasted_service_s", 0.0))
    return {
        "per_class": per_class,
        "jain": jain_fairness(slowdowns),
        "mean_latency": (
            float(np.mean([r.latency for r in results if r is not None]))
            if any(r is not None for r in results) else nan
        ),
        "slo_attainment": (slo_met / slo_total) if slo_total else nan,
        "slo_met_count": slo_met,
        "worker_seconds_spent": worker_seconds,
        # Spend per met SLO (inf when nothing met): the frontier metric.
        "cost_per_slo": (
            worker_seconds / slo_met if slo_met else float("inf")
        ),
    }


def run_open_loop(
    specs: Sequence[Tuple],
    cluster: ClusterConfig,
    process: ArrivalProcess,
    num_queries: int,
    seed: int = 0,
    resolve: Callable[[QueryProfile], StrategyConfig] = dyskew_strategy,
    fair_share: Optional[FairShareConfig] = None,
    feed_factor: float = 2.0,
    batch_ticks: Optional[bool] = None,
    none_closed_form: Optional[bool] = None,
    closed_form_drain: Optional[bool] = None,
    grid_align: Optional[float] = None,
    deadline_aware: bool = False,
    deadline_cfg: Optional["DeadlineConfig"] = None,
    preemption: bool = False,
    autoscale: Optional["AutoscaleConfig"] = None,
    faults: Optional["FaultSchedule"] = None,
    fault_cfg: Optional["FaultConfig"] = None,
    sim_seed: int = 0,
    device: DeviceLike = None,
) -> Dict[str, object]:
    """One open-loop scenario end to end: materialize the arrival stream,
    run it on one shared cluster (optionally under fair-share admission),
    and summarize per-class tails + fairness (+ SLO attainment/tardiness
    when ``specs`` carry slo targets).  ``batch_ticks`` /
    ``none_closed_form`` / ``closed_form_drain`` and the SLO-layer flags
    (``deadline_aware`` / ``deadline_cfg`` / ``preemption`` /
    ``autoscale``) forward to :class:`MultiQuerySimulator`;
    ``grid_align`` snaps arrivals onto a shared tick grid (see
    :func:`open_loop_tenants`), which puts a homogeneous fleet inside
    the batched-tick auto envelope — the many-tenant bench relies on
    this so hundreds of tenants batch BY DEFAULT.  The run's per-kind
    event counters are returned under ``"event_counts"`` and its resize
    log under ``"resizes"``.  ``sim_seed`` feeds the engine's per-tenant
    policy RNG streams (stochastic registry policies; the deterministic
    built-ins never consult theirs)."""
    tenants = open_loop_tenants(
        specs, cluster, resolve, process, num_queries, seed=seed,
        feed_factor=feed_factor, grid_align=grid_align,
    )
    sim = MultiQuerySimulator(
        cluster, fair_share=fair_share, batch_ticks=batch_ticks,
        none_closed_form=none_closed_form,
        closed_form_drain=closed_form_drain,
        deadline_aware=deadline_aware, deadline_cfg=deadline_cfg,
        preemption=preemption, autoscale=autoscale,
        faults=faults, fault_cfg=fault_cfg, seed=sim_seed, device=device,
    )
    results = sim.run(tenants)
    out = summarize_open_loop(
        tenants, results, cluster, fault_stats=sim.last_fault_stats
    )
    out["tenants"] = tenants
    out["results"] = results
    out["event_counts"] = dict(sim.last_event_counts)
    out["resizes"] = list(sim.last_resizes)
    out["fault_stats"] = dict(sim.last_fault_stats)
    return out


# ------------------------------------------------------------------ #
# Multi-stage pipelines (skew propagation)
# ------------------------------------------------------------------ #


def imbalance_coefficient(loads: Sequence[float]) -> float:
    """Skew coefficient of a per-worker load vector: max/mean.  1.0 is
    perfectly balanced; k means the hottest worker holds k times its
    fair share (the quantity DySkew's waterfill drives toward 1).
    Empty/all-zero loads have nothing to imbalance and return NaN."""
    x = np.asarray(list(loads), dtype=np.float64)
    if len(x) == 0 or not np.any(x):
        return float("nan")
    return float(x.max() / x.mean())


def amplification_ratios(imbalances: Sequence[float]) -> List[float]:
    """Stage-over-stage skew amplification: ratio of consecutive
    imbalance coefficients.  >1 means the exchange AMPLIFIED skew
    (e.g. a key-collision groupby), <1 means it attenuated."""
    imb = list(imbalances)
    return [
        float(imb[k + 1] / imb[k]) if imb[k] and np.isfinite(imb[k])
        else float("nan")
        for k in range(len(imb) - 1)
    ]


def summarize_pipeline(pres) -> Dict[str, object]:
    """Aggregate a `repro_torch.sim.pipeline.PipelineResult` into the skew
    propagation report: per-stage INPUT imbalance (rows offered per
    worker — what the shuffle produced), per-stage WORK imbalance
    (busy seconds per worker — what redistribution achieved against
    that input), stage-over-stage amplification of the input skew, and
    the end-to-end makespan vs the sum of per-stage makespans (equal
    for one tenant; a gap measures cross-tenant stage overlap)."""
    input_imb = [
        imbalance_coefficient(s.input_rows_per_worker) for s in pres.stages
    ]
    work_imb = [
        imbalance_coefficient(s.busy_per_worker) for s in pres.stages
    ]
    return {
        "stages": [s.name for s in pres.stages],
        "strategies": [s.strategy for s in pres.stages],
        "input_imbalance": input_imb,
        "work_imbalance": work_imb,
        "amplification": amplification_ratios(input_imb),
        "stage_makespans": [s.makespan for s in pres.stages],
        "makespan": pres.makespan,
        "stage_makespan_sum": pres.stage_makespan_sum,
        "rows_out": list(pres.rows_out),
    }


def run_pipeline_ab(
    stages,
    inputs,
    cluster: ClusterConfig,
    kinds: Sequence[str] = ("dyskew", "static_rr", "p2c"),
    seed: int = 0,
    device: DeviceLike = None,
) -> Dict[str, Dict[str, object]]:
    """A/B a chained-stage pipeline across registry policies: the SAME
    stages, inputs and seed (so keys/costs/fanout draws are identical
    across arms), with every stage's redistribution strategy overridden
    to each ``kinds`` entry in turn.  Returns
    ``{kind: summarize_pipeline(result)}``."""
    from repro_torch.sim.pipeline import PipelineSimulator, override_strategy

    out: Dict[str, Dict[str, object]] = {}
    for kind in kinds:
        sim = PipelineSimulator(
            cluster, override_strategy(stages, kind), seed=seed, device=device,
        )
        out[kind] = summarize_pipeline(sim.run(inputs))
    return out
