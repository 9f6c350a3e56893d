"""Discrete-event simulator of Snowpark-style UDF execution.

This is the *paper-faithful* layer: it models the asynchronous engine the
paper describes — virtual-warehouse nodes hosting pools of Python
interpreter processes (workers), producer link instances 1:1 with workers,
batches of rows flowing through adaptive data links, and a network that
charges for cross-node row movement.  Per-row UDF cost is OPAQUE to the
link (the defining difficulty in §I): routing decisions use only observed
backlog and the sibling-observable metrics of §III.A.

The state machines/skew models are the exact `repro_torch.core`
implementations, run on the simulator's ``device`` and fed host numpy
arrays (cast to float32 on the host, moved, and the distribute mask copied
back each tick), so the simulator and the serving paths share one
algorithm.  State
machines tick on a fixed virtual-time cadence (`tick_interval`), modelling
the engine's metrics subsystem; batch routing consults the latest
distribute mask plus the shared per-batch admission planner
(`repro_torch.core.admission`: Row Size Model density guard, cost gate,
self-skip eligibility — the same planner the serving engine and the data
pipeline call).

Strategies are pluggable: ``StrategyConfig.kind`` names a policy in the
`repro_torch.core.policy` registry — ``none`` (default 1:1 link), ``static_rr``
(the legacy Snowpark per-row round-robin, paper §II.B Fig. 1) and
``dyskew`` (the paper's adaptive link) are the built-in trio, and new
policies (``p2c``, ``key_affinity``, ``hillclimb``, ...) land as plugins
through the same seam (`repro_torch.core.policy.available_policies()` lists the
roster; an unknown kind raises at `StrategyConfig` construction).  The
engine asks the POLICY CLASS — never a kind string — which fast paths
apply: ``never_redistributes`` licenses the closed-form 'none' path,
``drain_safe`` the closed-form drain, ``uses_link`` the (batched-)tick
machinery and ``batched_waterfill`` the coalesced-run waterfill planner.

ONE event loop.  ``MultiQuerySimulator.run`` is the only event loop in
this module; ``Simulator.run_query`` is its N=1 specialization (one
tenant, arrival at t=0).  `MultiQuerySimulator` interleaves N concurrent
queries (tenants) over ONE shared cluster — shared interpreter pools and
shared per-node NIC occupancy — while each tenant keeps its own
`AdaptiveLinkSim`, cost estimator, flow-control window and strategy, as in
the paper's production setting where many Snowpark queries contend for the
same virtual warehouse.  Tenants carry priority weights; passing a
`FairShareConfig` turns on the weighted deficit-round-robin admission
layer (`repro_torch.core.admission.FairShareAdmission`), which paces each
tenant's batches into the shared pool/NIC and parks over-share arrivals
until completed service earns them credit.  The result is one
`QueryResult` per tenant (latency measured from the tenant's arrival),
which `sim/replay.py` and `benchmarks/bench_multi_tenant.py` aggregate
into per-tenant percentiles and Jain's fairness index.

Engine invariants (the bars `tests/test_sim_equivalence.py` enforces on
the reference and `tests/test_torch_sim.py` on this port):

  * Array-backed core.  Queued rows live in contiguous per-worker ring
    buffers (`_RowRing`): ``buf[head:tail]`` is the FIFO of pending row
    costs, pushes are single vectorized segment copies (a push may
    compact/grow, so popped views must be consumed before the next
    push), and a parallel int32 ``qbuf`` lane records each row's owning
    tenant whenever more than one tenant shares the cluster.  Batch
    routing groups rows per destination with ONE stable sort
    (`_group_by_dest`), and event payloads are numpy segments, never
    per-row Python tuples.
  * Bit-exactness bar.  The seed list-of-tuples engine is preserved in
    `repro_torch.sim.legacy`, and the unified loop must reproduce its
    `QueryResult` to rtol=1e-9 for single-tenant runs (and for
    multi-tenant runs that are provably non-interacting).  The
    trajectories are chaotic — one ulp of rounding difference amplifies
    through routing decisions — so the loop keeps the legacy engine's
    float operations in the legacy order: service-burst totals are
    sequential sums (``np.bincount`` weight accumulation, which adds in
    index order), per-destination byte totals use numpy's pairwise
    ``.sum()`` on the same element order the legacy masks produced, and
    the EMA update is ``(1-a)*est + a*(total/rows)``.  Do not "simplify"
    these expressions.
  * Determinism.  Given the same tenants the engine is bit-reproducible:
    no RNG is consulted inside the loop, heap ties break on a
    monotonically increasing sequence number, and the fair-share planner
    is deterministic.  This is what lets `sim/replay.py` fan suites out
    across a process pool (``REPRO_BENCH_WORKERS`` pins the worker
    count; 0/1 = serial) with results identical to the serial run.

Scaling to hundreds of tenants.  Several fast paths keep the loop cheap
at large N, governed by flags on `MultiQuerySimulator` whose ``None``
default enables them only where they are provably equivalent to the
reference trajectory:

  * Batched ticks (``batch_ticks``).  Per-tenant `AdaptiveLinkSim`
    dispatch is replaced by ONE `repro_torch.sim.batched_link.BatchedLinkSim`
    call per shared tick: tenants with the same (DySkewConfig,
    tick_interval) form a group whose (T, n) stacked link state advances
    through a single `tick_many` call, driven by one coalesced heap
    event per group cadence with inactive tenants masked.  A tenant
    arriving off-grid gets a one-off masked join tick at its arrival (so
    eager links distribute from row one) and then rides the shared grid.
    ``None`` (auto) decides PER GROUP, batching exactly the proven
    envelope: a single-member group (its grid IS its cadence), or a
    multi-link group whose every member arrives exactly on the group's
    chained tick grid (`_arrivals_on_grid`; identical arrivals are the
    trivial case) — then each member ticks at precisely its per-tenant
    instants and the vmap rows are bit-exact, so the trajectory is
    bit-identical to the per-tenant path.  Off-grid multi-link groups
    fall back to per-tenant links under auto, because the shared grid
    would quantize their tick times; ``batch_ticks=True`` forces them.
    `sim/replay.py::open_loop_tenants(grid_align=...)` snaps open-loop
    arrivals onto the grid so whole suites batch by default.
  * Batched same-instant routing.  A maximal run of arrival events at
    one timestamp is routed through ONE `waterfill_counts_many` call
    per cascade level: different tenants' same-instant batches are
    independent (backlog, estimate and masks are per-tenant), while
    same-tenant batches cascade through its own ``outstanding`` backlog
    and form sequential levels.  All side effects (fair-share
    admission, NIC occupancy, pushes, pacing) apply in heap pop order,
    and same-(time, destination) _ENQUEUE pushes coalesce into one heap
    event whose segments replay individually at pop — bit-identical to
    uncoalesced events.
  * Closed-form drain (``closed_form_drain``).  Once every arrival has
    been routed (checked conservatively: the per-tenant remaining
    counters, which also cover fair-share-parked work, all hit zero),
    no state-machine transition can change the result — routing is the
    only consumer of distribute masks and cost estimates — and workers
    become independent FIFO servers.  The loop exits the heap and
    finishes each worker exactly: a short per-event replay while
    transfers are in flight, then one prefix-sum walk over the loaded
    ring (generalizing `closed_form_none_result`'s bit-order-exact
    accumulation to the mixed-strategy endgame); pending tick cadences
    reduce to closed-form counting (exact up to the constructed-only
    case of a tick time EXACTLY equalling a completion time in float,
    where the closed form's documented tie convention can differ from
    the heap's seq tie-break by one num_ticks — telemetry only).
    ``False`` replays the heap to exhaustion instead (the A/B the bench
    reports).  While any arrival is pending — i.e. while a link
    transition could still affect a routing decision — the heap always
    runs.
  * Closed-form 'none' strategy (``none_closed_form``).  A tenant that
    never redistributes keeps every producer's rows on its own worker,
    so per-worker completion times collapse to a prefix sum over
    service-chunk totals — no event loop needed.  ``None`` (auto) takes
    the closed form only in the proven-exact regime (all tenants 'none',
    no fair share, disjoint producers, single-batch streams);
    ``True`` extends it to multi-batch streams, where it is exact while
    workers stay backlogged and a lower bound otherwise.

SLO layer (all OFF by default — with the defaults the loop takes no new
branches, so the equivalence pins are untouched):

  * Deadline-aware admission (``deadline_aware``).  Tenants carry
    ``slo_target`` (seconds from arrival); the fair-share planner is
    upgraded to `repro_torch.core.admission.DeadlineAwareAdmission`, whose EDF
    credit boost relaxes the admission threshold as slack runs out
    (charging in full — debt — so weighted shares still hold) and whose
    release order re-offers parked work earliest-deadline-first.
  * Preemption (``preemption``).  An urgent tenant whose batch was
    parked may displace admitted-but-unstarted rows of over-share
    tenants: `_RowRing.extract` pulls the victim's rows from the tail
    of the worker rings, they re-enter through fair share
    (`release_parked`) and return to their ORIGINAL worker (transfer
    already paid; only the rows lane is re-charged).  The closed-form
    drain's conservative detector counts preempt-parked rows as pending
    work, so the drain cannot fire while any displaced row awaits
    re-injection.
  * Autoscaling (``autoscale``).  A recurring RESIZE heap event feeds
    `AutoscalePolicy` the queued-row backlog and running SLO attainment
    and resizes the active pool in whole workers.  Decommissioned
    workers drain gracefully but are ineligible destinations (+inf
    waterfill backlog; static_rr cycles the active set; a
    decommissioned producer's scan re-targets the least-backlogged
    active worker and pays the transfer).  Post-drain RESIZE events are
    inert.

Per-event hygiene: the density guard's idle-sibling fraction comes from
an incrementally-maintained idle-worker census (not an O(n) scan per
batch), and every run records per-kind event counters in
``MultiQuerySimulator.last_event_counts`` (heap pops by kind, arrivals
coalesced, enqueues coalesced, batched waterfill rows, drain stats) —
the bench surfaces them so event-count reductions are directly visible.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import deque
from typing import Callable, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.core import state_machine
from repro_torch.core.admission import (
    AutoscaleConfig,
    AutoscalePolicy,
    DeadlineAwareAdmission,
    DeadlineConfig,
    FairShareAdmission,
    FairShareConfig,
)
# The policy seam lives in repro.core.policy since the registry refactor;
# StrategyConfig and the waterfill trio are re-exported here because the
# legacy oracle (`repro_torch.sim.legacy`) and the test suite import them from
# this module.  noqa: F401 on the re-exports.
from repro_torch.core.policy import (  # noqa: F401
    PolicyContext,
    RedistributionPolicy,
    StrategyConfig,
    _waterfill_repair,
    available_policies,
    register_policy,
    resolve_policy,
    waterfill_counts,
    waterfill_counts_many,
)
from repro_torch.core.types import DySkewConfig, Policy, link_state_init
from repro_torch.runtime.fault_tolerance import FaultConfig, FaultTolerantRuntime
from repro_torch.sim.batched_link import BatchedLinkSim
from repro_torch.sim.faults import (
    NIC_DEGRADE,
    PREEMPT,
    SLOWDOWN,
    FaultSchedule,
    default_sim_fault_config,
)


# --------------------------------------------------------------------- #
# Cluster / workload dataclasses
# --------------------------------------------------------------------- #


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    num_nodes: int = 4
    interpreters_per_node: int = 8
    # Cross-node NIC bandwidth and per-batch latency.
    network_bandwidth: float = 1.25e9      # bytes/s (10 GbE)
    network_latency: float = 200e-6        # s per cross-node batch hop
    # Same-node IPC (VW thread → interpreter) costs.
    ipc_bandwidth: float = 8e9
    ipc_latency: float = 20e-6
    # Fixed serialization overhead per row crossing a process boundary
    # (§III.B: 'mandatory data serialization across process boundaries').
    per_row_serialize: float = 2e-6
    # Model per-node egress NIC occupancy (transfers from one node
    # serialize on its uplink — what saturates on 100 GB+ heavy rows).
    model_contention: bool = True
    # Credit-based flow control: a producer pauses once its destination's
    # outstanding (sent-unacked) rows exceed this window. Link-level
    # redistribution relieves exactly this backpressure — the mechanism by
    # which DySkew unblocks straggler pipelines.
    flow_window_rows: int = 32

    @property
    def num_workers(self) -> int:
        return self.num_nodes * self.interpreters_per_node

    def node_of(self, worker: int) -> int:
        return worker // self.interpreters_per_node


@dataclasses.dataclass
class Batch:
    """A rowset batch: costs are the TRUE (hidden) per-row UDF seconds.

    ``ids`` is an optional per-row lineage lane (tenant-local row
    indices in ``[0, total rows of the tenant)``): when present AND the
    engine runs with ``trace_placement=True``, the final worker of each
    row is recorded in ``MultiQuerySimulator.last_placement`` — the hook
    the pipeline layer (`repro_torch.sim.pipeline`) uses to propagate skew
    across chained stages.  The lane is never read on the hot path
    otherwise, and tracing itself performs no float arithmetic, so it
    cannot perturb the legacy-equivalence trajectory.
    """

    costs: np.ndarray   # (rows,) float64
    sizes: np.ndarray   # (rows,) float64 bytes
    ids: Optional[np.ndarray] = None   # (rows,) int64 lineage ids

    @property
    def num_rows(self) -> int:
        return len(self.costs)

    @property
    def total_bytes(self) -> float:
        # Cached: batches are immutable in practice and re-routed often
        # (once per strategy under comparison).
        tb = self.__dict__.get("_total_bytes")
        if tb is None:
            tb = self.__dict__["_total_bytes"] = float(self.sizes.sum())
        return tb


@dataclasses.dataclass
class QueryResult:
    latency: float
    utilization: float
    bytes_moved_remote: float
    rows_redistributed: int
    redistribution_applied: bool
    per_worker_busy: np.ndarray
    decision_overhead: float
    num_ticks: int = 0
    #: Rows of this tenant displaced back through fair share by the SLO
    #: preemption path (0 unless the engine ran with ``preemption=True``).
    preempted_rows: int = 0


# --------------------------------------------------------------------- #
# Adaptive link driver (core state machine on the device, host arrays in)
# --------------------------------------------------------------------- #


class AdaptiveLinkSim:
    """Host-side wrapper around the core state machines for all producer
    link instances of one query (they are siblings of each other), with
    their state on ``device`` (``None``: the GPU)."""

    def __init__(self, cfg: DySkewConfig, n: int, device: DeviceLike = None):
        self.cfg = cfg
        self.n = n
        self.device = resolve_device(device)
        # State lives on the device between ticks; only the distribute
        # mask comes back each tick.
        self.state = link_state_init(n, cfg, self.device)

    def tick(self, rows, sync, density, bpr, signal) -> np.ndarray:
        # Cast on the host (a contiguous copy), then move, as the reference does.
        f32 = np.float32
        rows_t, sync_t, density_t, bpr_t, signal_t = (
            torch.from_numpy(a.astype(dtype)).to(self.device)
            for a, dtype in ((rows, f32), (sync, f32), (density, f32), (bpr, f32), (signal, bool))
        )
        self.state, distribute = state_machine.tick(
            self.state,
            self.cfg,
            rows_this_tick=rows_t,
            sync_time_this_tick=sync_t,
            batch_density=density_t,
            bytes_per_row=bpr_t,
            signal_this_tick=signal_t,
        )
        return distribute.cpu().numpy()

    @property
    def states(self) -> np.ndarray:
        return self.state["state"].cpu().numpy()

    @property
    def transitions(self) -> np.ndarray:
        return self.state["transitions"].cpu().numpy()


# --------------------------------------------------------------------- #
# Routing helpers
# --------------------------------------------------------------------- #

# (`_waterfill_repair` / `waterfill_counts` / `waterfill_counts_many`
# moved verbatim to `repro_torch.core.policy` with the registry refactor and
# are re-exported above.)


class _RowRing:
    """Contiguous FIFO ring of queued row costs for ONE worker.

    Segments are appended with a single vectorized copy; service bursts
    pop a contiguous view.  Popped views must be consumed before the next
    push (a push may compact the buffer).  When ``track_qids`` is set a
    parallel int32 lane records the owning tenant of each row (used by
    the multi-tenant event loop for per-query accounting in shared
    pools; the N=1 loop skips the lane entirely).
    """

    __slots__ = ("buf", "qbuf", "head", "tail")

    def __init__(self, cap: int = 256, track_qids: bool = False):
        self.buf = np.empty(cap, np.float64)
        self.qbuf = np.empty(cap, np.int32) if track_qids else None
        self.head = 0
        self.tail = 0

    def __len__(self) -> int:
        return self.tail - self.head

    def push(self, costs: np.ndarray, qid: int = 0) -> None:
        k = len(costs)
        if self.tail + k > self.buf.size:
            self._compact_grow(k)
        self.buf[self.tail:self.tail + k] = costs
        if self.qbuf is not None:
            self.qbuf[self.tail:self.tail + k] = qid
        self.tail += k

    def _compact_grow(self, k: int) -> None:
        live = self.tail - self.head
        cap = self.buf.size
        while cap < live + k:
            cap *= 2
        if cap > self.buf.size:
            new = np.empty(cap, np.float64)
            new[:live] = self.buf[self.head:self.tail]
            self.buf = new
            if self.qbuf is not None:
                newq = np.empty(cap, np.int32)
                newq[:live] = self.qbuf[self.head:self.tail]
                self.qbuf = newq
        elif live:
            # Slide live region to the front (copy src first if overlapping).
            src = self.buf[self.head:self.tail]
            self.buf[:live] = src.copy() if self.head < live else src
            if self.qbuf is not None:
                qsrc = self.qbuf[self.head:self.tail]
                self.qbuf[:live] = qsrc.copy() if self.head < live else qsrc
        self.head = 0
        self.tail = live

    def pop(self, k: int) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        k = min(k, self.tail - self.head)
        i = self.head
        self.head += k
        costs = self.buf[i:i + k]
        qids = self.qbuf[i:i + k] if self.qbuf is not None else None
        return costs, qids

    def extract(self, qid: int, max_rows: int) -> np.ndarray:
        """Remove up to ``max_rows`` rows owned by ``qid`` from the queued
        region (taken from the TAIL end — the rows that would have been
        served last), compacting the survivors in FIFO order.  Returns
        the extracted costs.  Requires the tenant lane (``track_qids``);
        used by the SLO preemption path to re-park admitted-but-unstarted
        service of an over-share tenant."""
        if self.qbuf is None or self.tail == self.head or max_rows <= 0:
            return np.empty(0, np.float64)
        seg_q = self.qbuf[self.head:self.tail]
        idx = np.flatnonzero(seg_q == qid)
        if not len(idx):
            return np.empty(0, np.float64)
        if len(idx) > max_rows:
            idx = idx[-max_rows:]
        seg_c = self.buf[self.head:self.tail]
        costs = seg_c[idx].copy()
        keep = np.ones(len(seg_q), bool)
        keep[idx] = False
        live_c = seg_c[keep]      # fancy indexing copies — safe to write back
        live_q = seg_q[keep]
        m = len(live_c)
        self.buf[self.head:self.head + m] = live_c
        self.qbuf[self.head:self.head + m] = live_q
        self.tail = self.head + m
        return costs


def _transfer_delay(c: ClusterConfig, src_worker: int, dst_worker: int,
                    nbytes: float, nrows: int) -> float:
    """Contention-free transfer latency (NIC occupancy handled by the
    caller when model_contention is on)."""
    ser = nrows * c.per_row_serialize
    if c.node_of(src_worker) == c.node_of(dst_worker):
        if src_worker == dst_worker:
            return ser  # stays in-process pipeline; serialization only
        return c.ipc_latency + nbytes / c.ipc_bandwidth + ser
    return c.network_latency + nbytes / c.network_bandwidth + ser


def _group_by_dest(
    dests: np.ndarray, costs: np.ndarray, sizes: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Group a batch's rows by destination with ONE stable sort.

    Returns (sorted_dests, starts, ends, costs_sorted, sizes_sorted);
    group j covers rows [starts[j], ends[j]) of the sorted arrays and all
    go to destination sorted_dests[starts[j]].  Destinations come out
    ascending and rows keep their in-batch order within a group — the
    same grouping the legacy per-destination boolean masks produced.
    """
    order = np.argsort(dests, kind="stable")
    sd = dests[order]
    bounds = np.flatnonzero(sd[1:] != sd[:-1]) + 1
    starts = np.concatenate(([0], bounds))
    ends = np.concatenate((bounds, [len(sd)]))
    return sd, starts, ends, costs[order], sizes[order]


def _producer_placement(tenant: "TenantQuery") -> Optional[np.ndarray]:
    """Placement of a 'none'-strategy tenant in closed form: every
    lineage-tagged row stays on its producing worker (the exact property
    `closed_form_none_result` relies on).  None when no batch carries an
    ids lane."""
    hi = -1
    for stream in tenant.streams:
        for b in stream:
            if b.ids is not None and len(b.ids):
                hi = max(hi, int(b.ids.max()))
    if hi < 0:
        return None
    place = np.full(hi + 1, -1, np.int64)
    for p, stream in enumerate(tenant.streams):
        for b in stream:
            if b.ids is not None:
                place[b.ids] = p
    return place


def closed_form_none_result(
    tenant: "TenantQuery", cluster: ClusterConfig
) -> QueryResult:
    """Vectorized closed form for a 'none'-strategy tenant.

    Without redistribution every producer's rows stay on its own worker,
    so each worker is an independent FIFO server: its completion time is
    the prefix sum of its service-chunk totals starting from the first
    enqueue (arrival + first-batch serialization).  The float operations
    mirror the event loop exactly — within-chunk ``cumsum`` reproduces the
    loop's sequential python-float chunk sums, and the outer ``cumsum``
    reproduces the heap's ``now + total`` accumulation — so the result is
    bit-identical to the event loop whenever no worker idles mid-stream
    and every service pop finds a full chunk queued.  Both hold trivially
    for single-batch streams (the proven regime the engine auto-selects);
    for multi-batch backlogged streams the result is exact up to chunk-
    boundary rounding, and a lower bound if a worker would have idled.
    """
    c = cluster
    n = c.num_workers
    ser = c.per_row_serialize
    busy = np.zeros(n)
    last_done = tenant.arrival
    for p, stream in enumerate(tenant.streams):
        if not stream:
            continue
        costs = (
            stream[0].costs if len(stream) == 1
            else np.concatenate([b.costs for b in stream])
        )
        m = len(costs)
        nchunks = -(-m // _SERVICE_CHUNK)
        padded = np.zeros(nchunks * _SERVICE_CHUNK)
        padded[:m] = costs
        # Sequential within-chunk accumulation (the event loop's python
        # sum), then sequential across chunks (the loop's now += total).
        totals = np.cumsum(
            padded.reshape(nchunks, _SERVICE_CHUNK), axis=1
        )[:, -1]
        first_enqueue = tenant.arrival + len(stream[0].costs) * ser
        walk = np.cumsum(np.concatenate(([first_enqueue], totals)))
        busy[p] = float(np.cumsum(totals)[-1])
        completion = float(walk[-1])
        if completion > last_done:
            last_done = completion
    latency = max(last_done - tenant.arrival, 1e-12)
    return QueryResult(
        latency=float(latency),
        utilization=float(busy.sum() / (latency * n)),
        bytes_moved_remote=0.0,
        rows_redistributed=0,
        redistribution_applied=False,
        per_worker_busy=busy,
        decision_overhead=0.0,
        num_ticks=0,
    )


# --------------------------------------------------------------------- #
# The simulator
# --------------------------------------------------------------------- #

_TICK, _ARRIVAL, _ENQUEUE, _DONE, _ADMITTED, _GTICK, _RESIZE = (
    0, 1, 2, 3, 4, 5, 6
)
# Fault layer: FAIL pulls a worker (crash / end of spot drain) or opens a
# slowdown/NIC window; PREEMPT_NOTICE starts a spot drain (routing stops,
# service continues); RECOVER closes a transient window or rejoins a
# replaced worker; HBEAT drives virtual-time heartbeats + detection.
# None of these is ever pushed when the fault schedule is empty.
_FAIL, _PREEMPT_NOTICE, _RECOVER, _HBEAT = 7, 8, 9, 10

_KIND_NAMES = (
    "tick", "arrival", "enqueue", "done", "admitted", "gtick", "resize",
    "fail", "preempt_notice", "recover", "hbeat",
)

#: Rows per service burst (completion-ack granularity).
_SERVICE_CHUNK = 16

#: Sentinel: route_batch computes the destinations itself (no precomputed
#: waterfill plan from a coalesced same-time arrival run).
_RB_INLINE = object()


def _arrivals_on_grid(
    arrivals: List[float], interval: float, max_steps: int = 1 << 20
) -> bool:
    """True when every arrival lies exactly on the chained float grid
    ``origin, origin+I, (origin+I)+I, ...`` that the engine's coalesced
    group tick walks (``push(now + interval)`` from the earliest arrival).

    This is the provable batched-tick equivalence condition for a
    multi-link tenant group: a member arriving at a chained grid value
    ticks at exactly the instants its per-tenant cadence would (both
    chains advance by single float additions of ``interval`` from equal
    values), so the shared grid quantizes nothing.  Identical arrivals
    are the trivial case (every arrival IS the origin).  The check is
    exact float equality — conservative by construction.
    """
    uniq = sorted(set(arrivals))
    t = uniq[0]
    steps = 0
    for a in uniq[1:]:
        while t < a:
            t += interval
            steps += 1
            if steps > max_steps:
                return False
        if t != a:
            return False
    return True


# (`StrategyConfig` moved to `repro_torch.core.policy` with the registry
# refactor — it now validates `kind` against the registry at construction
# — and is re-exported above for the legacy oracle and existing callers.)


@dataclasses.dataclass
class TenantQuery:
    """One tenant of a multi-query run: its input streams, its strategy,
    when it arrives on the shared cluster (virtual seconds), and its
    fair-share priority weight (only consulted when the engine runs with
    a `FairShareConfig`; higher weight = larger share)."""

    name: str
    streams: List[List[Batch]]
    strategy: StrategyConfig
    arrival: float = 0.0
    arrival_gap: float = 1e-4
    weight: float = 1.0
    #: SLO target: seconds from arrival to last-row completion.  None =
    #: no deadline.  Consulted only when the engine runs with
    #: ``deadline_aware=True`` (and by the replay harness's attainment
    #: metrics); otherwise inert.
    slo_target: Optional[float] = None


class MultiQuerySimulator:
    """THE event loop: N concurrent queries over ONE shared cluster.

    Workers (interpreter pools) and per-node NIC uplinks are shared across
    tenants — a straggler pipeline of one query delays everyone behind it
    in the same ring, which is exactly the contention the paper's
    production setting implies.  Each tenant keeps private link state
    machines, cost estimator, backlog counters and tick cadence, so
    redistribution decisions stay per-query.  ``Simulator`` (the
    single-query API) is the N=1 case of this loop.

    ``fair_share`` enables the weighted deficit-round-robin admission
    layer: each batch arrival must clear the tenant's pool/NIC deficit
    before it is routed; over-share arrivals are parked and re-offered in
    round-robin order as completed service earns the tenant credit.

    ``batch_ticks`` selects the tick driver: ``True`` stacks all link
    tenants into shared `BatchedLinkSim` groups advanced by ONE tick
    call per coalesced tick event (the path that scales to hundreds of
    tenants), ``False`` keeps one `AdaptiveLinkSim` per tenant on its own
    cadence, and ``None`` (default) auto-selects batching PER GROUP
    where it is provably bit-identical: single-member groups and
    multi-link groups whose members all arrive exactly on the group's
    chained tick grid (identical arrivals included — see
    `_arrivals_on_grid`).

    ``closed_form_drain`` (default on; ``False`` disables) exits the
    heap once every arrival has been routed and finishes each worker by
    bit-order-exact prefix sums, recovering the remaining tick counts in
    closed form — the endgame of every run stops paying per-event cost.

    ``none_closed_form`` selects the no-event-loop closed form for runs
    whose tenants all use the 'none' strategy on disjoint producers:
    ``None`` (default) applies it only in the proven-exact single-batch
    regime, ``True`` forces it (exact while backlogged, else a lower
    bound), ``False`` always runs the event loop.  See the module
    docstring for the equivalence arguments.

    ``device`` is where every tenant's link state lives and ticks
    (``None``: the GPU; ``"cpu"`` on a host without one).  The event loop
    itself is host numpy whatever the device.
    """

    def __init__(
        self,
        cluster: ClusterConfig,
        fair_share: Optional[FairShareConfig] = None,
        batch_ticks: Optional[bool] = None,
        none_closed_form: Optional[bool] = None,
        closed_form_drain: Optional[bool] = None,
        deadline_aware: bool = False,
        deadline_cfg: Optional[DeadlineConfig] = None,
        preemption: bool = False,
        autoscale: Optional[AutoscaleConfig] = None,
        faults: Optional[FaultSchedule] = None,
        fault_cfg: Optional[FaultConfig] = None,
        trace_placement: bool = False,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        # Fully deterministic given (tenants, seed): the streams/arrivals
        # carry their own seeds, and `seed` only feeds the per-tenant
        # policy RNG streams (child streams [seed, q]) — the
        # deterministic built-in policies never consult theirs, so the
        # legacy no-RNG-in-the-loop invariant still holds for them.
        self.seed = seed
        self.cluster = cluster
        self.fair_share = fair_share
        self.batch_ticks = batch_ticks
        self.none_closed_form = none_closed_form
        self.closed_form_drain = closed_form_drain
        # SLO layer (all default OFF — with the defaults the loop takes
        # not a single new branch, so the legacy equivalence pin is
        # untouched).  ``deadline_aware`` upgrades the fair-share planner
        # to `DeadlineAwareAdmission` (tenants' `slo_target` become
        # admission deadlines with an EDF credit boost); ``preemption``
        # lets an urgent tenant displace admitted-but-unstarted rows of
        # over-share tenants back through fair share; ``autoscale``
        # schedules a recurring RESIZE event that grows/shrinks the
        # active interpreter pool per `AutoscalePolicy`.
        if deadline_aware and fair_share is None:
            raise ValueError(
                "deadline_aware requires fair_share (the deadline-aware "
                "planner is an upgrade of the fair-share layer)"
            )
        if preemption and not deadline_aware:
            raise ValueError(
                "preemption requires deadline_aware (victims are picked "
                "by the deadline-aware planner)"
            )
        self.deadline_aware = deadline_aware
        self.deadline_cfg = deadline_cfg
        self.preemption = preemption
        self.autoscale = autoscale
        # Fault layer (default OFF like the SLO layer above: with
        # ``faults=None`` or an empty schedule no fault event is pushed
        # and no fault branch is taken).  ``fault_cfg`` tunes detection
        # (`FaultConfig`); None means `default_sim_fault_config()`.
        if faults is not None:
            faults.validate(cluster.num_workers, cluster.num_nodes)
        self.faults = faults
        self.fault_cfg = fault_cfg
        #: Fault/recovery telemetry of the most recent `run` (always set;
        #: ``{'enabled': False}``-shaped when no schedule was active).
        self.last_fault_stats: Dict[str, object] = {}
        #: Record the final worker of every lineage-tagged row (requires
        #: ``Batch.ids``).  Purely observational: the tracing branch does
        #: no float arithmetic and no RNG draws, so a traced run is
        #: bit-identical to an untraced one (pinned by
        #: tests/test_pipeline.py's differential test).
        self.trace_placement = trace_placement
        #: Per-tenant (rows,) int64 final-worker arrays of the most
        #: recent traced `run` (None for tenants without an ids lane).
        self.last_placement: List[Optional[np.ndarray]] = []
        #: Per-kind event counters of the most recent `run` (heap events
        #: popped by kind, coalescing stats, drain stats).  Telemetry
        #: only — reported by `benchmarks/bench_multi_tenant.py`.
        self.last_event_counts: Dict[str, int] = {}
        #: (time, old, new) resize log of the most recent autoscaled run.
        self.last_resizes: List[Tuple[float, int, int]] = []

    def _none_fast_path_ok(self, tenants: List[TenantQuery]) -> bool:
        """True when the closed-form 'none' path may replace the loop."""
        if self.none_closed_form is False or self.fair_share is not None:
            return False
        if self.autoscale is not None:
            return False
        if self.faults is not None and len(self.faults.events) > 0:
            return False
        if not tenants:
            return False
        if any(
            not resolve_policy(t.strategy.kind).never_redistributes
            for t in tenants
        ):
            return False
        # Producers must be disjoint: a worker fed by two tenants serves
        # an interleaved FIFO the per-tenant closed form cannot see.
        seen = set()
        for t in tenants:
            for p, stream in enumerate(t.streams):
                if stream:
                    if p in seen:
                        return False
                    seen.add(p)
        if self.none_closed_form:
            return True
        # Auto: only the regime where the closed form is provably
        # bit-identical to the event loop (single-batch streams — no
        # arrival pacing, no idle gaps, whole-stream chunk boundaries).
        return all(len(s) <= 1 for t in tenants for s in t.streams)

    def _transfer_delay(self, src: int, dst: int, nbytes: float,
                        nrows: int) -> float:
        return _transfer_delay(self.cluster, src, dst, nbytes, nrows)

    def run(self, tenants: List[TenantQuery]) -> List[QueryResult]:
        c = self.cluster
        n = c.num_workers
        nq = len(tenants)

        if self._none_fast_path_ok(tenants):
            # No redistribution, disjoint producers: per-worker completion
            # times are a prefix sum — skip the event loop entirely.
            self.last_event_counts = {"none_closed_form_tenants": nq}
            self.last_fault_stats = {"enabled": False}
            if self.trace_placement:
                self.last_placement = [
                    _producer_placement(t) for t in tenants
                ]
            return [closed_form_none_result(t, c) for t in tenants]

        # Hot-loop locals: node lookup table, flat network constants, and
        # plain-Python scalar state (single-element numpy indexing is ~10x
        # a list index at this event grain).  Vector math converts the
        # lists once per tick / per routed batch instead.
        node = [w // c.interpreters_per_node for w in range(n)]
        net_bw, net_lat = c.network_bandwidth, c.network_latency
        ipc_bw, ipc_lat = c.ipc_bandwidth, c.ipc_latency
        ser = c.per_row_serialize
        contention = c.model_contention
        flow_window = c.flow_window_rows
        heappush, heappop = heapq.heappush, heapq.heappop

        rings = [_RowRing(track_qids=nq > 1) for _ in range(n)]
        worker_running = [False] * n
        nic_free_at = [0.0] * c.num_nodes
        # Incrementally-maintained idle-worker census (a worker is idle
        # iff it is not running and its ring is empty).  Replaces the
        # per-batch O(n) sibling scan the density guard used to pay.
        worker_idle = [True] * n
        idle_count = n

        # Per-tenant state (outer index = tenant).
        strategies = [t.strategy for t in tenants]
        streams = [t.streams for t in tenants]
        # Capability flags come from the POLICY CLASS, not a kind string:
        # the registry is the single source of truth for which engine
        # machinery (links, overhead billing, batched planning) applies.
        pol_cls = [resolve_policy(t.strategy.kind) for t in tenants]
        has_link = [cls.uses_link for cls in pol_cls]
        pays_overhead = [cls.pays_decision_overhead for cls in pol_cls]
        batched_wf = [cls.batched_waterfill for cls in pol_cls]
        links: List[Optional[AdaptiveLinkSim]] = [None] * nq
        # Batched-tick groups: tenants sharing (DySkewConfig,
        # tick_interval) ride one BatchedLinkSim and ONE coalesced grid
        # tick event; entries are (sim, member qids, interval, origin).
        # ``batch_ticks=None`` (auto) decides PER GROUP: a group batches
        # when it is provably bit-identical to the per-tenant cadence —
        # a single member (its grid IS its cadence), or every member
        # arriving exactly on the group's chained tick grid (see
        # `_arrivals_on_grid`; identical arrivals are the trivial case).
        # Groups failing the check fall back to per-tenant links.
        groups: List[Tuple[BatchedLinkSim, List[int], float, float]] = []
        group_of: Dict[int, int] = {}
        by_key: Dict[Tuple, List[int]] = {}
        for q in range(nq):
            if has_link[q]:
                key = (strategies[q].dyskew, strategies[q].tick_interval)
                by_key.setdefault(key, []).append(q)
        for (cfg_g, interval), members in by_key.items():
            if self.batch_ticks is None:
                batch_group = len(members) == 1 or _arrivals_on_grid(
                    [tenants[q].arrival for q in members], interval
                )
            else:
                batch_group = self.batch_ticks
            if batch_group:
                origin = min(tenants[q].arrival for q in members)
                for q in members:
                    group_of[q] = len(groups)
                groups.append((
                    BatchedLinkSim(cfg_g, n, len(members), self.device),
                    members, interval, origin,
                ))
            else:
                for q in members:
                    links[q] = AdaptiveLinkSim(
                        strategies[q].dyskew, n, self.device
                    )
        # Per-group member state as contiguous arrays (the per-tick live
        # scan used to rebuild python lists per event — at T≳128 that
        # dominated the coalesced tick's host cost).
        member_slot: Dict[int, Tuple[int, int]] = {}
        grp_members_arr: List[np.ndarray] = []
        grp_arrival: List[np.ndarray] = []
        grp_last_tick: List[np.ndarray] = []
        grp_active: List[np.ndarray] = []
        grp_final: List[np.ndarray] = []
        for g, (_, members, _, _) in enumerate(groups):
            for i, q in enumerate(members):
                member_slot[q] = (g, i)
            grp_members_arr.append(np.asarray(members, np.int64))
            grp_arrival.append(
                np.asarray([tenants[q].arrival for q in members])
            )
            grp_last_tick.append(np.full(len(members), np.nan))
            grp_active.append(np.ones(len(members), bool))
            grp_final.append(np.zeros(len(members), bool))
        est_row_cost = [1e-3] * nq
        # Observable backlog: rows sent to each consumer minus rows acked
        # complete (the producer sees its own sends and completion acks;
        # it never sees the hidden per-row costs).
        outstanding = [[0.0] * n for _ in range(nq)]
        recv_in_tick = [[0.0] * n for _ in range(nq)]
        sync_in_tick = [[0.0] * n for _ in range(nq)]
        rows_arr_in_tick = [[0.0] * n for _ in range(nq)]
        batches_arr_in_tick = [[0.0] * n for _ in range(nq)]
        bytes_arr_in_tick = [[0.0] * n for _ in range(nq)]
        # Batched groups keep their per-tick metric accumulators as rows
        # of ONE contiguous (T, n) float64 array per group, so a grid
        # tick consumes them with zero list→array conversion (the
        # conversion dominated the coalesced tick at T≳128).  Event
        # handlers mutate the same views through the per-tenant aliases;
        # scalar `row[w] += x` is the identical IEEE float64 add the
        # list path performs.
        group_acc: List[Dict[str, np.ndarray]] = []
        for sim_g, members, _, _ in groups:
            acc = {
                k: np.zeros((len(members), n))
                for k in ("recv", "sync", "rows", "batches", "bytes")
            }
            group_acc.append(acc)
            for i, q in enumerate(members):
                recv_in_tick[q] = acc["recv"][i]
                sync_in_tick[q] = acc["sync"][i]
                rows_arr_in_tick[q] = acc["rows"][i]
                batches_arr_in_tick[q] = acc["batches"][i]
                bytes_arr_in_tick[q] = acc["bytes"][i]
        busy = [[0.0] * n for _ in range(nq)]
        rows_done = [[0] * n for _ in range(nq)]
        bytes_moved = [0.0] * nq
        rows_redist = [0] * nq
        dec_overhead = [0.0] * nq
        num_ticks = np.zeros(nq, np.int64)
        remaining_arrivals = [sum(len(s) for s in t.streams) for t in tenants]
        total_remaining = sum(remaining_arrivals)
        rows_total = [
            sum(b.num_rows for s in t.streams for b in s) for t in tenants
        ]
        # Lineage tracing (observational only — see __init__): per-tenant
        # final-worker arrays, written where routing fixes a row's home.
        # Preemption re-parks rows to their ORIGINAL worker, so a row's
        # placement never changes after its batch is routed.
        trace: Optional[List[Optional[np.ndarray]]] = None
        if self.trace_placement:
            trace = [None] * nq
            self.last_placement = trace
        rows_completed = [0] * nq
        last_done = [t.arrival for t in tenants]
        # tenant_active(q), maintained incrementally: flips False exactly
        # once — at the _DONE event completing the tenant's last row
        # after its arrivals are exhausted, or at the tenant's last
        # arrival when there is no row left to complete (zero-row
        # batches), matching the old live recomputation at both
        # observation points.
        active_flag = [
            remaining_arrivals[q] > 0 or rows_completed[q] < rows_total[q]
            for q in range(nq)
        ]
        for q, slot in member_slot.items():
            grp_active[slot[0]][slot[1]] = active_flag[q]
        # Closed-form drain: once every arrival has been routed, nothing
        # a state machine does can change the result (routing is the only
        # consumer of distribute masks / cost estimates), so the heap can
        # be exited and each worker finished by prefix sums.  Gated on
        # every policy CLASS declaring itself drain-safe (state changes
        # only inside `route`) — a policy that mutates observable state
        # on another trigger forces the heap to run to exhaustion.
        # ---- Fault layer gate (inert with no schedule) ---------------- #
        # With ``faults=None`` or an empty schedule, ``faults_on`` is
        # False: no FAIL/HBEAT event is ever pushed and every fault
        # branch below is dead, so the trajectory is bit-identical to a
        # pre-fault-layer run (the legacy rtol-1e-9 pin and the policy
        # digest pins stay green).
        faults_on = self.faults is not None and len(self.faults.events) > 0
        fcfg: Optional[FaultConfig] = None
        if faults_on:
            fcfg = (
                self.fault_cfg if self.fault_cfg is not None
                else default_sim_fault_config()
            )
        # Faults disable the closed-form drain: a crash after the last
        # arrival invalidates the prefix-sum finish.
        drain_on = self.closed_form_drain is not False and not faults_on \
            and all(cls.drain_safe for cls in pol_cls)
        drained = False
        # Event telemetry (self.last_event_counts).
        tick_n = gtick_n = arrival_n = admitted_n = enq_n = done_n = 0
        resize_n = 0
        arrival_runs = arrivals_in_runs = enq_coalesced = 0
        wf_calls = wf_rows = 0
        drained_events = drained_chunks = drained_ticks = 0

        planner: Optional[FairShareAdmission] = None
        dl_planner: Optional[DeadlineAwareAdmission] = None
        parked: List[Deque[Tuple[int, int]]] = [deque() for _ in range(nq)]
        if self.fair_share is not None and nq > 0:
            if self.deadline_aware:
                planner = dl_planner = DeadlineAwareAdmission(
                    [t.weight for t in tenants],
                    [t.slo_target for t in tenants],
                    self.fair_share,
                    self.deadline_cfg or DeadlineConfig(),
                )
            else:
                planner = FairShareAdmission(
                    [t.weight for t in tenants], self.fair_share
                )
        # ---- SLO layer state (inert with the default flags) ----------- #
        # Absolute per-tenant deadlines (inf = no SLO target).
        deadlines = [
            t.arrival + t.slo_target if t.slo_target is not None
            else float("inf")
            for t in tenants
        ]
        # Preemption re-parks ring rows (worker, costs) per victim; they
        # re-enter through fair share in `release_parked` and return to
        # the SAME worker (their transfer was already paid, so only the
        # rows lane is re-charged).
        preempt_on = self.preemption and dl_planner is not None and nq > 1
        preempt_parked: List[Deque[Tuple[int, np.ndarray]]] = [
            deque() for _ in range(nq)
        ]
        preempt_pending = 0           # re-parked rows not yet re-injected
        parked_rows_total = 0         # rows in fair-share-parked batches
        preempted_rows = [0] * nq     # per-tenant telemetry
        slo_done = slo_met = 0        # running attainment (autoscale input)
        # Autoscale: the active pool is a prefix-biased subset of the
        # physical workers; inactive workers drain their queues but
        # receive no new rows (waterfill sees them as +inf backlog).
        autoscale_on = self.autoscale is not None
        as_policy: Optional[AutoscalePolicy] = None
        worker_active = [True] * n
        active_count = n
        if autoscale_on:
            floor_w = max(self.autoscale.min_workers, 1)
            if faults_on:
                # Autoscale × failure guard: the commissioned pool may
                # never be targeted below the fault layer's min_hosts
                # (the _RESIZE handler additionally refuses to shrink
                # the LIVE pool below it, and to decommission a worker
                # that recovery traffic is in flight to).
                floor_w = max(floor_w, fcfg.min_hosts)
            as_cfg = dataclasses.replace(
                self.autoscale,
                min_workers=min(floor_w, n),
                max_workers=min(self.autoscale.max_workers, n),
            )
            as_policy = AutoscalePolicy(as_cfg)
            active_count = as_cfg.min_workers
            for w in range(active_count, n):
                worker_active[w] = False
        worker_active_np = np.asarray(worker_active)
        active_ids = np.flatnonzero(worker_active_np)
        # Idle census restricted to the ACTIVE pool (the density guard's
        # sibling signal under autoscale) — maintained incrementally at
        # the same flip points as the global census, never scanned.
        active_idle_count = active_count
        self.last_resizes = []

        # ---- Fault-layer state (all inert when ``faults_on`` False) --- #
        # Ground truth vs detection: ``worker_alive`` is physics (a dead
        # interpreter serves nothing and its in-flight chunk is void);
        # ``routable`` is what routing SEES — it flips at detection (the
        # heartbeat/idle-time path), at a spot notice, or at straggler
        # exclusion, never at the failure instant itself (no oracle).
        worker_alive = [True] * n
        routable = [True] * n
        detected = [False] * n      # dead AND noticed (recovery ran)
        excluded_str = [False] * n  # excluded as straggler (still alive)
        speed_factor = [1.0] * n
        nic_factor = [1.0] * c.num_nodes
        # Generation counter: bumped when a worker dies so the _DONE its
        # in-flight chunk already scheduled is recognized as a ghost.
        worker_gen = [0] * n
        # (service_start, costs, qids) of each worker's in-flight chunk —
        # the rows a crash voids (recovered via re-execution, charged).
        inflight: List[Optional[Tuple[float, np.ndarray,
                                      Optional[np.ndarray]]]] = [None] * n
        # Rows that died with a not-yet-detected worker, per worker:
        # (tenant, costs) stashes awaiting detection or early rejoin.
        dead_rows: List[List[Tuple[int, np.ndarray]]] = [
            [] for _ in range(n)
        ]
        # Recovery lane: per-tenant queues of cost arrays pulled off dead
        # /draining workers, re-admitted through fair share (charged).
        fault_parked: List[Deque[np.ndarray]] = [deque() for _ in range(nq)]
        fault_pending = 0
        recovered_rows = [0] * nq    # ring-resident rows re-routed
        reexecuted_rows = [0] * nq   # in-flight rows lost + re-executed
        migrated_rows = [0] * nq     # straggler-drain migrations
        wasted_service = 0.0         # partial service voided by deaths
        transfer_retries = 0
        retry_backoff_total = 0.0
        retry_attempts = [0] * n     # per failed DESTINATION (backoff)
        recovery_until = [0.0] * n   # recovery traffic in flight until t
        shrink_blocked = 0           # satellite-1 guard trips (telemetry)
        hb_busy = [0.0] * n          # service seconds since last HBEAT
        hb_rows = [0] * n            # rows completed since last HBEAT
        detections = straggler_excl = ghost_dones = 0
        fail_n = notice_n = recover_n = hbeat_n = 0
        mesh_log: List[Tuple[float, Tuple[int, int]]] = []
        rt: Optional[FaultTolerantRuntime] = None
        if faults_on:
            rt = FaultTolerantRuntime(n, fcfg, self.device)
        fs_retry_base = self.faults.retry_base if faults_on else 1e-3
        fs_retry_cap = self.faults.retry_cap if faults_on else 1e-3
        # Composed routing view: routable ∧ commissioned.  Only consulted
        # when faults_on (policy closures hand it out late-bound).
        routable_np = np.asarray(routable)
        eligible_np = worker_active_np
        eligible_ids = active_ids

        def refresh_eligible() -> None:
            nonlocal routable_np, eligible_np, eligible_ids
            routable_np = np.asarray(routable)
            eligible_np = routable_np & worker_active_np
            ids = np.flatnonzero(eligible_np)
            if not len(ids):
                # Degenerate case (every commissioned worker is dead or
                # draining): fall back to the commissioned pool — the
                # transfers bounce with backoff until someone recovers.
                eligible_np = worker_active_np
                ids = np.flatnonzero(eligible_np)
            eligible_ids = ids

        events: List[Tuple[float, int, int, int, int, object]] = []
        seq = 0

        def push(t: float, kind: int, qid: int, who: int, payload: object):
            nonlocal seq
            heappush(events, (t, seq, kind, qid, who, payload))
            seq += 1

        for g, (_, _, _, origin) in enumerate(groups):
            # Grid tick first (lowest seq) so eager links distribute from
            # row one for members arriving at the grid origin.
            push(origin, _GTICK, g, 0, None)
        for q, t in enumerate(tenants):
            # Tick first (lower seq) so eager links distribute from row one.
            if links[q] is not None:
                push(t.arrival, _TICK, q, 0, None)
            elif q in group_of:
                g = group_of[q]
                if t.arrival > groups[g][3]:
                    # Off-grid arrival: one-off masked join tick so this
                    # tenant's eager link engages at arrival instead of
                    # waiting for the next shared grid point.
                    push(t.arrival, _GTICK, g, 0, q)
            for p, stream in enumerate(t.streams):
                if stream:
                    push(t.arrival, _ARRIVAL, q, p, 0)
        if autoscale_on and tenants:
            # First decision at the earliest arrival; the chain then
            # recurs every `interval` while any tenant is active.
            push(min(t.arrival for t in tenants), _RESIZE, 0, 0, None)
        if faults_on and tenants:
            # The whole schedule is data, pushed up front: the loop never
            # draws a fault, so same schedule ⇒ same trajectory.
            for fe in self.faults.events:
                if fe.kind == PREEMPT:
                    push(fe.time, _PREEMPT_NOTICE, 0, fe.worker, fe)
                else:
                    push(fe.time, _FAIL, 0, fe.worker, fe)
            # Heartbeat chain (detection cadence); recurs while any
            # tenant is active or recovery rows are pending.
            push(
                min(t.arrival for t in tenants) + fcfg.heartbeat_interval,
                _HBEAT, 0, 0, None,
            )

        def start_worker(w: int, now: float):
            if worker_running[w]:
                return
            if faults_on and not worker_alive[w]:
                # A dead worker's ring freezes where it stands; recovery
                # (detection or early rejoin) decides what happens to it.
                return
            ring = rings[w]
            if ring.tail == ring.head:
                return
            chunk, qids = ring.pop(_SERVICE_CHUNK)
            # Sequential Python-float sum: bit-identical to the legacy
            # engine's per-tuple accumulation, so the engines stay on the
            # same event trajectory (tiny rounding differences amplify
            # chaotically through routing decisions).
            total = sum(chunk.tolist())
            if qids is None:
                counts = totals = None
            else:
                counts = np.bincount(qids, minlength=nq)
                # bincount accumulates weights in index order — the same
                # sequential float additions as the single-tenant sum.
                totals = np.bincount(qids, weights=chunk, minlength=nq)
            if faults_on:
                fac = speed_factor[w]
                if fac != 1.0:
                    # Transient slowdown: the chunk serves fac× slower;
                    # the stretch is billed as real busy time (it is
                    # spend) and is what the sync-slope detector sees.
                    total = total * fac
                    if totals is not None:
                        totals = totals * fac
                # pop() hands out views into the ring buffer; the stash
                # must survive later pushes (compaction), so copy.
                inflight[w] = (
                    now, chunk.copy(),
                    None if qids is None else qids.copy(),
                )
                payload = (total, len(chunk), counts, totals, worker_gen[w])
            else:
                payload = (total, len(chunk), counts, totals)
            worker_running[w] = True
            push(now + total, _DONE, 0, w, payload)

        def siblings_idle_frac(p: int) -> float:
            # Incremental census: same value the O(n) scan produced.
            if autoscale_on:
                # Decommissioned-but-draining workers must not count as
                # idle siblings (they are not eligible destinations).
                idle = active_idle_count - (
                    1 if worker_active[p] and worker_idle[p] else 0
                )
                return idle / max(
                    active_count - (1 if worker_active[p] else 0), 1
                )
            idle = idle_count - (1 if worker_idle[p] else 0)
            return idle / max(n - 1, 1)

        # One policy instance per tenant, observing the live engine state
        # through `PolicyContext` closures (est_row_cost / outstanding /
        # autoscale masks are run() locals that get REASSIGNED, so the
        # views must read them late).  The per-batch guard pipeline —
        # density guard, backlog masking, cost gate — lives on the policy
        # (`RedistributionPolicy`, one copy), consulted by both the
        # scalar `route_batch` path and the coalesced run's phase-1
        # planner, so guard ordering and gate inputs cannot drift.  Each
        # tenant gets an independent child RNG stream of the simulator
        # seed; the deterministic built-ins never consult it, preserving
        # the no-RNG-in-the-loop invariant.

        def _make_policy(q: int) -> RedistributionPolicy:
            ctx = PolicyContext(
                num_workers=n,
                rng=np.random.default_rng([self.seed, q]),
                node_of=c.node_of,
                network_bandwidth=net_bw,
                per_row_serialize=ser,
                est_row_cost=lambda: est_row_cost[q],
                outstanding=lambda: outstanding[q],
                idle_sibling_frac=siblings_idle_frac,
                # Under faults the composed view (commissioned ∧ routable)
                # replaces the plain autoscale mask, so every mask-aware
                # policy routes around dead/draining workers for free.
                active_mask=(
                    (lambda: eligible_np) if faults_on
                    else (lambda: worker_active_np) if autoscale_on
                    else (lambda: None)
                ),
                active_ids=(
                    (lambda: eligible_ids) if faults_on
                    else (lambda: active_ids) if autoscale_on
                    else (lambda: None)
                ),
                live_mask=(
                    (lambda: routable_np) if faults_on
                    else (lambda: None)
                ),
            )
            return strategies[q].make_policy(ctx)

        policies = [_make_policy(q) for q in range(nq)]

        def route_batch(
            q: int, p: int, b: Batch, now: float,
            dests_pre: object = _RB_INLINE,
            emit: Optional[Callable] = None,
        ) -> None:
            """Route one batch at virtual time ``now``.

            ``dests_pre`` is either the `_RB_INLINE` sentinel (compute the
            destinations here — the scalar path) or a precomputed plan
            from a coalesced same-time arrival run (None = keep local, an
            array = the batched-waterfill destinations, guards already
            applied).  ``emit`` redirects the _ENQUEUE pushes into the
            run's coalescing buffer instead of the heap.
            """
            out_q = outstanding[q]
            if dests_pre is not _RB_INLINE:
                dests = dests_pre
            else:
                # The policy seam: per-row destinations or None (keep
                # local).  The base `RedistributionPolicy.route` wraps
                # the proposal with the shared guard pipeline (density
                # guard → proposal over the masked backlog → cost gate).
                dests = policies[q].route(p, b, now)

            if dests is None and faults_on and not (
                routable[p] and worker_active[p]
            ):
                # Dead/draining/excluded (or decommissioned) producer:
                # its scan re-targets the least-backlogged ELIGIBLE
                # worker — one grouped transfer, priced like any
                # redistribution.  Subsumes the autoscale redirect below
                # when the fault layer is active.
                d = int(eligible_ids[
                    int(np.argmin(np.asarray(out_q)[eligible_ids]))
                ])
                dests = np.full(b.num_rows, d, np.int64)
            elif dests is None and autoscale_on and not worker_active[p]:
                # Decommissioned producer worker: its scan re-targets the
                # least-backlogged active worker (one grouped transfer, so
                # the IPC/NIC cost below is priced like any redistribution).
                d = int(active_ids[
                    int(np.argmin(np.asarray(out_q)[active_ids]))
                ])
                dests = np.full(b.num_rows, d, np.int64)

            if trace is not None and b.ids is not None:
                tr = trace[q]
                if tr is None:
                    tr = trace[q] = np.full(rows_total[q], -1, np.int64)
                tr[b.ids] = p if dests is None else dests

            if dests is None:
                # All-local fast path (no redistribution this batch):
                # in-process pipeline, serialization delay only.
                nrows = b.num_rows
                if emit is None:
                    push(now + nrows * ser, _ENQUEUE, q, p, b.costs)
                else:
                    emit(now + nrows * ser, q, p, b.costs)
                out_q[p] += nrows
                return
            sd, starts, ends, costs_s, sizes_s = _group_by_dest(
                dests, b.costs, b.sizes
            )
            # Per-group pairwise .sum() matches the legacy masked sums
            # bit-for-bit (same elements, same order, same algorithm).
            src_node = node[p]
            for j in range(len(starts)):
                lo, hi = starts[j], ends[j]
                d = int(sd[lo])
                nrows = hi - lo
                nbytes = float(sizes_s[lo:hi].sum())
                if node[d] != src_node:
                    rows_redist[q] += nrows
                    bytes_moved[q] += nbytes
                    if contention:
                        # Serialize on the source node's uplink.
                        nf = nic_free_at[src_node]
                        start = now if now > nf else nf
                        occupy = nbytes / net_bw
                        if faults_on and nic_factor[src_node] != 1.0:
                            # Degraded uplink: occupancy stretches.
                            occupy = occupy * nic_factor[src_node]
                        nic_free_at[src_node] = start + occupy
                        arrive = start + occupy + net_lat + nrows * ser
                    else:
                        bw_t = nbytes / net_bw
                        if faults_on and nic_factor[src_node] != 1.0:
                            bw_t = bw_t * nic_factor[src_node]
                        arrive = now + net_lat + bw_t + nrows * ser
                elif d == p:
                    arrive = now + nrows * ser
                else:
                    rows_redist[q] += nrows
                    arrive = now + ipc_lat + nbytes / ipc_bw + nrows * ser
                if emit is None:
                    push(arrive, _ENQUEUE, q, d, costs_s[lo:hi])
                else:
                    emit(arrive, q, d, costs_s[lo:hi])
                out_q[d] += nrows

        def try_admit(q: int, rows: int, nbytes: float, bpr: float,
                      now: float) -> bool:
            """The one planner-admission call: plain fair share, or the
            deadline-aware variant fed the tenant's absolute deadline."""
            if dl_planner is None:
                return planner.try_admit(q, rows, nbytes, bpr)
            return dl_planner.try_admit(
                q, rows, nbytes, bpr, deadline=deadlines[q], now=now
            )

        def preempt_for(uq: int, need: int, now: float) -> bool:
            """Displace up to ``need`` admitted-but-unstarted rows of
            over-share tenants (never ones at least as urgent as ``uq``)
            out of the worker rings, re-parking them for fair-share
            re-injection; the planner advances ``uq``'s credit by the
            freed amount.  Returns True if anything was preempted."""
            nonlocal preempt_pending, idle_count, active_idle_count
            freed = 0
            for victim, excess in dl_planner.preempt_candidates(
                protect=(uq,)
            ):
                if deadlines[victim] <= deadlines[uq]:
                    continue
                want = int(min(excess, need - freed))
                for w in range(n):
                    if want <= 0:
                        break
                    costs = rings[w].extract(victim, want)
                    kk = len(costs)
                    if not kk:
                        continue
                    want -= kk
                    freed += kk
                    left = outstanding[victim][w] - kk
                    outstanding[victim][w] = left if left > 0.0 else 0.0
                    preempt_parked[victim].append((w, costs))
                    preempt_pending += kk
                    preempted_rows[victim] += kk
                    dl_planner.preempt_transfer(victim, uq, kk)
                    if (
                        not worker_running[w] and not worker_idle[w]
                        and rings[w].tail == rings[w].head
                    ):
                        worker_idle[w] = True
                        idle_count += 1
                        if autoscale_on and worker_active[w]:
                            active_idle_count += 1
                if freed >= need:
                    break
            return freed > 0

        def fair_share_parks(kind: int, q: int, p: int, k: int,
                             b: Batch, now: float) -> bool:
            """Fair-share gate at an _ARRIVAL (re-offered _ADMITTED work
            was already charged): True → the batch was parked.  The ONE
            copy of the park-or-admit policy — both the singleton path
            and the coalesced-run path go through it."""
            nonlocal parked_rows_total
            if planner is None or kind != _ARRIVAL:
                return False
            bpr = b.total_bytes / max(b.num_rows, 1)
            if try_admit(q, b.num_rows, b.total_bytes, bpr, now):
                return False
            if (
                preempt_on
                # Urgency gate (same policy as the serving engine): only
                # a tenant whose slack has run inside the horizon may
                # displace others' work — and only when the admission
                # WOULD succeed given the credit a full preemption could
                # transfer (dry-run probe; displacing victims for a
                # doomed retry would delay them for nothing).
                and deadlines[q] - now < dl_planner.dcfg.urgency_horizon
                and dl_planner.would_admit(
                    q, b.num_rows, b.total_bytes, bpr,
                    deadline=deadlines[q], now=now,
                    rows_advance=float(b.num_rows),
                )
                and preempt_for(q, b.num_rows, now)
                and try_admit(q, b.num_rows, b.total_bytes, bpr, now)
            ):
                return False
            parked[q].append((p, k))
            parked_rows_total += b.num_rows
            return True

        def handle_arrival(
            kind: int, q: int, p: int, k: int, now: float,
            dests_pre: object = _RB_INLINE,
            emit: Optional[Callable] = None,
        ) -> bool:
            """The _ARRIVAL/_ADMITTED bookkeeping around `route_batch`.
            Returns False when the batch was parked by fair share."""
            nonlocal total_remaining
            st = strategies[q]
            b = streams[q][p][k]
            if fair_share_parks(kind, q, p, k, b, now):
                return False
            remaining_arrivals[q] -= 1
            total_remaining -= 1
            # The last arrival can retire a tenant whose rows are already
            # all complete (zero-row batches) — without this check its
            # tick chain would reschedule forever.
            tenant_done_check(q)
            rows_arr_in_tick[q][p] += b.num_rows
            batches_arr_in_tick[q][p] += 1
            bytes_arr_in_tick[q][p] += b.total_bytes
            if pays_overhead[q]:
                dec_overhead[q] += st.decision_overhead
                now += st.decision_overhead
            route_batch(q, p, b, now, dests_pre, emit)
            if k + 1 < len(streams[q][p]):
                # Flow control: pace against the least-backlogged valid
                # destination (own consumer when routing locally).
                if policies[q].paces_spread(p):
                    if faults_on:
                        # Dead/draining workers' frozen backlogs must not
                        # release the window (pace on eligible only).
                        bl = min(outstanding[q][w] for w in eligible_ids)
                    elif autoscale_on:
                        bl = min(outstanding[q][w] for w in active_ids)
                    else:
                        bl = min(outstanding[q])
                else:
                    bl = outstanding[q][p]
                backpressure = max(0.0, bl - flow_window) * est_row_cost[q]
                push(now + tenants[q].arrival_gap + backpressure,
                     _ARRIVAL, q, p, k + 1)
            return True

        def route_arrival_run(now: float, run_ev: List[Tuple]) -> None:
            """Route a maximal run of same-instant arrival events.

            The run is routed through ONE batched waterfill per cascade
            level: same-instant batches of DIFFERENT tenants are provably
            independent (backlog, cost estimate and masks are per-tenant,
            and nothing that routing mutates is read by another tenant's
            waterfill), while consecutive batches of the SAME tenant
            cascade through its own `outstanding` backlog and therefore
            form sequential levels.  Every side effect (fair-share
            admission, NIC occupancy, ring pushes, flow-control pacing)
            is applied strictly in heap pop order, so the trajectory is
            bit-identical to routing the events one at a time.

            Tie caveat (same class as the drain's documented tick tie):
            the buffered _ENQUEUE events are pushed after the run's
            flow-control _ARRIVAL pushes, so their heap seqs trail
            those arrivals'.  Seq order is only observable when two
            event timestamps are EXACTLY equal in float — here a
            ``now + gap + backpressure`` arrival colliding with a
            ``now + nrows*ser``-style delivery, quantities with no
            algebraic relation — which no generic workload produces.
            """
            nonlocal wf_calls, wf_rows, enq_coalesced
            # Phase 0 (pop order): fair-share admission; park or admit.
            admitted: List[Tuple[int, int, int, int, Batch]] = []
            for kind_e, q, p, k in run_ev:
                b = streams[q][p][k]
                if not fair_share_parks(kind_e, q, p, k, b, now):
                    admitted.append((kind_e, q, p, k, b))
            if not admitted:
                return
            # Phase 1: precompute every dyskew batch's routing plan.
            # plans[i] is _RB_INLINE (none/static_rr — computed inline in
            # pop order), None (stays local) or the waterfill dests.
            plans: List[object] = [_RB_INLINE] * len(admitted)
            chains: Dict[int, List[int]] = {}
            for i, (_, q, p, k, b) in enumerate(admitted):
                # Only policies whose proposal IS a waterfill over
                # `spread_backlog` (class flag) may be planned through
                # the batched call; everything else routes inline in pop
                # order, which is always correct.
                if batched_wf[q]:
                    chains.setdefault(q, []).append(i)
            shadow = {
                q: np.asarray(outstanding[q], np.float64) for q in chains
            }
            cursor = {q: 0 for q in chains}
            while chains:
                level: List[int] = []
                for q in list(chains):
                    lst = chains[q]
                    cur = cursor[q]
                    while cur < len(lst):
                        i = lst[cur]
                        _, _, p, k, b = admitted[i]
                        if policies[q].wants_spread(p, b):
                            break  # needs a waterfill at this level
                        plans[i] = None
                        shadow[q][p] += b.num_rows
                        cur += 1
                    if cur >= len(lst):
                        del chains[q]
                        continue
                    level.append(lst[cur])
                    cursor[q] = cur + 1
                if not level:
                    continue
                bls = np.empty((len(level), n))
                ks = np.empty(len(level), np.int64)
                units = np.empty(len(level))
                for r, i in enumerate(level):
                    _, q, p, k, b = admitted[i]
                    bls[r] = policies[q].spread_backlog(p, shadow[q])
                    ks[r] = b.num_rows
                    units[r] = policies[q].spread_unit()
                counts_lvl = waterfill_counts_many(bls, ks, units)
                wf_calls += 1
                wf_rows += len(level)
                for r, i in enumerate(level):
                    _, q, p, k, b = admitted[i]
                    counts = counts_lvl[r]
                    dests = np.repeat(np.arange(n), counts)
                    if not policies[q].admits(p, b, dests):
                        plans[i] = None
                        shadow[q][p] += b.num_rows
                        continue
                    plans[i] = dests
                    shadow[q] += counts
            # Phase 2 (pop order): apply everything — admission already
            # done in phase 0, so pass kind=_ADMITTED to skip it — with
            # same-(time, destination) _ENQUEUE pushes coalesced into one
            # heap event carrying the concatenated segments.
            pending_enq: Dict[Tuple[float, int], List] = {}

            def emit(t: float, q: int, d: int, seg: np.ndarray) -> None:
                lst = pending_enq.get((t, d))
                if lst is None:
                    pending_enq[(t, d)] = [(q, seg)]
                else:
                    lst.append((q, seg))

            for i, (_, q, p, k, b) in enumerate(admitted):
                handle_arrival(_ADMITTED, q, p, k, now, plans[i], emit)
            # dyslint: disable=DY402 -- insertion order IS heap pop order (pinned by the coalesced-run contract); the accumulator is an integer event counter
            for (t, d), segs in pending_enq.items():
                if len(segs) == 1:
                    q, seg = segs[0]
                    push(t, _ENQUEUE, q, d, seg)
                else:
                    push(t, _ENQUEUE, -1, d, segs)
                    enq_coalesced += len(segs) - 1

        def release_parked(now: float) -> None:
            """Re-offer parked arrivals after new credit (round-robin
            order; EDF-first under the deadline-aware planner).
            Preemption-parked rows are re-offered ahead of a tenant's
            parked batches — they already paid their transfer and return
            straight to their original worker's ring."""
            nonlocal preempt_pending, parked_rows_total
            progress = True
            while progress:
                progress = False
                for q in planner.release_order():
                    pq = preempt_parked[q]
                    while pq:
                        w, costs = pq[0]
                        if not try_admit(q, len(costs), 0.0, 0.0, now):
                            break
                        pq.popleft()
                        preempt_pending -= len(costs)
                        outstanding[q][w] += len(costs)
                        push(now, _ENQUEUE, q, w, costs)
                        progress = True
                    dq = parked[q]
                    if not dq:
                        continue
                    p, k = dq[0]
                    b = streams[q][p][k]
                    bpr = b.total_bytes / max(b.num_rows, 1)
                    if try_admit(q, b.num_rows, b.total_bytes, bpr, now):
                        dq.popleft()
                        parked_rows_total -= b.num_rows
                        push(now, _ADMITTED, q, p, k)
                        progress = True

        def tenant_done_check(q: int) -> None:
            """Flip the incrementally-maintained tenant_active flag (and
            its group mirror) when the tenant's last row completes."""
            nonlocal slo_done, slo_met
            if (
                active_flag[q]
                and remaining_arrivals[q] == 0
                and rows_completed[q] >= rows_total[q]
            ):
                active_flag[q] = False
                slot = member_slot.get(q)
                if slot is not None:
                    grp_active[slot[0]][slot[1]] = False
                if tenants[q].slo_target is not None:
                    # Running attainment — the autoscaler's SLO signal.
                    slo_done += 1
                    if last_done[q] <= deadlines[q]:
                        slo_met += 1

        # ---- Fault-layer recovery helpers (faults_on only) ------------ #

        def park_recovery(q: int, costs: np.ndarray,
                          bucket: List[int]) -> None:
            nonlocal fault_pending
            k = len(costs)
            if not k:
                return
            fault_parked[q].append(costs)
            fault_pending += k
            bucket[q] += k

        def drain_ring(w: int, bucket: List[int], refund: bool) -> None:
            """Pull every queued row off worker ``w``'s ring into the
            recovery lane.  The ring IS the row-level lineage here: its
            FIFO segments are exactly the rows the lineage lane last
            placed on ``w`` (per-row tenant ids in the qid lane), so
            recovery re-reads them instead of re-running the query.  The
            producer-visible backlog rolls back and the planner retires
            the rows from its in-service ledger (``on_lost``; refunded
            only when the SYSTEM displaced them — straggler migration)."""
            ring = rings[w]
            if ring.tail == ring.head:
                return
            costs = ring.buf[ring.head:ring.tail].copy()
            qarr = (
                ring.qbuf[ring.head:ring.tail].copy()
                if ring.qbuf is not None else None
            )
            ring.head = ring.tail
            if qarr is None:
                groups_r = ((0, costs),)
            else:
                groups_r = tuple(
                    (int(q2), costs[qarr == q2]) for q2 in np.unique(qarr)
                )
            for q2, cq in groups_r:
                kk = len(cq)
                left = outstanding[q2][w] - kk
                outstanding[q2][w] = left if left > 0.0 else 0.0
                if planner is not None:
                    planner.on_lost(q2, kk, refund=refund)
                park_recovery(q2, cq, bucket)

        def void_dead_rows(w: int) -> None:
            """Recover the stashes that died with worker ``w`` (its lost
            in-flight chunk): retire from the ledger WITHOUT refund — the
            spend happened — and park for charged re-execution."""
            for q2, cq in dead_rows[w]:
                kk = len(cq)
                left = outstanding[q2][w] - kk
                outstanding[q2][w] = left if left > 0.0 else 0.0
                if planner is not None:
                    planner.on_lost(q2, kk, refund=False)
                park_recovery(q2, cq, reexecuted_rows)
            dead_rows[w].clear()

        def inject_recovered(now: float) -> None:
            """Re-admit fault-parked rows through fair share — charged,
            not free (the retry debt) — and route each granted segment to
            the least-backlogged eligible worker, paying the lineage
            re-fetch as a normal transfer."""
            nonlocal fault_pending
            progress = True
            while progress and fault_pending:
                progress = False
                order = (
                    planner.release_order() if planner is not None
                    else range(nq)
                )
                for q in order:
                    fq = fault_parked[q]
                    while fq:
                        costs = fq[0]
                        kk = len(costs)
                        if planner is not None and not planner.try_readmit(
                            q, kk, deadline=deadlines[q], now=now
                        ):
                            break
                        fq.popleft()
                        fault_pending -= kk
                        d = int(eligible_ids[int(np.argmin(
                            np.asarray(outstanding[q])[eligible_ids]
                        ))])
                        outstanding[q][d] += kk
                        arrive = now + net_lat + kk * ser
                        if arrive > recovery_until[d]:
                            # Satellite-1 guard input: autoscale must not
                            # decommission ``d`` while this is in flight.
                            recovery_until[d] = arrive
                        push(arrive, _ENQUEUE, q, d, costs)
                        progress = True

        def census_idle_if_empty(w: int) -> None:
            """Restore the idle-census invariant for ``w`` after a
            recovery/migration emptied its ring (a dead worker is never
            counted idle; see the _FAIL handler)."""
            nonlocal idle_count, active_idle_count
            if (
                not worker_running[w] and not worker_idle[w]
                and rings[w].tail == rings[w].head
            ):
                worker_idle[w] = True
                idle_count += 1
                if autoscale_on and worker_active[w]:
                    active_idle_count += 1

        def detect_dead(w: int, now: float) -> None:
            """The detection moment for a dead worker: exclude it from
            routing, drain its frozen ring and its voided in-flight rows
            through the recovery lane, remesh the survivors."""
            nonlocal detections
            detected[w] = True
            routable[w] = False
            detections += 1
            rt.exclude([w])
            mesh_log.append((now, rt.mesh_shape()))
            refresh_eligible()
            drain_ring(w, recovered_rows, refund=False)
            void_dead_rows(w)
            inject_recovered(now)

        now = 0.0
        while events:
            now, _, kind, qid, who, payload = heappop(events)
            if kind == _ENQUEUE:
                enq_n += 1
                w = who
                # A coalesced event replays each segment's push and the
                # worker-start check it would have performed as its own
                # heap event — identical trajectory, one pop; a classic
                # event is the one-segment case of the same body.
                segs = payload if type(payload) is list else ((qid, payload),)
                if faults_on and not routable[w]:
                    # Transfer landed on a dead/draining/excluded
                    # destination: the sender retries against the
                    # least-backlogged eligible worker after a capped
                    # exponential backoff (attempts per failed dest).
                    att = retry_attempts[w]
                    retry_attempts[w] = att + 1
                    delay = min(
                        fs_retry_base * (2.0 ** min(att, 20)),
                        fs_retry_cap,
                    )
                    for q, seg in segs:
                        kk = len(seg)
                        if not kk:
                            continue
                        d = int(eligible_ids[int(np.argmin(
                            np.asarray(outstanding[q])[eligible_ids]
                        ))])
                        left = outstanding[q][w] - kk
                        outstanding[q][w] = left if left > 0.0 else 0.0
                        outstanding[q][d] += kk
                        transfer_retries += 1
                        retry_backoff_total += delay
                        push(now + delay, _ENQUEUE, q, d, seg)
                    continue
                for q, seg in segs:
                    # A zero-row segment leaves (ring, running) — and
                    # hence idleness — unchanged.
                    if len(seg) and worker_idle[w]:
                        worker_idle[w] = False
                        idle_count -= 1
                        if autoscale_on and worker_active[w]:
                            active_idle_count -= 1
                    rings[w].push(seg, qid=q)
                    recv_in_tick[q][w] += len(seg)
                    if not worker_running[w]:
                        start_worker(w, now)
            elif kind == _DONE:
                w = who
                if faults_on:
                    total, nrows, counts, totals, gen = payload
                    if gen != worker_gen[w]:
                        # Ghost completion: the chunk died with its
                        # worker before this _DONE fired.  Nothing is
                        # billed — the rows recover via the dead-row
                        # stash, never here.
                        ghost_dones += 1
                        continue
                    inflight[w] = None
                    hb_busy[w] += total
                    hb_rows[w] += nrows
                else:
                    total, nrows, counts, totals = payload
                done_n += 1
                if counts is None:
                    # N=1 specialization: no per-tenant split needed.
                    busy[0][w] += total
                    rows_done[0][w] += nrows
                    sync_in_tick[0][w] += total
                    avg = total / nrows if nrows else 0.0
                    ema = strategies[0].cost_ema
                    est_row_cost[0] = (1 - ema) * est_row_cost[0] + ema * avg
                    left = outstanding[0][w] - nrows
                    outstanding[0][w] = left if left > 0.0 else 0.0
                    rows_completed[0] += nrows
                    last_done[0] = now
                    tenant_done_check(0)
                    done_tenants = ((0, nrows),)
                else:
                    done_tenants = []
                    for q in np.flatnonzero(counts):
                        q = int(q)
                        cnt, tot = int(counts[q]), float(totals[q])
                        busy[q][w] += tot
                        rows_done[q][w] += cnt
                        sync_in_tick[q][w] += tot
                        avg = tot / cnt
                        ema = strategies[q].cost_ema
                        est_row_cost[q] = (
                            (1 - ema) * est_row_cost[q] + ema * avg
                        )
                        left = outstanding[q][w] - cnt
                        outstanding[q][w] = left if left > 0.0 else 0.0
                        rows_completed[q] += cnt
                        last_done[q] = now
                        tenant_done_check(q)
                        done_tenants.append((q, cnt))
                worker_running[w] = False
                start_worker(w, now)
                if not worker_running[w]:
                    worker_idle[w] = True
                    idle_count += 1
                    if autoscale_on and worker_active[w]:
                        active_idle_count += 1
                if planner is not None:
                    for q, cnt in done_tenants:
                        planner.on_complete(q, cnt)
                        if not active_flag[q]:
                            planner.deactivate(q)
                    if faults_on and fault_pending:
                        # Fresh credit: recovery rows re-enter ahead of
                        # parked batches (they were already in service).
                        inject_recovered(now)
                    release_parked(now)
                elif faults_on and fault_pending:
                    inject_recovered(now)
            elif kind == _ARRIVAL or kind == _ADMITTED:
                # Under autoscale (and under faults, same reason with the
                # dead-producer redirect), arrivals route strictly one at
                # a time: the coalesced run's phase-1 shadow cannot see
                # the decommissioned-producer redirect (it credits
                # kept-local rows to the inactive worker), so the batched
                # plan would diverge from pop-order routing.
                if not autoscale_on and not faults_on and events and \
                        events[0][0] == now and (
                    events[0][2] in (_ARRIVAL, _ADMITTED)
                ):
                    # A maximal run of same-instant arrivals: route them
                    # through the batched waterfill path.
                    run_ev = [(kind, qid, who, payload)]
                    if kind == _ARRIVAL:
                        arrival_n += 1
                    else:
                        admitted_n += 1
                    while events and events[0][0] == now and events[0][2] in (
                        _ARRIVAL, _ADMITTED
                    ):
                        _, _, k2, q2, w2, pl2 = heappop(events)
                        run_ev.append((k2, q2, w2, pl2))
                        if k2 == _ARRIVAL:
                            arrival_n += 1
                        else:
                            admitted_n += 1
                    arrival_runs += 1
                    arrivals_in_runs += len(run_ev)
                    route_arrival_run(now, run_ev)
                else:
                    if kind == _ARRIVAL:
                        arrival_n += 1
                    else:
                        admitted_n += 1
                    handle_arrival(kind, qid, who, payload, now)
                if (
                    drain_on and total_remaining == 0
                    and preempt_pending == 0 and events
                ):
                    drained = True
                    break
            elif kind == _RESIZE:
                resize_n += 1
                if any(active_flag):
                    # Backlog = everything queued for service: ring rows,
                    # preempt-parked rows, AND fair-share-parked batches
                    # — under admission-paced overload the parked queues
                    # are the dominant backlog, and an autoscaler blind
                    # to them would never grow.  (Parked rows are an
                    # incrementally-maintained counter, like the idle
                    # census — no per-decision scan.)
                    backlog = float(
                        sum(len(r) for r in rings)
                        + preempt_pending + parked_rows_total
                    )
                    att = (slo_met / slo_done) if slo_done else None
                    target = as_policy.decide(now, active_count, backlog, att)
                    if target != active_count:
                        # (De)commission whole workers: lowest-index
                        # inactive first on grow, highest-index active
                        # first on shrink.  A decommissioned worker keeps
                        # serving its ring (graceful drain) but receives
                        # no new rows.
                        if target > active_count:
                            for w in range(n):
                                if active_count >= target:
                                    break
                                if not worker_active[w]:
                                    worker_active[w] = True
                                    active_count += 1
                                    if worker_idle[w]:
                                        active_idle_count += 1
                        else:
                            if faults_on:
                                live_active = sum(
                                    1 for w2 in range(n)
                                    if worker_active[w2]
                                    and worker_alive[w2] and routable[w2]
                                )
                            for w in range(n - 1, -1, -1):
                                if active_count <= target:
                                    break
                                if worker_active[w]:
                                    if faults_on:
                                        live_w = (
                                            worker_alive[w] and routable[w]
                                        )
                                        if now < recovery_until[w] or (
                                            live_w and
                                            live_active <= fcfg.min_hosts
                                        ):
                                            # Scale-down × failure guard:
                                            # never decommission a worker
                                            # mid-recovery (rows in
                                            # flight to it) and never
                                            # shrink the LIVE pool below
                                            # min_hosts — crashes may
                                            # have already eaten into it.
                                            shrink_blocked += 1
                                            continue
                                        if live_w:
                                            live_active -= 1
                                    worker_active[w] = False
                                    active_count -= 1
                                    if worker_idle[w]:
                                        active_idle_count -= 1
                        worker_active_np = np.asarray(worker_active)
                        active_ids = np.flatnonzero(worker_active_np)
                        if faults_on:
                            refresh_eligible()
                    push(now + as_policy.cfg.interval, _RESIZE, 0, 0, None)
            elif kind == _FAIL:
                fail_n += 1
                fe = payload
                w = who
                if fe.kind == NIC_DEGRADE:
                    # ``worker`` names a NODE for NIC events.
                    nic_factor[w] = fe.factor
                    if fe.duration < float("inf"):
                        push(now + fe.duration, _RECOVER, 0, w, fe)
                elif fe.kind == SLOWDOWN:
                    if worker_alive[w]:
                        speed_factor[w] = fe.factor
                        if fe.duration < float("inf"):
                            push(now + fe.duration, _RECOVER, 0, w, fe)
                elif worker_alive[w]:
                    # Crash, or the announced end of a spot drain: the
                    # worker is gone.  Its in-flight chunk is void (the
                    # already-scheduled _DONE becomes a ghost via the
                    # generation bump, the partial service is wasted
                    # spend) and its queue freezes until detection.
                    worker_alive[w] = False
                    if worker_running[w]:
                        t_start, chunk, qarr = inflight[w]
                        wasted_service += now - t_start
                        worker_gen[w] += 1
                        worker_running[w] = False
                        inflight[w] = None
                        if qarr is None:
                            dead_rows[w].append((0, chunk))
                        else:
                            for q2 in np.unique(qarr):
                                q2 = int(q2)
                                dead_rows[w].append((q2, chunk[qarr == q2]))
                    if worker_idle[w]:
                        # Dead ⇒ not idle: it must not count as an idle
                        # sibling nor as spare capacity.
                        worker_idle[w] = False
                        idle_count -= 1
                        if autoscale_on and worker_active[w]:
                            active_idle_count -= 1
                    if fe.kind == PREEMPT:
                        # The drain was ANNOUNCED — no heartbeat wait:
                        # whatever the instance could not finish inside
                        # the notice window recovers right now.
                        detect_dead(w, now)
                    if fe.duration < float("inf"):
                        push(now + fe.duration, _RECOVER, 0, w, fe)
            elif kind == _PREEMPT_NOTICE:
                notice_n += 1
                fe = payload
                w = who
                if worker_alive[w] and routable[w]:
                    # Spot notice: no new rows from this instant; the
                    # instance keeps draining its queue until the pull.
                    routable[w] = False
                    refresh_eligible()
                push(now + fe.notice, _FAIL, 0, w, fe)
            elif kind == _RECOVER:
                recover_n += 1
                fe = payload
                w = who
                if fe.kind == NIC_DEGRADE:
                    nic_factor[w] = 1.0
                elif fe.kind == SLOWDOWN:
                    speed_factor[w] = 1.0
                    if excluded_str[w]:
                        # The slowdown that got this worker excluded as a
                        # straggler is over: rejoin mesh and routing.
                        excluded_str[w] = False
                        routable[w] = True
                        rt.rejoin(w, now)
                        mesh_log.append((now, rt.mesh_shape()))
                        refresh_eligible()
                elif not worker_alive[w]:
                    # Replacement instance (spot rebalance / restart)
                    # takes the dead worker's slot.
                    worker_alive[w] = True
                    if not detected[w]:
                        # Back BEFORE detection: the frozen queue simply
                        # resumes, but the chunk that died still
                        # re-executes (charged — the spend happened).
                        void_dead_rows(w)
                    else:
                        detected[w] = False
                        routable[w] = True
                        rt.rejoin(w, now)
                        mesh_log.append((now, rt.mesh_shape()))
                        refresh_eligible()
                    start_worker(w, now)
                    census_idle_if_empty(w)
                    if fault_pending:
                        inject_recovered(now)
            elif kind == _HBEAT:
                hbeat_n += 1
                # Virtual-time heartbeats: live workers report their mean
                # per-row service time over the window (idle workers echo
                # the fleet mean — no signal, no skew); dead workers stay
                # silent, so the runtime's idle-time model flags them
                # after ``missed_beats_dead`` quiet windows.  Straggler
                # flags come from the N-strikes sync-slope model — THE
                # detection path; the engine never short-circuits either
                # with ground truth.
                served = [
                    w2 for w2 in range(n)
                    if worker_alive[w2] and hb_rows[w2] > 0
                ]
                fleet = (
                    sum(hb_busy[w2] / hb_rows[w2] for w2 in served)
                    / len(served) if served else 0.0
                )
                for w2 in range(n):
                    if worker_alive[w2]:
                        step = (
                            hb_busy[w2] / hb_rows[w2] if hb_rows[w2] > 0
                            else fleet
                        )
                        rt.heartbeat(w2, now, step)
                    hb_busy[w2] = 0.0
                    hb_rows[w2] = 0
                det = rt.tick(now)
                for h in det["failed"]:
                    if not worker_alive[h] and not detected[h]:
                        detect_dead(h, now)
                for h in det["stragglers"]:
                    if (
                        worker_alive[h] and routable[h]
                        and int(eligible_np.sum()) - 1 >= fcfg.min_hosts
                    ):
                        # N-strikes straggler: exclude from routing,
                        # migrate its queued (unstarted) rows.  Its
                        # in-flight chunk finishes — nothing is lost —
                        # so the planner REFUNDS the migrated rows'
                        # charge (the system chose this displacement;
                        # contrast the crash path's retry debt).
                        excluded_str[h] = True
                        routable[h] = False
                        straggler_excl += 1
                        rt.exclude([h])
                        mesh_log.append((now, rt.mesh_shape()))
                        refresh_eligible()
                        drain_ring(h, migrated_rows, refund=True)
                        census_idle_if_empty(h)
                if fault_pending:
                    inject_recovered(now)
                if any(active_flag) or fault_pending:
                    push(
                        now + fcfg.heartbeat_interval, _HBEAT, 0, 0, None
                    )
            elif kind == _TICK:
                tick_n += 1
                q = qid
                num_ticks[q] += 1
                rows_arr = np.asarray(rows_arr_in_tick[q])
                batches_arr = np.asarray(batches_arr_in_tick[q])
                density = np.where(
                    batches_arr > 0,
                    rows_arr / np.maximum(batches_arr, 1),
                    0.0,
                )
                bpr = np.where(
                    rows_arr > 0,
                    np.asarray(bytes_arr_in_tick[q]) / np.maximum(rows_arr, 1),
                    0.0,
                )
                policies[q].set_link_mask(links[q].tick(
                    np.asarray(recv_in_tick[q]), np.asarray(sync_in_tick[q]),
                    density, bpr, np.asarray(worker_running, bool),
                ).tolist())
                recv_in_tick[q] = [0.0] * n
                sync_in_tick[q] = [0.0] * n
                rows_arr_in_tick[q] = [0.0] * n
                batches_arr_in_tick[q] = [0.0] * n
                bytes_arr_in_tick[q] = [0.0] * n
                if active_flag[q]:
                    push(now + strategies[q].tick_interval, _TICK, q, 0, None)
            else:  # _GTICK — ONE coalesced tick drives a whole group
                gtick_n += 1
                g = qid
                sim_g, members, interval, _ = groups[g]
                # A member participates while it has arrived, has not
                # already ticked at this instant (join tick colliding with
                # a grid point), and is active — plus exactly one
                # post-drain tick, mirroring the per-tenant cadence where
                # the already-scheduled tick still fires after drain.
                gact = grp_active[g]
                if payload is None:
                    elig = (
                        (grp_arrival[g] <= now)
                        & (grp_last_tick[g] != now)
                        & (gact | ~grp_final[g])
                    )
                else:
                    q = payload
                    i = member_slot[q][1]
                    elig = np.zeros(len(members), bool)
                    if grp_last_tick[g][i] != now and (
                        gact[i] or not grp_final[g][i]
                    ):
                        elig[i] = True
                if elig.any():
                    acc = group_acc[g]
                    rows_arr = acc["rows"]
                    batches_arr = acc["batches"]
                    # Same elementwise formulas as the per-tenant tick,
                    # lifted to (T, n) — bit-identical per row.
                    density = np.where(
                        batches_arr > 0,
                        rows_arr / np.maximum(batches_arr, 1),
                        0.0,
                    )
                    bpr = np.where(
                        rows_arr > 0,
                        acc["bytes"] / np.maximum(rows_arr, 1),
                        0.0,
                    )
                    dist = sim_g.tick(
                        acc["recv"], acc["sync"], density, bpr,
                        np.asarray(worker_running, bool),
                        elig,
                    )
                    idxs = np.flatnonzero(elig)
                    num_ticks[grp_members_arr[g][idxs]] += 1
                    grp_last_tick[g][idxs] = now
                    # One bulk tolist (C loop) instead of a python-level
                    # conversion per live member.
                    dist_rows = dist.tolist()
                    for i in idxs:
                        policies[members[int(i)]].set_link_mask(
                            dist_rows[int(i)]
                        )
                    # Fancy-index reset writes through to the same rows
                    # the per-tenant accumulator aliases view.
                    for key in ("recv", "sync", "rows", "batches", "bytes"):
                        acc[key][idxs] = 0.0
                    grp_final[g][idxs[~gact[idxs]]] = True
                if payload is None and gact.any():
                    push(now + interval, _GTICK, g, 0, None)

        if drained:
            # ---- Closed-form drain -------------------------------------
            # Every arrival has been routed (total_remaining == 0, which
            # also implies no parked fair-share work), so the events left
            # in the heap are only in-flight _ENQUEUEs, running workers'
            # _DONEs, and tick cadences.  From here on (a) routing never
            # happens again, so distribute masks, cost estimates and the
            # fair-share planner cannot influence the result, and (b)
            # workers are independent FIFO servers (an _ENQUEUE/_DONE at
            # worker w touches only w).  Each worker is finished exactly:
            # a short per-event replay while transfers are still landing,
            # then one prefix-sum walk over its fully-loaded ring — the
            # same float operations in the same order as the heap (see
            # `closed_form_none_result` for the op-order argument).  Tick
            # cadences reduce to counting: a pending tick chain fires at
            # chained times t, t+I, ... while its tenant is active plus
            # exactly one final fire, so num_ticks is recovered from the
            # completion times without advancing any state machine.
            drained_events = len(events)
            enq_by_w: Dict[int, List[Tuple]] = {}
            done_by_w: Dict[int, Tuple] = {}
            tick_chains: List[Tuple[float, int, int, int, object]] = []
            for t_e, s_e, kind_e, qid_e, who_e, payload_e in events:
                if kind_e == _ENQUEUE:
                    enq_by_w.setdefault(who_e, []).append(
                        (t_e, s_e, qid_e, payload_e)
                    )
                elif kind_e == _DONE:
                    tot_e, nr_e, cnts_e, tots_e = payload_e
                    done_by_w[who_e] = (t_e, s_e, tot_e, nr_e, cnts_e, tots_e)
                elif kind_e == _RESIZE:
                    # Post-drain resizes are inert: routing is over, so
                    # the pool size can no longer affect any result.
                    pass
                else:  # _TICK chains, _GTICK chains AND pending join ticks
                    tick_chains.append((t_e, s_e, kind_e, qid_e, payload_e))
            events.clear()
            # Fire order matters when a pending one-off join tick (a
            # zero-batch member arriving after the fleet's last routed
            # arrival) coexists with its group's recurring chain: the
            # heap delivers whichever comes first, and the member's
            # single post-inactive fire belongs to that event.
            tick_chains.sort(key=lambda e: (e[0], e[1]))
            inf = float("inf")

            def apply_done_stats(w, t_d, tot, nr, cnts, tots):
                if cnts is None:
                    busy[0][w] += tot
                    rows_done[0][w] += nr
                    rows_completed[0] += nr
                    if t_d > last_done[0]:
                        last_done[0] = t_d
                else:
                    for q in np.flatnonzero(cnts):
                        q = int(q)
                        busy[q][w] += float(tots[q])
                        rows_done[q][w] += int(cnts[q])
                        rows_completed[q] += int(cnts[q])
                        if t_d > last_done[q]:
                            last_done[q] = t_d

            def start_chunk(w, t_s):
                ring = rings[w]
                if ring.tail == ring.head:
                    return None
                chunk, qids = ring.pop(_SERVICE_CHUNK)
                tot = sum(chunk.tolist())
                if qids is None:
                    return (t_s + tot, inf, tot, len(chunk), None, None)
                cnts = np.bincount(qids, minlength=nq)
                tots = np.bincount(qids, weights=chunk, minlength=nq)
                return (t_s + tot, inf, tot, len(chunk), cnts, tots)

            for w in range(n):
                pend = done_by_w.get(w)
                enqs = sorted(enq_by_w.get(w, ()))
                # Phase A: replay the in-flight transfers exactly (chunk
                # pops interleave with arrivals in (time, seq) order).
                i = 0
                while i < len(enqs):
                    te, se = enqs[i][0], enqs[i][1]
                    if pend is not None and (pend[0], pend[1]) < (te, se):
                        t_d = pend[0]
                        apply_done_stats(
                            w, t_d, pend[2], pend[3], pend[4], pend[5]
                        )
                        drained_chunks += 1
                        pend = start_chunk(w, t_d)
                    else:
                        _, _, qe, pl = enqs[i]
                        i += 1
                        segs = pl if type(pl) is list else ((qe, pl),)
                        for q, seg in segs:
                            rings[w].push(seg, qid=q)
                            if pend is None:
                                pend = start_chunk(w, te)
                if pend is None:
                    continue
                # Phase B: the ring holds everything this worker will
                # ever serve — finish it with one prefix-sum walk.
                t0 = pend[0]
                apply_done_stats(w, t0, pend[2], pend[3], pend[4], pend[5])
                drained_chunks += 1
                ring = rings[w]
                m = ring.tail - ring.head
                if not m:
                    continue
                costs = ring.buf[ring.head:ring.tail]
                qids = (
                    ring.qbuf[ring.head:ring.tail]
                    if ring.qbuf is not None else None
                )
                nch = -(-m // _SERVICE_CHUNK)
                drained_chunks += nch
                padded = np.zeros(nch * _SERVICE_CHUNK)
                padded[:m] = costs
                # Within-chunk sequential accumulation (the loop's python
                # sum), then sequential across chunks (now += total).
                totals = np.cumsum(
                    padded.reshape(nch, _SERVICE_CHUNK), axis=1
                )[:, -1]
                times = np.cumsum(np.concatenate(([t0], totals)))
                if qids is None:
                    busy[0][w] = float(np.cumsum(
                        np.concatenate(([busy[0][w]], totals))
                    )[-1])
                    rows_done[0][w] += m
                    rows_completed[0] += m
                    tl = float(times[-1])
                    if tl > last_done[0]:
                        last_done[0] = tl
                else:
                    # Per-(chunk, tenant) splits: np.add.at accumulates in
                    # ring order — the same per-cell float addition order
                    # as the loop's per-chunk np.bincount.
                    ci = np.arange(m) // _SERVICE_CHUNK
                    tt = np.zeros((nch, nq))
                    cc = np.zeros((nch, nq), np.int64)
                    np.add.at(tt, (ci, qids), costs)
                    np.add.at(cc, (ci, qids), 1)
                    busy_row = np.asarray([busy[q][w] for q in range(nq)])
                    walk = np.cumsum(
                        np.vstack((busy_row[None, :], tt)), axis=0
                    )[-1]
                    colrows = cc.sum(axis=0)
                    for q in np.flatnonzero(colrows):
                        q = int(q)
                        busy[q][w] = float(walk[q])
                        rows_done[q][w] += int(colrows[q])
                        rows_completed[q] += int(colrows[q])
                        tl = float(times[int(np.flatnonzero(cc[:, q])[-1]) + 1])
                        if tl > last_done[q]:
                            last_done[q] = tl
                ring.head = ring.tail
            # Tick cadences: count the remaining fires in closed form.
            # A chain fires at t0, t0+I, (t0+I)+I, ... (chained float
            # adds, replayed here) while its tenant has uncompleted rows,
            # plus one final fire from the already-scheduled event.
            # Tie convention: a fire at EXACTLY the tenant's completion
            # time counts as the final fire (as if the completing _DONE
            # popped first).  The heap breaks such a tie by push seq and
            # can count one extra tick — but the tie needs a chained
            # tick time to equal a service-sum completion time in exact
            # float, which no generic workload produces; the divergence
            # is deterministic and confined to num_ticks (telemetry),
            # never latencies or busy vectors.
            for t0, _, kind_e, gid, payload_e in tick_chains:
                if kind_e == _TICK:
                    interval = strategies[gid].tick_interval
                    t_c = t0
                    cnt = 0
                    t_q = last_done[gid]
                    while t_c < t_q:
                        cnt += 1
                        t_c += interval
                    num_ticks[gid] += cnt + 1
                    drained_ticks += cnt + 1
                    continue
                _, members, interval, _ = groups[gid]
                gfin = grp_final[gid]
                glt = grp_last_tick[gid]
                if payload_e is not None:
                    # A pending one-off join tick: fires ONCE for its
                    # member at t0 and never reschedules.  Reachable
                    # only for a member with no batches at all (any
                    # batch-carrying member's join tick pops before its
                    # first arrival, hence before the drain).
                    q = payload_e
                    i = member_slot[q][1]
                    if not gfin[i] and glt[i] != t0:
                        num_ticks[q] += 1
                        drained_ticks += 1
                        if not grp_active[gid][i]:
                            gfin[i] = True
                    continue
                for i, q in enumerate(members):
                    if gfin[i]:
                        continue
                    if grp_arrival[gid][i] > t0:
                        # Not yet arrived at this chain instant: the heap
                        # gates eligibility on arrival, and the member's
                        # single post-arrival fire belongs to its pending
                        # one-off join tick (sorted into this loop) — an
                        # active member can never be here, since all its
                        # arrivals routed before the drain began.
                        continue
                    t_c = t0
                    if glt[i] == t0:
                        # The member already ticked at this instant
                        # (join tick colliding with the pending grid
                        # event — the heap's `last_tick != now`
                        # guard); its chain starts one step later.
                        t_c = t0 + interval
                    cnt = 0
                    t_q = last_done[q]
                    while t_c < t_q:
                        cnt += 1
                        t_c += interval
                    num_ticks[q] += cnt + 1
                    drained_ticks += cnt + 1
                    gfin[i] = True

        if as_policy is not None:
            self.last_resizes = list(as_policy.resizes)
        self.last_event_counts = {
            "tick": tick_n,
            "gtick": gtick_n,
            "arrival": arrival_n,
            "admitted": admitted_n,
            "enqueue": enq_n,
            "done": done_n,
            "resize": resize_n,
            "resizes_applied": len(self.last_resizes),
            "preempted_rows": int(sum(preempted_rows)),
            "heap_events": (
                tick_n + gtick_n + arrival_n + admitted_n + enq_n + done_n
                + resize_n + fail_n + notice_n + recover_n + hbeat_n
            ),
            "fail": fail_n,
            "preempt_notice": notice_n,
            "recover": recover_n,
            "hbeat": hbeat_n,
            "ghost_dones": ghost_dones,
            "recovered_rows": int(sum(recovered_rows)),
            "reexecuted_rows": int(sum(reexecuted_rows)),
            "migrated_rows": int(sum(migrated_rows)),
            "transfer_retries": transfer_retries,
            "arrival_runs_coalesced": arrival_runs,
            "arrivals_in_runs": arrivals_in_runs,
            "enqueues_coalesced": enq_coalesced,
            "waterfill_batched_calls": wf_calls,
            "waterfill_batched_rows": wf_rows,
            "drain_entered": int(drained),
            "drained_heap_events": drained_events,
            "drained_chunks": drained_chunks,
            "drained_ticks": drained_ticks,
        }
        self.last_fault_stats = {
            "enabled": faults_on,
            "injected": (
                self.faults.injected_counts() if faults_on else {}
            ),
            "detections": detections,
            "straggler_exclusions": straggler_excl,
            "recovered_rows": list(recovered_rows),
            "reexecuted_rows": list(reexecuted_rows),
            "migrated_rows": list(migrated_rows),
            "unrecovered_rows": int(fault_pending),
            "wasted_service_s": float(wasted_service),
            "transfer_retries": transfer_retries,
            "retry_backoff_s": float(retry_backoff_total),
            "ghost_dones": ghost_dones,
            "shrink_blocked_mid_recovery": shrink_blocked,
            "mesh_log": list(mesh_log),
            "runtime_events": list(rt.events) if rt is not None else [],
        }

        results: List[QueryResult] = []
        for q, t in enumerate(tenants):
            latency = max(last_done[q] - t.arrival, 1e-12)
            busy_q = np.asarray(busy[q])
            total_rows = int(sum(rows_done[q]))
            applied = rows_redist[q] > 0.01 * max(total_rows, 1)
            results.append(QueryResult(
                latency=float(latency),
                utilization=float(busy_q.sum() / (latency * n)),
                bytes_moved_remote=float(bytes_moved[q]),
                rows_redistributed=int(rows_redist[q]),
                redistribution_applied=bool(applied),
                per_worker_busy=busy_q,
                decision_overhead=float(dec_overhead[q]),
                num_ticks=int(num_ticks[q]),
                preempted_rows=int(preempted_rows[q]),
            ))
        return results


class Simulator:
    """Single-query API: the N=1 case of :class:`MultiQuerySimulator`.

    Kept as the stable entry point for the single-query benches/tests;
    it owns no event loop of its own — the unified
    multi-tenant loop runs the query as a lone tenant arriving at t=0,
    which `tests/test_sim_equivalence.py` pins bit-tight against the seed
    engine (`repro_torch.sim.legacy`).
    """

    def __init__(
        self,
        cluster: ClusterConfig,
        strategy: StrategyConfig,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.cluster = cluster
        self.strategy = strategy
        self.seed = seed
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)

    def _transfer_delay(self, src_worker: int, dst_worker: int, nbytes: float,
                        nrows: int) -> float:
        return _transfer_delay(self.cluster, src_worker, dst_worker,
                               nbytes, nrows)

    def run_query(
        self,
        batches_per_producer: List[List[Batch]],
        arrival_gap: float = 1e-4,
    ) -> QueryResult:
        """Execute one query.

        ``batches_per_producer[i]`` is the (possibly skewed) input stream of
        producer link instance i; batches arrive back-to-back separated by
        ``arrival_gap`` (the scan feeding the UDF operator).
        """
        tenant = TenantQuery(
            name="query",
            streams=batches_per_producer,
            strategy=self.strategy,
            arrival=0.0,
            arrival_gap=arrival_gap,
        )
        return MultiQuerySimulator(
            self.cluster, seed=self.seed, device=self.device
        ).run(
            [tenant]
        )[0]
