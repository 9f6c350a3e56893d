"""The original pure-Python discrete-event simulator, kept verbatim.

This is the seed implementation of :mod:`repro_torch.sim.engine` before the
array-backed rewrite: per-row ``(cost, size)`` Python tuples shuttled
through per-worker lists, one ``heapq`` loop, hand-rolled admission
guards.  It is retained ONLY as the behavioural reference for the
equivalence tests (``tests/test_sim_equivalence.py``) that pin the
array-backed engine's ``QueryResult`` to this one on seeded workloads.
Do not grow features here — new work goes into ``repro_torch.sim.engine``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import heapq

import numpy as np

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.sim.engine import (
    AdaptiveLinkSim,
    Batch,
    ClusterConfig,
    QueryResult,
    StrategyConfig,
    waterfill_counts,
)

_TICK, _ARRIVAL, _ENQUEUE, _DONE = 0, 1, 2, 3


class LegacySimulator:
    def __init__(
        self,
        cluster: ClusterConfig,
        strategy: StrategyConfig,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.cluster = cluster
        self.strategy = strategy
        self.device = resolve_device(device)
        self.rng = np.random.default_rng(seed)

    # -- helpers -------------------------------------------------------- #

    def _transfer_delay(self, src_worker: int, dst_worker: int, nbytes: float,
                        nrows: int) -> float:
        """Contention-free transfer latency (NIC occupancy handled by the
        caller when model_contention is on)."""
        c = self.cluster
        ser = nrows * c.per_row_serialize
        if c.node_of(src_worker) == c.node_of(dst_worker):
            if src_worker == dst_worker:
                return ser  # stays in-process pipeline; serialization only
            return c.ipc_latency + nbytes / c.ipc_bandwidth + ser
        return c.network_latency + nbytes / c.network_bandwidth + ser

    # -- main entry ------------------------------------------------------ #

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
        c = self.cluster
        st = self.strategy
        cfg = st.dyskew
        n = c.num_workers

        # Worker state.
        queue_rows: List[List[Tuple[float, float]]] = [[] for _ in range(n)]
        busy_time = np.zeros(n)
        rows_done = np.zeros(n)
        worker_running = [False] * n

        # Metric accumulators between state-machine ticks.
        recv_in_tick = np.zeros(n)        # rows received by each consumer
        sync_in_tick = np.zeros(n)        # sync time per consumer
        rows_arr_in_tick = np.zeros(n)    # rows arrived at each producer
        batches_arr_in_tick = np.zeros(n)
        bytes_arr_in_tick = np.zeros(n)

        # Opaque-cost estimator (global EMA of observed per-row time).
        est_row_cost = 1e-3
        # Observable backlog: rows sent to each consumer minus rows acked
        # complete (the producer sees its own sends and completion acks; it
        # never sees the hidden per-row costs).
        outstanding_rows = np.zeros(n)

        link: Optional[AdaptiveLinkSim] = None
        distribute_mask = np.zeros(n, bool)
        if st.kind == "dyskew":
            link = AdaptiveLinkSim(cfg, n, self.device)

        bytes_moved = 0.0
        rows_redist = 0
        decision_overhead_total = 0.0
        rr_counter = 0
        num_ticks = 0
        # Per-node egress NIC occupancy (heavy-row saturation, §III.B).
        nic_free_at = np.zeros(c.num_nodes)

        remaining_arrivals = sum(len(s) for s in batches_per_producer)
        in_flight = 0

        events: List[Tuple[float, int, int, int, object]] = []
        seq = 0

        def push(t: float, kind: int, who: int, payload: object):
            nonlocal seq
            heapq.heappush(events, (t, seq, kind, who, payload))
            seq += 1

        # Seed the first tick BEFORE any arrival (same timestamp, lower
        # seq): eager links redistribute from the operator's first row.
        if link is not None:
            push(0.0, _TICK, 0, None)
        # Arrivals are chained per producer: batch k+1 is scheduled only
        # after batch k is routed, delayed by scan production time plus
        # credit-based backpressure against the destination backlog.
        streams = batches_per_producer
        for p, stream in enumerate(streams):
            if stream:
                push(0.0, _ARRIVAL, p, 0)

        def active() -> bool:
            return (
                remaining_arrivals > 0
                or in_flight > 0
                or any(worker_running)
                or any(queue_rows[w] for w in range(n))
            )

        service_chunk = 16  # rows per service burst (ack granularity)

        def start_worker(w: int, now: float):
            if worker_running[w] or not queue_rows[w]:
                return
            rows = queue_rows[w][:service_chunk]
            queue_rows[w] = queue_rows[w][service_chunk:]
            total = sum(cst for cst, _ in rows)
            worker_running[w] = True
            push(now + total, _DONE, w, rows)

        def siblings_idle_frac(p: int) -> float:
            idle = [
                (not worker_running[w]) and (not queue_rows[w])
                for w in range(n) if w != p
            ]
            return sum(idle) / max(len(idle), 1)

        def route_batch(p: int, b: Batch, now: float) -> None:
            nonlocal bytes_moved, rows_redist, rr_counter, in_flight
            if st.kind == "static_rr":
                dests = (rr_counter + np.arange(b.num_rows)) % n
                rr_counter += b.num_rows
            elif not distribute_mask[p]:
                dests = np.full(b.num_rows, p)
            else:
                dests = None
                # Row Size Model admission guard (§III.B): low batch density
                # + no skew benefit visible → keep the heavy rows local.
                bpr = b.total_bytes / max(b.num_rows, 1)
                if (
                    st.enable_density_guard
                    and b.num_rows < cfg.min_batch_density
                    and bpr >= cfg.heavy_row_bytes
                    and siblings_idle_frac(p) < cfg.idle_sibling_frac
                ):
                    dests = np.full(b.num_rows, p)
                if dests is None:
                    bl = outstanding_rows * est_row_cost
                    if cfg.self_skip:
                        # Forced-remote ablation (§III.B): the producer must
                        # bypass its own node's interpreters entirely
                        # (Fig. 1 — redistribution targets interpreters on
                        # *other* VW nodes), leaving local CPU idle.
                        bl = bl.copy()
                        own = c.node_of(p)
                        for w in range(n):
                            if c.node_of(w) == own:
                                bl[w] = np.inf
                    counts = waterfill_counts(
                        bl, b.num_rows, max(est_row_cost, 1e-9)
                    )
                    dests = np.repeat(np.arange(n), counts)
                    if st.enable_cost_gate:
                        # Cost gate (§I goal 3): refuse when estimated
                        # movement time exceeds estimated straggler savings.
                        moving = dests != p
                        mv_bytes = float(b.sizes[moving].sum())
                        t_move = (
                            mv_bytes / c.network_bandwidth
                            + int(moving.sum()) * c.per_row_serialize
                        )
                        saved = (
                            est_row_cost * float(moving.sum()) * (1.0 - 1.0 / n)
                        )
                        if saved <= cfg.cost_gate * t_move:
                            dests = np.full(b.num_rows, p)

            for d in np.unique(dests):
                d = int(d)
                m = dests == d
                nbytes = float(b.sizes[m].sum())
                nrows = int(m.sum())
                cross_node = c.node_of(d) != c.node_of(p)
                if d != p:
                    rows_redist += nrows
                    if cross_node:
                        bytes_moved += nbytes
                arrive = now + self._transfer_delay(p, d, nbytes, nrows)
                if cross_node and c.model_contention:
                    # Serialize on the source node's uplink.
                    src_node = c.node_of(p)
                    start = max(now, nic_free_at[src_node])
                    occupy = nbytes / c.network_bandwidth
                    nic_free_at[src_node] = start + occupy
                    arrive = start + occupy + c.network_latency \
                        + nrows * c.per_row_serialize
                payload = list(zip(b.costs[m].tolist(), b.sizes[m].tolist()))
                in_flight += 1
                push(arrive, _ENQUEUE, d, payload)
                outstanding_rows[d] += nrows

        now = 0.0
        last_work_done = 0.0
        while events:
            now, _, kind, who, payload = heapq.heappop(events)
            if kind == _TICK:
                num_ticks += 1
                rows_arr = rows_arr_in_tick
                density = np.where(
                    batches_arr_in_tick > 0,
                    rows_arr / np.maximum(batches_arr_in_tick, 1),
                    0.0,
                )
                bpr = np.where(
                    rows_arr > 0, bytes_arr_in_tick / np.maximum(rows_arr, 1), 0.0
                )
                signal = np.array(worker_running, dtype=bool)
                distribute_mask = link.tick(
                    recv_in_tick, sync_in_tick, density, bpr, signal
                )
                recv_in_tick[:] = 0.0
                sync_in_tick[:] = 0.0
                rows_arr_in_tick[:] = 0.0
                batches_arr_in_tick[:] = 0.0
                bytes_arr_in_tick[:] = 0.0
                if active():
                    push(now + st.tick_interval, _TICK, 0, None)
            elif kind == _ARRIVAL:
                p, k = who, payload
                b = streams[p][k]
                remaining_arrivals -= 1
                rows_arr_in_tick[p] += b.num_rows
                batches_arr_in_tick[p] += 1
                bytes_arr_in_tick[p] += b.total_bytes
                if link is not None:
                    decision_overhead_total += st.decision_overhead
                    now += st.decision_overhead
                route_batch(p, b, now)
                if k + 1 < len(streams[p]):
                    # Flow control: pace against the least-backlogged valid
                    # destination (own consumer when routing locally).
                    if st.kind == "static_rr" or distribute_mask[p]:
                        bl = float(outstanding_rows.min())
                    else:
                        bl = float(outstanding_rows[p])
                    backpressure = max(0.0, bl - c.flow_window_rows) * est_row_cost
                    push(now + arrival_gap + backpressure, _ARRIVAL, p, k + 1)
            elif kind == _ENQUEUE:
                w = who
                in_flight -= 1
                queue_rows[w].extend(payload)
                recv_in_tick[w] += len(payload)
                start_worker(w, now)
            else:  # _DONE
                w = who
                rows = payload
                total = sum(cst for cst, _ in rows)
                busy_time[w] += total
                rows_done[w] += len(rows)
                sync_in_tick[w] += total
                avg = total / max(len(rows), 1)
                est_row_cost = (1 - st.cost_ema) * est_row_cost + st.cost_ema * avg
                outstanding_rows[w] = max(outstanding_rows[w] - len(rows), 0.0)
                worker_running[w] = False
                last_work_done = now
                start_worker(w, now)

        makespan = max(last_work_done, 1e-12)
        util = float(busy_time.sum() / (makespan * n))
        total_rows = int(rows_done.sum())
        applied = rows_redist > 0.01 * max(total_rows, 1)
        return QueryResult(
            latency=makespan,
            utilization=util,
            bytes_moved_remote=bytes_moved,
            rows_redistributed=rows_redist,
            redistribution_applied=applied,
            per_worker_busy=busy_time,
            decision_overhead=decision_overhead_total,
            num_ticks=num_ticks,
        )
