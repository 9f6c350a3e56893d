"""Fair share and the SLO layer, held through the port on the CPU: the
twins of ``tests/test_fair_share.py`` and of ``tests/test_slo_layer.py``.

Each twin runs its reference test's workload through ``repro_torch`` with
``device="cpu"`` and asserts the reference test's claim with its bounds:
weighted shares, starvation-freedom, Jain's index, the open-loop arrival
processes, EDF order, preemption and autoscale conserving every row,
deadline-aware admission beating weight-only.  What a run returns (the
planner's deficits, latencies, p50/p99, Jain's index) is also held to the
reference's run of the same inputs and seeds, bit for bit, with the
distribute mask of every link tick (``RefRuns``: the reference's side runs
once per module).

``test_slo_layer.py``'s ``TestServingTimeline`` is twinned by
``test_torch_serving.py::TestServingTimeline``, its
``TestPipelineTokenConservation`` by ``test_torch_data.py``'s
``test_unpacked_doc_is_carried_not_dropped`` and
``test_tenant_tokens_equal_emitted_tokens``.
"""

from collections import deque

import numpy as np
import pytest

from torch_sim_common import RefRuns, same_bits


@pytest.fixture(scope="module")
def twin():
    return RefRuns()


def _fs(m, **kw):
    kw = kw or dict(quantum_rows=64.0, heavy_row_bytes=1e6)
    return m.admission.FairShareConfig(**kw)


# --------------------------------------------------------------------- #
# test_fair_share.py: the weighted deficit-round-robin planner
# --------------------------------------------------------------------- #


def rejects_bad_weights(m):
    with pytest.raises(ValueError):
        m.admission.FairShareAdmission([])
    with pytest.raises(ValueError):
        m.admission.FairShareAdmission([1.0, 0.0])


def bypass_when_pool_idle(m):
    """Nothing in service → any request admitted (work conservation)."""
    p = m.admission.FairShareAdmission([1.0, 1.0], _fs(m))
    assert p.try_admit(1, rows=10_000, nbytes=1e12, bytes_per_row=1e9)
    return list(p.deficit_rows)


def pacing_under_load_and_credit_refill(m):
    p = m.admission.FairShareAdmission([1.0, 1.0], _fs(m, quantum_rows=64.0, burst_quanta=4.0))
    # cap = burst_quanta * quantum * share = 4 * 64 * 0.5 = 128 rows.
    assert p.try_admit(0, 128, 0.0)          # idle bypass, drains deficit
    assert not p.try_admit(0, 128, 0.0)      # in service now: refused
    assert p.backlogged[0]
    p.on_complete(0, 64)                     # one round → +64 credit
    assert not p.try_admit(0, 128, 0.0)      # 64 < charge and < cap
    p.on_complete(0, 64)                     # deficit reaches cap
    assert p.try_admit(0, 128, 0.0)          # saturated → admissible
    return list(p.deficit_rows)


def priority_weights_shape_credit(m):
    p = m.admission.FairShareAdmission([3.0, 1.0], _fs(m, quantum_rows=100.0, burst_quanta=100.0))
    assert p.try_admit(0, 400, 0.0)          # idle bypass
    assert p.try_admit(1, 600, 0.0)          # affordable; leaves cap
    assert not p.try_admit(0, 1e9, 0.0)
    assert not p.try_admit(1, 1e9, 0.0)
    d0, d1 = p.deficit_rows
    p.on_complete(0, 100)
    assert p.deficit_rows[0] - d0 == pytest.approx(75.0)
    assert p.deficit_rows[1] - d1 == pytest.approx(25.0)
    return list(p.deficit_rows)


def idle_tenants_get_no_credit_when_others_wait(m):
    p = m.admission.FairShareAdmission([1.0, 1.0], _fs(m))
    assert p.try_admit(0, 128, 0.0)
    assert not p.try_admit(0, 500, 0.0)      # tenant 0 backlogged
    d1 = p.deficit_rows[1]                   # tenant 1 idle
    p.on_complete(0, 64)
    assert p.deficit_rows[1] == d1           # no credit leaked to idle
    return list(p.deficit_rows)


def heavy_row_bytes_gates_nic_lane(m):
    """Row Size Model: only heavy-row batches charge byte budget."""
    p = m.admission.FairShareAdmission([1.0, 1.0], _fs(m, quantum_rows=1e9, quantum_bytes=100.0,
                                                       burst_quanta=1.0, heavy_row_bytes=1e6))
    assert p.try_admit(0, 1, nbytes=1e9, bytes_per_row=100.0)  # light
    assert p.deficit_bytes[0] == pytest.approx(50.0)  # not charged
    assert p.try_admit(0, 1, nbytes=40.0, bytes_per_row=2e6)  # heavy
    assert p.deficit_bytes[0] == pytest.approx(10.0)  # charged 40
    return list(p.deficit_bytes)


def pick_next_token_share_follows_weights(m):
    p = m.admission.FairShareAdmission([3.0, 1.0], _fs(m, quantum_rows=16.0))
    served = [0.0, 0.0]
    costs = np.random.default_rng(0).uniform(5.0, 20.0, 4000)
    for c in costs:
        q = p.pick_next([float(c), float(c)])
        served[q] += c
    assert served[0] / sum(served) == pytest.approx(0.75, abs=0.05)
    return served


def pick_next_skips_missing_items(m):
    p = m.admission.FairShareAdmission([1.0, 1.0], _fs(m))
    assert p.pick_next([None, 8.0]) == 1
    with pytest.raises(ValueError):
        p.pick_next([None, None])


FAIR_SHARE_PLANNER_CASES = [
    rejects_bad_weights, bypass_when_pool_idle, pacing_under_load_and_credit_refill,
    priority_weights_shape_credit, idle_tenants_get_no_credit_when_others_wait,
    heavy_row_bytes_gates_nic_lane, pick_next_token_share_follows_weights,
    pick_next_skips_missing_items,
]


def closed_loop_shares(m, weights):
    """Tenant 0 submits 1000-row batches, tenant 1 16-row batches, both
    with unbounded demand, service at a fixed rate."""
    p = m.admission.FairShareAdmission(list(weights), _fs(m, quantum_rows=64, burst_quanta=4))
    admitted = [0.0, 0.0]
    inflight = deque()
    batch = [1000, 16]
    for _ in range(8000):
        for q in (0, 1):
            while p.try_admit(q, batch[q], 0.0):
                admitted[q] += batch[q]
                inflight.append((q, batch[q]))
        served = 0
        while inflight and served < 64:
            q, r = inflight.popleft()
            take = min(r, 64 - served)
            p.on_complete(q, take)
            served += take
            if r > take:
                inflight.appendleft((q, r - take))
    return admitted


class TestFairSharePlanner:
    """One case a reference test of ``TestFairSharePlanner`` (its name with
    ``test_`` dropped): the case's assertions run on the port, and what it
    returns equals the reference's."""

    @pytest.mark.parametrize("case", FAIR_SHARE_PLANNER_CASES, ids=lambda f: f.__name__)
    def test_planner(self, twin, case):
        ref, port = twin(case)
        same_bits(ref, port)

    @pytest.mark.parametrize("weights,want", [((1.0, 1.0), 0.5), ((3.0, 1.0), 0.75)])
    def test_throughput_converges_to_weights_despite_batch_asymmetry(self, twin, weights, want):
        ref, admitted = twin(closed_loop_shares, weights)
        assert admitted[0] / sum(admitted) == pytest.approx(want, abs=0.05)
        same_bits(ref, admitted)


# --------------------------------------------------------------------- #
# test_fair_share.py: the admission layer inside the event loop
# --------------------------------------------------------------------- #


def _uniform_tenants(m, cluster, weights, slos=None, n_rows=1500, seed=10):
    prof = m.workload.QueryProfile(name="t", n_rows=n_rows, mean_row_cost=1.2e-3, cost_sigma=0.8,
                                   partition_alpha=0.6, hot_fraction=0.1)
    gap = m.replay.scan_arrival_gap(prof, cluster)
    slos = slos or [None] * len(weights)
    return [
        m.engine.TenantQuery(f"t{i}", m.workload.generate_query(prof, cluster.num_workers, seed=seed + i),
                             m.replay.dyskew_strategy(prof), 0.0, gap, weight=w, slo_target=s)
        for i, (w, s) in enumerate(zip(weights, slos))
    ]


def _total_cost(t):
    return sum(float(b.costs.sum()) for s in t.streams for b in s)


def fair_run(m, weights, slos=None, mode=None):
    """Fair share over uniform tenants; ``mode`` "pinned" adds autoscale
    with the pool pinned at the whole cluster, "deadline" deadline-aware
    admission with preemption."""
    cluster = m.engine.ClusterConfig(num_nodes=2)
    tenants = _uniform_tenants(m, cluster, weights, slos)
    kw = {}
    if mode == "pinned":
        n = cluster.num_workers
        kw = dict(autoscale=m.admission.AutoscaleConfig(min_workers=n, max_workers=n))
    elif mode == "deadline":
        kw = dict(deadline_aware=True, preemption=True)
    sim = m.engine.MultiQuerySimulator(cluster, fair_share=_fs(m), **kw, **m.dev)
    return sim.run(tenants), [_total_cost(t) for t in tenants]


def interference_runs(m):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    profiles = m.workload.skew_interference_suite(4)
    out = []
    for fair_share in (None, _fs(m)):
        ts = m.replay.staggered_tenants(profiles, cluster, m.replay.dyskew_strategy, seed=0,
                                        stagger_frac=0.05)
        rs = m.engine.MultiQuerySimulator(cluster, fair_share=fair_share, **m.dev).run(ts)
        sds = [r.latency / max(m.replay.ideal_latency(t, cluster), 1e-12) for t, r in zip(ts, rs)]
        out.append((m.replay.jain_fairness(sds), rs))
    return out


class TestFairShareEngine:
    def test_priority_ordering_under_contention(self, twin):
        """A high-weight tenant running the same workload as its equal
        neighbours finishes sooner; at equal weights it has no such edge."""
        ref_gold, (gold, _) = twin(fair_run, (8.0, 1.0, 1.0, 1.0), min_ticks=1)
        ref_flat, (flat, _) = twin(fair_run, (1.0, 1.0, 1.0, 1.0), min_ticks=1)
        others = np.mean([r.latency for r in gold[1:]])
        assert gold[0].latency < 0.8 * others
        assert gold[0].latency < 0.8 * flat[0].latency
        flat_lat = [r.latency for r in flat]
        assert min(flat_lat) > 0.85 * max(flat_lat)
        same_bits((ref_gold[0], ref_flat[0]), (gold, flat))

    def test_starvation_freedom_every_tenant_completes(self, twin):
        """Even at 100:1 weights every tenant finishes all of its rows."""
        ref, (results, totals) = twin(fair_run, (100.0, 1.0, 1.0, 1.0), min_ticks=1)
        assert len(results) == 4
        for r, total in zip(results, totals):
            np.testing.assert_allclose(r.per_worker_busy.sum(), total, rtol=1e-9)
            assert np.isfinite(r.latency) and r.latency > 0
        same_bits(ref, (results, totals))

    def test_determinism_with_fair_share(self, twin):
        ref, (r1, _) = twin(fair_run, (4.0, 1.0, 1.0), min_ticks=1)
        _, (r2, _) = twin(fair_run, (4.0, 1.0, 1.0), min_ticks=1)
        for a, b in zip(r1, r2):
            assert a.latency == b.latency
            assert a.rows_redistributed == b.rows_redistributed
        same_bits(ref[0], r1)

    def test_jain_bounds_on_interference_scenario(self, twin):
        """One skewed aggressor, three victims: Jain's index over the
        slowdowns within [1/n, 1], and fair share no less fair."""
        ref, port = twin(interference_runs, min_ticks=1)
        (j_nofair, _), (j_fair, rs_fair) = port
        n = 4
        for j in (j_nofair, j_fair):
            assert 1.0 / n - 1e-9 <= j <= 1.0 + 1e-9
        assert j_fair >= j_nofair - 0.02
        for r in rs_fair:
            assert r.latency > 0
        same_bits(ref, port)


# --------------------------------------------------------------------- #
# test_fair_share.py: open-loop arrival processes and their summaries
# --------------------------------------------------------------------- #


def poisson_rate_and_monotonicity(m):
    t = m.workload.arrival_times(m.workload.ArrivalProcess(kind="poisson", rate=4.0), 4000, 1)
    assert np.all(np.diff(t) > 0)
    assert np.diff(t).mean() == pytest.approx(0.25, rel=0.1)
    return t


def burst_is_burstier_than_poisson(m):
    """On/off modulation fattens the inter-arrival distribution: CV² > 1.3."""
    bt = m.workload.arrival_times(m.workload.ArrivalProcess(kind="burst", rate=2.0), 4000, 1)
    iat = np.diff(bt)
    cv2 = iat.var() / iat.mean() ** 2
    assert cv2 > 1.3
    return bt, cv2


def unknown_process_kind_raises(m):
    with pytest.raises(ValueError):
        m.workload.arrival_times(m.workload.ArrivalProcess(kind="weibull"), 10, 0)


def jain_fairness_index_bounds(m):
    out = m.replay.jain_fairness([1.0, 1.0, 1.0, 1.0]), m.replay.jain_fairness([1.0, 0.0, 0.0, 0.0])
    assert out[0] == pytest.approx(1.0)
    assert out[1] == pytest.approx(0.25)
    return out


def jain_fairness_undefined_inputs_are_nan(m):
    assert np.isnan(m.replay.jain_fairness([]))
    assert np.isnan(m.replay.jain_fairness([0.0, 0.0]))


def summarize_open_loop_handles_missing_completions(m):
    """A class whose every query failed to complete reports n=0 with NaN
    percentiles instead of crashing."""
    cluster = m.engine.ClusterConfig(num_nodes=2)
    tenants = m.replay.open_loop_tenants(
        m.workload.priority_class_suite(), cluster, m.replay.dyskew_strategy,
        m.workload.ArrivalProcess(kind="poisson", rate=5.0), 4, seed=0,
    )
    out = m.replay.summarize_open_loop(tenants, [None] * len(tenants), cluster)
    assert np.isnan(out["jain"]) and np.isnan(out["mean_latency"])
    for stats in out["per_class"].values():
        assert stats["n"] == 0
        assert np.isnan(stats["p50"]) and np.isnan(stats["p999"])
    results = m.engine.MultiQuerySimulator(cluster, **m.dev).run(tenants)
    mixed = [r if t.name.startswith("gold") else None for t, r in zip(tenants, results)]
    out2 = m.replay.summarize_open_loop(tenants, mixed, cluster)
    assert out2["per_class"]["bulk"]["n"] == 0
    assert np.isnan(out2["per_class"]["bulk"]["p50"])
    assert out2["per_class"]["gold"]["n"] > 0
    assert np.isfinite(out2["per_class"]["gold"]["p50"])
    assert np.isfinite(out2["jain"])
    return out, out2


def open_loop_tenants_cycle_specs(m):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    tenants = m.replay.open_loop_tenants(
        m.workload.priority_class_suite(), cluster, m.replay.dyskew_strategy,
        m.workload.ArrivalProcess(kind="poisson", rate=5.0), 8, seed=0,
    )
    assert len(tenants) == 8
    arr = [t.arrival for t in tenants]
    assert arr == sorted(arr)
    assert {t.name.split("#")[0] for t in tenants} == {"gold", "bulk"}
    assert all(t.weight == 8.0 for t in tenants if t.name.startswith("gold"))
    return [(t.name, t.arrival, t.weight, t.slo_target) for t in tenants]


OPEN_LOOP_CASES = [
    poisson_rate_and_monotonicity, burst_is_burstier_than_poisson, unknown_process_kind_raises,
    jain_fairness_index_bounds, jain_fairness_undefined_inputs_are_nan,
    summarize_open_loop_handles_missing_completions, open_loop_tenants_cycle_specs,
]


def _without_tenants(out):
    """A ``run_open_loop`` summary less its inputs (the tenants, whose
    strategies hold each side's own resolve function)."""
    return {k: v for k, v in out.items() if k != "tenants"}


def open_loop_classes(m):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    specs = m.workload.priority_class_suite()
    proc = m.workload.ArrivalProcess(
        kind="poisson", rate=m.replay.open_loop_rate([p for p, _ in specs], cluster, load=0.75))
    base = m.replay.run_open_loop(specs, cluster, proc, 10, seed=0, **m.dev)
    fair = m.replay.run_open_loop(specs, cluster, proc, 10, seed=0, fair_share=_fs(m), **m.dev)
    return _without_tenants(base), _without_tenants(fair)


class TestOpenLoopWorkload:
    """One case a reference test of ``TestOpenLoopWorkload`` (its name with
    ``test_`` dropped), as for the planner."""

    @pytest.mark.parametrize("case", OPEN_LOOP_CASES, ids=lambda f: f.__name__)
    def test_open_loop(self, twin, case):
        ref, port = twin(case)
        same_bits(ref, port)

    def test_open_loop_run_reports_classes_and_jain(self, twin):
        """A Poisson stream of two priority classes reports per-class
        p50/p99 and Jain's index; fair share does not hurt the gold tail."""
        ref, (base, fair) = twin(open_loop_classes, min_ticks=1)
        for out in (base, fair):
            assert set(out["per_class"]) == {"gold", "bulk"}
            for stats in out["per_class"].values():
                assert stats["p50"] <= stats["p99"] <= stats["p999"]
            assert 0.0 < out["jain"] <= 1.0 + 1e-9
        assert fair["per_class"]["gold"]["p99"] <= 1.05 * base["per_class"]["gold"]["p99"]
        same_bits(ref, (base, fair))


# --------------------------------------------------------------------- #
# test_slo_layer.py: the EDF planner and autoscale
# --------------------------------------------------------------------- #


def _deadline(m, weights, slos, fs=None):
    return m.admission.DeadlineAwareAdmission(weights, slos, fs or _fs(m))


def slo_targets_length_validated(m):
    with pytest.raises(ValueError):
        _deadline(m, [1.0, 1.0], [0.5])


def boost_admits_urgent_but_charges_in_full(m):
    # caps: burst_quanta(4) * quantum(64) * share(0.5) = 128 rows.
    p = _deadline(m, [1.0, 1.0], [0.5, None])
    assert p.try_admit(1, 256, 0.0)          # idle bypass → busy pool
    assert p.try_admit(0, 118, 0.0, deadline=100.0, now=0.0)
    d0 = p.deficit_rows[0]
    assert d0 == pytest.approx(10.0)
    assert not p.try_admit(0, 60, 0.0, deadline=100.0, now=0.0)
    # At the deadline: boosted through (max boost 2 * 64 * 0.5 = 64 rows).
    assert p.try_admit(0, 60, 0.0, deadline=0.0, now=0.0)
    assert p.deficit_rows[0] == pytest.approx(d0 - 60)  # full charge
    assert p.deficit_rows[0] < 0  # debt, not minted credit
    assert p.boost_admits[0] == 1
    return list(p.deficit_rows), list(p.boost_admits)


def edf_release_order_prefers_earliest_deadline(m):
    p = _deadline(m, [1.0, 1.0, 1.0], [5.0, 1.0, None])
    assert p.try_admit(2, 512, 0.0)  # saturate via the no-SLO tenant
    assert p.try_admit(0, 10, 0.0, deadline=5.0, now=0.0)
    assert p.try_admit(1, 10, 0.0, deadline=1.0, now=0.0)
    assert not p.try_admit(0, 1_000, 0.0, deadline=5.0, now=0.0)
    assert not p.try_admit(1, 1_000, 0.0, deadline=1.0, now=0.0)
    order = p.release_order()
    assert order.index(1) < order.index(0)
    assert order.index(0) < order.index(2)  # no-deadline last
    return list(order)


def starvation_freedom_no_slo_tenant_still_admitted(m):
    p = _deadline(m, [1.0, 1.0], [0.1, None], _fs(m, quantum_rows=64.0, burst_quanta=2.0))
    assert p.try_admit(0, 200, 0.0, deadline=0.0, now=0.0)
    assert p.try_admit(1, 32, 0.0)      # drains below the cap
    assert not p.try_admit(1, 64, 0.0)  # parked behind the urgent one
    for rounds in range(8):
        p.on_complete(0, 32)
        if p.try_admit(1, 64, 0.0):
            return rounds
    pytest.fail("deadline-free tenant starved")


def preempt_candidates_names_over_share_tenants(m):
    p = _deadline(m, [1.0, 1.0, 1.0], [0.5, None, None])
    assert p.try_admit(1, 900, 0.0)
    assert p.try_admit(2, 100, 0.0)
    cands = p.preempt_candidates(protect=(0,))
    assert cands and cands[0][0] == 1      # most-over-share first
    assert all(q != 0 for q, _ in cands)   # protected
    assert all(q != 2 for q, _ in cands)   # 10 % of 1000 rows against 1/3: not over
    return cands


def preempt_transfer_bookkeeping(m):
    p = _deadline(m, [1.0, 1.0], [0.5, None])
    assert p.try_admit(1, 400, 0.0)
    assert p.try_admit(0, 50, 0.0)  # drain 0 so the advance shows
    out1 = p.outstanding_rows[1]
    d0, d1 = p.deficit_rows
    p.preempt_transfer(victim=1, urgent=0, rows=100)
    assert p.outstanding_rows[1] == pytest.approx(out1 - 100)
    assert p.deficit_rows[1] > d1          # victim refunded
    assert p.deficit_rows[0] > d0          # urgent advanced
    assert p.preempted_rows[1] == pytest.approx(100)
    assert p.backlogged[1]
    return list(p.deficit_rows), list(p.outstanding_rows), list(p.preempted_rows)


def hysteresis_grow_shrink_cooldown(m):
    pol = m.admission.AutoscalePolicy(m.admission.AutoscaleConfig(
        min_workers=4, max_workers=16, backlog_high=32.0, backlog_low=4.0, step=4, cooldown=1.0))
    assert pol.decide(0.0, 4, 1_000.0) == 8          # grow
    assert pol.decide(0.5, 8, 1_000.0) == 8          # cooldown holds
    assert pol.decide(1.5, 8, 1_000.0) == 12         # grow again
    assert pol.decide(3.0, 12, 0.0) == 8             # shrink
    assert pol.decide(10.0, 4, 0.0) == 4             # floor
    assert [r[1:] for r in pol.resizes] == [(4, 8), (8, 12), (12, 8)]
    return list(pol.resizes)


def attainment_triggers_growth(m):
    cfg = m.admission.AutoscaleConfig(min_workers=4, max_workers=8, step=4, backlog_high=1e9,
                                      attainment_low=0.9)
    # Backlog alone is below the threshold; sagging attainment grows.
    assert m.admission.AutoscalePolicy(cfg).decide(0.0, 4, 10.0, attainment=0.5) == 8
    # Healthy attainment with the same backlog: no change.
    assert m.admission.AutoscalePolicy(cfg).decide(0.0, 4, 10.0, attainment=1.0) == 4


def rotation_fallback_charges_cost_instead_of_free_reset(m):
    """The rotation-bound fallback of ``pick_next`` charges the served
    item (carrying debt); zeroing the deficit was a free reset."""
    p = m.admission.FairShareAdmission([1.0, 1.0], _fs(m, quantum_rows=1.0))
    p.deficit_rows[0] = -5_000.0
    before = p.deficit_rows[0]
    assert p.pick_next([10.0, None]) == 0
    # 24 loop iterations visit tenant 0 twelve times at +1 row each, then
    # the fallback charges the cost.
    assert p.deficit_rows[0] == pytest.approx(before + 12.0 - 10.0)
    return list(p.deficit_rows)


SLO_PLANNER_CASES = [
    slo_targets_length_validated, boost_admits_urgent_but_charges_in_full,
    edf_release_order_prefers_earliest_deadline, starvation_freedom_no_slo_tenant_still_admitted,
    preempt_candidates_names_over_share_tenants, preempt_transfer_bookkeeping,
    hysteresis_grow_shrink_cooldown, attainment_triggers_growth,
    rotation_fallback_charges_cost_instead_of_free_reset,
]


class TestSLOPlanner:
    """One case a reference test of ``TestDeadlineAwarePlanner``,
    ``TestAutoscalePolicy`` and ``TestPickNextDebt`` (its name with
    ``test_`` dropped), as for the fair-share planner."""

    @pytest.mark.parametrize("case", SLO_PLANNER_CASES, ids=lambda f: f.__name__)
    def test_planner(self, twin, case):
        ref, port = twin(case)
        same_bits(ref, port)


# --------------------------------------------------------------------- #
# test_slo_layer.py: deadline admission, preemption and RESIZE in the loop
# --------------------------------------------------------------------- #


def autoscaled_run(m):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    sim = m.engine.MultiQuerySimulator(
        cluster, fair_share=_fs(m),
        autoscale=m.admission.AutoscaleConfig(min_workers=4, max_workers=cluster.num_workers,
                                              backlog_high=16.0, step=4, interval=0.05,
                                              cooldown=0.1),
        **m.dev,
    )
    tenants = _uniform_tenants(m, cluster, (1.0, 1.0, 1.0, 1.0))
    return sim.run(tenants), list(sim.last_resizes), [_total_cost(t) for t in tenants]


def _slo_open_loop(m, tenants, deadline_aware=False, preemption=False):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    specs = m.workload.slo_suite()
    proc = m.workload.ArrivalProcess(
        kind="poisson", rate=m.replay.open_loop_rate([p for p, _, _ in specs], cluster, load=2.5))
    kw = dict(fair_share=_fs(m), seed=0)
    if deadline_aware:
        kw.update(deadline_aware=True, preemption=preemption,
                  deadline_cfg=m.admission.DeadlineConfig(urgency_horizon=1.0, boost_quanta=4.0))
    return m.replay.run_open_loop(specs, cluster, proc, tenants, **kw, **m.dev)


def preempted_open_loop(m):
    out = _slo_open_loop(m, 10, deadline_aware=True, preemption=True)
    return _without_tenants(out), [_total_cost(t) for t in out["tenants"]]


def weight_only_and_deadline_aware(m):
    return tuple(_without_tenants(_slo_open_loop(m, 14, deadline_aware=d)) for d in (False, True))


class TestEngineSLOLayer:
    def test_resize_noop_equivalence_vs_fixed_pool(self, twin):
        """A pool pinned at the full cluster fires RESIZE events that
        change nothing: every result IDENTICAL to the fixed-pool run."""
        ref_base, (base, _) = twin(fair_run, (4.0, 1.0, 1.0), min_ticks=1)
        ref_pinned, (pinned, _) = twin(fair_run, (4.0, 1.0, 1.0), None, "pinned", min_ticks=1)
        for a, b in zip(base, pinned):
            assert a.latency == b.latency
            assert a.rows_redistributed == b.rows_redistributed
            np.testing.assert_array_equal(a.per_worker_busy, b.per_worker_busy)
        same_bits((ref_base[0], ref_pinned[0]), (base, pinned))

    def test_autoscale_grows_under_overload_and_conserves_work(self, twin):
        ref, (results, resizes, totals) = twin(autoscaled_run, min_ticks=1)
        assert any(new > old for _, old, new in resizes)
        for r, total in zip(results, totals):
            np.testing.assert_allclose(r.per_worker_busy.sum(), total, rtol=1e-9)
        same_bits(ref, (results, resizes, totals))

    def test_preemption_conserves_every_row(self, twin):
        """Preempted rows are re-injected, never lost, and the overloaded
        open loop preempts something."""
        ref, (out, totals) = twin(preempted_open_loop, min_ticks=1)
        assert out["event_counts"]["preempted_rows"] > 0
        for r, total in zip(out["results"], totals):
            np.testing.assert_allclose(r.per_worker_busy.sum(), total, rtol=1e-9)
        assert sum(r.preempted_rows for r in out["results"]) == out["event_counts"]["preempted_rows"]
        same_bits(ref, (out, totals))

    def test_deadline_aware_beats_weight_only_under_overload(self, twin):
        ref, (base, dl) = twin(weight_only_and_deadline_aware, min_ticks=1)
        assert dl["slo_attainment"] >= base["slo_attainment"]
        g_base, g_dl = base["per_class"]["gold"], dl["per_class"]["gold"]
        assert g_dl["slo_attainment"] >= g_base["slo_attainment"]
        assert g_dl["p99_tardiness"] <= g_base["p99_tardiness"] + 1e-9
        same_bits(ref, (base, dl))

    def test_deadline_run_is_deterministic(self, twin):
        args = ((1.0, 1.0, 1.0), (0.3, None, None), "deadline")
        ref, (r1, _) = twin(fair_run, *args, min_ticks=1)
        _, (r2, _) = twin(fair_run, *args, min_ticks=1)
        for a, b in zip(r1, r2):
            assert a.latency == b.latency
            assert a.preempted_rows == b.preempted_rows
        same_bits(ref[0], r1)
