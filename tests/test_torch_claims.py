"""The paper's claims and the simulator's equivalence pins, held through
the port on the CPU: the twins of ``tests/test_paper_claims.py`` and
``tests/test_sim_equivalence.py``.

Each twin runs its reference test's workload through ``repro_torch`` with
``device="cpu"`` and asserts the reference test's claim with its bounds:
Fig. 4's bands, the §III.B heavy-row regression and its recovery by the
density guard, the policy semantics, the array engine against its legacy
oracle, the admission planner.  What a run returns is also held to the
reference's run of the same inputs and seeds, bit for bit, with the
distribute mask of every link tick (``RefRuns``: the reference's side runs
once per module).  A reference test that an earlier port test already
twins is named where its twin would stand.
"""

import numpy as np
import pytest

from torch_sim_common import PORT, TOL, RefRuns, default_strategies, same_bits


@pytest.fixture(scope="module")
def twin():
    return RefRuns()


# --------------------------------------------------------------------- #
# test_paper_claims.py
# --------------------------------------------------------------------- #

FIG4_QUERIES = ("q05", "q10", "q19", "q22")


def fig4(m):
    cluster = m.engine.ClusterConfig(num_nodes=4)
    suite = {p.name: p for p in m.workload.tpcxbb_suite()}
    out = {}
    for i, name in enumerate(FIG4_QUERIES):
        prof = suite[name]
        batches = m.workload.generate_query(prof, cluster.num_workers, seed=100 + i)
        leg = m.engine.Simulator(cluster, m.replay.legacy_strategy(prof), i, **m.dev).run_query(batches)
        dk = m.engine.Simulator(cluster, m.replay.dyskew_strategy(prof), i, **m.dev).run_query(batches)
        out[name] = (m.replay.improvement(leg.latency, dk.latency), leg, dk)
    return out


class TestFig4Bands:
    @pytest.fixture(scope="class")
    def results(self, twin):
        return twin(fig4, min_ticks=1)

    def test_q10_large_gain(self, results):
        ref, port = results
        assert 0.30 <= port["q10"][0] <= 0.60  # paper: +43 %
        same_bits(ref["q10"], port["q10"])

    def test_q19_large_gain(self, results):
        ref, port = results
        assert 0.20 <= port["q19"][0] <= 0.50  # paper: +36 %
        same_bits(ref["q19"], port["q19"])

    def test_balanced_queries_unchanged(self, results):
        ref, port = results
        assert abs(port["q05"][0]) < 0.08
        assert abs(port["q22"][0]) < 0.08
        same_bits((ref["q05"], ref["q22"]), (port["q05"], port["q22"]))


def heavy_rows_arms(m):
    t = m.types
    cluster = m.engine.ClusterConfig(num_nodes=4)
    prof = m.workload.heavy_rows_case(row_gb=1.0, n_rows=48)
    batches = m.workload.generate_query(prof, cluster.num_workers, seed=0)
    unguarded = m.engine.StrategyConfig(
        kind="dyskew",
        dyskew=t.DySkewConfig(policy=t.Policy.EAGER_SNOWPARK, cost_gate=0.0,
                              min_batch_density_frac=0.0),
        enable_density_guard=False, enable_cost_gate=False,
    )
    return [m.engine.Simulator(cluster, st, 0, **m.dev).run_query(batches)
            for st in (m.engine.StrategyConfig(kind="none"), unguarded,
                       m.engine.StrategyConfig(kind="dyskew"))]


class TestHeavyRowBands:
    def test_regression_and_recovery(self, twin):
        ref, port = twin(heavy_rows_arms, min_ticks=1)
        none, ung, grd = port
        assert ung.latency > 10.0 * none.latency   # paper: up to 20x
        assert grd.latency < 1.1 * none.latency
        same_bits(ref, port)


def policy_run(m, policy_name):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    policy = getattr(m.types.Policy, policy_name)
    if policy_name == "NEVER":
        prof = m.workload.QueryProfile(name="nv", n_rows=4000, mean_row_cost=1e-3,
                                       partition_alpha=1.0, hot_fraction=0.3, policy=policy)
    else:
        prof = m.workload.QueryProfile(name="ea", n_rows=4000, mean_row_cost=1e-3, policy=policy)
    batches = m.workload.generate_query(prof, cluster.num_workers, seed=0)
    return m.engine.Simulator(cluster, m.replay.dyskew_strategy(prof), 0, **m.dev).run_query(batches)


def constrained_arms(m):
    prof = m.workload.QueryProfile(name="lc", locality_constrained=True)
    return m.replay.legacy_strategy(prof), m.replay.dyskew_strategy(prof)


class TestPolicySemantics:
    def test_never_policy_moves_nothing(self, twin):
        ref, r = twin(policy_run, "NEVER")
        assert r.rows_redistributed == 0
        assert not r.redistribution_applied
        same_bits(ref, r)

    def test_eager_udf_applies(self, twin):
        ref, r = twin(policy_run, "EAGER_SNOWPARK", min_ticks=1)
        assert r.redistribution_applied
        same_bits(ref, r)

    def test_constrained_query_legacy_falls_back_to_none(self, twin):
        ref, (leg, st) = twin(constrained_arms)
        assert leg.kind == "none"
        assert st.kind == "dyskew"
        assert st.dyskew.policy == PORT.types.Policy.LATE
        same_bits(ref, (leg, st))


# --------------------------------------------------------------------- #
# test_sim_equivalence.py: the array engine against its legacy oracle
# --------------------------------------------------------------------- #


def assert_equivalent(new, old, with_applied=True):
    """The reference's ``_compare`` bar: rtol 1e-9, counts exactly."""
    for f in ("latency", "utilization", "bytes_moved_remote"):
        np.testing.assert_allclose(getattr(new, f), getattr(old, f), **TOL)
    assert new.rows_redistributed == old.rows_redistributed
    if with_applied:
        assert new.redistribution_applied == old.redistribution_applied
    np.testing.assert_allclose(new.per_worker_busy, old.per_worker_busy, **TOL)


def _profile(m, name):
    w = m.workload
    if name == "eq":
        return w.QueryProfile(name="eq", n_rows=3000, mean_row_cost=1e-3, cost_sigma=1.2,
                              partition_alpha=1.0, hot_fraction=0.2)
    if name == "eq2":
        return w.QueryProfile(name="eq2", n_rows=2000, mean_row_cost=2e-3, cost_sigma=0.8,
                              partition_alpha=0.4, locality_constrained=True)
    if name == "heavy_rows":
        return w.heavy_rows_case(row_gb=1.0, n_rows=48)
    return w.self_skip_case()


def _strategy(m, prof, name):
    if name == "self_skip":
        return m.engine.StrategyConfig(
            kind="dyskew",
            dyskew=m.types.DySkewConfig(policy=m.types.Policy.EAGER_SNOWPARK, self_skip=True),
        )
    if name in ("legacy_strategy", "dyskew_strategy"):
        return getattr(m.replay, name)(prof)
    return default_strategies(m, name)


def engine_and_legacy(m, nodes, prof_name, strategy_name, seed, gap=None):
    cluster = m.engine.ClusterConfig(num_nodes=nodes)
    prof = _profile(m, prof_name)
    strategy = _strategy(m, prof, strategy_name)
    batches = m.workload.generate_query(prof, cluster.num_workers, seed=seed)
    if gap is None:
        gap = m.replay.scan_arrival_gap(prof, cluster)
    new = m.engine.Simulator(cluster, strategy, seed, **m.dev).run_query(batches, gap)
    old = m.legacy.LegacySimulator(cluster, strategy, seed, **m.dev).run_query(batches, gap)
    return new, old


class TestEngineEquivalence:
    """The port's array engine reproduces the port's legacy engine.
    (static_rr, 3) and (dyskew, 3) are
    ``test_torch_sim.py::TestEngineParity::test_port_engine_holds_its_legacy_oracle``."""

    @pytest.mark.parametrize("kind,seed", [("none", 0), ("none", 3), ("static_rr", 0), ("dyskew", 0)])
    def test_skewed_workload_all_strategies(self, twin, kind, seed):
        ref, (new, old) = twin(engine_and_legacy, 4, "eq", kind, seed)
        assert_equivalent(new, old)
        same_bits(ref, (new, old))

    def test_heavy_rows_guarded(self, twin):
        ref, (new, old) = twin(engine_and_legacy, 4, "heavy_rows", "dyskew", 0, 1e-4, min_ticks=1)
        assert_equivalent(new, old)
        same_bits(ref, (new, old))

    def test_self_skip_ablation(self, twin):
        ref, (new, old) = twin(engine_and_legacy, 2, "self_skip", "self_skip", 0, min_ticks=1)
        assert_equivalent(new, old)
        same_bits(ref, (new, old))

    def test_ab_resolution_strategies(self, twin):
        for arm in ("legacy_strategy", "dyskew_strategy"):
            ref, (new, old) = twin(engine_and_legacy, 2, "eq2", arm, 1)
            assert_equivalent(new, old)
            same_bits(ref, (new, old))


# --------------------------------------------------------------------- #
# test_sim_equivalence.py: the shared admission planner
# --------------------------------------------------------------------- #


def _planner(m, **kw):
    return m.admission.BatchAdmission(m.types.DySkewConfig(policy=m.types.Policy.EAGER_SNOWPARK, **kw))


def cost_gate_blocks_heavy_cheap_rows(m):
    dec = _planner(m).admit_move(bytes_moved=1e9, rows_moved=8, est_row_cost=1e-4, num_instances=8,
                                 bandwidth=1.25e9, per_row_overhead=2e-6)
    assert not dec.admit and dec.reason == "cost_gate"
    assert dec.est_transfer > dec.est_saved
    return dec


def cost_gate_admits_expensive_small_rows(m):
    dec = _planner(m).admit_move(bytes_moved=64_000, rows_moved=128, est_row_cost=5e-3,
                                 num_instances=8, bandwidth=1.25e9, per_row_overhead=2e-6)
    assert dec.admit and dec.reason == "ok"
    return dec


def cost_gate_threshold_scales(m):
    args = dict(bytes_moved=1e6, rows_moved=32, est_row_cost=1e-4, num_instances=8,
                bandwidth=1.25e9, per_row_overhead=2e-6)
    loose = _planner(m, cost_gate=0.1).admit_move(**args)
    strict = _planner(m, cost_gate=10.0).admit_move(**args)
    assert loose.admit
    assert not strict.admit
    return loose, strict


def cost_gate_disabled_admits_everything(m):
    p = m.admission.BatchAdmission(m.types.DySkewConfig(policy=m.types.Policy.EAGER_SNOWPARK),
                                   enable_cost_gate=False)
    dec = p.admit_move(1e12, 4, 1e-9, 8, 1.25e9, 2e-6)
    assert dec.admit
    return dec


def transfer_and_savings_formulas(m):
    a = m.admission
    out = (a.transfer_seconds(1e9, 10, 1e9, 1e-3), a.straggler_savings(1e-3, 100, 1),
           a.straggler_savings(1e-3, 100, 4))
    assert out[0] == pytest.approx(1.01)
    # Savings scale with (1 - 1/n): nothing saved on a 1-worker cluster.
    assert out[1] == 0.0
    assert out[2] == pytest.approx(0.075)
    return out


def density_guard_blocks_sparse_heavy_batches(m):
    p = _planner(m)
    assert p.density_guard_blocks(num_rows=2, bytes_per_row=p.cfg.heavy_row_bytes * 10,
                                  idle_sibling_frac=0.0)


def density_guard_ignores_small_light_batches(m):
    # End-of-stream remainder batches (few rows, small bytes) must NOT trip it.
    assert not _planner(m).density_guard_blocks(num_rows=2, bytes_per_row=128.0, idle_sibling_frac=0.0)


def density_guard_yields_to_idle_siblings(m):
    p = _planner(m)
    assert not p.density_guard_blocks(num_rows=2, bytes_per_row=p.cfg.heavy_row_bytes * 10,
                                      idle_sibling_frac=1.0)


def density_guard_lazy_idle_callable(m):
    p = _planner(m)
    calls = []

    def frac():
        calls.append(1)
        return 0.0

    # Cheap size checks fail → the expensive sibling scan is skipped.
    assert not p.density_guard_blocks(10_000, 8.0, frac)
    assert not calls
    assert p.density_guard_blocks(2, p.cfg.heavy_row_bytes * 10, frac)
    assert calls
    return len(calls)


def no_self_skip_everyone_eligible(m):
    mask = _planner(m).eligible_destinations(8, producer=3)
    assert mask.all()
    return mask


def self_skip_excludes_producer(m):
    mask = _planner(m, self_skip=True).eligible_destinations(8, 3)
    assert not mask[3] and mask.sum() == 7
    return mask


def self_skip_excludes_whole_node(m):
    c = m.engine.ClusterConfig(num_nodes=2, interpreters_per_node=4)
    mask = _planner(m, self_skip=True).eligible_destinations(c.num_workers, producer=1, node_of=c.node_of)
    assert not mask[:4].any() and mask[4:].all()
    return mask


PLANNER_CASES = [
    cost_gate_blocks_heavy_cheap_rows, cost_gate_admits_expensive_small_rows,
    cost_gate_threshold_scales, cost_gate_disabled_admits_everything,
    transfer_and_savings_formulas, density_guard_blocks_sparse_heavy_batches,
    density_guard_ignores_small_light_batches, density_guard_yields_to_idle_siblings,
    density_guard_lazy_idle_callable, no_self_skip_everyone_eligible,
    self_skip_excludes_producer, self_skip_excludes_whole_node,
]


class TestAdmissionPlanner:
    """One case a reference test of ``TestAdmissionPlanner`` (its name with
    ``test_`` dropped): the case's assertions run on the port, and what it
    returns equals the reference's."""

    @pytest.mark.parametrize("case", PLANNER_CASES, ids=lambda f: f.__name__)
    def test_planner(self, twin, case):
        ref, port = twin(case)
        same_bits(ref, port)


# --------------------------------------------------------------------- #
# test_sim_equivalence.py: the multi-tenant loop
# --------------------------------------------------------------------- #


def _run_multi(m, cluster, tenants, **kw):
    sim = m.engine.MultiQuerySimulator(cluster, **kw, **m.dev)
    return sim.run(tenants), dict(sim.last_event_counts)


def single_tenant_and_legacy(m, kind):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    prof = m.workload.QueryProfile(name="mt_eq", n_rows=2000, mean_row_cost=1e-3, cost_sigma=1.1,
                                   partition_alpha=0.8, hot_fraction=0.15)
    st = default_strategies(m, kind)
    batches = m.workload.generate_query(prof, cluster.num_workers, seed=2)
    gap = m.replay.scan_arrival_gap(prof, cluster)
    multi = _run_multi(m, cluster, [m.engine.TenantQuery("solo", batches, st, 0.0, gap)])[0][0]
    old = m.legacy.LegacySimulator(cluster, st, 0, **m.dev).run_query(batches, gap)
    return multi, old


def disjoint_tenants_and_legacy(m):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    n = cluster.num_workers
    st = m.engine.StrategyConfig(kind="none")
    prof = m.workload.QueryProfile(name="disjoint", n_rows=1500, mean_row_cost=1e-3, cost_sigma=0.9)
    gap = m.replay.scan_arrival_gap(prof, cluster)
    full = m.workload.generate_query(prof, n, seed=9)
    half = n // 2
    streams_a = [s if p < half else [] for p, s in enumerate(full)]
    streams_b = [s if p >= half else [] for p, s in enumerate(full)]
    multi = _run_multi(m, cluster, [m.engine.TenantQuery("a", streams_a, st, 0.0, gap),
                                    m.engine.TenantQuery("b", streams_b, st, 0.0, gap)])[0]
    solos = [m.legacy.LegacySimulator(cluster, st, 0, **m.dev).run_query(s, gap)
             for s in (streams_a, streams_b)]
    return multi, solos


class TestMultiTenantEquivalence:
    @pytest.mark.parametrize("kind", ["none", "static_rr", "dyskew"])
    def test_single_tenant_bit_exact_vs_legacy(self, twin, kind):
        ref, (multi, old) = twin(single_tenant_and_legacy, kind)
        assert_equivalent(multi, old, with_applied=False)
        same_bits(ref, (multi, old))

    def test_disjoint_tenants_bit_exact_vs_legacy(self, twin):
        ref, (multi, solos) = twin(disjoint_tenants_and_legacy)
        for res, solo in zip(multi, solos):
            assert_equivalent(res, solo, with_applied=False)
        same_bits(ref, (multi, solos))


def _mixed_tenants(m, cluster):
    # An eagerly distributing tenant, a distribute-late tenant whose link
    # transitions mid-run, a static round-robin and a 'none' tenant.
    profiles = m.workload.multi_tenant_suite(4, seed=47)
    tenants = m.replay.staggered_tenants(profiles, cluster, m.replay.dyskew_strategy, seed=1)
    tenants[1].strategy = m.engine.StrategyConfig(kind="static_rr")
    tenants[3].strategy = m.engine.StrategyConfig(kind="none")
    return tenants


def mixed_drain_and_heap(m):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    heap = _run_multi(m, cluster, _mixed_tenants(m, cluster), closed_form_drain=False)
    fast = _run_multi(m, cluster, _mixed_tenants(m, cluster))
    total_batches = sum(len(s) for t in _mixed_tenants(m, cluster) for s in t.streams)
    return fast, heap, total_batches


def join_tick_at_grid_event(m):
    cluster = m.engine.ClusterConfig(num_nodes=1, interpreters_per_node=4)
    st = default_strategies(m, "dyskew")
    interval = st.tick_interval
    g2 = (0.0 + interval) + interval  # chained grid value
    rng = np.random.default_rng(7)

    def tenant(name, arrival):
        streams = [[] for _ in range(cluster.num_workers)]
        streams[0] = [m.engine.Batch(costs=rng.exponential(1e-3, 24), sizes=np.full(24, 256.0))]
        return m.engine.TenantQuery(name, streams, st, arrival, 1e-4)

    tenants = [tenant("a", 0.0), tenant("b", g2)]
    heap = _run_multi(m, cluster, tenants, closed_form_drain=False)[0]
    fast = _run_multi(m, cluster, tenants)[0]
    return fast, heap


def zero_row_census(m):
    cluster = m.engine.ClusterConfig(num_nodes=1, interpreters_per_node=4)
    n = cluster.num_workers
    rng = np.random.default_rng(23)
    streams = [[] for _ in range(n)]
    streams[2] = [m.engine.Batch(costs=np.empty(0), sizes=np.empty(0))]
    zero = m.engine.TenantQuery("z", streams, m.engine.StrategyConfig(kind="none"), 0.0, 1e-4)
    # 2 sparse heavy rows: the density guard's size checks trip, so the
    # idle-sibling fraction decides; threshold 0.9 tells all-3-idle (1.0)
    # from the corrupted census (2/3).
    streams = [[] for _ in range(n)]
    streams[0] = [m.engine.Batch(costs=rng.exponential(0.05, 2), sizes=np.full(2, 2e6))]
    st = m.engine.StrategyConfig(
        kind="dyskew",
        dyskew=m.types.DySkewConfig(policy=m.types.Policy.EAGER_SNOWPARK, idle_sibling_frac=0.9),
        enable_cost_gate=False,
    )
    heavy = m.engine.TenantQuery("h", streams, st, 0.1, 1e-4)
    return _run_multi(m, cluster, [zero, heavy], none_closed_form=False)[0]


def pending_join_tick(m, arrival):
    cluster = m.engine.ClusterConfig(num_nodes=1, interpreters_per_node=4)
    st = default_strategies(m, "dyskew")
    rng = np.random.default_rng(19)
    streams_a = [[] for _ in range(cluster.num_workers)]
    streams_a[0] = [m.engine.Batch(costs=rng.exponential(1e-3, 24), sizes=np.full(24, 256.0))]
    a = m.engine.TenantQuery("a", streams_a, st, 0.0, 1e-4)
    b = m.engine.TenantQuery("b", [[] for _ in range(cluster.num_workers)], st, arrival, 1e-4)
    heap = _run_multi(m, cluster, [a, b], batch_ticks=True, closed_form_drain=False)[0]
    fast = _run_multi(m, cluster, [a, b], batch_ticks=True)[0]
    return fast, heap


def coalesced_enqueues(m):
    cluster = m.engine.ClusterConfig(num_nodes=1, interpreters_per_node=4)
    rng = np.random.default_rng(11)
    st = m.engine.StrategyConfig(kind="none")

    def tenant(name):
        streams = [[] for _ in range(cluster.num_workers)]
        streams[0] = [m.engine.Batch(costs=rng.exponential(1e-3, 40), sizes=np.full(40, 256.0))]
        return m.engine.TenantQuery(name, streams, st, 0.0, 1e-4)

    tenants = [tenant("a"), tenant("b")]
    fast, counts = _run_multi(m, cluster, tenants, none_closed_form=False)
    heap = _run_multi(m, cluster, tenants, none_closed_form=False, closed_form_drain=False)[0]
    total = sum(b.costs.sum() for t in tenants for s in t.streams for b in s)
    return fast, heap, counts, total


class TestClosedFormDrain:
    """The closed-form drain against replaying the heap to exhaustion.
    ``test_flag_false_keeps_the_heap`` and
    ``test_zero_row_batch_tenant_terminates`` are
    ``test_torch_sim.py::TestMultiTenantParity::test_mixed_strategy_trace[heap]``
    and ``::test_zero_row_batch_tenant_terminates``."""

    def test_bit_identical_on_mixed_strategy_trace(self, twin):
        ref, port = twin(mixed_drain_and_heap, min_ticks=1)
        (fast, counts), (heap, _), _ = port
        assert counts["drain_entered"] == 1
        assert counts["drained_heap_events"] > 0
        for a, b in zip(fast, heap):
            assert a.latency == b.latency
            assert a.utilization == b.utilization
            assert a.num_ticks == b.num_ticks
            assert a.rows_redistributed == b.rows_redistributed
            np.testing.assert_array_equal(a.per_worker_busy, b.per_worker_busy)
        same_bits(ref, port)

    def test_detector_conservative_while_arrivals_pending(self, twin):
        ref, port = twin(mixed_drain_and_heap, min_ticks=1)
        (res, counts), _, total_batches = port
        assert counts["drain_entered"] == 1
        # Every arrival was popped from the heap, none synthesized by the drain ...
        assert counts["arrival"] + counts["admitted"] == total_batches
        # ... and links transitioned before the drain began.
        assert any(r.rows_redistributed > 0 for r in res)
        same_bits(ref, port)

    def test_drain_num_ticks_exact_with_join_tick_at_pending_grid_event(self, twin):
        ref, (fast, heap) = twin(join_tick_at_grid_event, min_ticks=1)
        for a, b in zip(fast, heap):
            assert a.num_ticks == b.num_ticks
            assert a.latency == b.latency
        same_bits(ref, (fast, heap))

    def test_zero_row_enqueue_does_not_corrupt_idle_census(self, twin):
        ref, res = twin(zero_row_census, min_ticks=1)
        assert res[1].rows_redistributed > 0
        same_bits(ref, res)

    @pytest.mark.parametrize("arrival", [0.013, 0.253, 1.01])
    def test_drain_pending_join_tick_fires_once(self, twin, arrival):
        ref, (fast, heap) = twin(pending_join_tick, arrival, min_ticks=1)
        for x, y in zip(fast, heap):
            assert x.num_ticks == y.num_ticks
            assert x.latency == y.latency
        same_bits(ref, (fast, heap))

    def test_coalesced_enqueues_drain_exact(self, twin):
        ref, port = twin(coalesced_enqueues)
        fast, heap, counts, total = port
        assert counts["enqueues_coalesced"] >= 1
        for a, b in zip(fast, heap):
            assert a.latency == b.latency
            np.testing.assert_array_equal(a.per_worker_busy, b.per_worker_busy)
        np.testing.assert_allclose(sum(r.per_worker_busy.sum() for r in fast), total, rtol=1e-9)
        same_bits(ref, port)


def _suite_tenants(m, cluster, num=4, resolve="dyskew_strategy", seed=0, suite_seed=41):
    profiles = m.workload.multi_tenant_suite(num, seed=suite_seed)
    return m.replay.staggered_tenants(profiles, cluster, getattr(m.replay, resolve), seed=seed)


def _total_cost(t):
    return sum(float(b.costs.sum()) for s in t.streams for b in s)


def conservation_per_tenant(m):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    tenants = _suite_tenants(m, cluster)
    return _run_multi(m, cluster, tenants)[0], [_total_cost(t) for t in tenants]


def two_runs(m):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    return [_run_multi(m, cluster, _suite_tenants(m, cluster))[0] for _ in range(2)]


def shared_and_solo(m):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    tenants = _suite_tenants(m, cluster)
    shared = _run_multi(m, cluster, tenants)[0]
    solo = [_run_multi(m, cluster, [m.engine.TenantQuery(t.name, t.streams, t.strategy, 0.0,
                                                         t.arrival_gap)])[0][0]
            for t in tenants]
    return shared, solo


def legacy_and_dyskew_concurrent(m):
    cluster = m.engine.ClusterConfig(num_nodes=4)
    return [_run_multi(m, cluster, _suite_tenants(m, cluster, 6, arm, 0, 43))[0]
            for arm in ("legacy_strategy", "dyskew_strategy")]


def simulator_and_one_tenant(m):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    prof = m.workload.QueryProfile(name="solo", n_rows=2000, mean_row_cost=1e-3, cost_sigma=1.0,
                                   partition_alpha=0.8, hot_fraction=0.2)
    st = default_strategies(m, "dyskew")
    batches = m.workload.generate_query(prof, cluster.num_workers, seed=5)
    gap = m.replay.scan_arrival_gap(prof, cluster)
    solo = m.engine.Simulator(cluster, st, 0, **m.dev).run_query(batches, gap)
    multi = _run_multi(m, cluster, [m.engine.TenantQuery("solo", batches, st, 0.0, gap)])[0][0]
    return solo, multi


class TestMultiQuerySimulator:
    def test_conservation_per_tenant(self, twin):
        ref, (results, totals) = twin(conservation_per_tenant, min_ticks=1)
        assert len(results) == len(totals) == 4
        for r, total in zip(results, totals):
            np.testing.assert_allclose(r.per_worker_busy.sum(), total, rtol=1e-9)
            assert r.latency > 0
        same_bits(ref, (results, totals))

    def test_determinism(self, twin):
        ref, (r1, r2) = twin(two_runs, min_ticks=1)
        for a, b in zip(r1, r2):
            assert a.latency == b.latency
            assert a.rows_redistributed == b.rows_redistributed
        same_bits(ref, (r1, r2))

    def test_contention_slows_tenants_vs_solo(self, twin):
        """A tenant sharing the cluster can't beat its solo run."""
        ref, (shared, solo) = twin(shared_and_solo, min_ticks=1)
        for r, s in zip(shared, solo):
            assert r.latency >= s.latency * 0.999
        same_bits(ref, (shared, solo))

    def test_dyskew_beats_legacy_under_concurrency(self, twin):
        ref, (leg, dk) = twin(legacy_and_dyskew_concurrent, min_ticks=1)
        assert np.mean([r.latency for r in dk]) < np.mean([r.latency for r in leg])
        same_bits(ref, (leg, dk))

    def test_single_tenant_matches_simulator(self, twin):
        """``Simulator.run_query`` is the N=1 case of the unified loop."""
        ref, (solo, multi) = twin(simulator_and_one_tenant, min_ticks=1)
        assert multi.latency == solo.latency
        assert multi.rows_redistributed == solo.rows_redistributed
        np.testing.assert_array_equal(multi.per_worker_busy, solo.per_worker_busy)
        same_bits(ref, (solo, multi))
