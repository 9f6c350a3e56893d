"""The port's simulator against ``repro`` on the CPU: the engine, the
legacy oracle and the replay harness, driven by the same seeded workloads
on both sides.

The bar for every run is the reference's own: ``QueryResult`` fields agree
to rtol 1e-9 (counts exactly), and the distribute mask of EVERY link tick
is equal, recorded by wrapping ``AdaptiveLinkSim.tick`` and
``BatchedLinkSim.tick`` on both sides.  The trajectories are chaotic — one
flipped mask changes the whole run — so equal masks are what makes equal
results meaningful.  The port's own engine is also held to its legacy
oracle, as the reference's is.  The helpers are in ``torch_sim_common``.
"""

import numpy as np
import pytest

from torch_sim_common import PORT, TOL, assert_results_equal, default_strategies, run_both

import repro_torch.sim.engine as t_engine
import repro_torch.sim.replay as t_replay


# --------------------------------------------------------------------- #
# Single-query engine (the reference's TestEngineEquivalence cases)
# --------------------------------------------------------------------- #


def _single(m, cluster_kw, prof_fn, strategy_fn, seed, gap=None, legacy=False):
    cluster = m.engine.ClusterConfig(**cluster_kw)
    prof = prof_fn(m)
    batches = m.workload.generate_query(prof, cluster.num_workers, seed=seed)
    if gap is None:
        gap = m.replay.scan_arrival_gap(prof, cluster)
    sim_cls = m.legacy.LegacySimulator if legacy else m.engine.Simulator
    return sim_cls(cluster, strategy_fn(m, prof), seed, **m.dev).run_query(batches, gap)


def _eq_prof(m):
    return m.workload.QueryProfile(
        name="eq", n_rows=3000, mean_row_cost=1e-3, cost_sigma=1.2,
        partition_alpha=1.0, hot_fraction=0.2,
    )


def _self_skip_strategy(m, prof):
    return m.engine.StrategyConfig(
        kind="dyskew",
        dyskew=m.types.DySkewConfig(policy=m.types.Policy.EAGER_SNOWPARK, self_skip=True),
    )


class TestEngineParity:
    @pytest.mark.parametrize("legacy", [False, True], ids=["engine", "legacy"])
    @pytest.mark.parametrize("kind", ["none", "static_rr", "dyskew"])
    @pytest.mark.parametrize("seed", [0, 3])
    def test_skewed_workload_all_strategies(self, monkeypatch, kind, seed, legacy):
        ref, port = run_both(monkeypatch, lambda m: _single(
            m, dict(num_nodes=4), _eq_prof, lambda m, p: default_strategies(m, kind), seed,
            legacy=legacy,
        ), min_ticks=1 if kind == "dyskew" else 0)
        assert_results_equal(ref, port)

    @pytest.mark.parametrize("case", ["heavy_rows", "self_skip"])
    def test_guarded_cases(self, monkeypatch, case):
        if case == "heavy_rows":
            def build(m):
                return _single(m, dict(num_nodes=4),
                               lambda m: m.workload.heavy_rows_case(row_gb=1.0, n_rows=48),
                               lambda m, p: default_strategies(m, "dyskew"), 0, gap=1e-4)
        else:
            def build(m):
                return _single(m, dict(num_nodes=2), lambda m: m.workload.self_skip_case(),
                               _self_skip_strategy, 0)
        ref, port = run_both(monkeypatch, build, min_ticks=1)
        assert_results_equal(ref, port)

    @pytest.mark.parametrize("arm", ["legacy_strategy", "dyskew_strategy"])
    def test_ab_resolution_strategies(self, monkeypatch, arm):
        def prof(m):
            return m.workload.QueryProfile(
                name="eq2", n_rows=2000, mean_row_cost=2e-3, cost_sigma=0.8,
                partition_alpha=0.4, locality_constrained=True,
            )
        ref, port = run_both(monkeypatch, lambda m: _single(
            m, dict(num_nodes=2), prof, lambda m, p: getattr(m.replay, arm)(p), 1,
        ))
        assert_results_equal(ref, port)

    @pytest.mark.parametrize("kind", ["static_rr", "dyskew"])
    def test_port_engine_holds_its_legacy_oracle(self, kind):
        """The reference's own bar, on the port alone: the unified loop
        reproduces the seed engine it was rewritten from."""
        new = _single(PORT, dict(num_nodes=4), _eq_prof,
                      lambda m, p: default_strategies(m, kind), 3)
        old = _single(PORT, dict(num_nodes=4), _eq_prof,
                      lambda m, p: default_strategies(m, kind), 3, legacy=True)
        for f in ("latency", "utilization", "bytes_moved_remote"):
            np.testing.assert_allclose(getattr(new, f), getattr(old, f), **TOL)
        assert new.rows_redistributed == old.rows_redistributed
        np.testing.assert_allclose(new.per_worker_busy, old.per_worker_busy, **TOL)


# --------------------------------------------------------------------- #
# The multi-tenant loop (TestMultiTenantEquivalence, TestClosedFormDrain)
# --------------------------------------------------------------------- #


def _mixed_tenants(m, cluster):
    profiles = m.workload.multi_tenant_suite(4, seed=47)
    tenants = m.replay.staggered_tenants(profiles, cluster, m.replay.dyskew_strategy, seed=1)
    tenants[1].strategy = m.engine.StrategyConfig(kind="static_rr")
    tenants[3].strategy = m.engine.StrategyConfig(kind="none")
    return tenants


def _run_multi(m, cluster, tenants, **kw):
    sim = m.engine.MultiQuerySimulator(cluster, **kw, **m.dev)
    return sim.run(tenants), dict(sim.last_event_counts)


class TestMultiTenantParity:
    @pytest.mark.parametrize("kind", ["none", "static_rr", "dyskew"])
    def test_single_tenant(self, monkeypatch, kind):
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=2)
            prof = m.workload.QueryProfile(
                name="mt_eq", n_rows=2000, mean_row_cost=1e-3, cost_sigma=1.1,
                partition_alpha=0.8, hot_fraction=0.15,
            )
            batches = m.workload.generate_query(prof, cluster.num_workers, seed=2)
            gap = m.replay.scan_arrival_gap(prof, cluster)
            st = default_strategies(m, kind)
            return _run_multi(m, cluster, [m.engine.TenantQuery("solo", batches, st, 0.0, gap)])
        (ref, ref_ev), (port, port_ev) = run_both(monkeypatch, build)
        assert_results_equal(ref, port)
        assert port_ev == ref_ev

    @pytest.mark.parametrize("drain", [None, False], ids=["drain", "heap"])
    def test_mixed_strategy_trace(self, monkeypatch, drain):
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=2)
            return _run_multi(m, cluster, _mixed_tenants(m, cluster), closed_form_drain=drain)
        (ref, ref_ev), (port, port_ev) = run_both(monkeypatch, build, min_ticks=1)
        assert_results_equal(ref, port)
        assert port_ev == ref_ev
        assert port_ev["drain_entered"] == (0 if drain is False else 1)
        assert any(r.rows_redistributed > 0 for r in port)

    @pytest.mark.parametrize("arrival", [0.013, 1.01])
    def test_pending_join_tick(self, monkeypatch, arrival):
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=1, interpreters_per_node=4)
            st = default_strategies(m, "dyskew")
            rng = np.random.default_rng(19)
            streams_a = [[] for _ in range(cluster.num_workers)]
            streams_a[0] = [m.engine.Batch(costs=rng.exponential(1e-3, 24), sizes=np.full(24, 256.0))]
            a = m.engine.TenantQuery("a", streams_a, st, 0.0, 1e-4)
            b = m.engine.TenantQuery("b", [[] for _ in range(cluster.num_workers)], st, arrival, 1e-4)
            return _run_multi(m, cluster, [a, b], batch_ticks=True)
        (ref, ref_ev), (port, port_ev) = run_both(monkeypatch, build, min_ticks=1)
        assert_results_equal(ref, port)
        assert port_ev == ref_ev

    def test_zero_row_batch_tenant_terminates(self, monkeypatch):
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=1, interpreters_per_node=2)
            streams = [[] for _ in range(cluster.num_workers)]
            streams[0] = [m.engine.Batch(costs=np.empty(0), sizes=np.empty(0))]
            t = m.engine.TenantQuery("empty", streams, default_strategies(m, "dyskew"), 0.0, 1e-4)
            return [_run_multi(m, cluster, [t], closed_form_drain=d)[0][0] for d in (False, None)]
        ref, port = run_both(monkeypatch, build, min_ticks=2)
        assert_results_equal(ref, port)
        assert all(r.num_ticks >= 1 for r in port)


# --------------------------------------------------------------------- #
# The replay harness: the paper's Fig. 4 A/B
# --------------------------------------------------------------------- #


class TestReplayParity:
    def test_fig4_queries(self, monkeypatch):
        """Fig. 4's A/B, as the benchmark builds it, on the four queries of
        its quick mode (q10 and q19 are the two the paper singles out)."""
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=4)
            out = []
            for i, prof in enumerate(m.workload.tpcxbb_suite()):
                if prof.name not in ("q05", "q10", "q19", "q22"):
                    continue
                batches = m.workload.generate_query(prof, cluster.num_workers, seed=100 + i)
                for arm in (m.replay.legacy_strategy, m.replay.dyskew_strategy):
                    out.append(m.engine.Simulator(cluster, arm(prof), seed=i, **m.dev).run_query(batches))
            return out
        ref, port = run_both(monkeypatch, build, min_ticks=50)
        assert_results_equal(ref, port)

    def test_run_ab_serial_and_pool_device_string(self, monkeypatch):
        """``run_ab`` hands each task the device as a string; with the pool
        serial every task runs in this process."""
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=2)
            profs = m.workload.multi_tenant_suite(3, seed=5)
            res = m.replay.run_ab(profs, cluster, workers=1, **m.dev)
            return [r for arm in ("legacy", "dyskew") for r in res[arm].results]
        ref, port = run_both(monkeypatch, build, min_ticks=1)
        assert_results_equal(ref, port)

    def test_compare_suites_takes_device(self, monkeypatch):
        """``compare_suites`` hands its device to every ``run_suite``: on a
        host without a GPU the port runs it with ``device="cpu"``."""
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=2)
            profs = m.workload.customer_replay_suite(4)
            strategies = {name: m.replay.default_strategies()[name]
                          for name in ("none", "static_rr", "dyskew")}
            res = m.replay.compare_suites(profs, cluster, strategies, seed=3, **m.dev)
            assert list(res) == list(strategies)
            return [r for name in strategies for r in res[name].results]
        ref, port = run_both(monkeypatch, build, min_ticks=1)
        assert_results_equal(ref, port)

    def test_default_device_needs_a_gpu(self):
        import torch

        cluster = t_engine.ClusterConfig(num_nodes=1)
        if torch.cuda.is_available():
            assert t_engine.MultiQuerySimulator(cluster).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                t_engine.MultiQuerySimulator(cluster)
            with pytest.raises(RuntimeError, match="CUDA"):
                t_replay.run_ab([], cluster)
