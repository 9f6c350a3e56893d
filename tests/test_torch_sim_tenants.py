"""The port's many-tenant paths against ``repro`` on the CPU: the batched
link tick, the auto envelope that decides when tenants share it, the open
loop, and every registered policy run end to end.

Each run feeds both sides the same seeded workload and holds the
``QueryResult``s (rtol 1e-9, counts exactly), the event counters and the
distribute mask of every tick equal (helpers in ``torch_sim_common``).
"""

import numpy as np
import pytest

from torch_sim_common import PORT, REF, assert_results_equal, run_both

import repro.core.policy as j_policy
from repro_torch.models.convert import state_from_numpy


def _rand_inputs(rng, n):
    rows = (rng.poisson(3, n) * (rng.random(n) < 0.7)).astype(np.float64)
    sync = rng.random(n) * rows
    density = rng.random(n) * 100.0
    bpr = rng.random(n) * 2e6
    signal = rng.random(n) < 0.3
    return rows, sync, density, bpr, signal


def _configs(m):
    t = m.types
    return [
        t.DySkewConfig(policy=t.Policy.EAGER_SNOWPARK, skew_model=t.SkewModelKind.IDLE_TIME, n_strikes=2),
        t.DySkewConfig(policy=t.Policy.LATE, skew_model=t.SkewModelKind.ROW_PERCENTAGE, n_strikes=3),
        t.DySkewConfig(policy=t.Policy.LATE, skew_model=t.SkewModelKind.SYNC_TIME_SLOPE, n_strikes=2),
    ]


def _leaves(state):
    """(key path, numpy leaf) pairs of a link-state dict, in key order."""
    out = []

    def walk(prefix, tree):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(prefix + (k,), tree[k])
        else:
            out.append((prefix, np.asarray(tree.cpu() if hasattr(tree, "cpu") else tree)))

    walk((), state)
    return out


class TestBatchedLinkSim:
    @pytest.mark.parametrize("which", [0, 1, 2], ids=["idle", "rows", "slope"])
    def test_matches_reference_mixed_cadence(self, which):
        """T tenants on different cadences (through the active mask): the
        port's stacked tick against the reference's, mask for mask and
        leaf for leaf, and against T solo port links."""
        n, T, steps = 6, 5, 40
        rng = np.random.default_rng(0)
        ref = REF.batched.BatchedLinkSim(_configs(REF)[which], n, T)
        port = PORT.batched.BatchedLinkSim(_configs(PORT)[which], n, T, device="cpu")
        solo = [PORT.engine.AdaptiveLinkSim(_configs(PORT)[which], n, device="cpu") for _ in range(T)]
        for step in range(steps):
            active = np.array([step % (t + 1) == 0 for t in range(T)])
            inputs = [_rand_inputs(rng, n) for _ in range(T)]
            stacked = [np.stack([inp[k] for inp in inputs]) for k in range(5)]
            d_ref = ref.tick(*stacked, active=active)
            d_port = port.tick(*stacked, active=active)
            np.testing.assert_array_equal(d_port, d_ref, err_msg=f"step {step}")
            for t in range(T):
                if active[t]:
                    np.testing.assert_array_equal(d_port[t], solo[t].tick(*inputs[t]))
                else:
                    assert not d_port[t].any()
            for (kr, a), (kp, b) in zip(_leaves(ref.state), _leaves(port.state)):
                assert kr == kp
                np.testing.assert_array_equal(b, a, err_msg=f"step {step}: {kr}")
        for t in range(T):
            for (_, a), (_, b) in zip(_leaves(solo[t].state), _leaves(port.state)):
                np.testing.assert_array_equal(a, b[t])

    def test_inactive_rows_frozen(self):
        n, T = 4, 3
        rng = np.random.default_rng(1)
        sim = PORT.batched.BatchedLinkSim(_configs(PORT)[0], n, T, device="cpu")
        before = [x.copy() for _, x in _leaves(sim.state)]
        inputs = [np.stack([_rand_inputs(rng, n)[k]] * T) for k in range(5)]
        assert not sim.tick(*inputs, active=np.zeros(T, bool)).any()
        for a, (_, b) in zip(before, _leaves(sim.state)):
            np.testing.assert_array_equal(a, b)

    def test_capacity_padding(self):
        nxt = PORT.batched._next_pow2
        assert [nxt(1), nxt(2), nxt(129)] == [1, 2, 256]
        sim = PORT.batched.BatchedLinkSim(_configs(PORT)[0], 4, 5, device="cpu")
        assert sim.capacity == 8
        assert sim.states.shape == (5, 4)
        assert sim.state["state"].shape == (8, 4)
        # The padded rows never advance: they are masked on every tick.
        rng = np.random.default_rng(2)
        for _ in range(3):
            sim.tick(*[np.stack([_rand_inputs(rng, 4)[k]] * 5) for k in range(5)],
                     active=np.ones(5, bool))
        assert sim.ticks.tolist() == [3] * 5
        assert sim.state["tick"][5:].tolist() == [0, 0, 0]

    def test_stack_is_the_reference_tree_carried_across(self):
        ref = REF.batched.BatchedLinkSim(_configs(REF)[1], 4, 3)
        port = PORT.batched.BatchedLinkSim(_configs(PORT)[1], 4, 3, device="cpu")
        carried = state_from_numpy(ref.state, "cpu")
        for (ka, a), (kb, b) in zip(_leaves(carried), _leaves(port.state)):
            assert ka == kb and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# The auto envelope and the batched engine mode
# --------------------------------------------------------------------- #


def _suite_tenants(m, cluster, seed, num=4, arrival=None):
    profiles = m.workload.multi_tenant_suite(num, seed=seed)
    tenants = m.replay.staggered_tenants(profiles, cluster, m.replay.dyskew_strategy, seed=2)
    if arrival is not None:
        for t in tenants:
            t.arrival = arrival
    return tenants


def _run(m, cluster, tenants, **kw):
    sim = m.engine.MultiQuerySimulator(cluster, **kw, **m.dev)
    return sim.run(tenants), dict(sim.last_event_counts)


class TestAutoEnvelope:
    def test_on_grid_detection(self):
        t, grid = 0.1, [0.1]
        for _ in range(5):
            t += 0.008
            grid.append(t)
        for arrivals, interval in (([0.3, 0.3, 0.3], 0.05), ([grid[0], grid[2], grid[5]], 0.008),
                                   ([0.1, 0.1037], 0.008), ([0.0, 0.1 + 3e-18], 0.008)):
            assert (PORT.engine._arrivals_on_grid(arrivals, interval)
                    == REF.engine._arrivals_on_grid(arrivals, interval))

    @pytest.mark.parametrize("batch_ticks", [None, False, True], ids=["auto", "per_tenant", "forced"])
    def test_identical_arrival_group(self, monkeypatch, batch_ticks):
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=2)
            return _run(m, cluster, _suite_tenants(m, cluster, 51, arrival=0.02), batch_ticks=batch_ticks)
        (ref, ref_ev), (port, port_ev) = run_both(monkeypatch, build, min_ticks=1)
        assert_results_equal(ref, port)
        assert port_ev == ref_ev
        assert (port_ev["gtick"] > 0) == (batch_ticks is not False)

    def test_off_grid_group_falls_back_per_tenant(self, monkeypatch):
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=2)
            return _run(m, cluster, _suite_tenants(m, cluster, 51))
        (ref, ref_ev), (port, port_ev) = run_both(monkeypatch, build, min_ticks=1)
        assert_results_equal(ref, port)
        assert port_ev == ref_ev and port_ev["tick"] > 0

    def test_batched_groups_by_config(self, monkeypatch):
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=2)
            tenants = _suite_tenants(m, cluster, 41)
            tenants[1].strategy = m.engine.StrategyConfig(
                kind="dyskew",
                dyskew=m.types.DySkewConfig(policy=m.types.Policy.LATE,
                                            skew_model=m.types.SkewModelKind.ROW_PERCENTAGE),
                tick_interval=25e-3,
            )
            return _run(m, cluster, tenants, batch_ticks=True)
        (ref, ref_ev), (port, port_ev) = run_both(monkeypatch, build, min_ticks=1)
        assert_results_equal(ref, port)
        assert port_ev == ref_ev

    def test_grid_aligned_open_loop_batches_by_default(self, monkeypatch):
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=1)
            specs = m.workload.many_tenants_suite(16, seed=71)
            st = m.engine.StrategyConfig(
                kind="dyskew",
                dyskew=m.types.DySkewConfig(policy=m.types.Policy.LATE,
                                            skew_model=m.types.SkewModelKind.IDLE_TIME),
                tick_interval=8e-3,
            )
            proc = m.workload.ArrivalProcess(kind="poisson", rate=30.0)
            out = m.replay.run_open_loop(specs, cluster, proc, 16, seed=3, resolve=lambda p: st,
                                         grid_align=st.tick_interval, **m.dev)
            return out["results"], out["event_counts"]
        (ref, ref_ev), (port, port_ev) = run_both(monkeypatch, build, min_ticks=1)
        assert_results_equal(ref, port)
        assert port_ev == ref_ev and port_ev["gtick"] > 0


# --------------------------------------------------------------------- #
# Every registered policy, end to end (test_policy_interface's cases)
# --------------------------------------------------------------------- #


def _skewed_tenant(m, kind, seed=3, alpha=1.4):
    prof = m.workload.QueryProfile(
        name=f"t_{kind}", n_rows=4096, partition_alpha=alpha, hot_fraction=0.3, cost_sigma=0.8,
    )
    streams = m.workload.generate_query(prof, n_producers=8, seed=seed)
    return m.engine.TenantQuery(
        name=prof.name, streams=streams, strategy=m.engine.StrategyConfig(kind=kind), arrival=0.0,
    )


class TestPoliciesEndToEnd:
    @pytest.mark.parametrize("kind", sorted(j_policy.available_policies()))
    def test_engine_level_conservation(self, monkeypatch, kind):
        def build(m):
            t = _skewed_tenant(m, kind)
            cluster = m.engine.ClusterConfig(num_nodes=2, interpreters_per_node=4)
            res, ev = _run(m, cluster, [t], seed=0)
            total = sum(float(b.costs.sum()) for s in t.streams for b in s)
            return res, ev, total
        (ref, ref_ev, _), (port, port_ev, total) = run_both(monkeypatch, build)
        assert_results_equal(ref, port)
        assert port_ev == ref_ev
        assert float(np.asarray(port[0].per_worker_busy).sum()) == pytest.approx(total, rel=1e-9)

    @pytest.mark.parametrize("kind", ["p2c", "hillclimb"])
    def test_many_regime_under_batched_ticks(self, monkeypatch, kind):
        """Open-loop tenants on the shared 8 ms grid: the balanced majority
        rides the batched tick while the noisy neighbours run a registry
        policy, interleaved on one cluster."""
        def build(m):
            tick = 8e-3
            link = m.engine.StrategyConfig(
                kind="dyskew",
                dyskew=m.types.DySkewConfig(policy=m.types.Policy.LATE,
                                            skew_model=m.types.SkewModelKind.IDLE_TIME, n_strikes=2),
                tick_interval=tick,
            )

            def resolve(prof):
                if "skew" in prof.name:
                    return m.engine.StrategyConfig(kind=kind, tick_interval=tick)
                return link

            cluster = m.engine.ClusterConfig(num_nodes=2)
            specs = m.workload.many_tenants_suite(32, seed=71)
            proc = m.workload.ArrivalProcess(
                kind="poisson", rate=m.replay.open_loop_rate([p for p, _ in specs], cluster, load=3.0))
            out = m.replay.run_open_loop(specs, cluster, proc, 32, seed=1, resolve=resolve,
                                         grid_align=tick, sim_seed=7, **m.dev)
            return out["results"], out["event_counts"]
        (ref, ref_ev), (port, port_ev) = run_both(monkeypatch, build, min_ticks=1)
        assert_results_equal(ref, port)
        assert port_ev == ref_ev and port_ev["gtick"] > 0
