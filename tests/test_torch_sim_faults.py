"""The port's fault layer and pipeline layer against ``repro`` on the CPU:
the fault-tolerant runtime's detector (whose metric update and window
slopes run on the port's device), fault-injected simulator runs, and
chained-stage pipelines.

Each run feeds both sides the same seeded workload and holds the
``QueryResult``s (rtol 1e-9, counts exactly), the fault statistics and the
distribute mask of every tick equal (helpers in ``torch_sim_common``).
"""

import numpy as np
import pytest

from torch_sim_common import PORT, REF, assert_results_equal, run_both


def _fcfg(m):
    return m.ft.FaultConfig(heartbeat_interval=0.02, missed_beats_dead=2,
                            n_strikes=3, slope_window=8, min_hosts=2)


def _fs(m):
    return m.admission.FairShareConfig(quantum_rows=64.0, heavy_row_bytes=1e6)


def _tenants(m, cluster, n_tenants=3, n_rows=800, seed=3):
    prof = m.workload.QueryProfile(
        name="t", n_rows=n_rows, mean_row_cost=1.2e-3, cost_sigma=0.8,
        partition_alpha=0.6, hot_fraction=0.1,
    )
    gap = m.replay.scan_arrival_gap(prof, cluster)
    return [
        m.engine.TenantQuery(
            f"t{i}", m.workload.generate_query(prof, cluster.num_workers, seed=seed + i),
            m.replay.dyskew_strategy(prof), 0.02 * i, gap,
        )
        for i in range(n_tenants)
    ]


def _schedule(m, events):
    f = m.faults
    return f.FaultSchedule(events=tuple(f.FaultEvent(**e) for e in events))


def _fault_run(m, events, seed, **kw):
    cluster = m.engine.ClusterConfig(num_nodes=2)
    faults = None if events is None else _schedule(m, events)
    sim = m.engine.MultiQuerySimulator(
        cluster, fair_share=_fs(m), faults=faults,
        fault_cfg=_fcfg(m) if faults else None, **kw, **m.dev,
    )
    res = sim.run(_tenants(m, cluster, seed=seed))
    return res, dict(sim.last_fault_stats), dict(sim.last_event_counts)


# --------------------------------------------------------------------- #
# The runtime's detector on its own
# --------------------------------------------------------------------- #


class TestFaultTolerantRuntime:
    def test_detector_parity(self):
        """Heartbeats with a silent host, an accelerating straggler, an
        exclusion and a rejoin: every tick's report, the strikes and the
        metrics agree."""
        n = 6
        rts = [REF.ft.FaultTolerantRuntime(n), PORT.ft.FaultTolerantRuntime(n, device="cpu")]
        rng = np.random.default_rng(4)
        for k in range(40):
            now = (k + 1) * 10.0
            steps = rng.uniform(0.9, 1.1, n)
            steps[2] *= 1.0 + 0.15 * k            # host 2 slows down, faster and faster
            reports = []
            for rt in rts:
                for h in range(n):
                    if rt.hosts[h].alive and not (h == 4 and 10 <= k < 20):   # host 4 goes silent
                        rt.heartbeat(h, now, float(steps[h]))
                reports.append(rt.tick(now))
                if reports[-1]["failed"] or reports[-1]["stragglers"]:
                    rt.exclude(reports[-1]["failed"] + reports[-1]["stragglers"])
                if k == 30:
                    rt.rejoin(4, now)
            assert reports[0] == reports[1], k
            np.testing.assert_array_equal(rts[0].strikes, rts[1].strikes)
            for key, a in rts[0].metrics.items():
                b = rts[1].metrics[key]
                assert b.dtype == a.dtype == np.float32, key
                np.testing.assert_array_equal(b, a, err_msg=f"tick {k}: {key}")
        assert rts[0].events == rts[1].events and rts[0].events
        assert rts[0].survivors() == rts[1].survivors()

    def test_default_device_needs_a_gpu(self):
        import torch

        if torch.cuda.is_available():
            assert PORT.ft.FaultTolerantRuntime(2).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                PORT.ft.FaultTolerantRuntime(2)


# --------------------------------------------------------------------- #
# Fault-injected simulator runs (test_faults' grid)
# --------------------------------------------------------------------- #

CRASH = dict(time=0.05, kind="crash", worker=1)
SCHEDULES = {
    "empty": [],
    "single_crash": [CRASH],
    "crash_with_repair": [
        dict(time=0.05, kind="crash", worker=2, duration=0.2),
        dict(time=0.08, kind="crash", worker=5, duration=0.3),
    ],
    "preempt_with_notice": [
        dict(time=0.04, kind="preempt", worker=0, notice=0.02, duration=0.25),
        dict(time=0.10, kind="preempt", worker=3, notice=0.02, duration=0.25),
    ],
    "mixed_kinds": [
        dict(time=0.03, kind="crash", worker=3),
        dict(time=0.05, kind="preempt", worker=5, notice=0.03, duration=0.4),
        dict(time=0.02, kind="slowdown", worker=1, factor=4.0, duration=0.3),
        dict(time=0.04, kind="nic_degrade", worker=0, factor=3.0, duration=0.2),
    ],
}


class TestFaultRuns:
    @pytest.mark.parametrize("name", sorted(SCHEDULES))
    def test_schedule_parity(self, monkeypatch, name):
        seed = {"crash_with_repair": 7, "preempt_with_notice": 5}.get(name, 3)
        kw = {}
        if name == "mixed_kinds":
            kw = {"deadline_aware": True}

        def build(m):
            if name == "mixed_kinds":
                kw["deadline_cfg"] = m.admission.DeadlineConfig()
            return _fault_run(m, SCHEDULES[name], seed, **kw)
        (ref, ref_stats, ref_ev), (port, port_stats, port_ev) = run_both(monkeypatch, build, min_ticks=1)
        assert_results_equal(ref, port)
        assert repr(port_stats) == repr(ref_stats)
        assert port_ev == ref_ev
        if name == "single_crash":
            assert port_stats["detections"] >= 1
            assert sum(port_stats["recovered_rows"]) > 0

    def test_empty_schedule_is_the_fault_free_run(self, monkeypatch):
        (ref, _, _), (port, _, _) = run_both(monkeypatch, lambda m: _fault_run(m, None, 11))
        empty, _, _ = _fault_run(PORT, [], 11)
        assert_results_equal(port, empty)
        assert_results_equal(ref, port)

    @pytest.mark.parametrize("seed,slowdown", [(0, False), (2, True)])
    def test_hazard_draw(self, monkeypatch, seed, slowdown):
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=2)
            n = cluster.num_workers
            sched = m.faults.hazard_schedule(
                seed=seed, num_workers=n, num_nodes=cluster.num_nodes, horizon=1.5,
                crash_rate=3.0, preempt_rate=3.0, slowdown_rate=2.0 if slowdown else 0.0,
                mttr=0.3, min_live=max(2, n // 2),
            )
            sim = m.engine.MultiQuerySimulator(cluster, fair_share=_fs(m), faults=sched,
                                               fault_cfg=_fcfg(m), **m.dev)
            res = sim.run(_tenants(m, cluster, seed=seed))
            return res, repr(sim.last_fault_stats)
        (ref, ref_stats), (port, port_stats) = run_both(monkeypatch, build, min_ticks=1)
        assert_results_equal(ref, port)
        assert port_stats == ref_stats

    def test_retry_backoff_path(self, monkeypatch):
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=2, interpreters_per_node=4, network_latency=0.06)
            prof = m.workload.QueryProfile(
                name="t", n_rows=1200, mean_row_cost=1e-3, cost_sigma=0.8,
                partition_alpha=0.8, hot_fraction=0.2,
            )
            tenants = [m.engine.TenantQuery(
                "t", m.workload.generate_query(prof, cluster.num_workers, seed=11),
                m.replay.dyskew_strategy(prof), 0.0, 1e-4,
            )]
            sched = _schedule(m, [dict(time=0.03, kind="preempt", worker=w, notice=0.02, duration=0.5)
                                  for w in (4, 5, 6)])
            sim = m.engine.MultiQuerySimulator(cluster, faults=sched, fault_cfg=_fcfg(m), **m.dev)
            return sim.run(tenants), dict(sim.last_fault_stats)
        (ref, ref_stats), (port, port_stats) = run_both(monkeypatch, build, min_ticks=1)
        assert_results_equal(ref, port)
        assert repr(port_stats) == repr(ref_stats)
        assert port_stats["transfer_retries"] > 0 and port_stats["unrecovered_rows"] == 0


# --------------------------------------------------------------------- #
# Chained-stage pipelines (test_pipeline's cases)
# --------------------------------------------------------------------- #


def _fanout_rand(keys, rng):
    return rng.integers(0, 4, len(keys))


def _stages(m, shuffles, kind, fanout=None):
    specs = [
        m.pipeline.StageSpec(name=f"s{i}", shuffle=sh, mean_row_cost=2e-4,
                             fanout_fn=fanout, batch_rows=64)
        for i, sh in enumerate(shuffles)
    ]
    return m.pipeline.override_strategy(specs, kind)


def _inputs(m, n_rows, alpha=1.2):
    return [
        m.pipeline.PipelineInput(name="a", n_rows=n_rows, num_keys=64, zipf_alpha=alpha),
        m.pipeline.PipelineInput(name="b", n_rows=max(n_rows // 2, 8), num_keys=32,
                                 zipf_alpha=0.0, partition="rr"),
    ]


def _assert_pipeline_equal(ref, port):
    assert port.makespan == pytest.approx(ref.makespan, rel=1e-9, abs=0)
    assert port.rows_out == ref.rows_out
    for a, b in zip(ref.stages, port.stages):
        np.testing.assert_array_equal(b.input_rows_per_worker, a.input_rows_per_worker)
        np.testing.assert_allclose(b.busy_per_worker, a.busy_per_worker, rtol=1e-9, atol=0)
        np.testing.assert_allclose(b.completions, a.completions, rtol=1e-9, atol=0)
        assert_results_equal(a.results, b.results)


class TestPipelineParity:
    @pytest.mark.parametrize("kind", ["none", "static_rr", "dyskew", "p2c"])
    def test_two_stage_pipeline(self, monkeypatch, kind):
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=2, interpreters_per_node=4)
            sim = m.pipeline.PipelineSimulator(
                cluster, _stages(m, ["hash", "worker"], kind, fanout=_fanout_rand), seed=3, **m.dev)
            return sim.run(_inputs(m, 120))
        ref, port = run_both(monkeypatch, build)
        _assert_pipeline_equal(ref, port)

    def test_suite_scenario_through_run_pipeline_ab(self, monkeypatch):
        """One scenario of the quick pipeline suite, A/B over three arms
        with the pool serial, as the pipeline bench runs it."""
        def build(m):
            cluster = m.engine.ClusterConfig(num_nodes=2)
            name, stages, inputs = m.workload.pipeline_suite(quick=True)[1]
            return name, m.replay.run_pipeline_ab(stages, inputs, cluster, seed=13, **m.dev)
        (ref_name, ref), (port_name, port) = run_both(monkeypatch, build, min_ticks=1)
        assert port_name == ref_name
        assert sorted(port) == sorted(ref)
        for arm in ref:
            a, b = ref[arm], port[arm]
            assert a.keys() == b.keys()
            for key in a:
                if isinstance(a[key], list) and a[key] and isinstance(a[key][0], str):
                    assert b[key] == a[key], (arm, key)
                else:
                    np.testing.assert_allclose(
                        np.asarray(b[key], float), np.asarray(a[key], float),
                        rtol=1e-9, atol=0, equal_nan=True, err_msg=f"{arm}: {key}",
                    )
