"""The port's serving engine against ``repro.serving.engine`` on the CPU.

The engine is host numpy on both sides; its one tensor site is the DySkew
rebalance pass (``AdaptiveLink.step``), whose float32 KV byte counts feed
the cost gate.  Every case runs the reference and the port on the same
requests and holds the results EQUAL, key for key (floats included: the
same host arithmetic on the same destinations), then keeps the reference
test's own assertions on the port's result.  Mirrors ``TestServing`` of
``tests/test_substrate.py``, the serving cases of ``tests/test_slo_layer.py``
and ``tests/test_extra_coverage.py``, and the serving half of
``tests/test_policy_interface.py::TestServingAndDataResolution``.
"""

import math

import numpy as np
import pytest
import torch

import repro.serving.engine as j_engine
import repro_torch.serving.engine as t_engine
from repro.launch import serve as j_serve
from repro_torch.launch import serve as t_serve

CPU = "cpu"


def assert_same(a, b, where="result"):
    """Equal key for key: same keys, same types, floats bit-equal (NaN
    equal to NaN)."""
    assert type(a) is type(b), (where, type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b), (where, list(a), list(b))
        for k in a:
            assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, float):
        assert a == b or (math.isnan(a) and math.isnan(b)), (where, a, b)
    else:
        assert a == b, (where, a, b)


def run_both(cfg_kw, make_requests, seed=0, patch=None, moves=None):
    """The port's result of one run, after holding it equal to the
    reference's, and every rebalance pass's moves too, call by call
    (appended to ``moves`` when given).  ``patch(engine)`` may wrap the
    engine before it runs."""
    out, calls = [], []
    for m, kw in ((j_engine, {}), (t_engine, {"device": CPU})):
        eng = m.ServingEngine(m.ServeConfig(**cfg_kw), seed=seed, **kw)
        if patch is not None:
            patch(eng)
        log, inner = [], eng.sched.rebalance

        def rebalance(queued, load_tokens, _inner=inner, _log=log):
            _log.append(dict(_inner(queued, load_tokens)))
            return _log[-1]
        eng.sched.rebalance = rebalance
        out.append(eng.run(make_requests(m)))
        calls.append(log)
    assert_same(*out)
    assert calls[0] == calls[1]
    if moves is not None:
        moves.extend(calls[1])
    return out[1]


def _requests(m, n=64, skew=False, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        new = int(rng.integers(300, 400)) if (skew and i % 7 == 0) else int(rng.integers(20, 60))
        out.append(m.Request(rid=i, prompt_len=int(rng.integers(64, 512)),
                             max_new_tokens=new, arrival=float(i) * 0.02))
    return out


class TestServing:
    @pytest.mark.parametrize("scheduler", ["dyskew", "round_robin", "least_loaded", "p2c"])
    def test_completes_all_requests(self, scheduler):
        res = run_both(dict(num_replicas=4, scheduler=scheduler), _requests)
        assert res["completed"] == 64

    def test_dyskew_beats_round_robin_on_skew(self):
        reqs = lambda m: _requests(m, skew=True, seed=3)
        rr = run_both(dict(scheduler="round_robin"), reqs)
        dk = run_both(dict(scheduler="dyskew"), reqs)
        assert dk["p99_latency"] <= rr["p99_latency"] * 1.05
        assert dk["mean_latency"] <= rr["mean_latency"]

    def test_heavy_kv_requests_not_thrashed(self):
        res = run_both(dict(num_replicas=4, scheduler="dyskew", kv_bytes_per_token=4e6),
                       lambda m: _requests(m, skew=True))
        assert res["migrations"] <= 4

    def test_forward_migration_terminates(self):
        def patch(eng):
            orig, forced = eng.sched.rebalance, []

            def force_one(queued, load_tokens):
                if queued and not forced:
                    forced.append(True)
                    r = queued[0]
                    return {r.rid: (r.replica + 2) % eng.cfg.num_replicas}
                return orig(queued, load_tokens)
            eng.sched.rebalance = force_one

        res = run_both(dict(num_replicas=4, scheduler="dyskew"), lambda m: _requests(m, n=16), patch=patch)
        assert res["completed"] == 16
        assert res["migrations"] == 1


class TestServingTimeline:
    def test_prefill_latency_floor(self):
        res = run_both(dict(num_replicas=1, max_batch=4, prefill_rate=10_000.0, decode_rate=1_000.0),
                       lambda m: [m.Request(rid=0, prompt_len=40_000, max_new_tokens=100, arrival=0.0)])
        assert res["completed"] == 1
        assert res["mean_latency"] >= 40_000 / 10_000.0 + 100 / 1_000.0 - 2 * 10e-3

    def test_migration_charges_delay_but_not_unprefilled_kv(self):
        def reqs(m):
            out = [m.Request(rid=0, prompt_len=64, max_new_tokens=5_000, arrival=0.0)]
            return out + [m.Request(rid=1 + i, prompt_len=64, max_new_tokens=400, arrival=0.001)
                          for i in range(12)]
        cfg = dict(num_replicas=2, max_batch=2, decode_rate=500.0, scheduler="dyskew")
        moves = []
        res = run_both(cfg, reqs, moves=moves)
        assert sum(len(mv) for mv in moves) == res["migrations"]
        assert res["completed"] == 13
        assert res["migrations"] > 0
        assert res["migrated_gb"] == 0.0
        assert res["migration_delay_s"] == pytest.approx(res["migrations"] * 2e-3)

    def test_kv_counts_only_materialized_tokens(self):
        for m in (j_engine, t_engine):
            r = m.Request(rid=0, prompt_len=512, max_new_tokens=64, arrival=0.0)
            assert r.kv_len == 0
            r.prefilled, r.generated = 512, 10
            assert r.kv_len == 522 and r.kv_bytes(2.0) == pytest.approx(1044.0)

    def test_truncation_is_reported_not_silent(self):
        res = run_both(dict(num_replicas=1, max_batch=1, decode_rate=1.0, max_sim_s=0.5),
                       lambda m: [m.Request(rid=i, prompt_len=16, max_new_tokens=10_000, arrival=0.0)
                                  for i in range(3)])
        assert res["truncated"] and res["incomplete"] == 3 and res["completed"] == 0

    def test_slot_preemption_rescues_gold_deadlines(self):
        def reqs(m):
            return [m.Request(rid=i, prompt_len=128, max_new_tokens=60 if i % 4 == 0 else 400,
                              arrival=i * 0.01, tenant=0 if i % 4 == 0 else 1) for i in range(40)]
        cfg = dict(num_replicas=2, max_batch=4, decode_rate=2_000.0, tenant_weights=(1.0, 1.0),
                   slo_targets=(0.5, None), deadline_aware=True, preemption=True)
        res = run_both(cfg, reqs)
        assert res["preemptions"] > 0
        assert res["per_tenant"][0]["slo_attainment"] >= 0.9
        assert res["per_tenant"][0]["p99_tardiness"] <= 0.1
        assert "slo_attainment" in res

    def test_fair_share_without_deadlines(self):
        def reqs(m):
            return [m.Request(rid=i, prompt_len=96, max_new_tokens=80 + 40 * (i % 3),
                              arrival=i * 0.005, tenant=i % 3) for i in range(48)]
        res = run_both(dict(num_replicas=3, max_batch=4, tenant_weights=(3.0, 1.0, 1.0)), reqs)
        assert set(res["per_tenant"]) == {0, 1, 2}

    @pytest.mark.parametrize("bad", ["deadline_no_weights", "preempt_no_deadline", "no_slos", "slo_length"])
    def test_config_errors_raise_alike(self, bad):
        kw = {
            "deadline_no_weights": dict(deadline_aware=True),
            "preempt_no_deadline": dict(preemption=True),
            "no_slos": dict(tenant_weights=(1.0,), deadline_aware=True),
            "slo_length": dict(tenant_weights=(1.0, 1.0), slo_targets=(0.5,), deadline_aware=True),
        }[bad]
        msgs = []
        for m, dkw in ((j_engine, {}), (t_engine, {"device": CPU})):
            with pytest.raises(ValueError) as err:
                m.ServingEngine(m.ServeConfig(**kw), **dkw).run(
                    [m.Request(rid=0, prompt_len=8, max_new_tokens=4, arrival=0.0)])
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]


class TestServingMigration:
    def test_skewed_queues_trigger_migration(self):
        res = run_both(dict(num_replicas=4, scheduler="dyskew", kv_bytes_per_token=1e3),
                       lambda m: [m.Request(rid=i, prompt_len=64, max_new_tokens=500, arrival=0.0)
                                  for i in range(32)])
        assert res["completed"] == 32

    def test_round_robin_spreads_placement(self):
        res = run_both(dict(num_replicas=4, scheduler="round_robin"),
                       lambda m: [m.Request(rid=i, prompt_len=64, max_new_tokens=10, arrival=0.0)
                                  for i in range(8)])
        assert res["completed"] == 8 and res["migrations"] == 0


class TestSchedulerResolution:
    def test_serving_aliases_resolve(self):
        for sched, kind in (("round_robin", "static_rr"), ("least_loaded", "none"), ("p2c", "p2c")):
            s = t_engine.ServingScheduler(t_engine.ServeConfig(num_replicas=4, scheduler=sched), device=CPU)
            assert s.policy.name == kind

    def test_serving_unknown_scheduler_raises(self):
        with pytest.raises(ValueError, match="bogus"):
            t_engine.ServingScheduler(t_engine.ServeConfig(num_replicas=4, scheduler="bogus"), device=CPU)

    def test_serving_p2c_places_like_the_reference(self):
        load = np.array([5.0, 0.0, 3.0, 1.0])
        js = j_engine.ServingScheduler(j_engine.ServeConfig(num_replicas=4, scheduler="p2c"))
        ts = t_engine.ServingScheduler(t_engine.ServeConfig(num_replicas=4, scheduler="p2c"), device=CPU)
        got = [ts.place(None, load) for _ in range(16)]
        assert got == [js.place(None, load) for _ in range(16)]
        assert all(0 <= g < 4 for g in got)

    def test_default_device_needs_a_gpu(self):
        cfg = t_engine.ServeConfig()
        if torch.cuda.is_available():
            assert t_engine.ServingEngine(cfg).sched.link.device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                t_engine.ServingEngine(cfg)


class TestServeLauncher:
    @pytest.mark.parametrize("scheduler", ["dyskew", "round_robin"])
    def test_cli_prints_the_reference_result(self, scheduler, capsys, monkeypatch):
        argv = ["--requests", "32", "--scheduler", scheduler]
        monkeypatch.setattr("sys.argv", ["serve"] + argv)
        j_serve.main()
        want = capsys.readouterr().out
        t_serve.main(argv + ["--device", "cpu"])
        got = capsys.readouterr().out
        assert got == want and "completed: 32" in got
