"""The port's core link (types, skew models, state machine) against
``repro``: the same numpy inputs drive both, tick by tick, on the CPU.

Integer leaves (state, strikes, transitions, tick) and the distribute mask
must be EQUAL; float metrics agree to rtol 1e-6 (float32 sums over the
siblings may be taken in another order by the two frameworks, which moves
the last bit or two of a float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import skew_models as jsk
from repro.core import state_machine as jsm
from repro.core import types as jty
from repro_torch.core import skew_models as tsk
from repro_torch.core import state_machine as tsm
from repro_torch.core import types as tty

CPU = "cpu"
FLOAT_RTOL = 1e-6
INT_LEAVES = ("state", "strikes", "transitions", "tick")


def _jcfg(policy, model, looping, **kw):
    return jty.DySkewConfig(
        policy=jty.Policy[policy], skew_model=jty.SkewModelKind[model],
        looping=looping, **kw,
    )


def _tcfg(policy, model, looping, **kw):
    return tty.DySkewConfig(
        policy=tty.Policy[policy], skew_model=tty.SkewModelKind[model],
        looping=looping, **kw,
    )


def _tick_inputs(rng, shape, step):
    """One tick of sibling metrics: a hot instance in bursts (so the skew
    models fire and clear), idle instances, occasional heavy rows."""
    n = shape[-1]
    hot = (step // 7) % 2 == 0
    rows = rng.integers(0, 50, size=shape).astype(np.float32)
    if hot:
        rows[..., 0] += 400.0
        rows[..., n // 2:] = 0.0
    sync = (rows * rng.uniform(0.5, 1.5, size=shape)).astype(np.float32)
    density = np.where(
        rng.random(shape) < 0.3, rng.uniform(1, 30, size=shape), rows * 40.0
    ).astype(np.float32)
    bpr = np.where(rng.random(shape) < 0.3, 5e6, 100.0).astype(np.float32)
    signal = rng.random(shape) < 0.05
    return dict(
        rows_this_tick=rows, sync_time_this_tick=sync, batch_density=density,
        bytes_per_row=bpr, signal_this_tick=signal,
    )


def _assert_link_equal(jl, tl, where):
    for key in INT_LEAVES:
        a, b = np.asarray(jl[key]), tl[key].numpy()
        assert b.dtype == np.int32, (key, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"{where}: {key}")
    for key, a in jl["metrics"].items():
        b = tl["metrics"][key].numpy()
        assert b.dtype == np.float32 and b.shape == np.asarray(a).shape
        np.testing.assert_allclose(
            np.asarray(a), b, rtol=FLOAT_RTOL, atol=0, err_msg=f"{where}: {key}"
        )


POLICIES = ("NEVER", "LATE", "EARLY", "EAGER_SNOWPARK")
MODELS = ("ROW_PERCENTAGE", "IDLE_TIME", "SYNC_TIME_SLOPE")


class TestTickParity:
    @pytest.mark.parametrize("looping", [False, True])
    @pytest.mark.parametrize("model", MODELS)
    @pytest.mark.parametrize("policy", POLICIES)
    def test_sixty_ticks(self, policy, model, looping):
        n, ticks = 8, 60
        kw = dict(n_strikes=2, theta=0.6, heavy_row_bytes=1e6)
        jc, tc = _jcfg(policy, model, looping, **kw), _tcfg(policy, model, looping, **kw)
        jl = jty.link_state_init(n, jc)
        tl = tty.link_state_init(n, tc, device=CPU)
        _assert_link_equal(jl, tl, "init")
        jtick = jax.jit(lambda l, kws: jsm.tick(l, jc, **kws))
        rng = np.random.default_rng(
            [POLICIES.index(policy), MODELS.index(model), int(looping)]
        )
        seen_remote = False
        for step in range(ticks):
            inp = _tick_inputs(rng, (n,), step)
            jl, jd = jtick(jl, {k: jnp.asarray(v) for k, v in inp.items()})
            tl, td = tsm.tick(tl, tc, **{k: torch.from_numpy(v) for k, v in inp.items()})
            np.testing.assert_array_equal(
                np.asarray(jd), td.numpy(), err_msg=f"distribute at tick {step}"
            )
            assert td.dtype == torch.bool
            _assert_link_equal(jl, tl, f"tick {step}")
            seen_remote |= bool(td.any())
        # The inputs are meant to exercise the machine, not idle it.
        assert seen_remote == (policy != "NEVER")

    @pytest.mark.parametrize("policy", POLICIES)
    def test_without_signal(self, policy):
        n = 5
        jc, tc = _jcfg(policy, "IDLE_TIME", True), _tcfg(policy, "IDLE_TIME", True)
        jl, tl = jty.link_state_init(n, jc), tty.link_state_init(n, tc, device=CPU)
        rng = np.random.default_rng(7)
        for step in range(50):
            inp = _tick_inputs(rng, (n,), step)
            inp.pop("signal_this_tick")
            jl, jd = jsm.tick(jl, jc, **{k: jnp.asarray(v) for k, v in inp.items()})
            tl, td = tsm.tick(tl, tc, **{k: torch.from_numpy(v) for k, v in inp.items()})
            np.testing.assert_array_equal(np.asarray(jd), td.numpy())
            _assert_link_equal(jl, tl, f"tick {step}")


class TestTickManyParity:
    @pytest.mark.parametrize("model", MODELS)
    @pytest.mark.parametrize("policy", ("LATE", "EAGER_SNOWPARK"))
    def test_masked_rows(self, policy, model):
        T, n, ticks = 5, 6, 50
        kw = dict(n_strikes=2, theta=0.6)
        jc, tc = _jcfg(policy, model, True, **kw), _tcfg(policy, model, True, **kw)
        one_j = jty.link_state_init(n, jc)
        jl = jax.tree.map(lambda a: jnp.broadcast_to(a, (T,) + a.shape), one_j)
        one_t = tty.link_state_init(n, tc, device=CPU)
        tl = {
            k: ({m: v.expand(T, *v.shape).clone() for m, v in val.items()}
                if isinstance(val, dict) else val.expand(T, *val.shape).clone())
            for k, val in one_t.items()
        }
        rng = np.random.default_rng(11)
        jmany = jax.jit(lambda l, kws, act: jsm.tick_many(l, jc, active=act, **kws))
        for step in range(ticks):
            inp = _tick_inputs(rng, (T, n), step)
            # Tenant 4 arrives at tick 10, tenant 1 drains at tick 30, the
            # others flicker: mixed cadence.
            active = rng.random(T) < 0.7
            active[4] = step >= 10
            active[1] = step < 30
            before = {k: tl[k].clone() for k in INT_LEAVES}
            jl, jd = jmany(jl, {k: jnp.asarray(v) for k, v in inp.items()}, jnp.asarray(active))
            tl, td = tsm.tick_many(
                tl, tc, active=torch.from_numpy(active),
                **{k: torch.from_numpy(v) for k, v in inp.items()},
            )
            np.testing.assert_array_equal(np.asarray(jd), td.numpy())
            _assert_link_equal(jl, tl, f"tick {step}")
            for k in INT_LEAVES:  # inactive rows are frozen bit for bit
                assert torch.equal(tl[k][~torch.from_numpy(active)],
                                   before[k][~torch.from_numpy(active)])
            assert not td[~torch.from_numpy(active)].any()

    def test_no_mask_equals_row_by_row_tick(self):
        T, n = 4, 7
        tc = _tcfg("LATE", "ROW_PERCENTAGE", False, n_strikes=2)
        one = tty.link_state_init(n, tc, device=CPU)
        many = {
            k: ({m: v.expand(T, *v.shape).clone() for m, v in val.items()}
                if isinstance(val, dict) else val.expand(T, *val.shape).clone())
            for k, val in one.items()
        }
        singles = [tty.link_state_init(n, tc, device=CPU) for _ in range(T)]
        rng = np.random.default_rng(3)
        for step in range(20):
            inp = {k: torch.from_numpy(v) for k, v in _tick_inputs(rng, (T, n), step).items()}
            many, dm = tsm.tick_many(many, tc, **inp)
            for t in range(T):
                singles[t], d1 = tsm.tick(singles[t], tc, **{k: v[t] for k, v in inp.items()})
                assert torch.equal(dm[t], d1)
                for k in INT_LEAVES:
                    assert torch.equal(many[k][t], singles[t][k])
                for k, v in singles[t]["metrics"].items():
                    assert torch.equal(many["metrics"][k][t], v)


class TestSkewModelParity:
    """Function by function, on metrics made in numpy."""

    @staticmethod
    def _metrics(seed, n=9, w=8):
        rng = np.random.default_rng(seed)
        m = {
            "rows": rng.uniform(0, 1000, n).astype(np.float32),
            "idle_ticks": rng.integers(0, 5, n).astype(np.float32),
            "sync_window": np.cumsum(rng.uniform(0, 10, (n, w)), -1).astype(np.float32),
            "batch_density": rng.uniform(0, 100, n).astype(np.float32),
            "bytes_per_row": rng.choice([100.0, 5e6], n).astype(np.float32),
        }
        return ({k: jnp.asarray(v) for k, v in m.items()},
                {k: torch.from_numpy(v) for k, v in m.items()})

    @pytest.mark.parametrize("seed", range(4))
    def test_mean_of_others(self, seed):
        jm, tm = self._metrics(seed)
        np.testing.assert_allclose(
            np.asarray(jsk._mean_of_others(jm["rows"])),
            tsk._mean_of_others(tm["rows"]).numpy(), rtol=FLOAT_RTOL,
        )

    def test_mean_of_others_single_instance_is_inf(self):
        out = tsk._mean_of_others(torch.tensor([3.0]))
        assert torch.isinf(out).all() and (out > 0).all()
        assert not tsk.row_percentage_skew({"rows": torch.tensor([3.0])}, 0.5).any()
        assert not tsk.idle_time_skew({"idle_ticks": torch.tensor([0.0])}, 2, 0.5).any()

    @pytest.mark.parametrize("seed", range(4))
    def test_sync_slope(self, seed):
        jm, tm = self._metrics(seed)
        np.testing.assert_allclose(
            np.asarray(jsk.sync_slope(jm["sync_window"])),
            tsk.sync_slope(tm["sync_window"]).numpy(), rtol=1e-5,
        )  # rtol 1e-5: the centred sums cancel, which amplifies the last bit

    @pytest.mark.parametrize("seed", range(4))
    @pytest.mark.parametrize("model", MODELS)
    def test_detect_skew(self, model, seed):
        jm, tm = self._metrics(seed)
        jc, tc = _jcfg("LATE", model, False), _tcfg("LATE", model, False)
        np.testing.assert_array_equal(
            np.asarray(jsk.detect_skew(jm, jc)), tsk.detect_skew(tm, tc).numpy()
        )

    @pytest.mark.parametrize("seed", range(4))
    def test_heavy_rows_and_disable(self, seed):
        jm, tm = self._metrics(seed)
        jc, tc = _jcfg("LATE", "IDLE_TIME", False), _tcfg("LATE", "IDLE_TIME", False)
        np.testing.assert_array_equal(
            np.asarray(jsk.batch_density_heavy_rows(jm, jc)),
            tsk.batch_density_heavy_rows(tm, tc).numpy(),
        )
        np.testing.assert_array_equal(
            np.asarray(jsk.heavy_row_disable(jm, jc)),
            tsk.heavy_row_disable(tm, tc).numpy(),
        )

    @pytest.mark.parametrize("n_strikes", [1, 2, 3])
    def test_apply_n_strikes(self, n_strikes):
        rng = np.random.default_rng(n_strikes)
        skewed = rng.random(16) < 0.5
        strikes = rng.integers(0, 4, 16).astype(np.int32)
        jf, js = jsk.apply_n_strikes(jnp.asarray(skewed), jnp.asarray(strikes), n_strikes)
        tf, ts = tsk.apply_n_strikes(torch.from_numpy(skewed), torch.from_numpy(strikes), n_strikes)
        np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
        np.testing.assert_array_equal(np.asarray(js), ts.numpy())
        assert ts.dtype == torch.int32


class TestTypes:
    def test_enums_and_config_match(self):
        for name in ("LinkState", "Policy", "SkewModelKind"):
            je, te = getattr(jty, name), getattr(tty, name)
            assert {m.name: int(m) for m in je} == {m.name: int(m) for m in te}
        import dataclasses
        jf = {f.name: f.default for f in dataclasses.fields(jty.DySkewConfig)}
        tf = {f.name: f.default for f in dataclasses.fields(tty.DySkewConfig)}
        assert {k: (int(v) if hasattr(v, "name") else v) for k, v in jf.items()} == \
               {k: (int(v) if hasattr(v, "name") else v) for k, v in tf.items()}
        assert tty.NUM_STATES == jty.NUM_STATES

    def test_link_state_leaves(self):
        cfg = tty.DySkewConfig(slope_window=5)
        jl = jty.link_state_init(3, jty.DySkewConfig(slope_window=5))
        tl = tty.link_state_init(3, cfg, device=CPU)
        _assert_link_equal(jl, tl, "init")
        assert tl["metrics"]["sync_window"].shape == (3, 5)
        assert tl["tick"].shape == ()

    def test_state_predicates(self):
        s = torch.arange(tty.NUM_STATES, dtype=torch.int32)
        np.testing.assert_array_equal(
            tsm.routes_remote(s).numpy(), [tty.LinkState(i).routes_remote for i in range(6)]
        )
        np.testing.assert_array_equal(
            tsm.is_terminal(s).numpy(), [tty.LinkState(i).is_terminal for i in range(6)]
        )

    def test_default_device_needs_a_gpu(self):
        if torch.cuda.is_available():
            assert tty.link_state_init(2, tty.DySkewConfig())["state"].is_cuda
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                tty.link_state_init(2, tty.DySkewConfig())

    def test_routing_plan_is_a_plain_dataclass(self):
        plan = tty.RoutingPlan(dest=torch.zeros(4, dtype=torch.int32),
                               distribute=torch.zeros(2, dtype=torch.bool))
        assert plan.est_bytes_moved is None and plan.est_time_saved is None
