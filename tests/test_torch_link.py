"""The port's link layer against ``repro`` on the CPU: ordered sums, the
routing planners, the cost gate, ``AdaptiveLink.step``, the policy seam
and the contract data.

The same numpy inputs drive both sides.  Destinations, distribute masks
and integer leaves must be EQUAL; float loads and estimates agree to rtol
1e-6 (the port sums loads in item order, as XLA's scatter on the host
does, so in practice they are equal too).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import adaptive_link as jal
from repro.core import admission as jadm
from repro.core import contracts as jcon
from repro.core import policy as jpol
from repro.core import redistribution as jrd
from repro.core import types as jty
from repro_torch.core import adaptive_link as tal
from repro_torch.core import admission as tadm
from repro_torch.core import contracts as tcon
from repro_torch.core import ordered_sums as osum
from repro_torch.core import policy as tpol
from repro_torch.core import redistribution as trd
from repro_torch.core import types as tty
from repro_torch.models.convert import state_from_numpy

CPU = "cpu"
FLOAT_RTOL = 1e-6
INT_LEAVES = ("state", "strikes", "transitions", "tick")


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _sequential_scatter(base, index, values):
    """Oracle: float32 adds one at a time in item order (``ufunc.at`` is
    unbuffered and walks the indices in order)."""
    out = np.array(base, np.float32)
    np.add.at(out, index, np.asarray(values, np.float32))
    return out


def _sequential_last(x):
    acc = np.zeros(x.shape[:-1], np.float32)
    for i in range(x.shape[-1]):
        acc = (acc + x[..., i]).astype(np.float32)
    return acc


def _xla_host_last(x):
    """Oracle of XLA's host order for a reduce over the last axis: in order
    up to 32 elements; wider, windows of 32 (the zero padding split, the odd
    zero at the end) summed in order, repeated until 32 or fewer remain."""
    x = np.asarray(x, np.float32)
    while x.shape[-1] > 32:
        pad = -x.shape[-1] % 32
        x = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(pad // 2, pad - pad // 2)])
        x = _sequential_last(x.reshape(x.shape[:-1] + (-1, 32)))
    return _sequential_last(x)


# --------------------------------------------------------------------- #
# Ordered sums
# --------------------------------------------------------------------- #


class TestOrderedSums:
    @pytest.mark.parametrize("with_base", [False, True])
    @pytest.mark.parametrize("items,slots", [(5000, 7), (300, 3), (1, 4)])
    def test_scatter_add_adds_in_item_order(self, items, slots, with_base):
        rng = np.random.default_rng(items + slots)
        index = rng.integers(0, slots, items)
        index[: items // 3] = 0           # one long segment
        rng.shuffle(index)
        values = (rng.standard_normal(items) * 10 ** rng.uniform(-3, 3, items)).astype(np.float32)
        base = (rng.standard_normal(slots) * 100).astype(np.float32) if with_base else np.zeros(slots, np.float32)
        got = osum.scatter_add(_t(base), _t(index), _t(values)).numpy()
        np.testing.assert_array_equal(got, _sequential_scatter(base, index, values))
        # XLA on the host adds a scatter in the same order.
        ref = np.asarray(jnp.asarray(base).at[jnp.asarray(index)].add(jnp.asarray(values)))
        np.testing.assert_array_equal(got, ref)

    @pytest.mark.parametrize("shape", [(64, 8), (4, 33), (3, 5, 32), (16,)])
    def test_sum_last_is_sequential(self, shape):
        """In order up to width 32; (4, 33) takes XLA's windowed tree."""
        rng = np.random.default_rng(sum(shape))
        x = (rng.standard_normal(shape) * 10 ** rng.uniform(-3, 3, shape)).astype(np.float32)
        want = _xla_host_last(x)
        if shape[-1] <= 32:
            np.testing.assert_array_equal(want, _sequential_last(x))
        np.testing.assert_array_equal(osum.sum_last(_t(x)).numpy(), want)
        np.testing.assert_array_equal(osum.sum_last(_t(x), keepdim=True).numpy(), want[..., None])
        # XLA on the host, eager.
        np.testing.assert_array_equal(np.asarray(jnp.sum(jnp.asarray(x), axis=-1)), want)

    @pytest.mark.parametrize("size", [1, 2, 1000, 1025, 3001])
    def test_sum_all_is_a_pairwise_tree(self, size):
        rng = np.random.default_rng(size)
        x = (rng.standard_normal(size) * 10 ** rng.uniform(-3, 3, size)).astype(np.float32)
        level = x
        while len(level) > 1:
            if len(level) % 2:
                level = np.concatenate([level, np.zeros(1, np.float32)])
            level = (level[0::2] + level[1::2]).astype(np.float32)
        np.testing.assert_array_equal(osum.sum_all(_t(x)).numpy(), level[0])

    @pytest.mark.parametrize("size", [1, 31, 32, 33, 63, 64, 65, 1000, 1025, 1500, 32 * 32 + 1, 4096, 40_000])
    def test_sum_windows_is_xla_host_order(self, size):
        """One long ``sum_last`` is bit for bit ``jnp.sum`` on the host, on
        log-normal float32 with zeros among them (a masked sum's input),
        where ``sum_all`` is not."""
        rng = np.random.default_rng(size + 7)
        for _ in range(4):
            x = rng.lognormal(9.0, 1.5, size).astype(np.float32)
            x[rng.random(size) < 0.4] = 0.0
            want = np.asarray(jnp.sum(jnp.asarray(x)))
            assert osum.sum_last(_t(x)).numpy().tobytes() == want.tobytes(), size

    def test_div_rounds_once(self):
        x = np.arange(0, 4000, dtype=np.float32) * np.float32(1.37)
        for k in (3, 31, 1023):
            np.testing.assert_array_equal(osum.div(_t(x), k).numpy(), x / np.float32(k))


# --------------------------------------------------------------------- #
# Planners
# --------------------------------------------------------------------- #

ELIGIBLE = np.array([True, False, True, True, False, False, True, False])


def _costs(rng, kind, items):
    if kind == "skewed":
        return rng.lognormal(0.0, 1.5, items).astype(np.float32)
    if kind == "tied":                     # ties everywhere: order decides
        return np.where(rng.random(items) < 0.5, 1.0, 0.0).astype(np.float32)
    return np.ones(items, np.float32)


class TestPlanners:
    @pytest.mark.parametrize("offset", [0, 5])
    @pytest.mark.parametrize("eligible", [None, ELIGIBLE, np.zeros(8, bool)],
                             ids=["all", "holes", "none_eligible"])
    def test_round_robin(self, offset, eligible):
        j = jrd.round_robin(21, 8, offset, None if eligible is None else jnp.asarray(eligible))
        t = trd.round_robin(21, 8, offset, None if eligible is None else _t(eligible), device=CPU)
        np.testing.assert_array_equal(np.asarray(j), t.numpy())
        assert t.dtype == torch.int32

    @pytest.mark.parametrize("planner", ["zigzag", "lpt_greedy"])
    @pytest.mark.parametrize("cost_kind", ["skewed", "tied", "equal"])
    @pytest.mark.parametrize("base", [False, True])
    @pytest.mark.parametrize("holes", [False, True])
    def test_planner_parity(self, planner, cost_kind, base, holes):
        rng = np.random.default_rng(7)
        n, items = 8, 203
        costs = _costs(rng, cost_kind, items)
        kw_j, kw_t = {}, {}
        if base:
            b = np.round(rng.uniform(0, 20, n)).astype(np.float32)   # ties among bases too
            kw_j["base_loads"], kw_t["base_loads"] = jnp.asarray(b), _t(b)
        if holes:
            kw_j["eligible"], kw_t["eligible"] = jnp.asarray(ELIGIBLE), _t(ELIGIBLE)
        jd, jl = getattr(jrd, planner)(jnp.asarray(costs), n, **kw_j)
        td, tl = getattr(trd, planner)(_t(costs), n, **kw_t)
        np.testing.assert_array_equal(np.asarray(jd), td.numpy())
        assert td.dtype == torch.int32
        np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=FLOAT_RTOL, atol=0)
        np.testing.assert_array_equal(
            np.asarray(jrd.makespan(jd, jnp.asarray(costs), n)),
            trd.makespan(td, _t(costs), n).numpy(),
        )

    @pytest.mark.parametrize("self_skip", [False, True])
    def test_eligibility_and_local(self, self_skip):
        for sid in (0, 5):
            np.testing.assert_array_equal(
                np.asarray(jrd.eligibility_mask(8, sid, self_skip)),
                trd.eligibility_mask(8, sid, self_skip, device=CPU).numpy(),
            )
        np.testing.assert_array_equal(
            np.asarray(jrd.local_assignment(6, 3)), trd.local_assignment(6, 3, device=CPU).numpy()
        )


# --------------------------------------------------------------------- #
# Cost gate
# --------------------------------------------------------------------- #


class TestCostGate:
    @pytest.mark.parametrize("case", [
        ([10.0, 0.0], [5.0, 5.0], 1e6, 100, dict(link_bandwidth=50e9, per_item_overhead=1e-6)),
        ([1.1, 1.0], [1.05, 1.05], 100e9, 1, {}),
        ([1.0, 1.0], [2.0, 0.5], 0.0, 0, {}),
    ])
    def test_admit_redistribution_parity(self, case):
        before, after, nbytes, items, kw = case
        jok, jsaved, jt = jadm.admit_redistribution(
            jnp.asarray(before, jnp.float32), jnp.asarray(after, jnp.float32),
            jnp.asarray(nbytes, jnp.float32), jnp.asarray(items, jnp.int32),
            jadm.CostModelConfig(**kw),
        )
        tok, tsaved, tt = tadm.admit_redistribution(
            torch.tensor(before), torch.tensor(after), torch.tensor(nbytes),
            torch.tensor(items, dtype=torch.int32), tadm.CostModelConfig(**kw),
        )
        assert bool(jok) == bool(tok)
        np.testing.assert_allclose(float(tsaved), float(jsaved), rtol=FLOAT_RTOL)
        np.testing.assert_allclose(float(tt), float(jt), rtol=FLOAT_RTOL)
        # numpy operands take the same formulas.
        nok, _, nt = tadm.admit_redistribution(
            np.asarray(before, np.float32), np.asarray(after, np.float32),
            np.asarray(nbytes), np.asarray(items), tadm.CostModelConfig(**kw),
        )
        assert bool(nok) == bool(tok)
        np.testing.assert_allclose(float(nt), float(tt), rtol=FLOAT_RTOL)

    def test_modelled_link_bandwidth_is_the_reference_value(self):
        assert tadm.CostModelConfig() == tadm.CostModelConfig(
            **dataclasses.asdict(jadm.CostModelConfig())
        )
        assert dataclasses.asdict(tadm.CostModelConfig()) == dataclasses.asdict(jadm.CostModelConfig())


# --------------------------------------------------------------------- #
# AdaptiveLink.step
# --------------------------------------------------------------------- #


def _items(rng, n, items, tick, tied):
    producer = np.minimum(rng.zipf(1.6, items) - 1, n - 1).astype(np.int32)
    costs = np.ones(items, np.float32) if tied else rng.lognormal(-1.0, 1.5, items).astype(np.float32)
    if tick % 3 == 2:                      # a burst of giant rows: the gate's case
        sizes = np.full(items, 3e9, np.float32)
    else:
        sizes = rng.integers(100, 20000, items).astype(np.float32)
    valid = rng.random(items) < 0.9
    return costs, sizes, producer, valid


def _link_pair(policy, n, **kw):
    jcfg = jal.AdaptiveLinkConfig(
        dyskew=jty.DySkewConfig(policy=jty.Policy[policy], **kw), num_instances=n
    )
    tcfg = tal.AdaptiveLinkConfig(
        dyskew=tty.DySkewConfig(policy=tty.Policy[policy], **kw), num_instances=n
    )
    return jal.AdaptiveLink(jcfg), tal.AdaptiveLink(tcfg, device=CPU)


def _state_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _state_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _assert_state_equal(js, ts, where):
    for key in INT_LEAVES:
        np.testing.assert_array_equal(np.asarray(js[key]), ts[key].numpy(), err_msg=f"{where}: {key}")
    for key, a in js["metrics"].items():
        np.testing.assert_allclose(
            np.asarray(a), ts["metrics"][key].numpy(), rtol=FLOAT_RTOL, atol=0, err_msg=f"{where}: {key}"
        )


class TestAdaptiveLinkStep:
    @pytest.mark.parametrize("policy", ["EAGER_SNOWPARK", "LATE", "EARLY", "NEVER"])
    @pytest.mark.parametrize("n,items", [(4, 64), (32, 1500)])
    @pytest.mark.parametrize("tied", [False, True], ids=["skewed", "tied"])
    def test_step_parity(self, policy, n, items, tied):
        jl, tl = _link_pair(policy, n, n_strikes=2)
        js = jl.init_state()
        # The port starts from the reference's own tree, carried across.
        ts = state_from_numpy(_state_to_numpy(js), CPU)
        _assert_state_equal(js, tl.init_state(), "init")
        rng = np.random.default_rng(n * 31 + items + tied)
        moved_any = False
        for tick in range(6):
            costs, sizes, producer, valid = _items(rng, n, items, tick, tied)
            js, jp = jl.step(js, jnp.asarray(costs), jnp.asarray(sizes),
                             jnp.asarray(producer), jnp.asarray(valid))
            ts, tp = tl.step(ts, _t(costs), _t(sizes), _t(producer), _t(valid))
            where = f"{policy} n={n} tick {tick}"
            np.testing.assert_array_equal(np.asarray(jp.dest), tp.dest.numpy(), err_msg=where)
            np.testing.assert_array_equal(np.asarray(jp.distribute), tp.distribute.numpy(), err_msg=where)
            for est in ("est_bytes_moved", "est_time_saved"):
                np.testing.assert_allclose(
                    float(getattr(tp, est)), float(getattr(jp, est)), rtol=FLOAT_RTOL, err_msg=where
                )
            _assert_state_equal(js, ts, where)
            moved_any |= bool((tp.dest.numpy() != producer).any())
        # The workload exercises the plan: eager links move rows, NEVER none.
        if policy in ("NEVER", "EAGER_SNOWPARK", "EARLY"):
            assert moved_any == (policy != "NEVER")

    @pytest.mark.parametrize("n,items", [(4, 64), (32, 1500), (32, 4096)])
    def test_float_sizes_bit_equal(self, n, items):
        """Row sizes log-normal(9, 1.5) in float32, as serving's KV byte
        counts are: the gate's ``bytes_moved`` is one long sum, and the port
        must add it in XLA's order, so ``est_bytes_moved`` is EQUAL, not
        close, over 30 eager ticks."""
        jl, tl = _link_pair("EAGER_SNOWPARK", n)
        js, ts = jl.init_state(), tl.init_state()
        rng = np.random.default_rng(n * 7 + items)
        moved = 0
        for tick in range(30):
            producer = np.minimum(rng.zipf(1.6, items) - 1, n - 1).astype(np.int32)
            costs = rng.lognormal(-1.0, 1.5, items).astype(np.float32)
            sizes = rng.lognormal(9.0, 1.5, items).astype(np.float32)
            valid = rng.random(items) < 0.9
            js, jp = jl.step(js, jnp.asarray(costs), jnp.asarray(sizes),
                             jnp.asarray(producer), jnp.asarray(valid))
            ts, tp = tl.step(ts, _t(costs), _t(sizes), _t(producer), _t(valid))
            where = f"n={n} items={items} tick {tick}"
            np.testing.assert_array_equal(np.asarray(jp.dest), tp.dest.numpy(), err_msg=where)
            assert tp.est_bytes_moved.numpy().tobytes() == np.asarray(jp.est_bytes_moved).tobytes(), where
            assert tp.est_time_saved.numpy().tobytes() == np.asarray(jp.est_time_saved).tobytes(), where
            _assert_state_equal(js, ts, where)
            moved += int(float(tp.est_bytes_moved) > 0)
        assert moved > 0

    @pytest.mark.parametrize("self_skip", [False, True])
    def test_self_skip_parity(self, self_skip):
        jl, tl = _link_pair("EAGER_SNOWPARK", 4, self_skip=self_skip)
        js, ts = jl.init_state(), tl.init_state()
        producer = np.zeros(8, np.int32)
        for _ in range(2):
            js, jp = jl.step(js, jnp.ones(8), jnp.ones(8), jnp.asarray(producer))
            ts, tp = tl.step(ts, torch.ones(8), torch.ones(8), _t(producer))
            np.testing.assert_array_equal(np.asarray(jp.dest), tp.dest.numpy())
        assert (tp.dest.numpy() == 0).any() != self_skip

    def test_apply_plan_host_buckets_by_destination(self):
        jl, tl = _link_pair("EAGER_SNOWPARK", 4)
        _, jp = jl.step(jl.init_state(), jnp.ones(16), jnp.ones(16), jnp.zeros(16, jnp.int32))
        _, tp = tl.step(tl.init_state(), torch.ones(16), torch.ones(16), torch.zeros(16, dtype=torch.int32))
        items = list(range(16))
        assert tal.apply_plan_host(items, tp, 4) == jal.apply_plan_host(items, jp, 4)

    def test_default_device_needs_a_gpu(self):
        cfg = tal.AdaptiveLinkConfig(num_instances=4)
        if torch.cuda.is_available():
            assert tal.AdaptiveLink(cfg).init_state()["state"].is_cuda
        else:
            with pytest.raises(RuntimeError, match="CUDA"):
                tal.AdaptiveLink(cfg)


# --------------------------------------------------------------------- #
# Policy seam and contract data
# --------------------------------------------------------------------- #


def _ctx(mod, n=8, seed=0):
    return mod.PolicyContext(num_workers=n, rng=np.random.default_rng(seed))


class TestPolicySeam:
    def test_same_registry(self):
        assert tpol.available_policies() == jpol.available_policies()
        for kind in jpol.available_policies():
            jc, tc = jpol.resolve_policy(kind), tpol.resolve_policy(kind)
            for flag in jcon.CAPABILITY_FLAGS:
                assert getattr(tc, flag) == getattr(jc, flag), (kind, flag)

    @pytest.mark.parametrize("kind", sorted(jpol.available_policies()))
    @pytest.mark.parametrize("mask_mode", ["none", "self", "decom"])
    def test_propose_parity_and_conservation(self, kind, mask_mode):
        rng = np.random.default_rng(17)
        jp = jpol.StrategyConfig(kind=kind).make_policy(_ctx(jpol, seed=5))
        tp = tpol.StrategyConfig(kind=kind).make_policy(_ctx(tpol, seed=5))
        for trial in range(20):
            n = 8
            backlog = rng.exponential(2.0, size=n)
            producer = int(rng.integers(n))
            if mask_mode == "self":
                backlog[producer] = np.inf
            elif mask_mode == "decom":
                backlog[rng.integers(n, size=2)] = np.inf
            k = int(rng.integers(1, 600))
            jc = jp.propose(producer, k, backlog.copy(), unit=1e-5)
            tc = tp.propose(producer, k, backlog.copy(), unit=1e-5)
            if jc is None:
                assert tc is None and kind == "none"
                continue
            tc = np.asarray(tc)
            np.testing.assert_array_equal(tc, np.asarray(jc), err_msg=f"{kind} {mask_mode} {trial}")
            assert int(tc.sum()) == k and (tc >= 0).all()
            assert (tc[~np.isfinite(backlog)] == 0).all()

    @pytest.mark.parametrize("kind", ["static_rr", "p2c", "key_affinity", "none"])
    def test_place_one_parity(self, kind):
        rng = np.random.default_rng(3)
        jp = jpol.StrategyConfig(kind=kind).make_policy(_ctx(jpol, seed=2))
        tp = tpol.StrategyConfig(kind=kind).make_policy(_ctx(tpol, seed=2))
        for _ in range(40):
            backlog = rng.exponential(1.0, size=8)
            backlog[rng.integers(8)] = np.inf
            producer = int(rng.integers(8))
            assert tp.place_one(backlog.copy(), producer) == jp.place_one(backlog.copy(), producer)
            k = int(rng.integers(1, 50))       # the cycle is shared with propose
            jc, tc = jp.propose(producer, k, backlog.copy(), 1e-5), tp.propose(producer, k, backlog.copy(), 1e-5)
            assert (jc is None and tc is None) or np.array_equal(np.asarray(jc), np.asarray(tc))


class TestContracts:
    def test_port_copy_holds_the_reference_values(self):
        names = [k for k in vars(jcon) if k.isupper()]
        assert names
        for name in names:
            assert getattr(tcon, name) == getattr(jcon, name), name
        assert sorted(k for k in vars(tcon) if k.isupper()) == sorted(names)

    def test_capability_flags_match_the_port_base_class(self):
        for flag, default in tcon.CAPABILITY_FLAGS.items():
            assert getattr(tpol.RedistributionPolicy, flag) is default, flag
