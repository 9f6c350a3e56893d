"""The port's ``moe_apply`` against ``repro``'s on the CPU: the same
parameters (made with numpy, carried across by ``params_from_numpy``), the
same inputs, ten steps of carried DySkew state, static and adaptive, both
combine paths, with the router skewed as ``benchmarks/bench_moe_dispatch.py``
skews it.  The port carries ``ema_loads`` alone: its link decision is a
constant of the configuration, which
``test_moe_link_decides_from_its_first_tick`` holds to the reference's
state machine.

Tolerances: the effective capacities, ``moe_dropped_frac`` and
``moe_distribute_frac`` EQUAL (they are counts over which tokens were kept
and which shards distribute: any difference in keep or slot assignment
shows there and, far above tolerance, in ``y``); ``y`` rtol/atol 1e-5 in
float32 (matrix products and the combine sum in another order);
``ema_loads`` rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import ArchConfig as JArch, MoEConfig as JMoE
from repro.core import state_machine as jsm
from repro.core import types as jty
from repro.models.layers import moe as jmoe
from repro.models.perf_flags import PerfFlags as JFlags, use_flags as j_use_flags
from repro_torch.config.base import ArchConfig as TArch, MoEConfig as TMoE
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.models.layers import moe as tmoe
from repro_torch.models.perf_flags import PerfFlags as TFlags, use_flags as t_use_flags

E, K, D, FF = 32, 8, 128, 64
B, S = 4, 64
STEPS = 10
N_EP = 8


def _cfgs(adaptive, capacity_factor=1.25, e=E, k=K):
    kw = dict(name="bench", family="moe", num_layers=1, d_model=D, num_heads=4,
              num_kv_heads=2, d_ff=FF, vocab_size=256, dtype="float32")
    mk = dict(num_experts=e, top_k=k, expert_ff=FF,
              capacity_factor=capacity_factor, adaptive=adaptive)
    return JArch(moe=JMoE(**mk), **kw), TArch(moe=TMoE(**mk), **kw)


def _numpy_params(alpha, seed=0, e=E):
    rng = np.random.default_rng(seed)
    probs = 1.0 / np.arange(1, e + 1) ** alpha
    probs /= probs.sum()
    bias = (np.log(probs) - np.log(probs).mean()).astype(np.float32)
    return {
        "router": (0.02 * rng.standard_normal((D, e)) + 0.5 * bias[None, :]).astype(np.float32),
        # Scaled by the true fan-in, so that y is of order one and the
        # absolute tolerance below means what it says.
        "w_gate": (rng.standard_normal((e, D, FF)) / np.sqrt(D)).astype(np.float32),
        "w_up": (rng.standard_normal((e, D, FF)) / np.sqrt(D)).astype(np.float32),
        "w_down": (rng.standard_normal((e, FF, D)) / np.sqrt(FF)).astype(np.float32),
    }


def _reference_capacity(jlink, ema, c_static, c_buf):
    """``repro``'s effective capacities, as its ``moe_apply`` derives them
    from the shards' distribute mask after a tick and the loads' EMA."""
    E = ema.shape[0]
    distribute = jsm.routes_remote(jlink["state"]).astype(jnp.int32)
    use = distribute[jnp.arange(E) // (E // distribute.shape[0])] > 0
    caps = jnp.clip(jnp.round(ema * E * c_static), 1, c_buf).astype(jnp.int32)
    return np.asarray(jnp.where(use, caps, c_static))


def _assert_state_equal(js, ts, where, capacity_of=None):
    """The port's carried state, ``ema_loads`` alone, against the
    reference's; with ``capacity_of`` (the port's config, the tokens of a
    group) after a tick, also the port's capacities from the reference's
    EMA against the reference's own."""
    assert sorted(ts) == ["ema_loads"], where
    np.testing.assert_allclose(np.asarray(js["ema_loads"]), ts["ema_loads"].numpy(),
                               rtol=1e-6, err_msg=f"{where}: ema_loads")
    if capacity_of is None:
        return
    cfg, tokens = capacity_of
    c_static, c_buf = tmoe.capacities(cfg, tokens)
    got = tmoe.effective_capacity(torch.tensor(np.asarray(js["ema_loads"])), adaptive=cfg.moe.adaptive,
                                  c_static=c_static, c_buf=c_buf)
    np.testing.assert_array_equal(got.numpy(), _reference_capacity(js["link"], js["ema_loads"], c_static, c_buf),
                                  err_msg=f"{where}: capacities")


@pytest.mark.parametrize("scatter", [False, True], ids=["gather_combine", "scatter_combine"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "adaptive"])
@pytest.mark.parametrize("alpha", [0.0, 0.8, 1.5])
def test_ten_carried_steps(alpha, adaptive, scatter):
    jcfg, tcfg = _cfgs(adaptive)
    p_np = _numpy_params(alpha)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = params_from_numpy(p_np, device="cpu", dtype=torch.float32)
    jctx = jmoe.SpmdCtx(num_groups=1, num_ep_shards=N_EP)
    tctx = tmoe.SpmdCtx(num_groups=1, num_ep_shards=N_EP)
    jstate = jmoe.moe_state_init(jcfg, jctx)
    tstate = tmoe.moe_state_init(tcfg, device="cpu")
    _assert_state_equal(jstate, tstate, "init")

    with j_use_flags(JFlags(moe_scatter_combine=scatter)):
        jstep = jax.jit(lambda st, x: jmoe.moe_apply(jp, x, cfg=jcfg, state=st, ctx=jctx))
        jstep(jstate, jnp.zeros((B, S, D)))  # trace under the flag
    rng = np.random.default_rng(100)
    dropped = []
    for step in range(STEPS):
        x = rng.standard_normal((B, S, D)).astype(np.float32)
        jy, jstate, jm = jstep(jstate, jnp.asarray(x))
        with t_use_flags(TFlags(moe_scatter_combine=scatter)):
            ty, tstate, tm = tmoe.moe_apply(tp, torch.from_numpy(x), cfg=tcfg,
                                            state=tstate, ctx=tctx)
        where = f"step {step}"
        _assert_state_equal(jstate, tstate, where, capacity_of=(tcfg, B * S))
        for key in ("moe_dropped_frac", "moe_distribute_frac"):
            assert float(jm[key]) == float(tm[key]), (where, key)
        for key in ("moe_shard_imbalance", "moe_aux_loss"):
            np.testing.assert_allclose(float(jm[key]), float(tm[key]), rtol=1e-5,
                                       err_msg=f"{where}: {key}")
        np.testing.assert_allclose(np.asarray(jy), ty.numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=where)
        dropped.append(float(tm["moe_dropped_frac"]))
    if alpha > 0:
        assert max(dropped) > 0.0   # the skew does overflow the capacity


def _tick_loads(kind, tick, rng):
    """(E,) float32 expert loads of one call of B·S tokens, K picks each."""
    picks = B * S * K
    if kind == "zipf":
        probs = 1.0 / np.arange(1, E + 1) ** 1.2
        return rng.multinomial(picks, probs / probs.sum()).astype(np.float32)
    if kind == "uniform":
        return np.full(E, picks / E, np.float32)
    if kind == "one_hot_shard":
        out = np.zeros((N_EP, E // N_EP), np.float32)
        out[tick % N_EP] = picks / (E // N_EP)
        return out.reshape(E)
    return np.zeros(E, np.float32)


@pytest.mark.parametrize("loads", ["zipf", "uniform", "one_hot_shard", "zero"])
@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "adaptive"])
def test_moe_link_decides_from_its_first_tick(adaptive, loads):
    """The port takes the link's decision from the configuration: every
    shard distributes exactly when ``adaptive`` is set.  The reference's
    state machine under its ``moe_dyskew_config``, ticked as its
    ``moe_apply`` ticks it, says the same on each of 16 ticks, carried from
    INIT and from a fresh INIT each tick (a stateless call); and the port's
    capacities from the same EMA equal those the reference derives."""
    jcfg, tcfg = _cfgs(adaptive)
    dk = jmoe.moe_dyskew_config(adaptive)
    c_static, c_buf = tmoe.capacities(tcfg, B * S)

    @jax.jit
    def tick(link, loads_e):
        shard = loads_e.reshape(N_EP, -1).sum(axis=-1)
        return jsm.tick(link, dk, rows_this_tick=shard, sync_time_this_tick=shard, batch_density=shard,
                        bytes_per_row=jnp.full_like(shard, 2.0 * D), signal_this_tick=shard > 0)

    rng = np.random.default_rng(5)
    carried = jty.link_state_init(N_EP, dk)
    ema = jmoe.moe_state_init(jcfg, jmoe.SpmdCtx(num_groups=1, num_ep_shards=N_EP))["ema_loads"]
    for t in range(16):
        loads_e = jnp.asarray(_tick_loads(loads, t, rng))
        carried, distribute = tick(carried, loads_e)
        _, fresh = tick(jty.link_state_init(N_EP, dk), loads_e)
        assert np.asarray(distribute).tolist() == [adaptive] * N_EP, t
        assert np.asarray(fresh).tolist() == [adaptive] * N_EP, t
        ema = 0.9 * ema + 0.1 * loads_e / jnp.maximum(loads_e.sum(), 1.0)
        got = tmoe.effective_capacity(torch.tensor(np.asarray(ema)), adaptive=adaptive,
                                      c_static=c_static, c_buf=c_buf)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), _reference_capacity(carried, ema, c_static, c_buf),
                                      err_msg=f"tick {t}")


def test_adaptive_drops_less_than_static_under_skew():
    """The claim of ``benchmarks/bench_moe_dispatch.py``, on the port."""
    out = {}
    for adaptive in (False, True):
        _, tcfg = _cfgs(adaptive)
        tp = params_from_numpy(_numpy_params(1.5), device="cpu")
        ctx = tmoe.SpmdCtx(num_groups=1, num_ep_shards=N_EP)
        state = tmoe.moe_state_init(tcfg, device="cpu")
        rng = np.random.default_rng(100)
        fracs = []
        for _ in range(STEPS):
            x = torch.from_numpy(rng.standard_normal((B, S, D)).astype(np.float32))
            _, state, m = tmoe.moe_apply(tp, x, cfg=tcfg, state=state, ctx=ctx)
            fracs.append(float(m["moe_dropped_frac"]))
        out[adaptive] = float(np.mean(fracs[2:]))
    assert out[True] < out[False]


@pytest.mark.parametrize("seed", range(3))
def test_dispatch_plan_against_a_loop(seed):
    """keep and the slot of every pick, against the obvious host loop: walk
    the picks in arrival order, give each the next free rank of its expert,
    keep it while the rank is under that expert's capacity."""
    e, k, c_buf, tokens = 6, 2, 5, 17
    rng = np.random.default_rng(seed)
    flat_e = rng.integers(0, e, tokens * k).astype(np.int32)
    cap = rng.integers(1, c_buf + 1, e).astype(np.int32)
    counts = np.bincount(flat_e, minlength=e).astype(np.float32)
    order, slot_sorted, keep, src, valid = tmoe.dispatch_plan(
        torch.from_numpy(flat_e), torch.from_numpy(counts), torch.from_numpy(cap),
        c_buf=c_buf, top_k=k,
    )
    want_slot = np.full(tokens * k, e * c_buf)
    want_src = np.zeros(e * c_buf, np.int32)
    want_valid = np.zeros(e * c_buf, bool)
    fill = np.zeros(e, int)
    for i, ex in enumerate(flat_e):
        rank = fill[ex]
        fill[ex] += 1
        if rank < cap[ex]:
            want_slot[i] = ex * c_buf + rank
            want_src[want_slot[i]] = i // k
            want_valid[want_slot[i]] = True
    got_slot = np.empty(tokens * k, int)
    got_slot[order.numpy()] = slot_sorted.numpy()
    np.testing.assert_array_equal(got_slot, want_slot)
    np.testing.assert_array_equal(keep.numpy(), slot_sorted.numpy() < e * c_buf)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_array_equal(src.numpy()[want_valid], want_src[want_valid])
    assert src.dtype == torch.int32 and valid.dtype == torch.bool


def test_plain_ops_give_the_same_as_the_default_on_cpu():
    _, tcfg = _cfgs(True)
    tp = params_from_numpy(_numpy_params(0.8), device="cpu")
    ctx = tmoe.SpmdCtx(num_groups=1, num_ep_shards=N_EP)
    state = tmoe.moe_state_init(tcfg, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((B, S, D)).astype(np.float32))
    y1, s1, _ = tmoe.moe_apply(tp, x, cfg=tcfg, state=state, ctx=ctx)
    y2, s2, _ = tmoe.moe_apply(tp, x, cfg=tcfg, state=state, ctx=ctx, ops=tmoe.PLAIN_OPS)
    assert torch.equal(y1, y2) and torch.equal(s1["ema_loads"], s2["ema_loads"])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_default_combine_on_cpu_is_the_loop_bit_for_bit(dtype):
    """On the CPU the default combine is the plain loop in an
    ``autograd.Function``: ``moe_apply``'s output and the gradients of ``x``
    and of every leaf the same bits as the loop differentiated by autograd
    (``PLAIN_OPS.combine``), under a router that drops picks."""
    _, tcfg = _cfgs(True, capacity_factor=0.5)
    p_np = _numpy_params(1.5)
    x_np = np.random.default_rng(3).standard_normal((B, S, D)).astype(np.float32)
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal((B, S, D)).astype(np.float32)).to(dtype)
    ctx = tmoe.SpmdCtx(num_groups=1, num_ep_shards=N_EP)
    runs = []
    for ops in (tmoe.KERNEL_OPS, tmoe.DispatchOps(combine=tmoe.PLAIN_OPS.combine)):
        tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(p_np, device="cpu", dtype=dtype).items()}
        x = torch.from_numpy(x_np).to(dtype).requires_grad_(True)
        y, _, m = tmoe.moe_apply(tp, x, cfg=tcfg, state=tmoe.moe_state_init(tcfg, device="cpu"),
                                 ctx=ctx, ops=ops)
        runs.append([y.detach()] + list(torch.autograd.grad(y, [x] + [tp[k] for k in sorted(tp)], dy)))
        assert float(m["moe_dropped_frac"]) > 0.1
    for a, b in zip(*runs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_state_is_not_mutated():
    """A carried call leaves its state as it was and returns the advanced
    EMA; a stateless call starts from the same EMA, gives the same output
    and returns no state."""
    _, tcfg = _cfgs(True)
    tp = params_from_numpy(_numpy_params(0.8), device="cpu")
    ctx = tmoe.SpmdCtx(num_groups=1, num_ep_shards=N_EP)
    state = tmoe.moe_state_init(tcfg, device="cpu")
    before = state["ema_loads"].clone()
    x = torch.zeros(B, S, D)
    y, new_state, _ = tmoe.moe_apply(tp, x, cfg=tcfg, state=state, ctx=ctx)
    assert torch.equal(state["ema_loads"], before) and not torch.equal(new_state["ema_loads"], before)
    y_stateless, none, _ = tmoe.moe_apply(tp, x, cfg=tcfg, ctx=ctx)
    assert none is None and torch.equal(y_stateless, y)


def test_more_than_one_group_raises():
    """More than one token group runs (``tests/test_torch_ranks.py`` holds
    G 2 and 4 to the reference); a group count that does not divide the
    tokens into equal groups raises."""
    _, tcfg = _cfgs(True)
    tp = params_from_numpy(_numpy_params(0.0), device="cpu")
    assert (B * S) % 3
    ctx = tmoe.SpmdCtx(num_groups=3, num_ep_shards=N_EP)
    state = tmoe.moe_state_init(tcfg, device="cpu")
    with pytest.raises(ValueError, match="num_groups"):
        tmoe.moe_apply(tp, torch.zeros(B, S, D), cfg=tcfg, state=state, ctx=ctx)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("tokens", [8, 100, 8192])
def test_capacities_truncate_like_the_reference(tokens, adaptive):
    jcfg, tcfg = _cfgs(adaptive)
    assert jmoe.capacities(jcfg, tokens) == tmoe.capacities(tcfg, tokens)


def test_specs_and_dyskew_config_match():
    """The specs match, and the reference's link configuration has the
    facts the port's constant decision rests on: the eager policy under
    ``adaptive`` (else NEVER), and the heavy-row guard off (a density
    floor of 0 and rows of ``inf`` bytes)."""
    jcfg, tcfg = _cfgs(True)
    js, ts = jmoe.moe_specs(jcfg), tmoe.moe_specs(tcfg)
    assert {k: (v.shape, v.axes, v.init, v.scale) for k, v in js.items()} == \
           {k: (v.shape, v.axes, v.init, v.scale) for k, v in ts.items()}
    for adaptive in (False, True):
        jd = jmoe.moe_dyskew_config(adaptive)
        assert jd.policy == (jty.Policy.EAGER_SNOWPARK if adaptive else jty.Policy.NEVER)
        assert jd.min_batch_density_frac == 0.0 and jd.heavy_row_bytes == float("inf")


def test_state_from_numpy_keeps_types():
    """The reference's MoE state, its link aside, carries across as the
    port's ``moe_state_init`` (keys, dtype, bits); an int32 scalar stays
    one, a bfloat16 leaf stays bfloat16."""
    jcfg, tcfg = _cfgs(True)
    jstate = jmoe.moe_state_init(jcfg, jmoe.SpmdCtx(num_groups=1, num_ep_shards=N_EP))
    ts = state_from_numpy({"ema_loads": np.asarray(jstate["ema_loads"])}, device="cpu")
    own = tmoe.moe_state_init(tcfg, device="cpu")
    assert sorted(ts) == sorted(own) and ts["ema_loads"].dtype == torch.float32
    assert torch.equal(ts["ema_loads"], own["ema_loads"])
    tick = state_from_numpy({"tick": np.asarray(jstate["link"]["tick"])}, device="cpu")["tick"]
    assert tick.shape == () and tick.dtype == torch.int32
    bf = state_from_numpy({"k": np.asarray(jnp.ones((2, 3), jnp.bfloat16))}, device="cpu")
    assert bf["k"].dtype == torch.bfloat16 and float(bf["k"].sum()) == 6.0


class _FloatScatterAdds(torch.utils._python_dispatch.TorchDispatchMode):
    """Records each floating-point scatter-add the code under it runs
    (``index_add``, ``scatter_add``, ``index_put`` with accumulate): the
    ops that CUDA runs with atomic adds."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        accumulate = name.startswith("index_put") and (kwargs.get("accumulate") or (len(args) > 3 and args[3]))
        if (name.startswith(("index_add", "scatter_add")) or accumulate) and args[0].is_floating_point():
            self.seen.append((name, tuple(args[0].shape)))
        return func(*args, **kwargs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["float32", "bfloat16"])
def test_scatter_combine_is_deterministic(dtype):
    """H9's combine sums by token with ``dispatch_backward``'s segment sum:
    two passes give the same bits, forward and backward, with no float
    scatter-add of rows in the forward (the backward's index gradients
    write each element once: ``order`` is a permutation); in float32 it
    still matches the reference's H9: ``y`` at rtol/atol 1e-5, the
    gradients of ``x`` and of every leaf within 1e-5 of their largest
    element."""
    jcfg, tcfg = _cfgs(True)
    p_np = _numpy_params(0.8)
    x_np = np.random.default_rng(7).standard_normal((B, S, D)).astype(np.float32)
    dy_np = np.random.default_rng(8).standard_normal((B, S, D)).astype(np.float32)
    tctx = tmoe.SpmdCtx(num_groups=1, num_ep_shards=N_EP)

    def port():
        tp = {k: v.requires_grad_(True) for k, v in params_from_numpy(p_np, device="cpu", dtype=dtype).items()}
        x = torch.from_numpy(x_np).to(dtype).requires_grad_(True)
        with t_use_flags(TFlags(moe_scatter_combine=True)), _FloatScatterAdds() as mode:
            y, _, _ = tmoe.moe_apply(tp, x, cfg=tcfg, state=tmoe.moe_state_init(tcfg, device="cpu"), ctx=tctx)
        grads = torch.autograd.grad(y, [x] + [tp[k] for k in sorted(tp)], torch.from_numpy(dy_np).to(dtype))
        return [y.detach()] + list(grads), mode.seen

    first, seen = port()
    second, _ = port()
    # The only one: the plain histogram's counts (whole numbers, exact in
    # any order; the card runs the histogram kernel).
    assert seen == [("index_put_", (E,))], seen
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    if dtype != torch.float32:
        return
    jctx = jmoe.SpmdCtx(num_groups=1, num_ep_shards=N_EP)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    with j_use_flags(JFlags(moe_scatter_combine=True)):
        def f(x, p):
            return jmoe.moe_apply(p, x, cfg=jcfg, state=jmoe.moe_state_init(jcfg, jctx), ctx=jctx)[0]
        jy, vjp = jax.vjp(f, jnp.asarray(x_np), jp)
        jdx, jdp = vjp(jnp.asarray(dy_np))
    np.testing.assert_allclose(first[0].numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5)
    for i, (a, b) in enumerate(zip([jdx] + [jdp[k] for k in sorted(jdp)], first[1:])):
        a = np.asarray(a)
        assert np.abs(b.numpy() - a).max() <= 1e-5 * np.abs(a).max(), i
