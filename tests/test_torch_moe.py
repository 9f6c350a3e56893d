"""The port's ``moe_apply`` against ``repro``'s on the CPU: the same
parameters (made with numpy, carried across by ``params_from_numpy``), the
same inputs, ten steps of carried DySkew state, static and adaptive, both
combine paths, with the router skewed as ``benchmarks/bench_moe_dispatch.py``
skews it.

Tolerances: the link state's integer leaves, ``moe_dropped_frac`` and
``moe_distribute_frac`` EQUAL (they are counts over which tokens were kept
and which shards distribute: any difference in keep or slot assignment
shows there and, far above tolerance, in ``y``); ``y`` rtol/atol 1e-5 in
float32 (matrix products and the combine sum in another order); the float
metrics of the link rtol 1e-6.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import ArchConfig as JArch, MoEConfig as JMoE
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


def _assert_state_equal(js, ts, where):
    jl, tl = js["link"], ts["link"]
    for key in ("state", "strikes", "transitions", "tick"):
        np.testing.assert_array_equal(np.asarray(jl[key]), tl[key].numpy(),
                                      err_msg=f"{where}: {key}")
    for key, a in jl["metrics"].items():
        np.testing.assert_allclose(np.asarray(a), tl["metrics"][key].numpy(),
                                   rtol=1e-6, err_msg=f"{where}: {key}")
    np.testing.assert_allclose(np.asarray(js["ema_loads"]), ts["ema_loads"].numpy(),
                               rtol=1e-6, err_msg=f"{where}: ema_loads")


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
    tstate = tmoe.moe_state_init(tcfg, tctx, device="cpu")
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
        _assert_state_equal(jstate, tstate, where)
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


def test_adaptive_drops_less_than_static_under_skew():
    """The claim of ``benchmarks/bench_moe_dispatch.py``, on the port."""
    out = {}
    for adaptive in (False, True):
        _, tcfg = _cfgs(adaptive)
        tp = params_from_numpy(_numpy_params(1.5), device="cpu")
        ctx = tmoe.SpmdCtx(num_groups=1, num_ep_shards=N_EP)
        state = tmoe.moe_state_init(tcfg, ctx, device="cpu")
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
    state = tmoe.moe_state_init(tcfg, ctx, device="cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((B, S, D)).astype(np.float32))
    y1, s1, _ = tmoe.moe_apply(tp, x, cfg=tcfg, state=state, ctx=ctx)
    y2, s2, _ = tmoe.moe_apply(tp, x, cfg=tcfg, state=state, ctx=ctx, ops=tmoe.PLAIN_OPS)
    assert torch.equal(y1, y2) and torch.equal(s1["ema_loads"], s2["ema_loads"])


def test_state_is_not_mutated():
    _, tcfg = _cfgs(True)
    tp = params_from_numpy(_numpy_params(0.8), device="cpu")
    ctx = tmoe.SpmdCtx(num_groups=1, num_ep_shards=N_EP)
    state = tmoe.moe_state_init(tcfg, ctx, device="cpu")
    x = torch.zeros(B, S, D)
    _, new_state, _ = tmoe.moe_apply(tp, x, cfg=tcfg, state=state, ctx=ctx)
    assert int(state["link"]["tick"]) == 0 and int(new_state["link"]["tick"]) == 1


def test_more_than_one_group_raises():
    """More than one token group runs (``tests/test_torch_ranks.py`` holds
    G 2 and 4 to the reference); a group count that does not divide the
    tokens into equal groups raises."""
    _, tcfg = _cfgs(True)
    tp = params_from_numpy(_numpy_params(0.0), device="cpu")
    assert (B * S) % 3
    ctx = tmoe.SpmdCtx(num_groups=3, num_ep_shards=N_EP)
    state = tmoe.moe_state_init(tcfg, ctx, device="cpu")
    with pytest.raises(ValueError, match="num_groups"):
        tmoe.moe_apply(tp, torch.zeros(B, S, D), cfg=tcfg, state=state, ctx=ctx)


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("tokens", [8, 100, 8192])
def test_capacities_truncate_like_the_reference(tokens, adaptive):
    jcfg, tcfg = _cfgs(adaptive)
    assert jmoe.capacities(jcfg, tokens) == tmoe.capacities(tcfg, tokens)


def test_specs_and_dyskew_config_match():
    jcfg, tcfg = _cfgs(True)
    js, ts = jmoe.moe_specs(jcfg), tmoe.moe_specs(tcfg)
    assert {k: (v.shape, v.axes, v.init, v.scale) for k, v in js.items()} == \
           {k: (v.shape, v.axes, v.init, v.scale) for k, v in ts.items()}
    for adaptive in (False, True):
        jd, td = jmoe.moe_dyskew_config(adaptive), tmoe.moe_dyskew_config(adaptive)
        assert {f.name: (int(getattr(jd, f.name)) if f.name in ("policy", "skew_model")
                         else getattr(jd, f.name)) for f in dataclasses.fields(jd)} == \
               {f.name: (int(getattr(td, f.name)) if f.name in ("policy", "skew_model")
                         else getattr(td, f.name)) for f in dataclasses.fields(td)}


def test_state_from_numpy_keeps_types():
    jcfg, _ = _cfgs(True)
    jstate = jmoe.moe_state_init(jcfg, jmoe.SpmdCtx(num_groups=1, num_ep_shards=N_EP))
    ts = state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    assert ts["link"]["state"].dtype == torch.int32
    assert ts["link"]["tick"].shape == () and ts["link"]["tick"].dtype == torch.int32
    assert ts["link"]["metrics"]["sync_window"].shape == (N_EP, 8)
    assert ts["ema_loads"].dtype == torch.float32
    bf = state_from_numpy({"k": np.asarray(jnp.ones((2, 3), jnp.bfloat16))}, device="cpu")
    assert bf["k"].dtype == torch.bfloat16 and float(bf["k"].sum()) == 6.0
