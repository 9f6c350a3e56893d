"""Token groups and data-parallel ranks through the port against ``repro``
on the CPU.

``moe_apply`` at G 1, 2 and 4 token groups and ``Model.loss`` with its
gradients at G 4 against the reference at the same G, on a skewed router
with ``capacity_factor`` 1.0, where the group count changes the result (a
control holds G 1 and G 4 apart).  Then ranks of a gloo group on the CPU,
each a process of ``tests/torch_ranks_worker.py`` (spawned once per
module-scoped fixture, every wait with its own time limit): four ranks run
one and three ``make_train_step`` steps (AdamW, 1 and 2 microbatches) on
their rows of each global batch, held to the reference's single-device
jitted step at ``num_groups`` 4 on that batch; ``allreduce_compressed``
against the reference's under ``jax.vmap(axis_name=...)``; the op counter's
collective records and the roofline's ``t_collective``; and a checkpoint
written by two ranks restored into four ranks and into one process.

With two microbatches, rank r's microbatch i is group r of the reference's
microbatch i, so the reference's global batch is the ranks' microbatches in
the order (microbatch, rank).

Tolerances (as ``tests/test_torch_train.py`` states them):
  * ``moe_apply``: link states' integer leaves, ``moe_dropped_frac`` and
    ``moe_distribute_frac`` EQUAL; ``y`` rtol/atol 1e-5; link float metrics
    and ``ema_loads`` rtol 1e-6; ``moe_aux_loss`` rtol 1e-5.
  * ``Model.loss``: loss rtol 1e-5, each gradient leaf
    ``max|Δ| <= 1e-3 · max|g_ref|``.
  * train steps: losses rtol 1e-5, ``grad_norm`` rtol 1e-4, the routing
    metrics and ``lr`` EQUAL; parameters ``max|Δ| <= 1e-5 · max|p|``,
    moments ``2e-3 · max|m|``, ``ema_loads`` rtol 1e-6, link states and the
    step counter EQUAL, and every rank's link states and ``ema_loads`` the
    same bits as every other's.  Each rank's gradient is its share, summed
    over the ranks in float32: another order of sums than the reference's
    one backward, inside the bands above.  One exception, stated: a
    parameter element whose reference second moment is below
    ``NOISE_FLOOR`` of its leaf's largest and not zero (a gradient of 1e-5
    of the largest or less, at the float32 rounding of a sum that cancels;
    a row no token reaches has an exact zero on both sides) moves
    by AdamW's normalised step m / sqrt(v), whose sign and size there are
    the rounding's: such elements, at most 5 % of a leaf, are held only to
    ``|Δ| <= 2 · Σ lr`` (one full step of each sign).  One process at G 4
    and 2 microbatches leaves the 1e-5 band on this input too, at one
    embedding element, so it is not the ranks'.
  * ``allreduce_compressed``: the shared scale and every rank's int8
    payload EQUAL; the mean and the residual rtol 1e-6.
  * collective records: EQUAL to the bytes the step issues, counted from
    the shapes.
  * checkpoint: EQUAL (bit for bit) after the restore.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import get_config as j_get_config
from repro.models.layers import moe as jmoe
from repro.models.model_api import build as j_build
from repro.optim.grad_compress import allreduce_compressed as j_allreduce_compressed
from repro.optim.optimizers import OptimizerConfig as JOpt
from repro.train.step import StepConfig as JStep
from repro.train.step import make_train_step as j_make_train_step
from repro.train.step import train_state_init as j_train_state_init
from repro_torch.checkpoint.manager import CheckpointManager, flatten_with_paths
from repro_torch.config.base import get_config as t_get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import transformer as t_transformer
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.models.layers import moe as tmoe
from repro_torch.models.model_api import build as t_build
from repro_torch.models.param import tree_map
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.roofline import analysis as t_analysis

import torch_ranks_worker as worker
from test_torch_moe import N_EP, _assert_state_equal, _cfgs, _numpy_params
from test_torch_moe import B as MOE_B, D as MOE_D, S as MOE_S
from test_torch_train import (
    _batch,
    _flat_ref,
    _norm_err,
    assert_links_match,
    assert_metrics_match,
    flat_numpy,
    without_links,
)

ARCH = "granite-moe-1b-a400m"
CPU = "cpu"
RANKS, GROUPS = 4, 4
STEPS = 3
#: Seconds each wait on a rank may take (a process start, torch's import,
#: every body's reduced steps: about 30 s on an idle host, several times that
#: when six test workers share two cores); a hang fails its fixture well
#: inside the suite's own limit.
RANK_TIMEOUT_S = 600
#: Second moments below this share of their leaf's largest mark parameter
#: elements whose AdamW step is rounding noise (see the docstring).
NOISE_FLOOR = 1e-10


def _cfg(get_config):
    """Reduced granite in float32 with capacity_factor 1.0: the capacity of
    a group is below its worst case, so the groups decide what is dropped."""
    cfg = dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))


# --------------------------------------------------------------------- #
# Token groups in one process
# --------------------------------------------------------------------- #


def _moe_run(groups, adaptive, steps=4):
    """``steps`` carried steps of both ``moe_apply``s at ``groups`` groups on
    the skewed router; the port's outputs."""
    jcfg, tcfg = _cfgs(adaptive, capacity_factor=1.0)
    p_np = _numpy_params(1.5)
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    tp = params_from_numpy(p_np, device=CPU, dtype=torch.float32)
    jctx = jmoe.SpmdCtx(num_groups=groups, num_ep_shards=N_EP)
    tctx = tmoe.SpmdCtx(num_groups=groups, num_ep_shards=N_EP)
    jstate, tstate = jmoe.moe_state_init(jcfg, jctx), tmoe.moe_state_init(tcfg, device=CPU)
    jstep = jax.jit(lambda st, x: jmoe.moe_apply(jp, x, cfg=jcfg, state=st, ctx=jctx))
    rng = np.random.default_rng(100)
    ys = []
    for step in range(steps):
        x = rng.standard_normal((MOE_B, MOE_S, MOE_D)).astype(np.float32)
        jy, jstate, jm = jstep(jstate, jnp.asarray(x))
        ty, tstate, tm = tmoe.moe_apply(tp, torch.from_numpy(x), cfg=tcfg, state=tstate, ctx=tctx)
        where = f"G {groups} step {step}"
        _assert_state_equal(jstate, tstate, where, capacity_of=(tcfg, MOE_B * MOE_S // groups))
        for key in ("moe_dropped_frac", "moe_distribute_frac"):
            assert float(jm[key]) == float(tm[key]), (where, key)
        for key in ("moe_shard_imbalance", "moe_aux_loss"):
            np.testing.assert_allclose(float(tm[key]), float(jm[key]), rtol=1e-5, err_msg=f"{where}: {key}")
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=1e-5, atol=1e-5, err_msg=where)
        ys.append(ty.numpy())
    return ys


@pytest.mark.parametrize("adaptive", [False, True], ids=["static", "adaptive"])
@pytest.mark.parametrize("groups", [1, 2, 4])
def test_moe_groups_match_reference(groups, adaptive):
    _moe_run(groups, adaptive)


def test_group_count_changes_the_result():
    """The control: on this input G 1 and G 4 give other outputs, so the
    tests above would see a port that ignored the groups."""
    one, four = _moe_run(1, False, steps=1), _moe_run(4, False, steps=1)
    assert np.abs(one[0] - four[0]).max() > 1e-2


def test_each_kernel_launches_once_a_layer_whatever_g():
    """One call of each dispatch step a layer at G 4: the gating on all the
    tokens, the histogram over G·E bins, the gather into all G·E·C_buf
    slots."""
    _, tcfg = _cfgs(True, capacity_factor=1.0)
    tp = params_from_numpy(_numpy_params(1.5), device=CPU, dtype=torch.float32)
    ctx = tmoe.SpmdCtx(num_groups=4, num_ep_shards=N_EP)
    calls = []

    def rec(name, fn):
        return lambda *a: (calls.append((name, [tuple(t.shape) if torch.is_tensor(t) else t for t in a])),
                           fn(*a))[1]

    ops = tmoe.DispatchOps(rec("gating", tmoe.PLAIN_OPS.gating), rec("histogram", tmoe.PLAIN_OPS.histogram),
                           rec("dispatch", tmoe.PLAIN_OPS.dispatch), tmoe.PLAIN_OPS.scan)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((MOE_B, MOE_S, MOE_D)).astype(np.float32))
    tmoe.moe_apply(tp, x, cfg=tcfg, state=tmoe.moe_state_init(tcfg, device=CPU), ctx=ctx, ops=ops)
    T = MOE_B * MOE_S
    _, c_buf = tmoe.capacities(tcfg, T // 4)
    E, k = tcfg.moe.num_experts, tcfg.moe.top_k
    assert calls == [("gating", [(T, E), k]), ("histogram", [(T * k,), 4 * E]),
                     ("dispatch", [(T, MOE_D), (4 * E * c_buf,), (4 * E * c_buf,)])]


@pytest.mark.parametrize("seed", range(3))
def test_dispatch_plan_of_groups_against_a_loop(seed):
    """Three groups: each group's picks walked in arrival order against its
    own ranks, into expert-major slots ``(e·G + g)·c_buf + rank`` fed by
    token ``g·Tg + t``."""
    g_n, e, k, c_buf, tokens = 3, 6, 2, 5, 17
    rng = np.random.default_rng(seed)
    flat_e = rng.integers(0, e, (g_n, tokens * k)).astype(np.int32)
    cap = rng.integers(1, c_buf + 1, e).astype(np.int32)
    counts = np.stack([np.bincount(f, minlength=e) for f in flat_e]).astype(np.float32)
    order, slot_sorted, keep, src, valid = tmoe.dispatch_plan(
        torch.from_numpy(flat_e), torch.from_numpy(counts), torch.from_numpy(cap), c_buf=c_buf, top_k=k)
    n_slots = g_n * e * c_buf
    want_slot = np.full(g_n * tokens * k, n_slots)
    want_src = np.zeros(n_slots, np.int32)
    want_valid = np.zeros(n_slots, bool)
    for g in range(g_n):
        fill = np.zeros(e, int)
        for i, ex in enumerate(flat_e[g]):
            rank = fill[ex]
            fill[ex] += 1
            if rank < cap[ex]:
                slot = (ex * g_n + g) * c_buf + rank
                want_slot[g * tokens * k + i] = slot
                want_src[slot] = g * tokens + i // k
                want_valid[slot] = True
    got_slot = np.empty(g_n * tokens * k, int)
    got_slot[order.numpy()] = slot_sorted.numpy()
    np.testing.assert_array_equal(got_slot, want_slot)
    np.testing.assert_array_equal(keep.numpy(), slot_sorted.numpy() < n_slots)
    np.testing.assert_array_equal(valid.numpy(), want_valid)
    np.testing.assert_array_equal(src.numpy()[want_valid], want_src[want_valid])


def test_model_loss_and_gradients_at_four_groups():
    jm, tm = j_build(_cfg(j_get_config)), t_build(_cfg(t_get_config))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU)
    batch = _batch(np.random.default_rng(1))
    jctx, tctx = jmoe.SpmdCtx(num_groups=GROUPS), tmoe.SpmdCtx(num_groups=GROUPS)
    jdk = jm.dyskew_init(jctx)
    tdk = state_from_numpy(without_links(jax.tree.map(np.asarray, jdk)), device=CPU)

    def jloss(p):
        return jm.loss(p, jax.tree.map(jnp.asarray, batch), dyskew=jdk, ctx=jctx)
    (jl, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)

    flat = flatten_with_paths(tparams)
    live = [v.detach().requires_grad_(True) for _, v in flat]
    it = iter(live)
    tree = t_transformer.tree_map(lambda _: next(it), tparams)
    tl, taux = tm.loss(tree, {k: torch.from_numpy(v) for k, v in batch.items()}, dyskew=tdk, ctx=tctx)
    tgrads = torch.autograd.grad(tl, live)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jflat = _flat_ref(jgrads)
    for (key, _), g in zip(flat, tgrads):
        assert _norm_err(jflat[key], g.numpy()) <= 1e-3, key
    assert_metrics_match(jaux["metrics"], taux["metrics"], "Model.loss at G 4")
    assert float(taux["metrics"]["moe_dropped_frac"]) > 0.0
    assert_links_match(jaux["dyskew"], flat_numpy(taux["dyskew"]), "Model.loss at G 4")


# --------------------------------------------------------------------- #
# Ranks: one spawn of two ranks, one of four
# --------------------------------------------------------------------- #


def _ranks_batches(seed, n, rows):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(1, 256, (rows, 32)).astype(np.int32)
        targets = rng.integers(1, 256, (rows, 32)).astype(np.int32)
        targets[rng.random((rows, 32)) < 0.15] = -1
        out.append({"tokens": tokens, "targets": targets})
    return out


def _microbatch_order(batch, nm):
    """The ranks' rows (rank-contiguous) as the reference's global batch:
    microbatch-major, then rank."""
    b = next(iter(batch.values())).shape[0] // RANKS
    idx = [r * b + i * (b // nm) + j for i in range(nm) for r in range(RANKS) for j in range(b // nm)]
    return {k: v[idx] for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference():
    jm = j_build(_cfg(j_get_config))
    jopt = JOpt(name="adamw", warmup_steps=2, total_steps=20)
    jctx = jmoe.SpmdCtx(num_groups=GROUPS)
    jstate = j_train_state_init(jm, jopt, jax.random.PRNGKey(1), ctx=jctx)
    steps = {nm: jax.jit(j_make_train_step(jm, jopt, JStep(num_microbatches=nm), ctx=jctx)) for nm in (1, 2)}
    return steps, jstate, without_links(jax.tree.map(np.asarray, jstate))


@pytest.fixture(scope="module")
def two_ranks(reference, tmp_path_factory):
    _, _, state_np = reference
    where = tmp_path_factory.mktemp("ranks2")
    job = {"cfg": _cfg(t_get_config), "groups": GROUPS, "state": state_np,
           "batches": _ranks_batches(7, 1, 8), "dir": str(where / "ckpt")}
    res = run_ranks(worker.run_rank, 2, "save_checkpoint", job, timeout=RANK_TIMEOUT_S, store_dir=str(where))
    return job, res


@pytest.fixture(scope="module")
def four_ranks(reference, two_ranks, tmp_path_factory):
    _, _, state_np = reference
    where = tmp_path_factory.mktemp("ranks4")
    cfg = _cfg(t_get_config)
    rng = np.random.default_rng(11)
    common = {"cfg": cfg, "groups": GROUPS, "state": state_np}
    job = {
        "train_steps": dict(common, batches=_ranks_batches(2, STEPS, 8), microbatches=[1, 2]),
        "compressed": {"grads": {"a": rng.standard_normal((RANKS, 96)).astype(np.float32),
                                 "b": 3 * rng.standard_normal((RANKS, 8, 16)).astype(np.float32)},
                       "residual": {"a": 0.01 * rng.standard_normal((RANKS, 96)).astype(np.float32),
                                    "b": np.zeros((RANKS, 8, 16), np.float32)}},
        "counted_steps": dict(common, batches=_ranks_batches(5, 3, 8)),
        "restore_checkpoint": dict(common, dir=two_ranks[0]["dir"], batches=two_ranks[0]["batches"] * 2),
        "one_rank_group": {"cfg": cfg, "data": DataConfig(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4),
                           "opt": OptimizerConfig(name="adamw", warmup_steps=1, total_steps=4)},
    }
    res = run_ranks(worker.run_rank, RANKS, "several", job, timeout=RANK_TIMEOUT_S, store_dir=str(where))
    return job, res


def _same_on_every_rank(states, where):
    for key, a in states[0].items():
        if key.startswith("dyskew/"):
            for r, other in enumerate(states[1:], 1):
                np.testing.assert_array_equal(other[key], a, err_msg=f"{where}: rank {r} {key}")


@pytest.mark.parametrize("steps", [1, STEPS])
@pytest.mark.parametrize("nm", [1, 2])
def test_four_ranks_match_the_reference_step(reference, four_ranks, nm, steps):
    """Each rank's state after ``steps`` steps against ``repro``'s jitted
    step at ``num_groups`` 4 on the global batch, and every rank's link
    states the same bits."""
    jsteps, jstate, _ = reference
    jstep = jsteps[nm]
    job, res = four_ranks
    for i, batch in enumerate(job["train_steps"]["batches"][:steps]):
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, _microbatch_order(batch, nm)))
        for r, rank in enumerate(res):
            got = rank["train_steps"][nm]["metrics"][i]
            assert_metrics_match(jmet, got, f"rank {r} nm {nm} step {i + 1}")
    states = [rank["train_steps"][nm]["states"][steps - 1] for rank in res]
    lr_sum = sum(m["lr"] for m in res[0]["train_steps"][nm]["metrics"][:steps])
    jflat = _flat_ref(jstate)
    for r, flat in enumerate(states):
        where = f"rank {r} nm {nm} after {steps} steps"
        assert sorted(flat) == sorted(jflat), where
        for key, a in jflat.items():
            b = flat[key]
            assert a.shape == b.shape and a.dtype == b.dtype, (where, key)
            if key.endswith("/ema_loads"):
                np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f"{where}: {key}")
            elif a.dtype.kind != "f" or key.startswith("dyskew/"):
                np.testing.assert_array_equal(b, a, err_msg=f"{where}: {key}")
            elif key.startswith("params/"):
                v = jflat["opt/v/" + key[len("params/"):]]
                noise = (v > 0) & (v <= NOISE_FLOOR * v.max())
                assert noise.mean() <= 0.05, (where, key, noise.mean())
                diff = np.abs(a - b)
                assert diff[~noise].max() <= 1e-5 * np.abs(a).max(), (where, key)
                assert diff[noise].max(initial=0.0) <= 2 * lr_sum, (where, key)
            else:
                assert _norm_err(a, b) <= 2e-3, (where, key, _norm_err(a, b))
    _same_on_every_rank(states, f"nm {nm} after {steps} steps")
    assert sorted(k for k in states[0] if k.startswith("dyskew/")) == ["dyskew/l0/ema_loads"]


def test_allreduce_compressed_matches_reference(four_ranks):
    """Four ranks against ``repro``'s ``allreduce_compressed`` under
    ``jax.vmap(axis_name="pod")`` over a leading axis of four shards: the
    shared scale (the MAX all_reduce's result) and each rank's int8 payload
    (the SUM all_reduce's input) equal, the mean and residual rtol 1e-6."""
    job, res = four_ranks
    grads, residual = job["compressed"]["grads"], job["compressed"]["residual"]

    def shard(g, r):
        mean, new_r = j_allreduce_compressed(g, r, "pod")
        # The reference's shared scale and payload, by its own expressions.
        corrected = jax.tree.map(lambda a, b: a.astype(jnp.float32) + b, g, r)
        scale = jax.tree.map(lambda c: jnp.maximum(jax.lax.pmax(jnp.max(jnp.abs(c)), "pod") / 127.0, 1e-12),
                             corrected)
        q = jax.tree.map(lambda c, s: jnp.clip(jnp.round(c / s), -127, 127).astype(jnp.int8), corrected, scale)
        return mean, new_r, scale, q

    jmean, jres, jscale, jq = jax.vmap(shard, axis_name="pod")(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, residual))
    keys = sorted(grads)                          # the port's order of leaves
    for r, rank in enumerate(res):
        out = rank["compressed"]
        (amax_call,), sums = out["calls"][:1], out["calls"][1:]
        assert amax_call["op"] == "allreduce_" and [c["op"] for c in sums] == ["allreduce_"] * len(keys)
        scales = np.maximum(amax_call["out"][0] / 127.0, 1e-12).astype(np.float32)
        for i, key in enumerate(keys):
            assert scales[i] == np.asarray(jscale[key])[r], (r, key)
            np.testing.assert_array_equal(sums[i]["in"][0], np.asarray(jq[key])[r].astype(np.int32))
            np.testing.assert_allclose(out["mean"][key], np.asarray(jmean[key])[r], rtol=1e-6)
            np.testing.assert_allclose(out["residual"][key], np.asarray(jres[key])[r], rtol=1e-6, atol=1e-12)


def test_collectives_are_counted(four_ranks):
    """The op counter's records of one train step equal what the step
    issues: per MoE layer, one all_reduce of G·E counts and E probability
    sums (twice: remat recomputes each block); the loss's sum and count;
    one float32 all_reduce a parameter leaf; with compression, one MAX of
    every leaf's amax and one int32 sum a leaf.  ``analyze`` turns them into
    a non-zero ``t_collective``."""
    job, res = four_ranks
    cfg = job["counted_steps"]["cfg"]
    E = cfg.moe.num_experts
    n_moe = len(t_transformer.moe_layer_positions(cfg)) * t_transformer.num_blocks(cfg)
    leaves = [v for k, v in flatten_with_paths(job["counted_steps"]["state"]["params"])]
    moe = [4 * (GROUPS * E + E)] * n_moe
    # The forward's layers, the loss, the recompute's layers, the gradients.
    issued = moe + [8] + (moe if cfg.remat else [])
    want = {
        "plain": issued + [4 * v.size for v in leaves],
        "compressed": issued + [4 * len(leaves)] + [4 * v.size for v in leaves],
    }
    for r, rank in enumerate(res):
        for name, expect in want.items():
            recs = rank["counted_steps"][name]["result"]["collectives"]
            assert [c["bytes"] for c in recs] == expect, (r, name)
            assert {(c["op"], c["kind"], c["group"]) for c in recs} == {("allreduce_", "all-reduce", RANKS)}
            terms = t_analysis.analyze(rank["counted_steps"][name]["result"], RANKS, 1.0)
            wire = sum(2.0 * b * (RANKS - 1) / RANKS for b in expect)
            assert terms.collective_bytes_global == pytest.approx(wire * RANKS)
            assert terms.by_kind["all-reduce"] == int(wire) and terms.t_collective > 0
    # The compressed steps train, with a residual of each rank's own.
    for name in want:
        losses = [rank["counted_steps"][name]["losses"] for rank in res]
        assert all(np.isfinite(losses[0])) and all(l == losses[0] for l in losses)
        _same_on_every_rank([rank["counted_steps"][name]["dyskew"] for rank in res], name)
    res_a = res[0]["counted_steps"]["compressed"]["residual"]
    res_b = res[1]["counted_steps"]["compressed"]["residual"]
    assert any(np.abs(res_a[k]).max() > 0 and not np.array_equal(res_a[k], res_b[k]) for k in res_a)
    plain, comp = (res[0]["counted_steps"][n]["losses"] for n in ("plain", "compressed"))
    assert plain[0] == comp[0]
    np.testing.assert_allclose(comp, plain, rtol=1e-2)


def test_a_group_of_one_rank_is_no_group(four_ranks):
    """Through ``train/loop.py``: a group of one rank (its collectives
    issued, each the identity) gives the same bits as no group, in the
    losses and the whole train state."""
    _, res = four_ranks
    for rank in res:
        out = rank["one_rank_group"]
        assert out["losses"][0] == out["losses"][1] and out["states_equal"]


def test_one_process_has_no_group_to_compress_over():
    from repro_torch.train.step import StepConfig, make_train_step

    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_step(t_build(_cfg(t_get_config)), OptimizerConfig(), StepConfig(grad_compression=True))


def test_checkpoint_of_two_ranks_restores_anywhere(two_ranks, four_ranks):
    """Written by 2 ranks: each of them reads back its own residual; 4
    ranks and one process read the replicated state bit for bit and start
    the residual at zero (another world size); 4 ranks train on from it."""
    job2, res2 = two_ranks
    _, res4 = four_ranks
    saved = res2[0]["saved"]
    for r, rank in enumerate(res2):
        for key, a in rank["saved"].items():
            np.testing.assert_array_equal(rank["restored"][key], a, err_msg=f"2 ranks, rank {r}: {key}")
        if r:
            assert any(not np.array_equal(rank["saved"][k], saved[k]) for k in saved
                       if k.startswith("grad_residual/"))
    like = state_from_numpy(job2["state"], device=CPU)
    like["grad_residual"] = tree_map(lambda p: torch.ones(p.shape, dtype=torch.float32), like["params"])
    one = {k: v.numpy() for k, v in flatten_with_paths(CheckpointManager(job2["dir"]).restore(like))}
    for where, got in [("one process", one)] + [(f"4 ranks, rank {r}", rank["restore_checkpoint"]["restored"])
                                                  for r, rank in enumerate(res4)]:
        assert sorted(got) == sorted(saved), where
        for key, a in saved.items():
            if key.startswith("grad_residual/"):
                assert not got[key].any(), (where, key)
            else:
                np.testing.assert_array_equal(got[key], a, err_msg=f"{where}: {key}")
    losses = [rank["restore_checkpoint"]["loss_after"] for rank in res4]
    assert np.isfinite(losses[0]) and all(l == losses[0] for l in losses)
