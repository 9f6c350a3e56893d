"""The expert-parallel model axis through the port against ``repro`` on the
CPU.

Ranks of a gloo group on the CPU, each a process of
``tests/torch_ep_worker.py`` (one spawn a mesh, module-scoped fixtures,
every wait with its own time limit), on the meshes (data 1, model 2),
(data 1, model 4) and (data 2, model 2).  The M ranks of a model group hold
the same rows and each E/M of the experts of every expert leaf; each is
held to ``repro``'s single-device functions at ``SpmdCtx(num_groups=G,
num_ep_shards=M)`` on the global batch, an expert leaf to the reference's
slice of it:

  * ``moe_apply`` at G = D and G = 2D, adaptive and static, both combines,
    on reduced granite's shape (E 8, top-2) with a skewed router and
    ``capacity_factor`` 1.0, two carried steps; each dispatch step called
    once, the gather on the shard's slots only;
  * ``Model.loss`` and every gradient leaf at each mesh, with a control
    that drops ``to_shard``: the router, the embeddings and the attention
    leaves then lose (M−1)/M of their gradient through the gather;
  * two ``make_train_step`` steps (AdamW) at each mesh, and with two
    microbatches at (2, 2); one Adafactor step of reduced
    ``kimi-k2-1t-a32b`` at (1, 2);
  * prefill and two decode steps at each mesh, both combines at (1, 4);
  * a checkpoint written at (1, 2) restored at (1, 2), (1, 4), on the data
    group of (2, 2) alone (the manager as a (data 2, model 1) mesh reads it)
    and in one process;
  * the op counter's records of the model group's collectives against the
    bytes a train step and a prefill issue, at (1, 4);
  * what must raise.

Reduced granite (float32, ``capacity_factor`` 1.0) as in
``tests/test_torch_ranks.py``.  Tolerances, as ``tests/test_torch_ranks.py``
states them:
  * ``moe_apply``: ``y`` rtol/atol 1e-5; the link states' integer leaves,
    ``moe_dropped_frac`` and ``moe_distribute_frac`` EQUAL; link float
    metrics and ``ema_loads`` rtol 1e-6; ``moe_aux_loss`` and
    ``moe_shard_imbalance`` rtol 1e-5.
  * ``Model.loss``: loss rtol 1e-5, each gradient leaf
    ``max|Δ| <= 1e-3 · max|g_ref|``; the control leaves the router's and
    the embeddings' gradients more than 1e-2 · max|g_ref| off.
  * train steps: losses rtol 1e-5, ``grad_norm`` rtol 1e-4, the routing
    metrics and ``lr`` EQUAL; parameters ``max|Δ| <= 1e-5 · max|p|``
    (elements whose reference second moment is below ``NOISE_FLOOR`` of
    their leaf's largest, at most 5 % of a leaf, within ``2 · Σ lr``, as
    there), moments ``2e-3 · max|m|``, ``ema_loads`` rtol 1e-6, link
    states and the step counter EQUAL, and every rank's link states and
    ``ema_loads`` the same bits as every other rank's.
  * prefill and decode: logits rtol 1e-5 (atol 1e-5 of logits of order
    one).
  * checkpoint: EQUAL (bit for bit).
  * collective records: EQUAL to the bytes issued, counted from the shapes.
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
from repro.models.perf_flags import PerfFlags as JFlags, use_flags as j_use_flags
from repro.optim.optimizers import OptimizerConfig as JOpt
from repro.train.step import StepConfig as JStep
from repro.train.step import make_train_step as j_make_train_step
from repro.train.step import train_state_init as j_train_state_init
from repro_torch.checkpoint.manager import CheckpointManager, flatten_with_paths
from repro_torch.config.base import get_config as t_get_config
from repro_torch.launch import mesh as t_mesh
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import transformer as t_transformer
from repro_torch.models.layers import moe as tmoe
from repro_torch.models.model_api import build as t_build
from repro_torch.models.param import expert_axes, expert_rules, expert_shard, slice_shards
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.roofline import analysis as t_analysis
from repro_torch.train.step import train_state_init, train_state_specs

import torch_ep_worker as worker
from test_torch_moe import _cfgs, _numpy_params
from test_torch_moe import D as MOE_D, S as MOE_S
from test_torch_ranks import NOISE_FLOOR, _cfg
from test_torch_train import _flat_ref, _norm_err, assert_metrics_match

KIMI = "kimi-k2-1t-a32b"
CPU = "cpu"
#: The meshes, (data, model).
MESHES = ((1, 2), (1, 4), (2, 2))
MOE_E, MOE_K, MOE_B = 8, 2, 4
MOE_STEPS = 2
ROWS, SEQ, STEPS = 4, 32, 2
PROMPT, FEED = 16, 2
#: Seconds each wait on a rank may take (a process start, torch's import,
#: every body's reduced steps: about 20 s on an idle host, several times that
#: when six test workers share the cores).
RANK_TIMEOUT_S = 600


def _id(mesh):
    return f"{mesh[0]}x{mesh[1]}"


def _opt(name="adamw"):
    return JOpt(name=name, warmup_steps=2, total_steps=20), OptimizerConfig(name=name, warmup_steps=2, total_steps=20)


def _batches(seed, n, rows=ROWS):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        tokens = rng.integers(1, 256, (rows, SEQ)).astype(np.int32)
        targets = rng.integers(1, 256, (rows, SEQ)).astype(np.int32)
        targets[rng.random((rows, SEQ)) < 0.15] = -1
        out.append({"tokens": tokens, "targets": targets})
    return out


def _microbatch_order(batch, data, nm):
    """The data ranks' rows (rank-contiguous) as the reference's global
    batch: microbatch-major, then data rank."""
    b = next(iter(batch.values())).shape[0] // data
    idx = [r * b + i * (b // nm) + j for i in range(nm) for r in range(data) for j in range(b // nm)]
    return {k: v[idx] for k, v in batch.items()}


def _ranks(mesh):
    """(global rank, data index, model index) of every rank of ``mesh``."""
    data, model = mesh
    return [(d * model + m, d, m) for d in range(data) for m in range(model)]


def _slice(a, key, axes, m, model):
    return np.asarray(expert_shard(a, axes[key], m, model)) if key in axes else a


def _moe_cases(mesh):
    data = mesh[0]
    return [(g, adaptive, scatter) for g in (data, 2 * data) for adaptive in (False, True)
            for scatter in (False, True)]


# --------------------------------------------------------------------- #
# The reference, in this process
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def moe_inputs():
    rng = np.random.default_rng(100)
    return _numpy_params(1.5, e=MOE_E), [rng.standard_normal((MOE_B, MOE_S, MOE_D)).astype(np.float32)
                                         for _ in range(MOE_STEPS)]


@pytest.fixture(scope="module")
def moe_reference(moe_inputs):
    """``repro``'s ``moe_apply`` at each (G, M, adaptive, scatter) the meshes
    run: per step (y, link state, metrics)."""
    p_np, xs = moe_inputs
    jp = {k: jnp.asarray(v) for k, v in p_np.items()}
    out = {}
    for mesh in MESHES:
        for groups, adaptive, scatter in _moe_cases(mesh):
            key = (groups, mesh[1], adaptive, scatter)
            if key in out:
                continue
            jcfg, _ = _cfgs(adaptive, capacity_factor=1.0, e=MOE_E, k=MOE_K)
            jctx = jmoe.SpmdCtx(num_groups=groups, num_ep_shards=mesh[1])
            state = jmoe.moe_state_init(jcfg, jctx)
            with j_use_flags(JFlags(moe_scatter_combine=scatter)):
                step = jax.jit(lambda st, x, c=jcfg, ctx=jctx: jmoe.moe_apply(jp, x, cfg=c, state=st, ctx=ctx))
                runs = []
                for x in xs:
                    y, state, m = step(state, jnp.asarray(x))
                    runs.append((np.asarray(y), jax.tree.map(np.asarray, state), {k: float(v) for k, v in m.items()}))
            out[key] = runs
    return out


@pytest.fixture(scope="module")
def granite():
    jm = j_build(_cfg(j_get_config))
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, jax.tree.map(np.asarray, jparams)


@pytest.fixture(scope="module")
def train_reference():
    """Per mesh and microbatch count: the reference's initial state (numpy)
    and its states and metrics after each of STEPS jitted steps at
    ``num_groups`` = data, ``num_ep_shards`` = model on the global batch."""
    jm = j_build(_cfg(j_get_config))
    jopt, _ = _opt()
    batches = _batches(2, STEPS)
    out = {}
    for mesh in MESHES:
        jctx = jmoe.SpmdCtx(num_groups=mesh[0], num_ep_shards=mesh[1])
        init = j_train_state_init(jm, jopt, jax.random.PRNGKey(1), ctx=jctx)
        for nm in ((1, 2) if mesh == (2, 2) else (1,)):
            step = jax.jit(j_make_train_step(jm, jopt, JStep(num_microbatches=nm), ctx=jctx))
            state, runs = init, []
            for batch in batches:
                state, met = step(state, jax.tree.map(jnp.asarray, _microbatch_order(batch, mesh[0], nm)))
                runs.append((_flat_ref(state), met))
            out[mesh, nm] = runs
        out[mesh, "init"] = jax.tree.map(np.asarray, init)
    return batches, out


# --------------------------------------------------------------------- #
# The ranks: one spawn a mesh
# --------------------------------------------------------------------- #


def _spawn(mesh, job, tmp_path_factory):
    where = tmp_path_factory.mktemp(f"ep{_id(mesh)}")
    return run_ranks(worker.run_rank, mesh[0] * mesh[1], mesh[1], job, timeout=RANK_TIMEOUT_S,
                     store_dir=str(where))


def _common_job(mesh, moe_inputs, granite, train_reference):
    p_np, xs = moe_inputs
    jm, _, params_np = granite
    batches, ref = train_reference
    jctx = jmoe.SpmdCtx(num_groups=mesh[0], num_ep_shards=mesh[1])
    cfg = _cfg(t_get_config)
    tokens = np.random.default_rng(3).integers(1, 256, (ROWS, PROMPT + FEED)).astype(np.int32)
    return {
        "moe_cases": {"cases": _moe_cases(mesh), "params": p_np, "xs": xs,
                      "cfgs": {a: _cfgs(a, capacity_factor=1.0, e=MOE_E, k=MOE_K)[1] for a in (False, True)}},
        "train_steps": {"cfg": cfg, "groups": mesh[0], "state": ref[mesh, "init"], "batches": batches,
                        "microbatches": [1, 2] if mesh == (2, 2) else [1]},
        "serve": {"cfg": cfg, "groups": mesh[0], "params": params_np, "tokens": tokens[:, :PROMPT],
                  "feed": tokens[:, PROMPT:], "scatter": [False, True] if mesh == (1, 4) else [False]},
        "loss_grads": {"cfg": cfg, "groups": mesh[0], "params": params_np,
                       "dyskew": jax.tree.map(np.asarray, jm.dyskew_init(jctx)), "batch": _batches(1, 1)[0]},
    }


@pytest.fixture(scope="module")
def kimi_reference():
    jm = j_build(_kimi(j_get_config))
    jopt, _ = _opt("adafactor")
    jctx = jmoe.SpmdCtx(num_groups=1, num_ep_shards=2)
    init = j_train_state_init(jm, jopt, jax.random.PRNGKey(1), ctx=jctx)
    batch = _batches(4, 1)[0]
    state, met = jax.jit(j_make_train_step(jm, jopt, JStep(), ctx=jctx))(init, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, init), batch, _flat_ref(state), met


def _kimi(get_config):
    cfg = dataclasses.replace(get_config(KIMI).reduced(), dtype="float32")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=1.0))


@pytest.fixture(scope="module")
def mesh_1x2(moe_inputs, granite, train_reference, kimi_reference, tmp_path_factory):
    mesh = (1, 2)
    kimi_init, kimi_batch, _, _ = kimi_reference
    _, ref = train_reference
    where = tmp_path_factory.mktemp("ckpt12")
    job = dict(_common_job(mesh, moe_inputs, granite, train_reference),
               save_checkpoint={"cfg": _cfg(t_get_config), "groups": 1, "state": ref[mesh, "init"],
                                "batch": _batches(7, 1)[0], "dir": str(where / "ckpt")},
               raises={"cfg": _cfg(t_get_config)})
    job["train_steps/kimi"] = {"cfg": _kimi(t_get_config), "groups": 1, "state": kimi_init,
                               "batches": [kimi_batch], "microbatches": [1], "opt": "adafactor"}
    return job, _spawn(mesh, job, tmp_path_factory)


@pytest.fixture(scope="module")
def mesh_1x4(moe_inputs, granite, train_reference, mesh_1x2, tmp_path_factory):
    mesh = (1, 4)
    _, ref = train_reference
    ckpt = mesh_1x2[0]["save_checkpoint"]["dir"]
    job = dict(_common_job(mesh, moe_inputs, granite, train_reference),
               restore_checkpoint={"cfg": _cfg(t_get_config), "groups": 1, "dir": ckpt},
               counted={"cfg": _cfg(t_get_config), "groups": 1, "state": ref[mesh, "init"],
                        "params": granite[2], "batch": _batches(9, 1)[0]})
    return job, _spawn(mesh, job, tmp_path_factory)


@pytest.fixture(scope="module")
def mesh_2x2(moe_inputs, granite, train_reference, mesh_1x2, tmp_path_factory):
    mesh = (2, 2)
    ckpt = mesh_1x2[0]["save_checkpoint"]["dir"]
    job = dict(_common_job(mesh, moe_inputs, granite, train_reference),
               restore_checkpoint={"cfg": _cfg(t_get_config), "groups": 2, "dir": ckpt, "as_data_only": True})
    return job, _spawn(mesh, job, tmp_path_factory)


@pytest.fixture(scope="module")
def meshes(mesh_1x2, mesh_1x4, mesh_2x2):
    return {(1, 2): mesh_1x2, (1, 4): mesh_1x4, (2, 2): mesh_2x2}


# --------------------------------------------------------------------- #
# moe_apply
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh", MESHES, ids=_id)
@pytest.mark.parametrize("case", range(8))
def test_moe_apply_matches_reference(meshes, moe_reference, mesh, case):
    job, res = meshes[mesh]
    groups, adaptive, scatter = job["moe_cases"]["cases"][case]
    data, model = mesh
    ref = moe_reference[groups, model, adaptive, scatter]
    T = MOE_B * MOE_S // data
    Gl = groups // data
    _, c_buf = tmoe.capacities(_cfgs(adaptive, capacity_factor=1.0, e=MOE_E, k=MOE_K)[1], T // Gl)
    for r, d, m in _ranks(mesh):
        out = res[r]["moe_cases"][case]
        where = f"mesh {_id(mesh)} rank {r} G {groups} adaptive {adaptive} scatter {scatter}"
        assert out["w_gate"][0] == MOE_E // model, where
        assert out["calls"] == [("gating", [(T, MOE_E), MOE_K]), ("histogram", [(T * MOE_K,), Gl * MOE_E]),
                                ("dispatch", [(T, MOE_D), (Gl * MOE_E * c_buf // model,),
                                              (Gl * MOE_E * c_buf // model,)])], where
        for i, (jy, jstate, jm) in enumerate(ref):
            got = out["steps"][i]
            at = f"{where} step {i}"
            rows = slice(d * MOE_B // data, (d + 1) * MOE_B // data)
            np.testing.assert_allclose(got["y"], jy[rows], rtol=1e-5, atol=1e-5, err_msg=at)
            for key, a in _flat_ref(jstate).items():
                b = got["state"][key]
                if a.dtype.kind in "iub":
                    np.testing.assert_array_equal(b, a, err_msg=f"{at}: {key}")
                else:
                    np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=f"{at}: {key}")
            for key in ("moe_dropped_frac", "moe_distribute_frac"):
                assert got["metrics"][key] == jm[key], (at, key)
            for key in ("moe_shard_imbalance", "moe_aux_loss"):
                np.testing.assert_allclose(got["metrics"][key], jm[key], rtol=1e-5, err_msg=f"{at}: {key}")
        for r2, _, _ in _ranks(mesh):
            for key, a in out["steps"][-1]["state"].items():
                np.testing.assert_array_equal(res[r2]["moe_cases"][case]["steps"][-1]["state"][key], a,
                                              err_msg=f"{where}: rank {r2} {key}")


def test_the_skew_drops(moe_reference):
    """The control: on this router capacity 1.0 drops picks, so the groups
    and the shards decide what the tests above compare."""
    assert max(m["moe_dropped_frac"] for runs in moe_reference.values() for _, _, m in runs) > 0


# --------------------------------------------------------------------- #
# Model.loss and its gradients
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh", MESHES, ids=_id)
def test_loss_and_every_gradient_leaf(granite, meshes, mesh):
    """Each rank's loss, its gradients summed over its data group, against
    the reference's at G = data, M = model; an expert leaf against the
    reference's slice.  The control without ``to_shard`` must leave the
    band in the router's and the embeddings' gradients."""
    jm, jparams, _ = granite
    job, res = meshes[mesh]
    part = job["loss_grads"]
    data, model = mesh
    jctx = jmoe.SpmdCtx(num_groups=data, num_ep_shards=model)
    jdk = jm.dyskew_init(jctx)

    def jloss(p):
        return jm.loss(p, jax.tree.map(jnp.asarray, part["batch"]), dyskew=jdk, ctx=jctx)
    (jl, jaux), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
    jflat = _flat_ref(jgrads)
    axes = expert_axes(t_build(_cfg(t_get_config)).specs())
    for r, _, m in _ranks(mesh):
        out = res[r]["loss_grads"]
        np.testing.assert_allclose(out["loss"], float(jl), rtol=1e-5)
        assert_metrics_match(jaux["metrics"], out["metrics"], f"rank {r}")
        assert sorted(out["grads"]) == sorted(jflat)
        for key, g in out["grads"].items():
            want = _slice(jflat[key], key, axes, m, model)
            assert g.shape == want.shape, (r, key)
            assert _norm_err(want, g) <= 1e-3, (r, key, _norm_err(want, g))
        for key, a in _flat_ref(jaux["dyskew"]).items():
            np.testing.assert_array_equal(out["dyskew"][key], a, err_msg=f"rank {r}: {key}")
        control = out["control_grads"]
        for key in ("blocks/l0/moe/router", "embed/table"):
            assert _norm_err(jflat[key], control[key]) > 1e-2, (r, key, "the control stayed in the band")


# --------------------------------------------------------------------- #
# Train steps
# --------------------------------------------------------------------- #


def _assert_train_state(jflat, flat, axes, m, model, lr_sum, where, noise_cap=0.05):
    """``noise_cap``: the largest share of a leaf whose second moment may be
    at rounding (None: any share, each such element still within
    ``2 · lr_sum``)."""
    assert sorted(flat) == sorted(jflat), where
    for key, a in jflat.items():
        a = _slice(a, key, axes, m, model)
        b = flat[key]
        assert a.shape == b.shape and a.dtype == b.dtype, (where, key)
        if key.endswith("/ema_loads"):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f"{where}: {key}")
        elif a.dtype.kind != "f" or key.startswith("dyskew/"):
            np.testing.assert_array_equal(b, a, err_msg=f"{where}: {key}")
        elif key.startswith("params/") and "opt/v/" + key[len("params/"):] in jflat:
            v = _slice(jflat["opt/v/" + key[len("params/"):]], "opt/v/" + key[len("params/"):], axes, m, model)
            noise = (v > 0) & (v <= NOISE_FLOOR * v.max())
            assert noise_cap is None or noise.mean() <= noise_cap, (where, key, noise.mean())
            diff = np.abs(a - b)
            assert diff[~noise].max() <= 1e-5 * np.abs(a).max(), (where, key)
            assert diff[noise].max(initial=0.0) <= 2 * lr_sum, (where, key)
        elif key.startswith("params/"):
            assert _norm_err(a, b) <= 1e-5, (where, key, _norm_err(a, b))
        else:
            assert _norm_err(a, b) <= 2e-3, (where, key, _norm_err(a, b))


@pytest.mark.parametrize("mesh,nm", [((1, 2), 1), ((1, 4), 1), ((2, 2), 1), ((2, 2), 2)],
                         ids=["1x2", "1x4", "2x2", "2x2-microbatches"])
def test_train_steps_match_reference(meshes, train_reference, mesh, nm):
    """Two AdamW steps on every rank against the reference's jitted step at
    G = data, M = model on the global batch; every rank's link states the
    same bits."""
    _, ref = train_reference
    job, res = meshes[mesh]
    _, opt = _opt()
    axes = expert_axes(train_state_specs(t_build(_cfg(t_get_config)), opt))
    runs = ref[mesh, nm]
    for r, _, m in _ranks(mesh):
        got = res[r]["train_steps"][nm]
        lr_sum = 0.0
        for i, (jflat, jmet) in enumerate(runs):
            where = f"mesh {_id(mesh)} nm {nm} rank {r} step {i + 1}"
            assert_metrics_match(jmet, got["metrics"][i], where)
            lr_sum += got["metrics"][i]["lr"]
            _assert_train_state(jflat, got["states"][i], axes, m, mesh[1], lr_sum, where)
    last = [res[r]["train_steps"][nm]["states"][-1] for r, _, _ in _ranks(mesh)]
    for key, a in last[0].items():
        if key.startswith("dyskew/"):
            for r, other in enumerate(last[1:], 1):
                np.testing.assert_array_equal(other[key], a, err_msg=f"rank {r}: {key}")
    assert last[0]["dyskew/l0/link/tick"].tolist() == [STEPS * nm] * t_transformer.num_blocks(_cfg(t_get_config))


def test_adafactor_step_of_kimi(kimi_reference, mesh_1x2):
    """One Adafactor step of reduced kimi-k2 at (1, 2): the update RMS of an
    expert leaf over the whole leaf (summed over the model group)."""
    _, _, jflat, jmet = kimi_reference
    _, res = mesh_1x2
    _, opt = _opt("adafactor")
    axes = expert_axes(train_state_specs(t_build(_kimi(t_get_config)), opt))
    assert any(k.startswith("opt/v/") and k in axes for k in jflat)
    for r, _, m in _ranks((1, 2)):
        got = res[r]["train_steps/kimi"][1]
        assert_metrics_match(jmet, got["metrics"][0], f"kimi rank {r}")
        _assert_train_state(jflat, got["states"][0], axes, m, 2, got["metrics"][0]["lr"], f"kimi rank {r}")


# --------------------------------------------------------------------- #
# Serving
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh", MESHES, ids=_id)
def test_prefill_and_decode_match_reference(granite, meshes, mesh):
    jm, jparams, _ = granite
    job, res = meshes[mesh]
    part = job["serve"]
    data, model = mesh
    jctx = jmoe.SpmdCtx(num_groups=data, num_ep_shards=model)
    for scatter in part["scatter"]:
        with j_use_flags(JFlags(moe_scatter_combine=scatter)):
            prefill = jax.jit(lambda p, i, s: jm.prefill(p, i, s, ctx=jctx))
            decode = jax.jit(lambda p, s, t: jm.decode_step(p, s, t, ctx=jctx))
            state = jm.decode_state_init(ROWS, PROMPT + FEED)
            logits, state = prefill(jparams, {"tokens": jnp.asarray(part["tokens"])}, state)
            want = [np.asarray(logits)]
            for t in range(FEED):
                logits, state = decode(jparams, state, jnp.asarray(part["feed"][:, t:t + 1]))
                want.append(np.asarray(logits))
        for r, d, _ in _ranks(mesh):
            rows = slice(d * ROWS // data, (d + 1) * ROWS // data)
            for i, (a, b) in enumerate(zip(want, res[r]["serve"][scatter])):
                np.testing.assert_allclose(b, a[rows], rtol=1e-5, atol=1e-5,
                                           err_msg=f"mesh {_id(mesh)} rank {r} scatter {scatter} step {i}")


# --------------------------------------------------------------------- #
# Checkpoints
# --------------------------------------------------------------------- #


def test_checkpoint_restores_on_any_mesh(mesh_1x2, mesh_1x4, mesh_2x2):
    """Written at (1, 2): the file holds whole leaves (the two ranks' slices
    joined); it restores bit for bit at (1, 2), at (1, 4) as each rank's
    slices, at (2, 2) and on its data group alone (whole leaves), and in
    one process.  Link leaves of another shard count start afresh;
    ``ema_loads`` comes back."""
    job, res12 = mesh_1x2
    _, opt = _opt()
    cfg = _cfg(t_get_config)
    axes = expert_axes(train_state_specs(t_build(cfg), opt))
    saved = [rank["save_checkpoint"]["saved"] for rank in res12]
    for r, rank in enumerate(res12):
        for key, a in rank["save_checkpoint"]["saved"].items():
            np.testing.assert_array_equal(rank["save_checkpoint"]["restored"][key], a, err_msg=f"1x2 rank {r}: {key}")
    whole = {k: (np.concatenate([s[k] for s in saved], axis=axes[k]) if k in axes else saved[0][k])
             for k in saved[0]}
    for k in axes:
        assert saved[0][k].shape[axes[k]] * 2 == whole[k].shape[axes[k]]

    def same(got, model, m, where, links):
        assert sorted(got) == sorted(whole), where
        for key, a in whole.items():
            if key.startswith("dyskew/") and not key.endswith("ema_loads") and not links:
                continue
            np.testing.assert_array_equal(got[key], _slice(a, key, axes, m, model), err_msg=f"{where}: {key}")

    for r, _, m in _ranks((1, 4)):
        same(mesh_1x4[1][r]["restore_checkpoint"]["restored"], 4, m, f"1x4 rank {r}", links=False)
    for r, _, m in _ranks((2, 2)):
        out = mesh_2x2[1][r]["restore_checkpoint"]
        same(out["restored"], 2, m, f"2x2 rank {r}", links=True)
        same(out["data_only"], 1, 0, f"2x2 rank {r}, its data group alone", links=True)
    model = t_build(cfg)
    like = train_state_init(model, opt, torch.Generator().manual_seed(5), device=CPU)
    one = {k: v.numpy() for k, v in flatten_with_paths(CheckpointManager(job["save_checkpoint"]["dir"]).restore(like))}
    same(one, 1, 0, "one process", links=False)


# --------------------------------------------------------------------- #
# Collectives counted
# --------------------------------------------------------------------- #


def _issued(cfg, mesh, groups, tokens, params, train):
    """(kind, group size, bytes) of each collective one step issues, in
    order, on a rank of ``mesh``: a MoE layer's count all_reduce over the
    data group and its all-gather of the expert outputs over the model
    group; in a train step also the loss's sum and count, each block's
    recompute and ``to_shard``'s all_reduce of the tokens' gradient, one
    float32 all_reduce a parameter leaf over the data group, and the
    global norm's all_reduce of the expert leaves' sums of squares over
    the model group."""
    data, model = mesh
    E, d = cfg.moe.num_experts, cfg.d_model
    Gl = groups // data
    _, c_buf = tmoe.capacities(cfg, tokens // Gl)
    nb = t_transformer.num_blocks(cfg)
    per_block = len(t_transformer.moe_layer_positions(cfg))
    layer = [("all-reduce", data, 4 * (groups * E + E)), ("all-gather", model, Gl * E * c_buf * d * 4)]
    if not train:
        return layer * per_block * nb
    out = layer * per_block * nb + [("all-reduce", data, 8)]
    for _ in range(nb):
        out += (layer + [("all-reduce", model, tokens * d * 4)]) * per_block
    out += [("all-reduce", data, 4 * v.size) for _, v in flatten_with_paths(params)]
    out += [("all-reduce", model, 4 * len(expert_axes(t_build(cfg).specs())))]
    return out


def test_collectives_are_counted(granite, mesh_1x4):
    """At (1, 4) the op counter's records of a train step and a prefill
    equal what they issue, the model group's all-gathers and all_reduces
    beside the data group's; ``analyze`` prices the all-gathers at
    R·(M−1)/M on the wire."""
    job, res = mesh_1x4
    cfg = _cfg(t_get_config)
    part = job["counted"]
    tokens = ROWS * SEQ
    params = slice_shards(part["state"]["params"], expert_axes(t_build(cfg).specs()), 0, 4)
    want = {"train": _issued(cfg, (1, 4), 1, tokens, params, True),
            "prefill": _issued(cfg, (1, 4), 1, tokens, params, False)}
    for r, rank in enumerate(res):
        for name, expect in want.items():
            recs = rank["counted"][name]["collectives"]
            assert [(c["kind"], c["group"], c["bytes"]) for c in recs] == expect, (r, name)
            terms = t_analysis.analyze(rank["counted"][name], 4, 1.0)
            gathered = sum(b for kind, _, b in expect if kind == "all-gather")
            assert terms.by_kind["all-gather"] == int(gathered * 3 / 4)
            assert terms.t_collective > 0


# --------------------------------------------------------------------- #
# What raises
# --------------------------------------------------------------------- #


def test_what_raises(mesh_1x2):
    """``num_ep_shards`` other than the model group's size, and a model axis
    that does not divide the experts, each naming both; the pod meshes;
    a model axis that does not divide the ranks; slicing 8 experts 3
    ways."""
    _, res = mesh_1x2
    for rank in res:
        assert "num_ep_shards=4" in rank["raises"]["shards"] and "2 rank" in rank["raises"]["shards"]
        assert "num_ep_shards=2" in rank["raises"]["experts"] and "3 experts" in rank["raises"]["experts"]
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        t_mesh.make_production_mesh(multi_pod=True)
    with pytest.raises(NotImplementedError, match="multi-GPU"):
        t_mesh.dp_axes(True)
    with pytest.raises(ValueError, match="does not divide 4 ranks"):
        t_mesh.init_ranks(0, 4, device=torch.device(CPU), init_method="file:///nonexistent", model=3)
    with pytest.raises(ValueError, match="does not divide 8 experts"):
        expert_shard(np.zeros((2, 8, 3)), 1, 0, 3)


def test_a_rank_holds_its_slice_of_the_init():
    """A rank's init under a model group (the experts-only layout) is the slice of the one-process init at the same seed, leaf by
    leaf; the router stays whole."""
    from repro_torch.models.param import tree_materialize

    model = t_build(_cfg(t_get_config))
    specs = model.specs()
    whole = tree_materialize(specs, torch.Generator().manual_seed(3), device=CPU)
    axes = expert_axes(specs)
    assert sorted(axes) == [f"blocks/l0/moe/{w}" for w in ("w_down", "w_gate", "w_up")]
    for m in range(4):
        mine = tree_materialize(specs, torch.Generator().manual_seed(3), device=CPU, shard=(m, 4),
                                rules=expert_rules())
        want = slice_shards(whole, axes, m, 4)
        for (key, a), (_, b) in zip(flatten_with_paths(want), flatten_with_paths(mine)):
            assert torch.equal(a, b) and b.is_contiguous(), (m, key)
