"""The reference's whole mesh through the port against ``repro`` on the CPU:
``default_rules`` with FSDP of ``embed`` / ``expert_embed`` over the data
axes, the pod meshes, and the sharding switches H2, H6, H8 and H10.

Ranks of a gloo group on the CPU, each a process of
``tests/torch_fsdp_worker.py`` (one spawn a mesh, module-scoped fixtures,
every wait with its own time limit), on the meshes (data 2, model 1),
(4, 1), (2, 2), (pod 2, data 1, model 2) and (pod 2, data 2, model 1).
Each rank holds its slices of the reference's whole parameters
(``param.shard_axes`` / ``slice_shards``) and is held to ``repro``'s
single-device functions on the global batch, at ``SpmdCtx(num_groups=P·D,
num_ep_shards=M)`` for the MoE configs:

  * ``Model.loss`` and every gradient leaf gathered whole, and a prefill of
    16 tokens with two decode steps after it, for reduced granite (MoE,
    ``expert_embed``), starcoder2 (dense, GQA), mamba2, whisper
    (encoder-decoder, the cross cache) and pixtral (the VLM prefix), on
    every mesh; granite's and mamba2's loss and gradients under H6 (every
    weight's d_model over the fused (data, model), heads and widths whole)
    and granite's under H10 (``expert_embed`` whole) at (2, 2);
  * a control: the reduce-scattered leaves summed over the data group once
    more, as a step that all-reduced every leaf would, are D times the
    reference's gradient;
  * an AdamW step of granite at (2, 2), at (4, 1) and at (pod 2, data 2,
    model 1), the last the same bits as (4, 1); with H8 the same bits as
    without it at (2, 2); with H2 at (2, 1) against the reference's H2 step;
    with the int8 reduction, which takes only the leaves still all-reduced;
    an Adafactor step of reduced kimi-k2 at (2, 2) with factored threshold
    16, so that the d_model axis that the data axis slices is a factored
    one;
  * a checkpoint written at (2, 2), restored at (2, 2), (4, 1), (1, 2) and
    in one process;
  * the op counter's records at (2, 1): a prefill's FSDP all-gathers (one a
    data-sliced leaf), a train step's (twice a block leaf: the forward and
    remat's recompute) and its reduce-scatters (one a data-sliced leaf), as
    multisets, and H2's gathers and reduce-scatters at half the bytes.

Without ranks, for every leaf of all ten configs at (16, 16) and (2, 16,
16), under ``default_rules``, H6 and H10, the port's rank-local shapes
equal the reference's ``resolve_pspec`` but for the router, whose
``experts`` axis the port keeps whole.

Configs reduced, in float32; tokens, frames and patches made with numpy
from a seed.  Tolerances are those of ``tests/test_torch_tensor_parallel.py``
(which states their reasons; an FSDP step adds its partial sums in another
order, well inside them):
  * logits rtol 2e-4 and an absolute band of 2e-5 of the reference's
    largest |logit| (whisper 1e-3);
  * ``Model.loss`` rtol 1e-5; each gradient leaf ``max|Δ| <= 1e-3 ·
    max|g_ref|`` (whisper 1e-2); the control's leaves D times the
    reference's within that band, and more than 0.5 of its largest off
    the reference's;
  * train steps: losses rtol 1e-5, ``grad_norm`` rtol 1e-4, ``lr`` and the
    routing metrics EQUAL, parameters and moments as in
    ``tests/test_torch_expert_parallel.py``, ``ema_loads`` as there and
    the same bits on every rank.  H2's step: its gradients reach the optimizer
    through bf16 reduce-scatters, so its parameters are held within 2 ·
    lr (one AdamW step of either sign) and its loss at rtol 1e-5;
  * checkpoint: EQUAL (bit for bit);
  * collective records: EQUAL to the bytes issued.
"""

import collections
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import get_config as j_get_config
from repro.config.base import all_arch_ids
from repro.models import param as j_param
from repro.models.layers import moe as jmoe
from repro.models.model_api import build as j_build
from repro.models.perf_flags import PerfFlags as JFlags, use_flags as j_use_flags
from repro.optim.optimizers import OptimizerConfig as JOpt
from repro.train.step import StepConfig as JStep
from repro.train.step import make_train_step as j_make_train_step
from repro.train.step import train_state_init as j_train_state_init
from repro_torch.checkpoint.manager import CheckpointManager, flatten_with_paths
from repro_torch.config.base import get_config as t_get_config
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import transformer as t_transformer
from repro_torch.models.model_api import build as t_build
from repro_torch.models.param import (default_rules, dp_part, local_shape, shard_axes, slice_index, slice_size,
                                      take_slices)
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train.step import train_state_axes, train_state_init

import torch_fsdp_worker as worker
from test_torch_arch import GRAD_TOL, _params, _reduced, assert_logits
from test_torch_ranks import NOISE_FLOOR
from test_torch_train import ZERO_INIT, _flat_ref, _norm_err, _with_values, assert_metrics_match, without_links

CPU = "cpu"
#: (pod, data, model).
MESHES = ((1, 2, 1), (1, 4, 1), (1, 2, 2), (2, 1, 2), (2, 2, 1))
ROWS, SEQ, PROMPT, DECODE = 4, 32, 16, 2
GRANITE, STARCODER, MAMBA, KIMI = "granite-moe-1b-a400m", "starcoder2-3b", "mamba2-1.3b", "kimi-k2-1t-a32b"
FAMILIES = (GRANITE, STARCODER, MAMBA, "whisper-base", "pixtral-12b")
#: (switch, configs) of the loss and gradients at (2, 2) under H6 and H10.
SWITCHED = (("h6", (GRANITE, MAMBA)), ("h10", (GRANITE,)))
FACTORED = 16
RANK_TIMEOUT_S = 600


def _id(mesh):
    pod, data, model = mesh
    return f"{data}x{model}" if pod == 1 else f"p{pod}x{data}x{model}"


def _shape(mesh):
    pod, data, model = mesh
    return dict({"pod": pod} if pod > 1 else {}, data=data, model=model)


def _ranks(mesh):
    """(global rank, its coordinates) of every rank of ``mesh``."""
    shape = _shape(mesh)
    out = []
    for r in range(mesh[0] * mesh[1] * mesh[2]):
        coords, rest = {}, r
        for ax in reversed(list(shape)):
            coords[ax] = rest % shape[ax]
            rest //= shape[ax]
        out.append((r, coords))
    return out


def _opt(name="adamw", factored=128):
    return (JOpt(name=name, warmup_steps=2, total_steps=20, factored_dim_threshold=factored),
            OptimizerConfig(name=name, warmup_steps=2, total_steps=20, factored_dim_threshold=factored))


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (ROWS, SEQ)).astype(np.int32)}
    out["targets"][rng.random((ROWS, SEQ)) < 0.15] = -1
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((ROWS, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((ROWS, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _batches(cfg, seed, n):
    return [{k: v for k, v in _inputs(cfg, seed + i).items() if k in ("tokens", "targets")} for i in range(n)]


def _gm(mesh):
    """(token groups, expert-parallel shards) of a MoE config on ``mesh``."""
    return mesh[0] * mesh[1], mesh[2]


def _jctx(cfg, gm):
    return jmoe.SpmdCtx(num_groups=gm[0], num_ep_shards=gm[1] if cfg.moe is not None else 1)


def _slice(a, key, axes, mesh, coords):
    """The rank at ``coords``'s slices of the whole ``a`` (at ``key`` of
    ``axes``, ``shard_axes``' map)."""
    return np.asarray(take_slices(a, axes[key], _shape(mesh), coords)) if key in axes else a


def _assert_train_state(jflat, flat, axes, mesh, coords, lr_sum, where, noise_cap=0.05):
    """A rank's flat train state against the reference's sliced to it, as
    ``tests/test_torch_expert_parallel.py`` holds it."""
    assert sorted(flat) == sorted(jflat), where
    for key, a in jflat.items():
        a = _slice(a, key, axes, mesh, coords)
        b = flat[key]
        assert a.shape == b.shape and a.dtype == b.dtype, (where, key)
        if key.endswith("/ema_loads"):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f"{where}: {key}")
        elif a.dtype.kind != "f" or key.startswith("dyskew/"):
            np.testing.assert_array_equal(b, a, err_msg=f"{where}: {key}")
        elif key.startswith("params/") and "opt/v/" + key[len("params/"):] in jflat:
            v = _slice(jflat["opt/v/" + key[len("params/"):]], "opt/v/" + key[len("params/"):], axes, mesh, coords)
            noise = (v > 0) & (v <= NOISE_FLOOR * v.max())
            assert noise_cap is None or noise.mean() <= noise_cap, (where, key, noise.mean())
            diff = np.abs(a - b)
            assert diff[~noise].max(initial=0.0) <= 1e-5 * np.abs(a).max(), (where, key)
            assert diff[noise].max(initial=0.0) <= 2 * lr_sum, (where, key)
        elif key.startswith("params/"):
            assert _norm_err(a, b) <= 1e-5, (where, key, _norm_err(a, b))
        else:
            assert _norm_err(a, b) <= 2e-3, (where, key, _norm_err(a, b))


def _state_axes(cfg, mesh, opt, switch=""):
    return train_state_axes(t_build(cfg), opt, _shape(mesh), worker.rules_of(_shape(mesh), switch))


# --------------------------------------------------------------------- #
# The reference, in this process
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def family_reference():
    """Per config: the reference's numpy parameters and inputs; per (config,
    (G, M)): its loss, metrics and gradients, and the logits of a prefill
    of PROMPT tokens and DECODE decode steps (a MoE config at each (G, M)
    of the meshes; the others do not read it)."""
    out = {}
    for name in FAMILIES:
        jm = j_build(_reduced(j_get_config, name))
        params = jax.tree.map(np.asarray, _params(jm))
        inputs = _inputs(jm.cfg)
        jparams = jax.tree.map(jnp.asarray, params)
        out[name] = {"params": params, "inputs": inputs}
        gms = sorted({_gm(m) for m in MESHES}) if jm.cfg.moe is not None else [(1, 1)]
        for gm in gms:
            jctx = _jctx(jm.cfg, gm)
            batch = jax.tree.map(jnp.asarray, inputs)

            def jloss(p, jm=jm, batch=batch, jctx=jctx):
                return jm.loss(p, batch, ctx=jctx)
            (loss, aux), grads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(jparams)
            served = {k: jnp.asarray(v) for k, v in inputs.items() if k != "targets"}
            served["tokens"] = served["tokens"][:, :PROMPT]
            state = jm.decode_state_init(ROWS, SEQ)
            logits, state = jax.jit(lambda p, i, s, jm=jm, c=jctx: jm.prefill(p, i, s, ctx=c))(jparams, served, state)
            steps = [np.asarray(logits)[:, -1:]]
            decode = jax.jit(lambda p, s, t, jm=jm, c=jctx: jm.decode_step(p, s, t, ctx=c))
            for t in range(PROMPT, PROMPT + DECODE):
                logits, state = decode(jparams, state, jnp.asarray(inputs["tokens"][:, t:t + 1]))
                steps.append(np.asarray(logits))
            out[name, gm] = {"loss": float(loss), "metrics": aux["metrics"], "grads": _flat_ref(grads),
                             "serve": steps}
    return out


def _reference_at(ref, name, mesh):
    return ref[name, _gm(mesh)] if (name, _gm(mesh)) in ref else ref[name, (1, 1)]


#: (name, (G, M), H2) of the reference's train steps.
TRAINED = ((GRANITE, (2, 2), False), (GRANITE, (4, 1), False), (GRANITE, (2, 1), True))


@pytest.fixture(scope="module")
def train_reference():
    """Per (config, (G, M), H2) of TRAINED: the initial state (numpy) and the
    state and metrics after one jitted AdamW step on the global batch;
    kimi-k2's Adafactor step at (2, 2), factored threshold 16."""
    out = {}
    jopt, _ = _opt()
    for name, gm, h2 in TRAINED:
        jm = j_build(_reduced(j_get_config, name))
        jctx = _jctx(jm.cfg, gm)
        state = _with_values(j_train_state_init(jm, jopt, jax.random.PRNGKey(1), ctx=jctx), ZERO_INIT + ("bias",))
        init = without_links(jax.tree.map(np.asarray, state))
        batches = _batches(jm.cfg, 20, 1)
        with j_use_flags(JFlags(cast_before_gather=h2)):
            state, met = jax.jit(j_make_train_step(jm, jopt, JStep(), ctx=jctx))(
                state, jax.tree.map(jnp.asarray, batches[0]))
        out[name, gm, h2] = {"init": init, "batches": batches, "runs": [(_flat_ref(state), met)]}
    jopt, _ = _opt("adafactor", FACTORED)
    jm = j_build(_reduced(j_get_config, KIMI))
    jctx = _jctx(jm.cfg, (2, 2))
    state = j_train_state_init(jm, jopt, jax.random.PRNGKey(1), ctx=jctx)
    init = without_links(jax.tree.map(np.asarray, state))
    batch = _batches(jm.cfg, 30, 1)
    state, met = jax.jit(j_make_train_step(jm, jopt, JStep(), ctx=jctx))(state, jax.tree.map(jnp.asarray, batch[0]))
    out[KIMI] = {"init": init, "batches": batch, "runs": [(_flat_ref(state), met)]}
    return out


# --------------------------------------------------------------------- #
# The ranks: one spawn a mesh
# --------------------------------------------------------------------- #


def _spawn(mesh, job, tmp_path_factory):
    where = tmp_path_factory.mktemp(f"fsdp{_id(mesh)}")
    pod, data, model = mesh
    return run_ranks(worker.run_rank, pod * data * model, model, pod, job, timeout=RANK_TIMEOUT_S,
                     store_dir=str(where))


def _families(family_reference, names=FAMILIES, decode=DECODE, **kw):
    return dict(decode=decode, configs={
        name: {"cfg": _reduced(t_get_config, name), "params": family_reference[name]["params"],
               "inputs": family_reference[name]["inputs"], "prompt": PROMPT} for name in names}, **kw)


def _train(train_reference, key, **kw):
    ref = train_reference[key]
    name = key if isinstance(key, str) else key[0]
    return dict(cfg=_reduced(t_get_config, name), state=ref["init"], batches=ref["batches"], **kw)


@pytest.fixture(scope="module")
def mesh_2x2(family_reference, train_reference, tmp_path_factory):
    mesh = (1, 2, 2)
    job = {"families": _families(family_reference)}
    for switch, names in SWITCHED:
        job[f"families/{switch}"] = _families(family_reference, names, decode=None, switch=switch)
    job["train_steps"] = _train(train_reference, (GRANITE, (2, 2), False))
    job["train_steps/h8"] = _train(train_reference, (GRANITE, (2, 2), False), flags={"constrain_grads": True})
    job["train_steps/adafactor"] = _train(train_reference, KIMI, opt="adafactor", factored=FACTORED)
    job["save_checkpoint"] = {"cfg": _reduced(t_get_config, GRANITE),
                              "state": train_reference[GRANITE, (2, 2), False]["init"],
                              "batch": _batches(_reduced(t_get_config, GRANITE), 40, 1)[0],
                              "dir": str(tmp_path_factory.mktemp("fsdpckpt") / "ckpt")}
    return job, _spawn(mesh, job, tmp_path_factory)


@pytest.fixture(scope="module")
def mesh_2x1(family_reference, train_reference, mesh_2x2, tmp_path_factory):
    mesh = (1, 2, 1)
    cfg = _reduced(t_get_config, GRANITE)
    ckpt = mesh_2x2[0]["save_checkpoint"]["dir"]
    job = {"families": _families(family_reference, control=True),
           "train_steps/h2": _train(train_reference, (GRANITE, (2, 1), True), flags={"cast_before_gather": True}),
           "train_steps": _train(train_reference, (GRANITE, (2, 1), True)),
           "train_steps/compression": _train(train_reference, (GRANITE, (2, 1), True), compression=True),
           "counted": {"cfg": cfg, "state": train_reference[GRANITE, (2, 1), True]["init"],
                       "params": family_reference[GRANITE]["params"], "batch": _batches(cfg, 50, 1)[0]},
           "restore_checkpoint": {"cfg": cfg, "dir": ckpt, "as_model": 2,
                                  "store": "file://" + str(tmp_path_factory.mktemp("fsdp12") / "store")}}
    return job, _spawn(mesh, job, tmp_path_factory)


@pytest.fixture(scope="module")
def mesh_4x1(family_reference, train_reference, mesh_2x2, tmp_path_factory):
    mesh = (1, 4, 1)
    job = {"families": _families(family_reference),
           "train_steps": _train(train_reference, (GRANITE, (4, 1), False)),
           "restore_checkpoint": {"cfg": _reduced(t_get_config, GRANITE), "dir": mesh_2x2[0]["save_checkpoint"]["dir"]}}
    return job, _spawn(mesh, job, tmp_path_factory)


@pytest.fixture(scope="module")
def mesh_p2x1x2(family_reference, tmp_path_factory):
    mesh = (2, 1, 2)
    job = {"families": _families(family_reference),
           "families/h6": _families(family_reference, (GRANITE,), decode=None, switch="h6")}
    return job, _spawn(mesh, job, tmp_path_factory)


@pytest.fixture(scope="module")
def mesh_p2x2x1(family_reference, train_reference, tmp_path_factory):
    mesh = (2, 2, 1)
    job = {"families": _families(family_reference),
           "train_steps": _train(train_reference, (GRANITE, (4, 1), False))}
    return job, _spawn(mesh, job, tmp_path_factory)


@pytest.fixture(scope="module")
def meshes(mesh_2x2, mesh_2x1, mesh_4x1, mesh_p2x1x2, mesh_p2x2x1):
    return {(1, 2, 2): mesh_2x2, (1, 2, 1): mesh_2x1, (1, 4, 1): mesh_4x1, (2, 1, 2): mesh_p2x1x2,
            (2, 2, 1): mesh_p2x2x1}


# --------------------------------------------------------------------- #
# The rule table, without ranks
# --------------------------------------------------------------------- #


def test_default_rules_are_the_reference_table():
    for multi in (False, True):
        assert default_rules(multi) == j_param.default_rules(multi)


@pytest.mark.parametrize("switch", ["", "h6", "h10"])
@pytest.mark.parametrize("multi", [False, True], ids=["16x16", "2x16x16"])
def test_rank_shapes_equal_the_reference(multi, switch):
    """Every leaf of all ten configs: a rank's shape under the port's table
    against the reference's ``resolve_pspec`` on a ``{axis: size}`` mesh
    (it reads only ``mesh.shape``), the router's ``experts`` axis the only
    difference (whole in the port)."""
    shape = {"pod": 2, "data": 16, "model": 16} if multi else {"data": 16, "model": 16}
    jmesh = types.SimpleNamespace(shape=shape)
    rules = worker.rules_of(shape, switch)
    jrules = dict(j_param.default_rules(multi), batch=rules["batch"])
    if switch == "h10":
        jrules["expert_embed"] = None
    if switch == "h6":
        jrules["embed"] = ("pod", "data", "model") if multi else ("data", "model")
        jrules.update(heads=None, kv_heads=None, mlp=None, ssm_heads=None)
    routers = 0
    for name in all_arch_ids():
        jm, tm = j_build(j_get_config(name)), t_build(t_get_config(name))
        jleaves = dict(flatten_with_paths(jax.tree.map(lambda p: p, jm.specs(), is_leaf=j_param.is_spec)))
        for key, p in flatten_with_paths(tm.specs()):
            jspec = j_param.resolve_pspec(jleaves[key], jmesh, jrules)
            want = list(p.shape)
            for dim, names in enumerate(jspec):
                names = () if names is None else (names,) if isinstance(names, str) else names
                if key.endswith("/router") and p.axes[dim] == "experts":
                    routers += bool(names)
                    continue
                for n in names:
                    want[dim] //= shape[n]
            assert local_shape(p, shape, rules) == tuple(want), (name, key, switch)
    # Under H6 the router's embed takes the model axis first: no exception.
    assert (routers > 0) == (switch != "h6")


@pytest.mark.parametrize("arch,shape,mesh_name", [(GRANITE, "prefill_32k", "single"), (MAMBA, "decode_32k", "multi")])
def test_pod_rank_cell_full_size_ok(arch, shape, mesh_name, tmp_path):
    """A full-size rank of a pod on a fake process group: OK, its
    parameter bytes the sum of the rank-local shapes, its collective
    records over the data group (16 or 32 ranks) and the model group
    (16), with per-rank peak bytes, ``fits_hbm`` and ``t_collective``."""
    rec = dryrun.run_cell(arch, shape, mesh_name, out_dir=str(tmp_path), verbose=False)
    assert rec["status"] == "OK", rec.get("traceback")
    mesh = dryrun.make_production_mesh(multi_pod=mesh_name == "multi").shape
    assert rec["mesh_shape"] == mesh and rec["chips"] == (512 if mesh_name == "multi" else 256)
    cfg = t_get_config(arch)
    rules = dryrun.make_rules(cfg, mesh_name == "multi")
    local = sum(int(np.prod(local_shape(p, mesh, rules))) for _, p in flatten_with_paths(t_build(cfg).specs()))
    assert rec["params_a_rank"] == local and rec["param_bytes_a_rank"] == 2 * local    # bf16, served
    assert local < t_build(cfg).num_params() // 100
    data = mesh.get("pod", 1) * mesh["data"]
    assert rec["rows_a_rank"] * data == dryrun.SHAPES[shape].global_batch
    assert {int(k.split("x")[-1]) for k in rec["collectives"]} == {data, mesh["model"]}, rec["collectives"]
    assert rec["collectives"][f"all-gather x{data}"]["count"] > 0
    assert rec["memory"]["argument_bytes"] >= rec["param_bytes_a_rank"]
    assert rec["memory"]["fits_hbm"] == (rec["memory"]["peak_bytes"] <= 80 * 10 ** 9)
    assert rec["roofline"]["t_collective_s"] > 0


# --------------------------------------------------------------------- #
# Families: loss, gradients, serving
# --------------------------------------------------------------------- #


def _assert_family(ref, out, cfg, mesh, coords, where, serve=True):
    tol = GRAD_TOL.get(cfg.family, 1e-3)
    np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5, err_msg=where)
    assert_metrics_match(ref["metrics"], out["metrics"], where)
    assert sorted(out["grads"]) == sorted(ref["grads"]), where
    for key, g in out["grads"].items():
        assert g.shape == ref["grads"][key].shape, (where, key)
        assert _norm_err(ref["grads"][key], g) <= tol, (where, key, _norm_err(ref["grads"][key], g))
    if serve:
        data = mesh[0] * mesh[1]
        q = coords.get("pod", 0) * mesh[1] + coords["data"]
        rows = slice(q * ROWS // data, (q + 1) * ROWS // data)
        for i, (a, b) in enumerate(zip(ref["serve"], out["serve"])):
            assert b.shape == (ROWS // data, 1, cfg.padded_vocab), (where, i, b.shape)
            assert_logits(cfg, a[rows], torch.from_numpy(b), f"{where} step {i}")


@pytest.mark.parametrize("mesh", MESHES, ids=_id)
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_gradients_and_serving(family_reference, meshes, mesh, name):
    """Each rank's loss and metrics, every gradient leaf gathered whole
    (the data-sliced leaves reduce-scattered, the others summed over the
    data group), and its served logits against the reference's; each leaf
    held is the rank's ``local_shape``."""
    ref = _reference_at(family_reference, name, mesh)
    _, res = meshes[mesh]
    cfg = _reduced(t_get_config, name)
    rules = worker.rules_of(_shape(mesh))
    specs = dict(flatten_with_paths(t_build(cfg).specs()))
    for r, coords in _ranks(mesh):
        out = res[r]["families"][name]
        where = f"{name} mesh {_id(mesh)} rank {r}"
        _assert_family(ref, out, cfg, mesh, coords, where)
        assert out["held"] == {k: local_shape(p, _shape(mesh), rules) for k, p in specs.items()}, where
        assert out["scattered"] and all(k.split("/")[-1] in ("table", "scale", "bias", "router", "w_gate", "w_up",
                                                             "w_down", "wq", "wk", "wv", "wo", "w_z", "w_x",
                                                             "w_B", "w_C", "w_dt", "w_out")
                                        for k in out["scattered"]), where


@pytest.mark.parametrize("switch,name,mesh", [(s, n, (1, 2, 2)) for s, names in SWITCHED for n in names]
                         + [("h6", GRANITE, (2, 1, 2))], ids=lambda x: _id(x) if isinstance(x, tuple) else x)
def test_switches_h6_and_h10(family_reference, meshes, switch, name, mesh):
    """At (2, 2) under H6 (``embed`` over the fused (data, model), heads and
    widths whole) and H10 (``expert_embed`` whole), and at (pod 2, data 1,
    model 2) under H6 (``(pod, data, model)``, its data axis of one): the
    loss and every gradient leaf the reference's; under H6 a dimension
    sliced over the fused axes, under H10 the expert stacks whole over the
    data axes."""
    ref = _reference_at(family_reference, name, mesh)
    _, res = meshes[mesh]
    cfg = _reduced(t_get_config, name)
    axes = shard_axes(t_build(cfg).specs(), _shape(mesh), worker.rules_of(_shape(mesh), switch))
    if switch == "h6":
        assert any("model" in ax and dp_part(ax) for sl in axes.values() for _, ax in sl)
    else:
        assert not any(dp_part(ax) for k, sl in axes.items() if "/moe/w_" in k for _, ax in sl)
    for r, coords in _ranks(mesh):
        _assert_family(ref, res[r][f"families/{switch}"][name], cfg, mesh, coords, f"{name} {switch} rank {r}",
                       serve=False)


def test_control_a_second_sum_is_d_times(family_reference, mesh_2x1):
    """A data-sliced leaf's gradient, gathered whole, is the reference's and
    not D times it; summed over the data group once more (what a step that
    all-reduced every leaf would do), each rank's slice is the sum of the D
    ranks' different slices, and leaves the band by far."""
    mesh = (1, 2, 1)
    _, res = mesh_2x1
    for name in FAMILIES:
        ref = _reference_at(family_reference, name, mesh)
        cfg = _reduced(t_get_config, name)
        tol = GRAD_TOL.get(cfg.family, 1e-3)
        axes = shard_axes(t_build(cfg).specs(), _shape(mesh), worker.rules_of(_shape(mesh)))
        for r, coords in _ranks(mesh):
            out = res[r]["families"][name]
            assert sorted(out["control_grads"]) == out["scattered"]
            for key, g in out["control_grads"].items():
                whole = ref["grads"][key]
                if not np.abs(whole).max():
                    continue
                assert _norm_err(whole, out["grads"][key]) <= tol, (name, r, key)
                assert _norm_err(2 * whole, out["grads"][key]) >= 0.5 - tol, (name, r, key)
                assert _norm_err(_slice(whole, key, axes, mesh, coords), g) > 0.1, (name, r, key)


# --------------------------------------------------------------------- #
# Train steps
# --------------------------------------------------------------------- #


def _assert_steps(ref, got, cfg, mesh, coords, opt, where, switch="", noise_cap=0.05):
    axes = _state_axes(cfg, mesh, opt, switch)
    lr_sum = 0.0
    for i, (jflat, jmet) in enumerate(ref["runs"]):
        assert_metrics_match(jmet, got["metrics"][i], f"{where} step {i + 1}")
        lr_sum += got["metrics"][i]["lr"]
        _assert_train_state(jflat, got["states"][i], axes, mesh, coords, lr_sum, f"{where} step {i + 1}", noise_cap)


@pytest.mark.parametrize("mesh", [(1, 2, 2), (1, 4, 1), (2, 2, 1)], ids=_id)
def test_adamw_step_matches_reference(train_reference, meshes, mesh):
    """An AdamW step of granite on every rank against the reference's jitted
    step on the global batch; ``ema_loads`` the same bits on every rank."""
    ref = train_reference[GRANITE, _gm(mesh), False]
    _, res = meshes[mesh]
    _, opt = _opt()
    cfg = _reduced(t_get_config, GRANITE)
    for r, coords in _ranks(mesh):
        _assert_steps(ref, res[r]["train_steps"], cfg, mesh, coords, opt, f"mesh {_id(mesh)} rank {r}")
    last = [res[r]["train_steps"]["states"][-1] for r, _ in _ranks(mesh)]
    for key, a in last[0].items():
        if key.startswith("dyskew/"):
            for r, other in enumerate(last[1:], 1):
                np.testing.assert_array_equal(other[key], a, err_msg=f"rank {r}: {key}")


def test_pod_mesh_is_the_same_bits_as_its_data_axis(mesh_4x1, mesh_p2x2x1):
    """(pod 2, data 2, model 1) is (data 4, model 1) with the data group
    split in two pods: the same bits, rank for rank (losses, gradients,
    logits and the train step's state)."""
    (_, four), (_, pods) = mesh_4x1, mesh_p2x2x1
    for r in range(4):
        for name in FAMILIES:
            a, b = four[r]["families"][name], pods[r]["families"][name]
            assert a["loss"] == b["loss"], (r, name)
            for key in a["grads"]:
                np.testing.assert_array_equal(b["grads"][key], a["grads"][key], err_msg=f"{r} {name} {key}")
            for x, y in zip(a["serve"], b["serve"]):
                np.testing.assert_array_equal(y, x)
        sa, sb = four[r]["train_steps"]["states"][-1], pods[r]["train_steps"]["states"][-1]
        assert sorted(sa) == sorted(sb)
        for key in sa:
            np.testing.assert_array_equal(sb[key], sa[key], err_msg=f"rank {r}: {key}")


def test_h8_is_the_same_bits(mesh_2x2):
    """H8 (``constrain_grads``) at (2, 2): the same state bits as without it
    (the port's FSDP gradients are reduce-scattered whatever it says)."""
    _, res = mesh_2x2
    for r, _ in _ranks((1, 2, 2)):
        a, b = res[r]["train_steps"], res[r]["train_steps/h8"]
        assert a["metrics"] == b["metrics"]
        for key in a["states"][-1]:
            np.testing.assert_array_equal(b["states"][-1][key], a["states"][-1][key], err_msg=f"rank {r}: {key}")


def test_h2_step_against_reference(train_reference, mesh_2x1):
    """H2 at (2, 1): float32 masters cast to bf16 on the rank's slice, then
    gathered; against the reference's H2 step on the global batch, loss at
    rtol 1e-5 and every parameter within 2 · lr (its gradients pass bf16
    reduce-scatters); the plain step of the same state apart."""
    ref = train_reference[GRANITE, (2, 1), True]
    _, res = mesh_2x1
    _, opt = _opt()
    cfg = _reduced(t_get_config, GRANITE)
    axes = _state_axes(cfg, (1, 2, 1), opt)
    jflat, jmet = ref["runs"][0]
    for r, coords in _ranks((1, 2, 1)):
        got = res[r]["train_steps/h2"]
        np.testing.assert_allclose(got["metrics"][0]["loss"], float(jmet["loss"]), rtol=1e-5)
        lr = got["metrics"][0]["lr"]
        for key, a in jflat.items():
            if key.startswith("params/"):
                b = got["states"][0][key]
                assert np.abs(_slice(a, key, axes, (1, 2, 1), coords) - b).max() <= 2 * lr, (r, key)
        assert got["metrics"][0]["loss"] != res[r]["train_steps"]["metrics"][0]["loss"]


def test_compression_takes_only_the_all_reduced_leaves(mesh_2x1):
    """With the int8 reduction at (2, 1) the error-feedback residual holds
    only the leaves still all-reduced (none that the data axes slice); the
    loss is the plain step's."""
    _, res = mesh_2x1
    cfg = _reduced(t_get_config, GRANITE)
    axes = shard_axes(t_build(cfg).specs(), _shape((1, 2, 1)), worker.rules_of(_shape((1, 2, 1))))
    for r, _ in _ranks((1, 2, 1)):
        got = res[r]["train_steps/compression"]
        kept = {k[len("grad_residual/"):] for k in got["states"][0] if k.startswith("grad_residual/")}
        assert kept and not kept & set(axes) and kept | set(axes) == {
            k for k, _ in flatten_with_paths(t_build(cfg).specs())}
        assert got["metrics"][0]["loss"] == res[r]["train_steps"]["metrics"][0]["loss"]


def test_adafactor_step_with_a_factored_data_axis(train_reference, mesh_2x2):
    """One Adafactor step of reduced kimi-k2 at (2, 2), factored threshold
    16: factored leaves whose data-sliced d_model is one of the two factored
    axes (the row and column means summed over the data group)."""
    mesh = (1, 2, 2)
    ref = train_reference[KIMI]
    _, res = mesh_2x2
    _, opt = _opt("adafactor", FACTORED)
    cfg = _reduced(t_get_config, KIMI)
    axes = _state_axes(cfg, mesh, opt)
    pspecs = dict(flatten_with_paths(t_build(cfg).specs()))
    factored_on_data = [k for k in pspecs if f"opt/v/{k}/vr" in ref["runs"][0][0]
                        and any(dp_part(ax) and dim >= len(pspecs[k].shape) - 2 for dim, ax in axes["params/" + k])]
    assert factored_on_data
    for r, coords in _ranks(mesh):
        _assert_steps(ref, res[r]["train_steps/adafactor"], cfg, mesh, coords, opt, f"kimi rank {r}")


# --------------------------------------------------------------------- #
# Checkpoints
# --------------------------------------------------------------------- #


def _join(parts, slices, mesh):
    """The whole leaf from every rank's slices of it (rank order)."""
    shape = list(parts[0].shape)
    for dim, ax in slices:
        shape[dim] *= slice_size(ax, _shape(mesh))
    out = np.zeros(shape, parts[0].dtype)
    for (_, coords), part in zip(_ranks(mesh), parts):
        idx = [slice(None)] * len(shape)
        for dim, ax in slices:
            n, i = part.shape[dim], slice_index(ax, _shape(mesh), coords)
            idx[dim] = slice(i * n, (i + 1) * n)
        out[tuple(idx)] = part
    return out


def test_checkpoint_restores_on_other_meshes(mesh_2x2, mesh_2x1, mesh_4x1):
    """Written at (2, 2): it restores bit for bit at (2, 2), and at (4, 1),
    (1, 2) and in one process as each rank's slices of the whole leaves
    (the (2, 2) ranks' slices joined), ``ema_loads`` too."""
    job, res22 = mesh_2x2
    _, opt = _opt()
    cfg = _reduced(t_get_config, GRANITE)
    axes22 = _state_axes(cfg, (1, 2, 2), opt)
    whole = {key: _join([res22[r]["save_checkpoint"]["saved"][key] for r, _ in _ranks((1, 2, 2))],
                        axes22.get(key, ()), (1, 2, 2))
             for key in res22[0]["save_checkpoint"]["saved"]}
    for r, _ in _ranks((1, 2, 2)):
        for key, a in res22[r]["save_checkpoint"]["saved"].items():
            np.testing.assert_array_equal(res22[r]["save_checkpoint"]["restored"][key], a, err_msg=f"2x2 {r} {key}")

    def same(got, mesh, coords, where):
        axes = _state_axes(cfg, mesh, opt)
        assert sorted(got) == sorted(whole), where
        for key, a in whole.items():
            np.testing.assert_array_equal(got[key], _slice(a, key, axes, mesh, coords), err_msg=f"{where}: {key}")

    for r, coords in _ranks((1, 4, 1)):
        same(mesh_4x1[1][r]["restore_checkpoint"]["here"]["restored"], (1, 4, 1), coords, f"4x1 rank {r}")
    for r, coords in _ranks((1, 1, 2)):
        got = mesh_2x1[1][r]["restore_checkpoint"]["there"]
        assert got["shape"] == {"data": 1, "model": 2} and got["coords"] == coords
        same(got["restored"], (1, 1, 2), coords, f"1x2 rank {r}")
    like = train_state_init(t_build(cfg), opt, torch.Generator().manual_seed(5), device=CPU)
    one = {k: v.numpy() for k, v in flatten_with_paths(CheckpointManager(job["save_checkpoint"]["dir"]).restore(like))}
    same(one, (1, 1, 1), {"data": 0, "model": 0}, "one process")


# --------------------------------------------------------------------- #
# Collectives counted
# --------------------------------------------------------------------- #


def _fsdp_records(records, data):
    return collections.Counter((c["kind"], c["bytes"]) for c in records
                               if c["group"] == data and c["kind"] in ("all-gather", "reduce-scatter"))


def test_collective_records(mesh_2x1):
    """At (2, 1), granite's FSDP collectives over the data group as the op
    counter records them: a prefill all-gathers each data-sliced leaf once
    (whole, float32); a train step twice a block leaf (the forward and
    remat's recompute) and once the embedding table and final norm, and
    reduce-scatters each once to the rank's half; under H2 every one of
    them moves half the bytes (bf16)."""
    _, res = mesh_2x1
    cfg = _reduced(t_get_config, GRANITE)
    specs = t_build(cfg).specs()
    axes = shard_axes(specs, _shape((1, 2, 1)), worker.rules_of(_shape((1, 2, 1))))
    nb = t_transformer.num_blocks(cfg)
    gathered, scattered = collections.Counter(), collections.Counter()
    prefill = collections.Counter()
    for key, p in flatten_with_paths(specs):
        if key not in axes:
            continue
        block = key.startswith("blocks/")
        whole = int(np.prod(p.shape[1:] if block else p.shape))
        uses = nb if block else 1
        prefill[("all-gather", 4 * whole)] += uses
        gathered[("all-gather", 4 * whole)] += uses * (2 if block and cfg.remat else 1)
        scattered[("reduce-scatter", 4 * whole // 2)] += uses
    for r, _ in _ranks((1, 2, 1)):
        got = res[r]["counted"]
        assert _fsdp_records(got["prefill"], 2) == prefill, r
        assert _fsdp_records(got["train"], 2) == gathered + scattered, r
        half = collections.Counter({(k, b // 2): n for (k, b), n in (gathered + scattered).items()})
        assert _fsdp_records(got["train_h2"], 2) == half, r
