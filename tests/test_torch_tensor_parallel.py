"""The whole model axis through the port against ``repro`` on the CPU: the
reference's ``default_rules`` (``embed`` left whole), every leaf the table
puts on ``model`` sliced over the model group, with ``resolve_pspec``'s
fallback to whole leaves.

Ranks of a gloo group on the CPU, each a process of
``tests/torch_tp_worker.py`` (one spawn a mesh, module-scoped fixtures,
every wait with its own time limit), on the meshes (data 1, model 2),
(data 1, model 4) and (data 2, model 2).  Each rank holds its slice of the
reference's whole parameters (``param.shard_axes`` / ``slice_shards``) and
is held to ``repro``'s single-device functions on the global batch, at
``SpmdCtx(num_groups=D, num_ep_shards=M)`` for the MoE configs:

  * ``Model.loss`` and every gradient leaf, a sliced leaf against the
    reference's slice of it, and a prefill of 16 tokens with two decode
    steps after it (the last position's logits over the whole vocabulary,
    gathered from the ranks' columns), for reduced granite (MoE), starcoder2
    (gelu, attention biases; its 2 kv heads whole at M 4, each rank using
    the kv head of its query heads), chatglm3 (2 kv heads, half RoPE),
    granite-20b (MQA: one kv head, whole on every rank), mamba2 (a rank's
    heads and its part of the gated norm; the tied table), jamba (Mamba,
    attention and MoE), whisper (encoder-decoder, cross-attention caches,
    the tied table), pixtral (patch prefix) and qwen1.5 (int8 cache, its
    scales sharded with the kv heads);
  * a control that drops ``to_shard`` on the whole leaves a rank uses for
    its share only (the kv leaves where M does not divide the kv heads,
    mamba2's ``w_B`` / ``w_C`` / ``conv_B`` / ``conv_C`` / ``norm_scale``):
    each rank then holds only its part of their gradient, which leaves the
    band, and the parts of the M ranks add up to the reference's;
  * two AdamW steps of granite at each mesh, and of granite-20b and mamba2
    at (1, 4); one Adafactor step of reduced kimi-k2 and of starcoder2 at
    (1, 2) with ``factored_dim_threshold`` 16, so that the vocabulary's
    axis (second to last of the tables) and the ffn's width (last of
    ``w_up``, second to last of ``w_down``) are factored axes that are
    sliced;
  * a checkpoint of granite written at (1, 2), restored at (1, 4) and in
    one process;
  * the op counter's records of the model group's collectives, a prefill
    in order and a train step as a multiset, against what they issue,
    counted from the shapes, at (1, 4);
  * what raises.

Configs reduced, in float32; tokens, frames and patches made with numpy
from a seed.  Tolerances (those of ``tests/test_torch_arch.py`` and
``tests/test_torch_expert_parallel.py``, which state their reasons; a
sliced product adds its partial sums in another order, well inside them):
  * logits rtol 2e-4 and an absolute band of 2e-5 of the reference's
    largest |logit| (whisper 1e-3, the int8 cache 2e-3);
  * ``Model.loss`` rtol 1e-5; each gradient leaf ``max|Δ| <= 1e-3 ·
    max|g_ref|`` (whisper 1e-2); the control's leaves more than 1e-2 ·
    max|g_ref| off on every rank, their sum over the model group within
    the leaf's band;
  * train steps: losses rtol 1e-5, ``grad_norm`` rtol 1e-4, ``lr`` and the
    routing metrics EQUAL, parameters and moments as in
    ``tests/test_torch_expert_parallel.py``, link states EQUAL and the same
    bits on every rank;
  * checkpoint: EQUAL (bit for bit);
  * collective records: EQUAL to the bytes issued.
"""

import collections
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
from repro_torch.launch.mesh import run_ranks
from repro_torch.models import transformer as t_transformer
from repro_torch.models.layers import moe as tmoe
from repro_torch.models.layers.mamba2 import _dims as mamba_dims
from repro_torch.models.model_api import build as t_build
from repro_torch.models.param import default_rules, shard_axes, take_shard
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train.step import train_state_init, train_state_specs

import torch_tp_worker as worker
from test_torch_arch import GRAD_TOL, _params, _reduced, assert_logits
from test_torch_expert_parallel import _assert_train_state, _id, _ranks
from test_torch_train import ZERO_INIT, _flat_ref, _norm_err, _with_values, assert_metrics_match

CPU = "cpu"
MESHES = ((1, 2), (1, 4), (2, 2))
ROWS, SEQ, PROMPT, DECODE = 4, 32, 16, 2
GRANITE, STARCODER, MAMBA, KIMI = "granite-moe-1b-a400m", "starcoder2-3b", "mamba2-1.3b", "kimi-k2-1t-a32b"
FAMILIES = (GRANITE, STARCODER, "chatglm3-6b", "granite-20b", MAMBA, "jamba-1.5-large-398b",
            "whisper-base", "pixtral-12b", "qwen1.5-32b")
#: Per mesh, the configs whose control drops ``to_shard`` on whole leaves
#: (starcoder2's 2 kv heads are sliced at M 2, whole at M 4).
CONTROL = {(1, 2): ("granite-20b", MAMBA), (1, 4): (STARCODER, "granite-20b", MAMBA), (2, 2): ()}
SHARE_LEAVES = ("wk", "wv", "bk", "bv", "w_B", "w_C", "conv_B", "conv_C", "norm_scale")
#: (config, mesh) of the AdamW steps.
#: The dense one is granite-20b (MQA, gelu, no biases), not starcoder2:
#: starcoder2's key bias has a gradient of zero up to rounding (a bias
#: added to every key shifts a query's scores alike, which the softmax
#: ignores), so AdamW's step there is the sign of rounding noise on either
#: side.  The zero-initialised leaves (mamba2's ``A_log`` and ``dt_bias``,
#: the layernorms' ``bias``) get values from a seed on both sides first, as
#: in ``tests/test_torch_train.py``: started at zero, a leaf is after a step
#: nothing but AdamW's normalised update, whose last bits follow the
#: gradient's relative error element by element.
TRAINED = ((GRANITE, (1, 2)), (GRANITE, (1, 4)), (GRANITE, (2, 2)), ("granite-20b", (1, 4)), (MAMBA, (1, 4)))
#: The share of a leaf whose AdamW second moment may be at rounding
#: (``_assert_train_state``'s noise rule; each such element within 2 · Σ lr
#: of the reference).  No cap for mamba2: 5 % of the rows of a rank's
#: quarter of its tied table are such elements.
NOISE_CAP = {GRANITE: 0.05, "granite-20b": 0.05, MAMBA: None}
FACTORED = 16
STEPS = 2
RANK_TIMEOUT_S = 600


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


def _axes(cfg, model, opt=None):
    specs = t_build(cfg).specs() if opt is None else train_state_specs(t_build(cfg), opt)
    return shard_axes(specs, model, default_rules())


def _slice(a, key, axes, m, model):
    return np.asarray(take_shard(a, axes[key], m, model)) if key in axes else a


def _jctx(cfg, mesh):
    return jmoe.SpmdCtx(num_groups=mesh[0], num_ep_shards=mesh[1] if cfg.moe is not None else 1)


# --------------------------------------------------------------------- #
# The reference, in this process
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def family_reference():
    """Per config: the reference's numpy parameters and inputs; per (config,
    mesh): its loss, metrics and gradients, and the logits of a prefill of
    PROMPT tokens and DECODE decode steps (a MoE config at G = data, M =
    model; the others do not read the mesh)."""
    out = {}
    for name in FAMILIES:
        jm = j_build(_reduced(j_get_config, name))
        params = jax.tree.map(np.asarray, _params(jm))
        inputs = _inputs(jm.cfg)
        jparams = jax.tree.map(jnp.asarray, params)
        out[name] = {"params": params, "inputs": inputs}
        for mesh in (MESHES if jm.cfg.moe is not None else MESHES[:1]):
            jctx = _jctx(jm.cfg, mesh)
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
            out[name, mesh] = {"loss": float(loss), "metrics": aux["metrics"], "grads": _flat_ref(grads),
                               "serve": steps}
    return out


def _reference_at(ref, name, mesh):
    return ref[name, mesh] if (name, mesh) in ref else ref[name, MESHES[0]]


@pytest.fixture(scope="module")
def train_reference():
    """Per (config, mesh) of TRAINED: the initial state (numpy) and the
    state and metrics after each of STEPS jitted AdamW steps on the global
    batch; per config of the Adafactor step, the same for one step."""
    out = {}
    jopt, _ = _opt()
    for name, mesh in TRAINED:
        jm = j_build(_reduced(j_get_config, name))
        jctx = _jctx(jm.cfg, mesh)
        state = _with_values(j_train_state_init(jm, jopt, jax.random.PRNGKey(1), ctx=jctx), ZERO_INIT + ("bias",))
        init = jax.tree.map(np.asarray, state)
        batches = _batches(jm.cfg, 20, STEPS)
        step = jax.jit(j_make_train_step(jm, jopt, JStep(), ctx=jctx))
        runs = []
        for batch in batches:
            state, met = step(state, jax.tree.map(jnp.asarray, batch))
            runs.append((_flat_ref(state), met))
        out[name, mesh] = {"init": init, "batches": batches, "runs": runs}
    jopt, _ = _opt("adafactor", FACTORED)
    for name in (KIMI, STARCODER):
        jm = j_build(_reduced(j_get_config, name))
        jctx = _jctx(jm.cfg, (1, 2))
        state = j_train_state_init(jm, jopt, jax.random.PRNGKey(1), ctx=jctx)
        init = jax.tree.map(np.asarray, state)
        batch = _batches(jm.cfg, 30, 1)
        state, met = jax.jit(j_make_train_step(jm, jopt, JStep(), ctx=jctx))(state, jax.tree.map(jnp.asarray, batch[0]))
        out[name, "adafactor"] = {"init": init, "batches": batch, "runs": [(_flat_ref(state), met)]}
    return out


# --------------------------------------------------------------------- #
# The ranks: one spawn a mesh
# --------------------------------------------------------------------- #


def _spawn(mesh, job, tmp_path_factory):
    where = tmp_path_factory.mktemp(f"tp{_id(mesh)}")
    return run_ranks(worker.run_rank, mesh[0] * mesh[1], mesh[1], job, timeout=RANK_TIMEOUT_S,
                     store_dir=str(where))


def _control_shapes(names):
    """The shapes a block's whole share leaves have (the stack axis
    dropped): the control drops ``to_shard`` on tensors of these shapes,
    which no activation of these configs has."""
    out = set()
    for name in names:
        for key, p in flatten_with_paths(t_build(_reduced(t_get_config, name)).specs()):
            if key.startswith("blocks/") and key.rsplit("/", 1)[-1] in SHARE_LEAVES:
                out.add(tuple(p.shape[1:]))
    return sorted(out)


def _job(mesh, family_reference, train_reference):
    job = {"families": {"groups": mesh[0], "decode": DECODE, "control": CONTROL[mesh],
                        "control_shapes": _control_shapes(CONTROL[mesh]), "configs": {
        name: {"cfg": _reduced(t_get_config, name), "params": family_reference[name]["params"],
               "inputs": family_reference[name]["inputs"], "prompt": PROMPT} for name in FAMILIES}}}
    for name, where in TRAINED:
        if where == mesh:
            ref = train_reference[name, mesh]
            job[f"train_steps/{name}"] = {"cfg": _reduced(t_get_config, name), "groups": mesh[0],
                                          "state": ref["init"], "batches": ref["batches"]}
    return job


@pytest.fixture(scope="module")
def mesh_1x2(family_reference, train_reference, tmp_path_factory):
    mesh = (1, 2)
    where = tmp_path_factory.mktemp("tpckpt12")
    job = _job(mesh, family_reference, train_reference)
    for name in (KIMI, STARCODER):
        ref = train_reference[name, "adafactor"]
        job[f"train_steps/{name}-adafactor"] = {"cfg": _reduced(t_get_config, name), "groups": 1, "state": ref["init"],
                                                "batches": ref["batches"], "opt": "adafactor", "factored": FACTORED}
    job["save_checkpoint"] = {"cfg": _reduced(t_get_config, GRANITE), "groups": 1,
                              "state": train_reference[GRANITE, mesh]["init"],
                              "batch": _batches(_reduced(t_get_config, GRANITE), 40, 1)[0], "dir": str(where / "ckpt")}
    job["raises"] = {"cfg": _reduced(t_get_config, STARCODER), "mamba_cfg": _reduced(t_get_config, MAMBA)}
    return job, _spawn(mesh, job, tmp_path_factory)


def _counted_job(family_reference, train_reference):
    out = {}
    for name, scatter in ((GRANITE, [False, True]), ("granite-20b", [False]), (MAMBA, [False])):
        cfg = _reduced(t_get_config, name)
        out[name] = {"cfg": cfg, "state": train_reference[name, (1, 4)]["init"], "scatter": scatter,
                     "params": family_reference[name]["params"], "batch": _batches(cfg, 50, 1)[0]}
    return out


@pytest.fixture(scope="module")
def mesh_1x4(family_reference, train_reference, mesh_1x2, tmp_path_factory):
    mesh = (1, 4)
    job = _job(mesh, family_reference, train_reference)
    job["restore_checkpoint"] = {"cfg": _reduced(t_get_config, GRANITE), "groups": 1,
                                 "dir": mesh_1x2[0]["save_checkpoint"]["dir"]}
    job["counted"] = {"configs": _counted_job(family_reference, train_reference)}
    return job, _spawn(mesh, job, tmp_path_factory)


@pytest.fixture(scope="module")
def mesh_2x2(family_reference, train_reference, tmp_path_factory):
    mesh = (2, 2)
    job = _job(mesh, family_reference, train_reference)
    return job, _spawn(mesh, job, tmp_path_factory)


@pytest.fixture(scope="module")
def meshes(mesh_1x2, mesh_1x4, mesh_2x2):
    return {(1, 2): mesh_1x2, (1, 4): mesh_1x4, (2, 2): mesh_2x2}


# --------------------------------------------------------------------- #
# The rule table
# --------------------------------------------------------------------- #


def test_rules_resolve_as_the_reference_does():
    """The port's ``resolve_pspec`` on every leaf of every config's specs
    against ``repro``'s on a one-axis mesh of the same size, and the
    experts-only table's axes are ``expert_axes``'."""
    from jax.sharding import Mesh as JMesh

    from repro.models.param import default_rules as j_default_rules, resolve_pspec as j_resolve
    from repro_torch.models.param import expert_axes, expert_rules, resolve_pspec
    from repro_torch.models.param import tree_leaves as t_leaves

    jrules = dict(j_default_rules(False), embed=None, expert_embed=None)
    assert jrules == default_rules()

    class FakeMesh:
        def __init__(self, model):
            self.shape = {"model": model}

    for name in FAMILIES + (KIMI,):
        jm, tm = j_build(j_get_config(name)), t_build(t_get_config(name))
        jleaves = jax.tree.leaves(jm.specs(), is_leaf=lambda x: hasattr(x, "axes"))
        for model in (2, 4, 16):
            got = [resolve_pspec(p, {"model": model}, default_rules()) for p in t_leaves(tm.specs())]
            want = [tuple(j_resolve(p, FakeMesh(model), jrules)) for p in jleaves]
            assert got == want, (name, model)
        assert shard_axes(tm.specs(), 4, expert_rules()) == expert_axes(tm.specs()), name
    del JMesh


def test_a_rank_holds_what_the_reference_layout_gives_it():
    """Full granite at M 4 under the default rules: a rank's parameters
    (reckoned from the specs) are the experts', the attention's and the
    vocabulary's quarters and the whole router and norms; the router and
    MQA's kv head stay whole; a rank's init is the slice of the one-process
    init at the same seed."""
    import math

    from repro_torch.models.param import local_shape, slice_shards, tree_materialize

    specs = t_build(t_get_config(GRANITE)).specs()
    held = collections.Counter()
    for key, p in flatten_with_paths(specs):
        part = ("experts" if "/moe/w_" in key else "attention" if "/attn/" in key else
                "vocab" if key.endswith("table") else "router and norms")
        held[part] += math.prod(local_shape(p, 4, default_rules()))
    assert held == {"experts": 301_989_888, "attention": 18_874_368, "vocab": 25_231_360,
                    "router and norms": 836_608}
    assert "blocks/l0/moe/router" not in shard_axes(specs, 4, default_rules())
    mqa = shard_axes(t_build(t_get_config("granite-20b")).specs(), 4, default_rules())
    assert "blocks/l0/attn/wk" not in mqa and mqa["blocks/l0/attn/wq"] == 2
    model = t_build(_reduced(t_get_config, MAMBA))
    whole = tree_materialize(model.specs(), torch.Generator().manual_seed(3), device=CPU)
    axes = shard_axes(model.specs(), 4, default_rules())
    assert sorted(k.rsplit("/", 1)[-1] for k in axes if k.startswith("blocks/")) == sorted(
        ["A_log", "D", "conv_x", "dt_bias", "w_dt", "w_out", "w_x", "w_z"])
    for m in range(4):
        mine = tree_materialize(model.specs(), torch.Generator().manual_seed(3), device=CPU, shard=(m, 4))
        for (key, a), (_, b) in zip(flatten_with_paths(slice_shards(whole, axes, m, 4)), flatten_with_paths(mine)):
            assert torch.equal(a, b) and b.is_contiguous(), (m, key)


# --------------------------------------------------------------------- #
# Families: loss, gradients, serving
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("mesh", MESHES, ids=_id)
@pytest.mark.parametrize("name", FAMILIES)
def test_loss_gradients_and_serving(family_reference, meshes, mesh, name):
    """Each rank's loss and metrics, its gradients summed over its data
    group (a sliced leaf against the reference's slice), and its served
    logits against the reference's; the decode state holds the rank's kv
    heads and Mamba heads."""
    ref = _reference_at(family_reference, name, mesh)
    _, res = meshes[mesh]
    cfg = _reduced(t_get_config, name)
    data, model = mesh
    axes = _axes(cfg, model)
    tol = GRAD_TOL.get(cfg.family, 1e-3)
    for r, d, m in _ranks(mesh):
        out = res[r]["families"][name]
        where = f"{name} mesh {_id(mesh)} rank {r}"
        np.testing.assert_allclose(out["loss"], ref["loss"], rtol=1e-5, err_msg=where)
        assert_metrics_match(ref["metrics"], out["metrics"], where)
        assert sorted(out["grads"]) == sorted(ref["grads"]), where
        for key, g in out["grads"].items():
            want = _slice(ref["grads"][key], key, axes, m, model)
            assert g.shape == want.shape, (where, key)
            assert _norm_err(want, g) <= tol, (where, key, _norm_err(want, g))
        rows = slice(d * ROWS // data, (d + 1) * ROWS // data)
        for i, (a, b) in enumerate(zip(ref["serve"], out["serve"])):
            assert b.shape == (ROWS // data, 1, cfg.padded_vocab), (where, i, b.shape)
            assert_logits(cfg, a[rows], torch.from_numpy(b), f"{where} step {i}")
        H, K = cfg.num_heads, cfg.num_kv_heads
        kv = K // model if K % model == 0 else max(1, H // model * K // H)
        for key, shape in out["state_shapes"].items():
            if key.rsplit("/", 1)[-1] in ("k", "v", "k_scale", "v_scale"):
                assert shape[3] == kv, (where, key, shape)
            if key.endswith("/ssm"):
                assert shape[2] == cfg.mamba.num_heads(cfg.d_model) // model, (where, key, shape)
    assert axes, name


def test_control_without_to_shard(family_reference, meshes):
    """Without ``to_shard`` on the whole leaves a rank uses for its share
    (the kv leaves of starcoder2 at M 4 and of MQA, mamba2's B/C leaves and
    norm scale), each rank keeps only its part of their gradient: out of
    the band on every rank, and the parts of the model group's ranks add up
    to the reference's gradient."""
    checked = 0
    for mesh, names in CONTROL.items():
        _, res = meshes[mesh]
        for name in names:
            ref = _reference_at(family_reference, name, mesh)
            cfg = _reduced(t_get_config, name)
            axes = _axes(cfg, mesh[1])
            keys = [k for k in ref["grads"] if k.rsplit("/", 1)[-1] in SHARE_LEAVES and k not in axes
                    and k.startswith("blocks/")]
            assert keys, (name, mesh)
            for key in keys:
                parts = [res[r]["families"][name]["control_grads"][key] for r, _, _ in _ranks(mesh)]
                for r, part in enumerate(parts):
                    assert _norm_err(ref["grads"][key], part) > 1e-2, (name, mesh, r, key)
                assert _norm_err(ref["grads"][key], sum(parts)) <= 1e-3, (name, mesh, key)
                checked += 1
    assert checked >= 10


# --------------------------------------------------------------------- #
# Train steps
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("name,mesh", TRAINED, ids=[f"{n}-{_id(m)}" for n, m in TRAINED])
def test_train_steps_match_reference(train_reference, meshes, name, mesh):
    """Two AdamW steps on every rank against the reference's jitted step on
    the global batch; link states the same bits on every rank."""
    ref = train_reference[name, mesh]
    _, res = meshes[mesh]
    _, opt = _opt()
    cfg = _reduced(t_get_config, name)
    axes = _axes(cfg, mesh[1], opt)
    for r, _, m in _ranks(mesh):
        got = res[r][f"train_steps/{name}"]
        lr_sum = 0.0
        for i, (jflat, jmet) in enumerate(ref["runs"]):
            where = f"{name} mesh {_id(mesh)} rank {r} step {i + 1}"
            assert_metrics_match(jmet, got["metrics"][i], where)
            lr_sum += got["metrics"][i]["lr"]
            _assert_train_state(jflat, got["states"][i], axes, m, mesh[1], lr_sum, where, NOISE_CAP[name])
    last = [res[r][f"train_steps/{name}"]["states"][-1] for r, _, _ in _ranks(mesh)]
    for key, a in last[0].items():
        if key.startswith("dyskew/"):
            for r, other in enumerate(last[1:], 1):
                np.testing.assert_array_equal(other[key], a, err_msg=f"rank {r}: {key}")


@pytest.mark.parametrize("name", [KIMI, STARCODER])
def test_adafactor_step_with_sliced_factored_axes(train_reference, mesh_1x2, name):
    """One Adafactor step at (1, 2) with the factored threshold at 16:
    factored leaves whose sliced axis is one of the two factored ones (the
    row and column means summed over the group), ``_factored`` decided on
    the whole leaf's shape."""
    ref = train_reference[name, "adafactor"]
    _, res = mesh_1x2
    _, opt = _opt("adafactor", FACTORED)
    cfg = _reduced(t_get_config, name)
    axes = _axes(cfg, 2, opt)
    pspecs = dict(flatten_with_paths(t_build(cfg).specs()))
    # Factored leaves sliced on their second-to-last (vocab, or the ffn's
    # rows) and, for the dense ffn, on their last axis.
    sliced_factored = {len(pspecs[k].shape) - 1 - axes["params/" + k]
                       for k in pspecs if "params/" + k in axes and f"opt/v/{k}/vr" in ref["runs"][0][0]}
    assert 1 in sliced_factored and (name == KIMI or 0 in sliced_factored), sliced_factored
    jflat, jmet = ref["runs"][0]
    for r, _, m in _ranks((1, 2)):
        got = res[r][f"train_steps/{name}-adafactor"]
        where = f"{name} adafactor rank {r}"
        assert_metrics_match(jmet, got["metrics"][0], where)
        _assert_train_state(jflat, got["states"][0], axes, m, 2, got["metrics"][0]["lr"], where)


# --------------------------------------------------------------------- #
# Checkpoints
# --------------------------------------------------------------------- #


def test_checkpoint_restores_on_another_mesh(mesh_1x2, mesh_1x4):
    """Written at (1, 2): the file holds whole leaves (each sliced leaf's
    two slices joined along its own axis); it restores bit for bit at
    (1, 2), at (1, 4) as each rank's slices and in one process.  Link
    leaves of another shard count start afresh; ``ema_loads`` comes
    back."""
    job, res12 = mesh_1x2
    _, opt = _opt()
    cfg = _reduced(t_get_config, GRANITE)
    axes2 = _axes(cfg, 2, opt)
    saved = [rank["save_checkpoint"]["saved"] for rank in res12]
    for r, rank in enumerate(res12):
        for key, a in rank["save_checkpoint"]["saved"].items():
            np.testing.assert_array_equal(rank["save_checkpoint"]["restored"][key], a, err_msg=f"1x2 rank {r}: {key}")
    whole = {k: (np.concatenate([s[k] for s in saved], axis=axes2[k]) if k in axes2 else saved[0][k])
             for k in saved[0]}
    assert {k.split("/")[-1] for k in axes2} >= {"wq", "wo", "wk", "table", "w_gate"}

    def same(got, model, m, where, links):
        axes = _axes(cfg, model, opt)
        assert sorted(got) == sorted(whole), where
        for key, a in whole.items():
            if key.startswith("dyskew/") and not key.endswith("ema_loads") and not links:
                continue
            np.testing.assert_array_equal(got[key], _slice(a, key, axes, m, model), err_msg=f"{where}: {key}")

    for r, _, m in _ranks((1, 4)):
        same(mesh_1x4[1][r]["restore_checkpoint"]["restored"], 4, m, f"1x4 rank {r}", links=False)
    like = train_state_init(t_build(cfg), opt, torch.Generator().manual_seed(5), device=CPU)
    one = {k: v.numpy() for k, v in flatten_with_paths(CheckpointManager(job["save_checkpoint"]["dir"]).restore(like))}
    same(one, 1, 0, "one process", links=False)


# --------------------------------------------------------------------- #
# Collectives counted
# --------------------------------------------------------------------- #


def _prefill_issued(cfg, model, tokens, scatter):
    """(kind, group size, bytes) of each collective a prefill of the whole
    ``tokens`` batch (B, S) issues on a rank of (data 1, model M), in order:
    the embedding's sum of the ranks' rows; per layer the attention's or
    the Mamba mixer's sum of its partial output (and the gated norm's sum
    of squares before it), the ffn's sum or a MoE layer's counts over the
    data group of one and its combine; the last position's logits
    gathered."""
    B, S = tokens
    d, f32 = cfg.d_model, 4
    act = ("all-reduce", model, B * S * d * f32)
    out = [act]
    for j in range(t_transformer.block_period(cfg)):
        layer = []
        if cfg.is_attention_layer(j) and cfg.num_heads > 0:
            layer.append(act)
        else:
            layer += [("all-reduce", model, B * S * f32), act]
        if cfg.is_moe_layer(j):
            E = cfg.moe.num_experts
            layer.append(("all-reduce", 1, 4 * 2 * E))
            layer.append(("all-reduce", model, B * S * d * f32) if scatter else
                         ("all-gather", model, E * tmoe.capacities(cfg, B * S)[1] * d * f32))
        elif cfg.d_ff > 0:
            layer.append(act)
        out += layer
    out = [out[0]] + out[1:] * t_transformer.num_blocks(cfg)
    return out + [("all-gather", model, cfg.padded_vocab * B * f32)]


def _train_issued(cfg, model, tokens, params, scatter):
    """The multiset of (kind, group size, bytes) a train step issues on a
    rank of (data 1, model M): the forward's, again in each block's
    recompute (see below), and the loss's max and sums; in the backward ``to_shard``'s
    sum of each gradient of a replicated input (a layer's input, the
    logits' input, the gated norm's sum of squares, a MoE layer's tokens,
    whole leaves used for a share); one float32 sum a leaf over the data
    group of one and the global norm's sum over the model group."""
    B, S = tokens
    d, f32 = cfg.d_model, 4
    fwd = collections.Counter(_prefill_issued(cfg, model, tokens, scatter)[:-1])
    out = fwd.copy()
    # The recompute: each block's again, but for the embedding's, and for
    # the closing sum of a block that ends in one (a dense ffn's or a Mamba
    # layer's): non-reentrant checkpointing stops once the block's last
    # saved tensor is back, and that sum saves none.
    out.subtract(collections.Counter([("all-reduce", model, B * S * d * f32)]))
    out += fwd
    last = t_transformer.block_period(cfg) - 1
    if not cfg.is_moe_layer(last) and (cfg.d_ff > 0 or not cfg.is_attention_layer(last)):
        out.subtract(collections.Counter({("all-reduce", model, B * S * d * f32): t_transformer.num_blocks(cfg)}))
    act_grad = ("all-reduce", model, B * S * d * f32)
    loss = [("all-reduce", model, B * S * f32), ("all-reduce", model, 2 * B * S * f32), ("all-reduce", 1, 8),
            act_grad]
    out.update(loss)
    att = t_transformer.attention_specs(cfg) if cfg.num_heads else {}
    H, K = cfg.num_heads, cfg.num_kv_heads
    for j in range(t_transformer.block_period(cfg)):
        layer = [act_grad]
        if cfg.is_attention_layer(j) and cfg.num_heads > 0:
            if K % model and H % model == 0:
                layer += [("all-reduce", model, 4 * int(np.prod(att[n].shape))) for n in ("wk", "wv", "bk", "bv")
                          if n in att]
        else:
            _, di, _, _, g, n = mamba_dims(cfg)
            w = cfg.mamba.conv_width
            layer += [("all-reduce", model, B * S * f32),
                      ("all-reduce", model, 4 * d * g * n), ("all-reduce", model, 4 * d * g * n),
                      ("all-reduce", model, 4 * w * g * n), ("all-reduce", model, 4 * w * g * n),
                      ("all-reduce", model, 4 * di)]
        if cfg.is_moe_layer(j):
            layer.append(("all-reduce", model, B * S * d * f32))
            if scatter:
                layer.append(("all-reduce", model, B * S * cfg.moe.top_k * f32))
        elif cfg.d_ff > 0:
            layer.append(act_grad)
        out.update(layer * t_transformer.num_blocks(cfg))
    leaves = flatten_with_paths(params)
    out.update(("all-reduce", 1, 4 * v.size) for _, v in leaves)
    out.update([("all-reduce", model, 4 * len(shard_axes(t_build(cfg).specs(), model, default_rules())))])
    return +out


@pytest.mark.parametrize("name", [GRANITE, "granite-20b", MAMBA])
def test_collectives_are_counted(family_reference, train_reference, mesh_1x4, name):
    """At (1, 4) the op counter's records of a prefill equal what it issues,
    in order, and those of a train step as a multiset; for granite both
    combines."""
    job, res = mesh_1x4
    part = job["counted"]["configs"][name]
    cfg = part["cfg"]
    tokens = part["batch"]["tokens"].shape
    params = {k: _slice(v, k, _axes(cfg, 4), 0, 4)
              for k, v in flatten_with_paths(part["state"]["params"])}
    for r, rank in enumerate(res):
        for scatter, got in rank["counted"][name].items():
            records = [(c["kind"], c["group"], c["bytes"]) for c in got["prefill"]]
            assert records == _prefill_issued(cfg, 4, tokens, scatter), (name, r, scatter)
            records = collections.Counter((c["kind"], c["group"], c["bytes"]) for c in got["train"])
            assert records == _train_issued(cfg, 4, tokens, params, scatter), (name, r, scatter)


# --------------------------------------------------------------------- #
# What raises
# --------------------------------------------------------------------- #


def test_what_raises(mesh_1x2):
    """Query heads that straddle kv groups, Mamba heads that straddle B/C
    groups, and a table naming the data axis (FSDP) each raise, naming
    ROADMAP.md queue A."""
    _, res = mesh_1x2
    for rank in res:
        for key in ("kv", "mamba", "fsdp"):
            assert "ROADMAP.md queue A" in rank["raises"][key], (key, rank["raises"])
