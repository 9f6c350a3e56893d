"""Training through the port against ``repro`` on the CPU:
``granite-moe-1b-a400m`` reduced, in float32 (as ``repro.launch.train
--reduced`` runs it), with the parameters carried across from the
reference's own init; and the two families with Mamba-2 layers, reduced
``mamba2-1.3b`` (AdamW) and reduced ``jamba-1.5-large-398b`` (Adafactor, as
its config says), whose scan trains through ``StateScan``.  Their
zero-initialised ``A_log`` and ``dt_bias`` are given values from a seed
first, on both sides, so that the parameter tolerance below means the same
for them as for the other leaves: started at zero, such a leaf is after a
few steps nothing but AdamW's normalised updates, m / sqrt(v), whose last
bits follow the gradient's relative error element by element (3 steps at
``repro``'s zero init: ``A_log`` 2.5e-5 of its largest element).

Tolerances (stated per comparison):
  * ``lm_loss``: rtol 1e-6 (float32 logsumexp in another library).
  * ``Model.loss``: the loss rtol 1e-5; every gradient leaf
    ``max|Δ| <= 1e-3 · max|g_ref|``.  The forward logits of the two
    frameworks already differ by about 1e-5 of their scale (two layers of
    float32 products, softmaxes and norms in another order; see
    ``tests/test_torch_serve.py``), and the backward carries that through
    every product again.
  * train steps: losses rtol 1e-5, ``grad_norm`` rtol 1e-4; parameters
    ``max|Δ| <= 1e-5 · max|p|``; optimizer moments
    ``max|Δ| <= 2e-3 · max|m|`` (each moment is a sum of gradients, with
    the gradient bound above); the experts' load EMA rtol 1e-6 (XLA fuses
    its update inside the jitted step and rounds it in another order);
    integer leaves, the link states, the step counter and the dispatch
    telemetry EQUAL.
  * the two autograd ``Function``s: ``gradcheck`` in float64 at its
    defaults (eps 1e-6, atol 1e-5, rtol 1e-3), and on the CPU in float32
    the same bits as autograd through the plain versions.
  * remat on against off, microbatching, loop resume: EQUAL (one device,
    the same operations).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import get_config as j_get_config
from repro.models import transformer as j_transformer
from repro.models.model_api import build as j_build
from repro.optim.optimizers import OptimizerConfig as JOpt
from repro.train import loop as j_loop
from repro.train.step import StepConfig as JStep
from repro.train.step import make_train_step as j_make_train_step
from repro.train.step import train_state_init as j_train_state_init
from repro.data.pipeline import DataConfig as JData
from repro_torch.checkpoint.manager import CheckpointManager, flatten_with_paths
from repro_torch.config.base import get_config as t_get_config
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.kernels.dispatch import ops as dispatch_ops
from repro_torch.kernels.dispatch.ref import dispatch_gather_ref
from repro_torch.kernels.ssd_scan import ops as scan_ops
from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_ref
from repro_torch.kernels.topk_gating import ops as gating_ops
from repro_torch.kernels.topk_gating.ref import topk_gating_ref
from repro_torch.launch import train as t_launch
from repro_torch.models import transformer as t_transformer
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.models.model_api import build as t_build
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train.loop import LoopConfig, train
from repro_torch.train.step import StepConfig, make_train_step, train_state_init, train_state_specs

ARCH = "granite-moe-1b-a400m"
CPU = "cpu"
BATCH, SEQ = 4, 32
GRAD_TOL, PARAM_TOL, MOMENT_TOL = 1e-3, 1e-5, 2e-3


MAMBA_ARCHS = (("mamba2-1.3b", "adamw"), ("jamba-1.5-large-398b", "adafactor"))
#: Leaves the reference initialises to zero, given values before training.
ZERO_INIT = ("A_log", "dt_bias")


def _reduced(get_config, arch=ARCH, **kw):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32", **kw)


def _batch(rng, vocab=256):
    tokens = rng.integers(1, vocab, (BATCH, SEQ)).astype(np.int32)
    targets = rng.integers(1, vocab, (BATCH, SEQ)).astype(np.int32)
    targets[rng.random((BATCH, SEQ)) < 0.15] = -1
    return {"tokens": tokens, "targets": targets}


def without_links(tree):
    """``repro``'s tree without the MoE layers' link state machines (each
    ``dyskew/l<j>/link``): the port carries ``ema_loads`` alone, its link
    decision being a constant of the configuration
    (``test_torch_moe.py::test_moe_link_decides_from_its_first_tick``)."""
    if isinstance(tree, dict):
        return {k: without_links(v) for k, v in tree.items() if k != "link"}
    return tree


def _flat_ref(tree):
    """``repro``'s leaves by path as numpy, ``without_links``."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(without_links(tree))[0]:
        out["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in path)] = np.asarray(leaf)
    return out


def flat_numpy(tree):
    return {k: v.detach().numpy() for k, v in flatten_with_paths(tree)}


def assert_links_match(jdyskew, tflat, where):
    """The port's carried link states (numpy by path) against the
    reference's ``without_links``: the same keys, the same bits."""
    jflat = _flat_ref(jdyskew)
    assert sorted(tflat) == sorted(jflat), where
    for key, b in tflat.items():
        np.testing.assert_array_equal(b, jflat[key], err_msg=f"{where}: {key}")


def _norm_err(ref, got):
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)) if ref.size else 0.0


def assert_state_matches(jstate, tstate, where):
    """Train states leaf by leaf at the module's tolerances."""
    jflat = _flat_ref(jstate)
    tflat = flat_numpy(tstate)
    assert sorted(jflat) == sorted(tflat), where
    for key, a in jflat.items():
        b = tflat[key]
        assert a.shape == b.shape and a.dtype == b.dtype, (where, key)
        if key.endswith("/ema_loads"):
            np.testing.assert_allclose(b, a, rtol=1e-6, atol=0, err_msg=f"{where}: {key}")
        elif a.dtype.kind != "f" or key.startswith("dyskew/"):
            np.testing.assert_array_equal(a, b, err_msg=f"{where}: {key}")
        else:
            tol = PARAM_TOL if key.startswith("params/") else MOMENT_TOL
            assert _norm_err(a, b) <= tol, (where, key, _norm_err(a, b))


def assert_metrics_match(jm, tm, where):
    assert sorted(jm) == sorted(tm), where
    for k in jm:
        a, b = float(jm[k]), float(torch.as_tensor(tm[k]).detach())
        if k in ("moe_dropped_frac", "moe_distribute_frac", "moe_shard_imbalance", "lr"):
            assert a == b, (where, k, a, b)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-4 if k == "grad_norm" else 1e-5, err_msg=f"{where}: {k}")


@pytest.fixture(scope="module")
def models():
    jm, tm = j_build(_reduced(j_get_config)), t_build(_reduced(t_get_config))
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, tm, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU)


@pytest.fixture(scope="module", params=MAMBA_ARCHS, ids=[a for a, _ in MAMBA_ARCHS])
def mamba_models(request):
    arch, opt_name = request.param
    jm, tm = j_build(_reduced(j_get_config, arch)), t_build(_reduced(t_get_config, arch))
    jparams = jm.init(jax.random.PRNGKey(0))
    return opt_name, (jm, tm, jparams, params_from_numpy(jax.tree.map(np.asarray, jparams), device=CPU))


# --------------------------------------------------------------------- #
# The loss
# --------------------------------------------------------------------- #


class TestLoss:
    @pytest.mark.parametrize("masked", [0.0, 0.3, 1.0])
    def test_lm_loss(self, masked):
        rng = np.random.default_rng(int(masked * 10))
        logits = (rng.standard_normal((3, 17, 50)) * 4).astype(np.float32)
        targets = rng.integers(0, 50, (3, 17)).astype(np.int32)
        targets[rng.random((3, 17)) < masked] = -1
        want = float(j_transformer.lm_loss(jnp.asarray(logits), jnp.asarray(targets)))
        got = t_transformer.lm_loss(torch.from_numpy(logits), torch.from_numpy(targets))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=1e-6)

    def test_model_loss_and_gradients(self, models):
        jm, tm, jparams, tparams = models
        batch = _batch(np.random.default_rng(1))
        jdk = jm.dyskew_init()
        tdk = state_from_numpy(without_links(jax.tree.map(np.asarray, jdk)), device=CPU)

        def jloss(p):
            return jm.loss(p, jax.tree.map(jnp.asarray, batch), dyskew=jdk)
        (jl, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)

        flat = flatten_with_paths(tparams)
        live = {k: v.detach().requires_grad_(True) for k, v in flat}
        tree = {}
        for key, v in live.items():
            node = tree
            *parents, last = key.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[last] = v
        tl, taux = tm.loss(tree, {k: torch.from_numpy(v) for k, v in batch.items()}, dyskew=tdk)
        tgrads = torch.autograd.grad(tl, list(live.values()))
        np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
        jflat = _flat_ref(jgrads)
        for (key, _), g in zip(flat, tgrads):
            assert _norm_err(jflat[key], g.numpy()) <= GRAD_TOL, key
        assert_metrics_match(jaux["metrics"], taux["metrics"], "Model.loss")
        assert_links_match(jaux["dyskew"], flat_numpy(taux["dyskew"]), "Model.loss")


# --------------------------------------------------------------------- #
# Train steps
# --------------------------------------------------------------------- #


def _with_values(jstate, names, seed=3):
    """``jstate`` with numpy noise from ``seed`` added to the parameter
    leaves called ``names``."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        if str(getattr(path[-1], "key", "")) not in names:
            return a
        return a + jnp.asarray(0.5 * rng.standard_normal(a.shape), a.dtype)

    return dict(jstate, params=jax.tree_util.tree_map_with_path(leaf, jstate["params"]))


def _run_steps(models, opt_name, steps, microbatches=1, seed=2, noisy=()):
    jm, tm, _, _ = models
    jopt = JOpt(name=opt_name, warmup_steps=2, total_steps=20)
    topt = OptimizerConfig(name=opt_name, warmup_steps=2, total_steps=20)
    jstate = _with_values(j_train_state_init(jm, jopt, jax.random.PRNGKey(1)), noisy)
    tstate = state_from_numpy(without_links(jax.tree.map(np.asarray, jstate)), device=CPU)
    jstep = jax.jit(j_make_train_step(jm, jopt, JStep(num_microbatches=microbatches)))
    tstep = make_train_step(tm, topt, StepConfig(num_microbatches=microbatches))
    rng = np.random.default_rng(seed)
    for i in range(steps):
        batch = _batch(rng)
        jstate, jmet = jstep(jstate, jax.tree.map(jnp.asarray, batch))
        tstate, tmet = tstep(tstate, batch)
        assert_metrics_match(jmet, tmet, f"{opt_name} step {i + 1}")
    assert_state_matches(jstate, tstate, f"{opt_name} after {steps} steps")
    assert int(tstate["step"]) == steps
    return tstate


class TestTrainStep:
    @pytest.mark.parametrize("steps", [1, 3])
    @pytest.mark.parametrize("opt_name", ["adamw", "adafactor"])
    def test_steps_match_reference(self, models, opt_name, steps):
        _run_steps(models, opt_name, steps)

    @pytest.mark.parametrize("steps", [1, 3])
    def test_mamba_families_match_reference(self, mamba_models, steps):
        """The Mamba-2 layers train: every parameter, optimizer moment and
        (jamba) link state after one and three steps, and each step's
        metrics, against ``repro``'s jitted step."""
        opt_name, models = mamba_models
        state = _run_steps(models, opt_name, steps, noisy=ZERO_INIT)
        assert any("/mamba/" in k for k, _ in flatten_with_paths(state["params"]))

    def test_microbatches_match_reference(self, models):
        """Two microbatches a step: float32 accumulation, and ``ema_loads``
        advanced once a microbatch, as the reference advances it (the
        states matched above), the only state the links carry."""
        state = _run_steps(models, "adamw", 2, microbatches=2)
        assert {k: sorted(v) for k, v in state["dyskew"].items()} == {"l0": ["ema_loads"]}
        uniform = torch.full_like(state["dyskew"]["l0"]["ema_loads"], 1.0 / models[1].cfg.moe.num_experts)
        assert not torch.equal(state["dyskew"]["l0"]["ema_loads"], uniform)

    def test_remat_on_equals_off(self, models):
        """``torch.utils.checkpoint`` recomputes each block (its link's EMA
        included) from the same inputs: gradients, new link states and
        metrics are bit for bit those of the plain backward."""
        _, _, _, tparams = models
        batch = {k: torch.from_numpy(v) for k, v in _batch(np.random.default_rng(4)).items()}
        out = []
        for remat in (True, False):
            tm = t_build(_reduced(t_get_config, remat=remat))
            live = [v.detach().requires_grad_(True) for _, v in flatten_with_paths(tparams)]
            it = iter(live)
            tree = t_transformer.tree_map(lambda _: next(it), tparams)
            loss, aux = tm.loss(tree, batch, dyskew=tm.dyskew_init(device=CPU))
            out.append((loss, torch.autograd.grad(loss, live), aux))
        (l1, g1, a1), (l2, g2, a2) = out
        assert torch.equal(l1, l2)
        assert all(torch.equal(a, b) for a, b in zip(g1, g2))
        for (k, a), (_, b) in zip(flatten_with_paths(a1["dyskew"]), flatten_with_paths(a2["dyskew"])):
            assert torch.equal(a, b), k
        assert sorted(a1["dyskew"]["l0"]) == ["ema_loads"]
        assert a1["dyskew"]["l0"]["ema_loads"].shape == (t_transformer.num_blocks(tm.cfg), tm.cfg.moe.num_experts)


# --------------------------------------------------------------------- #
# The kernels' autograd Functions
# --------------------------------------------------------------------- #


class TestFunctions:
    def test_gating_gradcheck(self):
        rng = np.random.default_rng(5)
        logits = torch.from_numpy(rng.standard_normal((6, 8)) * 2).requires_grad_(True)
        fn = lambda x: gating_ops.Gating.apply(x, 3, topk_gating_ref)[0]
        assert torch.autograd.gradcheck(fn, (logits,))

    def test_dispatch_gradcheck(self):
        rng = np.random.default_rng(6)
        x = torch.from_numpy(rng.standard_normal((5, 3))).requires_grad_(True)
        src = torch.from_numpy(rng.integers(0, 5, 12).astype(np.int32))
        valid = torch.from_numpy(rng.random(12) < 0.6)
        fn = lambda t: dispatch_ops.Dispatch.apply(t, src, valid, dispatch_gather_ref)
        assert torch.autograd.gradcheck(fn, (x,))

    def test_functions_equal_plain_autograd(self):
        """float32 on the CPU: the Functions' backwards give the bits
        autograd gives through the plain versions, and the same bits twice."""
        rng = np.random.default_rng(7)
        logits = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
        dw = torch.from_numpy(rng.standard_normal((64, 8)).astype(np.float32))
        grads = []
        for fn in (lambda x: gating_ops.gating(x, 8)[0], lambda x: gating_ops.gating(x, 8)[0],
                   lambda x: topk_gating_ref(x, 8)[0]):
            leaf = logits.clone().requires_grad_(True)
            grads.append(torch.autograd.grad(fn(leaf), leaf, dw)[0])
        assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0], grads[2])

        x = torch.from_numpy(rng.standard_normal((50, 16)).astype(np.float32))
        src = torch.from_numpy(rng.integers(0, 50, 400).astype(np.int32))
        valid = torch.from_numpy(rng.random(400) < 0.7)
        dbuf = torch.from_numpy(rng.standard_normal((400, 16)).astype(np.float32))
        grads = []
        for fn in (lambda t: dispatch_ops.dispatch(t, src, valid), lambda t: dispatch_ops.dispatch(t, src, valid),
                   lambda t: dispatch_gather_ref(t, src, valid)):
            leaf = x.clone().requires_grad_(True)
            grads.append(torch.autograd.grad(fn(leaf), leaf, dbuf)[0])
        assert torch.equal(grads[0], grads[1])
        torch.testing.assert_close(grads[0], grads[2], rtol=1e-6, atol=1e-6)

    def test_indices_get_no_gradient(self):
        logits = torch.randn(4, 8, dtype=torch.float64, requires_grad=True)
        w, idx = gating_ops.gating(logits, 2)
        assert w.requires_grad and not idx.requires_grad and idx.dtype == torch.int32

    def test_state_scan_under_grad_returns_both_gradients(self):
        """Under grad the scan runs as ``StateScan``: both inputs get a
        gradient, the same bits as autograd through the plain scan; under
        ``torch.no_grad()`` it still runs, and records nothing."""
        rng = np.random.default_rng(8)
        states = torch.from_numpy(rng.standard_normal((4, 2, 4, 5)).astype(np.float32))
        decay = torch.from_numpy(rng.random((4, 2)).astype(np.float32))
        g = torch.from_numpy(rng.standard_normal((4, 2, 4, 5)).astype(np.float32))
        grads = []
        for fn in (scan_ops.state_scan, ssd_state_scan_ref):
            s, d = states.clone().requires_grad_(True), decay.clone().requires_grad_(True)
            out = fn(s, d)
            assert out.requires_grad
            grads.append(torch.autograd.grad(out, (s, d), g))
        (ds, dd), (ds_ref, dd_ref) = grads
        assert ds.shape == states.shape and dd.shape == decay.shape
        assert float(ds.abs().max()) > 0 and float(dd.abs().max()) > 0
        assert torch.equal(ds, ds_ref) and torch.equal(dd, dd_ref)
        with torch.no_grad():
            out = scan_ops.state_scan(states.requires_grad_(True), decay)
        assert out.shape == states.shape and out.grad_fn is None
        assert scan_ops.state_scan(states.detach(), decay).shape == states.shape


# --------------------------------------------------------------------- #
# Loop, checkpoint resume, launcher
# --------------------------------------------------------------------- #


class TestLoop:
    def test_three_steps_with_resume(self, tmp_path):
        """Two steps with a checkpoint, then a run to step 3 resumes from
        it: the resumed step is the restored state plus one step on a fresh
        pipeline's first batch, bit for bit; the first two steps are those
        of an uninterrupted run."""
        cfg = _reduced(t_get_config)
        data = DataConfig(vocab_size=cfg.vocab_size, seq_len=SEQ, global_batch=BATCH, num_shards=2)
        opt = OptimizerConfig(warmup_steps=1, total_steps=3)
        ckpt = str(tmp_path / "ckpt")
        full = train(cfg, data, opt, LoopConfig(steps=3, log_every=1), device=CPU)
        part = train(cfg, data, opt, LoopConfig(steps=2, log_every=1, checkpoint_every=2,
                                                checkpoint_dir=ckpt), device=CPU)
        assert [h["loss"] for h in part["history"]] == [h["loss"] for h in full["history"][:2]]
        resumed = train(cfg, data, opt, LoopConfig(steps=3, log_every=1, checkpoint_every=2,
                                                   checkpoint_dir=ckpt), device=CPU)
        assert [h["step"] for h in resumed["history"]] == [3]
        assert int(resumed["state"]["step"]) == 3
        mgr = CheckpointManager(ckpt)
        assert mgr.all_steps() == [2, 3]
        restored = mgr.restore(part["state"], step=2)
        for (k, a), (_, b) in zip(flatten_with_paths(part["state"]), flatten_with_paths(restored)):
            assert torch.equal(a, b), k
        step = make_train_step(t_build(cfg), opt)
        want, _ = step(restored, next(DataPipeline(data, device=CPU)))
        for (k, a), (_, b) in zip(flatten_with_paths(want), flatten_with_paths(resumed["state"])):
            assert torch.equal(a, b), k
        for h in full["history"]:
            assert np.isfinite(h["loss"]) and h["data_wait_s"] >= 0.0

    def test_history_keys_match_reference(self):
        """The same metrics in each history entry as ``repro``'s loop (the
        port adds ``data_wait_s``)."""
        kw = dict(seq_len=SEQ, global_batch=BATCH, num_shards=2)
        jcfg, tcfg = _reduced(j_get_config), _reduced(t_get_config)
        jout = j_loop.train(jcfg, JData(vocab_size=jcfg.vocab_size, **kw), JOpt(), j_loop.LoopConfig(steps=1))
        tout = train(tcfg, DataConfig(vocab_size=tcfg.vocab_size, **kw), OptimizerConfig(),
                     LoopConfig(steps=1), device=CPU)
        assert sorted(tout["history"][0]) == sorted(list(jout["history"][0]) + ["data_wait_s"])
        assert sorted(k for k, _ in flatten_with_paths(tout["state"])) == sorted(_flat_ref(jout["state"]))

    def test_train_state_init_on_the_generator_device(self):
        tm = t_build(_reduced(t_get_config))
        st = train_state_init(tm, OptimizerConfig(), torch.Generator().manual_seed(0), device=CPU)
        again = train_state_init(tm, OptimizerConfig(), torch.Generator().manual_seed(0), device=CPU)
        assert st["step"].dtype == torch.int32 and st["step"].device.type == "cpu"
        for (k, a), (_, b) in zip(flatten_with_paths(st), flatten_with_paths(again)):
            assert torch.equal(a, b), k
        specs = flatten_with_paths(train_state_specs(tm, OptimizerConfig()))
        live = dict(flatten_with_paths({"params": st["params"], "opt": st["opt"]}))
        assert [k for k, _ in specs] == list(live)
        assert all(tuple(p.shape) == tuple(live[k].shape) for k, p in specs)

    @pytest.mark.parametrize("arch", [ARCH, "mamba2-1.3b"])
    def test_launcher_on_the_cpu(self, capsys, arch):
        t_launch.main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "4", "--seq", "32",
                       "--log-every", "1", "--device", "cpu"])
        out = capsys.readouterr().out.strip().splitlines()
        assert out[0].startswith("step     1  loss=")
        assert ("moe_drop=" in out[0]) == (t_get_config(arch).moe is not None)
        assert out[-1].startswith("done: loss")
