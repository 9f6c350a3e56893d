"""The port's optimizers, gradient compression and checkpoint manager
against ``repro`` on the CPU.

Mirrors ``TestOptimizers``, ``TestGradCompression`` and ``TestCheckpoint``
of ``tests/test_substrate.py`` on one process (``allreduce_compressed`` over
ranks and the elastic restore across world sizes are in
``tests/test_torch_ranks.py``), and adds parity: the same numpy parameters,
gradients and steps through both sides.  Tolerances: the learning rate
rtol 1e-6 (float32 cosine, one library's ``cos`` against another's); one
update's parameters and optimizer states rtol 1e-5 / atol 1e-7 (float32
element-wise arithmetic in the same order; ``sqrt``/``rsqrt`` may differ in
the last bit); quantized gradients EQUAL, scales rtol 1e-7; checkpoints
bit-exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as JCkpt
from repro.optim import grad_compress as j_gc
from repro.optim import optimizers as j_opt
from repro.optim.specs import opt_state_specs as j_specs
from repro_torch.checkpoint.manager import CheckpointManager, flatten_with_paths
from repro_torch.models.param import spec, tree_materialize
from repro_torch.optim import grad_compress as t_gc
from repro_torch.optim import optimizers as t_opt
from repro_torch.optim.specs import opt_state_specs

UPDATE_TOL = dict(rtol=1e-5, atol=1e-7)


def _t(tree):
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    return np.asarray(tree.detach().numpy() if isinstance(tree, torch.Tensor) else tree)


def assert_tree_close(a, b, **tol):
    fa, fb = flatten_with_paths(_np(a)), flatten_with_paths(_np(b))
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        np.testing.assert_allclose(y, x, err_msg=k, **tol)


def _tree(rng):
    """Parameters and gradients, one leaf factored under Adafactor's 128
    threshold, one not, one vector."""
    shapes = {"big": (160, 130), "blocks": {"w": (3, 40, 24), "b": (3, 24)}, "bias": (7,)}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        return rng.standard_normal(s).astype(np.float32)
    return make(shapes), make(shapes)


class TestOptimizers:
    def _quad_params(self):
        return {"w": torch.tensor([1.0, -2.0, 3.0]), "b": torch.zeros((3, 200))}

    @pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
    def test_decreases_quadratic_loss(self, name):
        cfg = t_opt.OptimizerConfig(name=name, lr=0.05, warmup_steps=0, weight_decay=0.0)
        params = self._quad_params()
        state = t_opt.opt_init(cfg, params)

        def loss(p):
            return sum(torch.sum(x ** 2) for x in (p["b"], p["w"]))

        l0 = float(loss(params))
        for step in range(20):
            grads = {k: 2 * v for k, v in params.items()}
            params, state, _ = t_opt.opt_update(cfg, grads, state, params, torch.tensor(step))
        factor = 0.8 if name == "sgd" else 0.5  # sgd is clipped
        assert float(loss(params)) < factor * l0, name

    def test_adafactor_factored_state_is_small(self):
        cfg = t_opt.OptimizerConfig(name="adafactor", factored_dim_threshold=128)
        state = t_opt.opt_init(cfg, {"big": torch.zeros((512, 256)), "small": torch.zeros((4, 4))})
        assert state["v"]["big"]["vr"].shape == (512,)
        assert state["v"]["big"]["vc"].shape == (256,)
        assert state["v"]["small"]["v"].shape == (4, 4)

    def test_opt_state_specs_match_init(self):
        pspecs = {"w": spec((256, 256), ("embed", "mlp")), "b": spec((8,), (None,))}
        params = tree_materialize(pspecs, torch.Generator().manual_seed(0), device="cpu")
        for name in ("adamw", "adafactor", "sgd"):
            cfg = t_opt.OptimizerConfig(name=name)
            live = flatten_with_paths(t_opt.opt_init(cfg, params))
            ab = flatten_with_paths(opt_state_specs(cfg, pspecs))
            assert [(k, tuple(v.shape), v.dtype) for k, v in live] == \
                   [(k, tuple(v.shape), v.dtype) for k, v in ab], name
            # The same tree as the reference's specs.
            from repro.models.param import spec as jspec
            jp = {"w": jspec((256, 256), ("embed", "mlp")), "b": jspec((8,), (None,))}
            jflat = jax.tree_util.tree_flatten_with_path(
                j_specs(j_opt.OptimizerConfig(name=name), jp),
                is_leaf=lambda x: hasattr(x, "axes"))[0]
            assert [("/".join(p.key for p in path), tuple(s.shape), tuple(s.axes)) for path, s in jflat] == \
                   [(k, tuple(v.shape), tuple(v.axes)) for k, v in ab], name

    def test_lr_schedule_warmup_and_decay(self):
        cfg = t_opt.OptimizerConfig(lr=1e-3, warmup_steps=10, total_steps=100)
        assert float(t_opt.lr_schedule(cfg, torch.tensor(0))) == 0.0
        assert float(t_opt.lr_schedule(cfg, torch.tensor(10))) == pytest.approx(1e-3)
        assert float(t_opt.lr_schedule(cfg, torch.tensor(100))) == pytest.approx(1e-4, rel=0.01)

    def test_lr_schedule_parity(self):
        for kw in (dict(lr=1e-3, warmup_steps=10, total_steps=100), dict(warmup_steps=0, total_steps=7)):
            jc, tc = j_opt.OptimizerConfig(**kw), t_opt.OptimizerConfig(**kw)
            for step in range(0, 120, 3):
                np.testing.assert_allclose(
                    float(t_opt.lr_schedule(tc, torch.tensor(step, dtype=torch.int32))),
                    float(j_opt.lr_schedule(jc, jnp.asarray(step, jnp.int32))), rtol=1e-6)

    def test_grad_clip(self):
        cfg = t_opt.OptimizerConfig(name="sgd", grad_clip=1.0, warmup_steps=0)
        _, _, stats = t_opt.opt_update(cfg, {"w": torch.full((4,), 100.0)}, {}, {"w": torch.zeros(4)},
                                       torch.tensor(0))
        assert float(stats["grad_norm"]) == pytest.approx(200.0)

    @pytest.mark.parametrize("name", ["adamw", "adafactor", "sgd"])
    @pytest.mark.parametrize("clip", [1.0, 1e6], ids=["clipped", "unclipped"])
    def test_updates_match_reference(self, name, clip):
        """Three updates from identical parameters and gradients."""
        rng = np.random.default_rng(3)
        params, _ = _tree(rng)
        jc = j_opt.OptimizerConfig(name=name, grad_clip=clip, warmup_steps=2, total_steps=10)
        tc = t_opt.OptimizerConfig(name=name, grad_clip=clip, warmup_steps=2, total_steps=10)
        jp, tp = jax.tree.map(jnp.asarray, params), _t(params)
        js, ts = j_opt.opt_init(jc, jp), t_opt.opt_init(tc, tp)
        for step in range(3):
            _, grads = _tree(rng)
            jp, js, jst = j_opt.opt_update(jc, jax.tree.map(jnp.asarray, grads), js, jp, jnp.asarray(step))
            tp, ts, tst = t_opt.opt_update(tc, _t(grads), ts, tp, torch.tensor(step))
            assert_tree_close(jp, tp, **UPDATE_TOL)
            assert_tree_close(js, ts, **UPDATE_TOL)
            for k in ("grad_norm", "lr"):
                np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=1e-6)

    def test_bfloat16_params_stay_bfloat16(self):
        """The update is taken in float32 and written back in the
        parameter's dtype (no float32 master copy), AdamW's moments in
        float32."""
        cfg = t_opt.OptimizerConfig(warmup_steps=0)
        p = {"w": torch.ones(8, dtype=torch.bfloat16)}
        s = t_opt.opt_init(cfg, p)
        new_p, new_s, _ = t_opt.opt_update(cfg, {"w": torch.ones(8, dtype=torch.bfloat16)}, s, p, torch.tensor(0))
        assert new_p["w"].dtype == torch.bfloat16 and new_s["m"]["w"].dtype == torch.float32


class TestGradCompression:
    def test_quantize_roundtrip_error_bounded(self):
        g = torch.from_numpy(np.random.default_rng(0).standard_normal(1000).astype(np.float32))
        q, s = t_gc.quantize_int8(g)
        assert float((t_gc.dequantize_int8(q, s) - g).abs().max()) <= float(s) * 0.51
        jq, js = j_gc.quantize_int8(jnp.asarray(g.numpy()))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_allclose(float(s), float(js), rtol=1e-7)

    def test_error_feedback_accumulates_residual(self):
        grads = {"w": torch.full((64,), 0.001)}
        qs, ss, rs = t_gc.compress_with_feedback(grads, t_gc.residual_init(grads))
        recon = t_gc.dequantize_int8(qs["w"], ss["w"]) + rs["w"]
        np.testing.assert_allclose(recon.numpy(), 0.001, rtol=1e-5)

    def test_feedback_matches_reference(self):
        rng = np.random.default_rng(5)
        _, grads = _tree(rng)
        jr = j_gc.residual_init(jax.tree.map(jnp.asarray, grads))
        tr = t_gc.residual_init(_t(grads))
        for _ in range(3):
            _, grads = _tree(rng)
            jq, jsc, jr = j_gc.compress_with_feedback(jax.tree.map(jnp.asarray, grads), jr)
            tq, tsc, tr = t_gc.compress_with_feedback(_t(grads), tr)
            assert_tree_close(jq, tq, rtol=0, atol=0)
            assert_tree_close(jsc, tsc, rtol=1e-7)
            assert_tree_close(jr, tr, rtol=1e-6, atol=1e-7)


class TestCheckpoint:
    def test_save_restore_roundtrip(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        state = {"params": {"w": torch.arange(12.0).reshape(3, 4)}, "step": torch.tensor(7, dtype=torch.int32)}
        mgr.save(7, state, blocking=True)
        restored = mgr.restore(state)
        assert torch.equal(restored["params"]["w"], state["params"]["w"])
        assert int(restored["step"]) == 7 and restored["step"].dtype == torch.int32

    def test_retention_gc(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, {"x": torch.zeros(4)}, blocking=True)
        assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4

    def test_atomicity_no_tmp_left(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        mgr.save(1, {"x": torch.zeros(2)}, blocking=True)
        assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))

    def test_async_save_snapshots_on_the_caller_thread(self, tmp_path):
        """The saved values are those at the call, whatever the caller does
        to its tensors before the write finishes."""
        mgr = CheckpointManager(str(tmp_path))
        x = torch.arange(4.0)
        mgr.save(1, {"x": x})
        x.add_(100.0)
        mgr.wait()
        assert torch.equal(mgr.restore({"x": x})["x"], torch.arange(4.0))

    def test_bfloat16_leaves_round_trip_as_raw_bits(self, tmp_path):
        mgr = CheckpointManager(str(tmp_path))
        w = torch.from_numpy(np.random.default_rng(1).standard_normal((5, 3)).astype(np.float32)).bfloat16()
        state = {"p": {"w": w, "flag": torch.tensor([True, False])}, "step": torch.tensor(3, dtype=torch.int32)}
        mgr.save(3, state, blocking=True)
        meta = json.load(open(tmp_path / "step_00000003" / "meta.json"))
        assert meta["keys"] == ["p/flag", "p/w", "step"] and meta["dtypes"] == {"p/w": "bfloat16"}
        with np.load(tmp_path / "step_00000003" / "shard_host0.npz") as data:
            assert data["p/w"].dtype == np.uint16
        back = mgr.restore(state)
        assert back["p"]["w"].dtype == torch.bfloat16 and torch.equal(back["p"]["w"], w)
        assert torch.equal(back["p"]["flag"], state["p"]["flag"])

    def test_restores_a_reference_checkpoint(self, tmp_path):
        """A float32 checkpoint written by ``repro`` restores into the port,
        and the port's float32 checkpoint into ``repro``: same layout."""
        rng = np.random.default_rng(2)
        params, _ = _tree(rng)
        jstate = {"params": jax.tree.map(jnp.asarray, params), "step": jnp.asarray(5, jnp.int32),
                  "dyskew": {"l0": {"tick": jnp.arange(3, dtype=jnp.int32)}}}
        JCkpt(str(tmp_path / "ref")).save(5, jstate, blocking=True)
        like = jax.tree.map(lambda a: torch.zeros_like(torch.from_numpy(np.array(a))), jstate)
        mgr = CheckpointManager(str(tmp_path / "ref"))
        assert mgr.latest_step() == 5
        back = mgr.restore(like)
        assert_tree_close(jstate, back, rtol=0, atol=0)
        CheckpointManager(str(tmp_path / "port")).save(6, back, blocking=True)
        again = JCkpt(str(tmp_path / "port")).restore(jstate)
        assert_tree_close(jstate, again, rtol=0, atol=0)
