"""The slice as a whole: ``granite-moe-1b-a400m`` reduced, float32, on the
CPU — prefill and greedy decode through the port against ``repro``, with
the weights and the decode state carried across by ``params_from_numpy`` /
``state_from_numpy``.

Tolerances: logits rtol 2e-4 / atol 2e-5 (two layers of float32 matrix
products, softmaxes and norms taken in another order by the two frameworks;
the errors compound through the residual stream), greedy tokens and the
cache position EQUAL.  The port's own decode-against-full-forward check
uses the band of ``tests/test_arch_smoke.py`` (rtol 2e-2 / atol 2e-3).
"""

import ast
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import get_config as j_get_config
from repro.models import transformer as j_transformer
from repro.models.layers.moe import SpmdCtx as JCtx
from repro.models.model_api import build as j_build
from repro.train.step import make_decode_step as j_make_decode_step
from repro.train.step import make_prefill_step as j_make_prefill_step
from repro_torch.config.base import get_config as t_get_config
from repro_torch.models import transformer as t_transformer
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.models.layers import attention as t_attention
from repro_torch.models.layers import basic as t_basic
from repro_torch.models.layers.moe import SpmdCtx as TCtx
from repro_torch.models.model_api import build as t_build
from repro_torch.models.param import spec, tree_leaves, tree_materialize
from repro_torch.models.perf_flags import PerfFlags, use_flags
from repro_torch.train.step import make_decode_step as t_make_decode_step
from repro_torch.train.step import make_prefill_step as t_make_prefill_step

from test_torch_train import without_links

ARCH = "granite-moe-1b-a400m"
ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH, SEQ, DECODE = 2, 32, 3
N_EP = 4


def _reduced(get_config):
    return dataclasses.replace(get_config(ARCH).reduced(), dtype="float32")


@pytest.fixture(scope="module")
def models():
    jm, tm = j_build(_reduced(j_get_config)), t_build(_reduced(t_get_config))
    jparams = jm.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu",
                                dtype=torch.float32)
    return jm, tm, jparams, tparams


def _tokens(seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (BATCH, SEQ)).astype(np.int32)


def test_prefill_and_greedy_decode_match_the_reference(models):
    jm, tm, jparams, tparams = models
    jctx, tctx = JCtx(num_groups=1, num_ep_shards=N_EP), TCtx(num_groups=1, num_ep_shards=N_EP)
    jpre, jdec = jax.jit(j_make_prefill_step(jm, jctx)), jax.jit(j_make_decode_step(jm, jctx))
    tpre, tdec = t_make_prefill_step(tm, tctx), t_make_decode_step(tm, tctx)
    max_seq = SEQ + DECODE + 1
    jstate = jm.decode_state_init(BATCH, max_seq)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), device="cpu")
    toks = _tokens()

    jlogits, jstate = jpre(jparams, jstate, {"tokens": jnp.asarray(toks)})
    tlogits, tstate = tpre(tparams, tstate, {"tokens": torch.from_numpy(toks)})
    for step in range(DECODE + 1):
        assert tlogits.shape == (BATCH, 1, tm.cfg.padded_vocab)
        assert bool(torch.isfinite(tlogits).all())
        np.testing.assert_allclose(np.asarray(jlogits), tlogits.numpy(),
                                   rtol=2e-4, atol=2e-5, err_msg=f"step {step}")
        jtok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
        ttok = torch.argmax(tlogits, dim=-1).to(torch.int32)
        np.testing.assert_array_equal(np.asarray(jtok), ttok.numpy())
        assert int(jstate["pos"]) == int(tstate["pos"]) == SEQ + step
        assert tstate["pos"].dtype == torch.int32
        if step == DECODE:
            break
        jlogits, jstate = jdec(jparams, jstate, jtok)
        tlogits, tstate = tdec(tparams, tstate, ttok)
    # The caches hold the same keys and values where they were written.
    # Keys are of magnitude 5 here (rotated sums of 64 products), so the
    # absolute band is set to that scale: 2e-4 is 4e-5 of the magnitude.
    for name in ("k", "v"):
        np.testing.assert_allclose(
            np.asarray(jstate["kv_l0"][name]), tstate["kv_l0"][name].numpy(),
            rtol=2e-4, atol=2e-4,
        )


def test_forward_with_carried_link_state_matches_the_reference(models):
    """``transformer.forward(..., dyskew=...)``: logits, metrics and the new
    link states (``ema_loads``), two calls in a row so that the second
    starts from carried state."""
    jm, tm, jparams, tparams = models
    jctx, tctx = JCtx(num_groups=1, num_ep_shards=N_EP), TCtx(num_groups=1, num_ep_shards=N_EP)
    jdk = jm.dyskew_init(jctx)
    tdk = state_from_numpy(without_links(jax.tree.map(np.asarray, jdk)), device="cpu")
    own = tm.dyskew_init(tctx, device="cpu")
    assert tree_leaves(jax.tree.map(lambda a: (a.shape, str(a.dtype)), own)) == \
           tree_leaves(jax.tree.map(lambda a: (a.shape, str(a.dtype)), tdk))
    jfwd = jax.jit(lambda p, t, dk: j_transformer.forward(p, t, cfg=jm.cfg, ctx=jctx, dyskew=dk))
    for call in range(2):
        toks = _tokens(seed=10 + call)
        jlogits, jaux = jfwd(jparams, jnp.asarray(toks), jdk)
        tlogits, taux = t_transformer.forward(
            tparams, torch.from_numpy(toks), cfg=tm.cfg, ctx=tctx, dyskew=tdk
        )
        np.testing.assert_allclose(np.asarray(jlogits), tlogits.numpy(), rtol=2e-4, atol=2e-5)
        assert set(jaux["metrics"]) == set(taux["metrics"])
        for key in ("moe_dropped_frac", "moe_distribute_frac"):
            assert float(jaux["metrics"][key]) == float(taux["metrics"][key])
        jdk, tdk = jaux["dyskew"], taux["dyskew"]
        assert {k: sorted(v) for k, v in tdk.items()} == {"l0": ["ema_loads"]}
        np.testing.assert_allclose(np.asarray(jdk["l0"]["ema_loads"]),
                                   tdk["l0"]["ema_loads"].numpy(), rtol=1e-6)


def test_decode_matches_full_forward(models):
    """Causality/cache correctness, the port alone: token-by-token decode
    logits must match the full forward pass."""
    _, tm, _, tparams = models
    toks = torch.from_numpy(_tokens())
    full_logits, _ = t_transformer.forward(
        tparams, toks, cfg=tm.cfg, dyskew=tm.dyskew_init(device="cpu")
    )
    rtol, atol = 2e-2, 2e-3
    half = SEQ // 2
    state = tm.decode_state_init(BATCH, SEQ, device="cpu")
    logits_p, state = tm.prefill(tparams, {"tokens": toks[:, :half]}, state)
    np.testing.assert_allclose(logits_p.numpy(), full_logits[:, :half].numpy(),
                               rtol=rtol, atol=atol)
    for t in range(half, half + 3):
        logits_t, state = tm.decode_step(tparams, state, toks[:, t:t + 1])
        np.testing.assert_allclose(logits_t[:, 0].numpy(), full_logits[:, t].numpy(),
                                   rtol=rtol, atol=atol, err_msg=f"step {t}")
    assert int(state["pos"]) == half + 3


def test_prefill_mutates_the_cache_in_place(models):
    _, tm, _, tparams = models
    state = tm.decode_state_init(BATCH, SEQ, device="cpu")
    k_before = state["kv_l0"]["k"]
    assert float(k_before.abs().sum()) == 0.0
    _, new_state = tm.prefill(tparams, {"tokens": torch.from_numpy(_tokens())}, state)
    assert new_state["kv_l0"]["k"] is k_before
    assert float(k_before.abs().sum()) > 0.0
    assert int(state["pos"]) == 0 and int(new_state["pos"]) == SEQ


def test_causal_skip_is_exact(models):
    _, tm, _, tparams = models
    toks = torch.from_numpy(_tokens())
    base, _ = t_transformer.forward(tparams, toks, cfg=tm.cfg)
    with use_flags(PerfFlags(causal_skip=True)):
        state = tm.decode_state_init(BATCH, SEQ + 8, device="cpu")
        skipped, _ = tm.prefill(tparams, {"tokens": toks}, state)
    np.testing.assert_allclose(base.numpy(), skipped.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("q_chunk", [4, 8, 32])
def test_attention_is_the_same_for_any_query_chunk(q_chunk):
    rng = np.random.default_rng(q_chunk)
    q = torch.from_numpy(rng.standard_normal((2, 32, 2, 2, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 40, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 40, 2, 16)).astype(np.float32))
    want = t_attention.chunked_attention(q, k, v, causal=True, kv_len=32, q_chunk=32)
    got = t_attention.chunked_attention(q, k, v, causal=True, kv_len=32, q_chunk=q_chunk)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-6)


def test_rope_rotates_interleaved_pairs():
    from repro.models.layers import basic as j_basic
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5, dtype=np.int32)[None, :] + 7
    for style in ("full", "half", "none"):
        want = j_basic.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, style)
        got = t_basic.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 10_000.0, style)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_the_reference(kind):
    from repro.models.layers import basic as j_basic
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 5, 32)).astype(np.float32)
    p = {"scale": rng.uniform(0.5, 1.5, 32).astype(np.float32),
         "bias": rng.standard_normal(32).astype(np.float32)}
    want = j_basic.norm_apply({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), kind)
    got = t_basic.norm_apply({k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["gelu", "silu", "relu2"])
def test_activations_match_the_reference(name):
    from repro.models.layers import basic as j_basic
    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(
        t_basic.act(name, torch.from_numpy(x)).numpy(),
        np.asarray(j_basic.act(name, jnp.asarray(x))), rtol=1e-5, atol=1e-6,
    )


def test_dense_model_matches_the_reference():
    """The dense branch the served model does not take: layernorm, a gelu
    mlp, qkv biases, tied embeddings, MQA, a vocabulary that needs no pad."""
    from repro.config.base import ArchConfig as JArch
    from repro_torch.config.base import ArchConfig as TArch
    kw = dict(name="dense", family="dense", num_layers=2, d_model=32, num_heads=4,
              num_kv_heads=1, d_ff=64, vocab_size=128, qkv_bias=True,
              tie_embeddings=True, norm="layernorm", mlp_act="gelu",
              rope_style="half", dtype="float32")
    jm, tm = j_build(JArch(**kw)), t_build(TArch(**kw))
    jparams = jm.init(jax.random.PRNGKey(2))
    # Biases are initialised to zero: give them values so that they count.
    jparams = jax.tree.map(lambda a: a + 0.01 if a.ndim == 3 and a.shape[-1] == 8 else a, jparams)
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    toks = np.random.default_rng(4).integers(0, 128, (2, 24)).astype(np.int32)
    jlogits, _ = j_transformer.forward(jparams, jnp.asarray(toks), cfg=jm.cfg)
    tlogits, taux = t_transformer.forward(tparams, torch.from_numpy(toks), cfg=tm.cfg)
    assert taux["metrics"] == {} and "lm_head" not in tparams
    # Tied unit-scale embeddings give logits of magnitude 30 here, so the
    # absolute band is 1e-4: 3e-6 of that magnitude.
    np.testing.assert_allclose(np.asarray(jlogits), tlogits.numpy(), rtol=2e-4, atol=1e-4)
    assert tm.dyskew_init() is None


def test_pad_vocab_logits_are_masked():
    table = torch.ones(8, 4)
    logits = t_basic.logits_apply({"table": table}, torch.ones(2, 3, 4), true_vocab=5)
    assert (logits[..., :5] == 4.0).all()
    assert (logits[..., 5:] == torch.finfo(torch.float32).min).all()


def test_specs_match_the_reference_at_full_width():
    jm, tm = j_build(j_get_config(ARCH)), t_build(t_get_config(ARCH))
    jleaves = jax.tree.leaves(
        jax.tree.map(lambda p: (p.shape, p.axes, p.init, p.scale), jm.specs(),
                     is_leaf=lambda x: hasattr(x, "axes")),
        is_leaf=lambda x: isinstance(x, tuple),
    )
    tleaves = [(p.shape, p.axes, p.init, p.scale) for p in tree_leaves(tm.specs())]
    assert jleaves == tleaves
    assert jm.num_params() == tm.num_params() > 1.3e9
    assert dataclasses.asdict(jm.cfg) == dataclasses.asdict(tm.cfg)


def test_tree_materialize_follows_the_init_rule():
    tree = {
        "w": spec((256, 64), ("embed", "mlp")),
        "r": spec((256, 8), ("embed", "experts"), scale=0.02),
        "b": spec((64,), (None,), init="zeros"),
        "s": spec((64,), (None,), init="ones"),
    }
    gen = torch.Generator().manual_seed(0)
    out = tree_materialize(tree, gen, dtype_override=torch.bfloat16, device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in out.values())
    assert float(out["b"].abs().sum()) == 0.0 and float(out["s"].sum()) == 64.0
    assert abs(float(out["w"].float().std()) - 1 / 16) < 0.005   # 1/sqrt(fan_in)
    assert abs(float(out["r"].float().std()) - 0.02) < 0.002
    again = tree_materialize(tree, torch.Generator().manual_seed(0),
                             dtype_override=torch.bfloat16, device="cpu")
    assert all(torch.equal(out[k], again[k]) for k in out)


def test_what_is_not_ported_says_so():
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.step import StepConfig, make_train_step

    tm = t_build(_reduced(t_get_config))
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        make_train_step(tm, OptimizerConfig(), StepConfig(grad_compression=True))
    with pytest.raises(KeyError):
        t_get_config("no-such-arch")


def test_default_device_needs_a_gpu():
    tm = t_build(_reduced(t_get_config))
    if torch.cuda.is_available():
        assert tm.decode_state_init(1, 4)["pos"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.decode_state_init(1, 4)
        with pytest.raises(RuntimeError, match="CUDA"):
            tm.init(torch.Generator().manual_seed(0))


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_the_port_imports_neither_jax_nor_the_reference_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "flax", "repro"}, (path, roots)
