"""All ten architectures of the registry through the port against ``repro``,
on the CPU, mirroring ``tests/test_arch_smoke.py``: each reduced config in
float32, the reference's own init carried across with ``params_from_numpy``
(attention biases and norm parameters moved off their zero / one init with
numpy noise from a seed, so that they count), tokens, frames and patches
made with numpy from a seed and fed to both sides.

Tolerances, each with its reason:
- logits, port against reference: rtol 2e-4 and an absolute band of 2e-5
  of the reference's largest |logit|.  Two to eight layers of float32
  products, softmaxes and norms are taken in another order by the two
  frameworks, and the errors compound through the residual stream (the
  band of ``tests/test_torch_serve.py``, scaled to the logits, which reach
  30 where unit-scale embeddings are tied to the head);
- reduced ``whisper-base``: 1e-3 of its largest |logit|.  float32 itself
  is that far from float64 there: against a float64 run of the port, the
  reference's float32 logits lie 1.1e-4 of the largest away on the
  uncached forward and up to 5.2e-4 on its cached path, the port's within
  5.9e-5 (the other nine configs: within 1.2e-5).  Its output projections,
  drawn at fan-in = 4 heads, give attention outputs of magnitude 100 on a
  unit-scale residual, and the layernorms divide what remains of their
  sums.  A computation in bfloat16 would still miss the band tenfold;
- the int8 cache (``qwen1.5-32b``), port against reference: 2e-3 of the
  largest |logit|.  Both sides quantize the same float32 keys and values up
  to their last bits, so an int8 value may sit one step apart where
  ``x / scale`` lies within a rounding of a half (one of 4,096 values here,
  which moves the logits by 6.6e-4 of the largest).  At most 1 % of the
  int8 values may differ, by one step; the float32 scales follow the keys'
  and values' last bits and are held to the logits' band, as are the float
  caches.  Quantizing at all moves the logits by 1.1e-2 to 6.1e-2;
- the port's own cached path against its uncached forward: the bands of
  ``tests/test_arch_smoke.py``, rtol 2e-2 / atol 2e-3, and rtol 0.5 /
  atol 0.25 for the int8 cache;
- ``Model.loss``: the loss rtol 1e-5; every gradient leaf
  ``max|Δ| <= 1e-3 · max|g_ref|``, as in ``tests/test_torch_train.py``
  (reduced ``whisper-base``: 1e-2, for the reason above: the reference's
  float32 gradients lie 2.6e-3 of the largest element from a float64 run
  of the port, the port's 6.4e-4; elsewhere both lie within 6e-5);
- ``quantize_kv``: bit for bit, values and scales;
- the int8 attention arms on the same int8 cache: rtol 1e-5 / atol 1e-6
  (one layer of float32 products and a softmax).

The encoder-decoder: ``repro``'s cached prefill attends to the first S
encoder frames only (S the prompt length), so where S < ``encoder_len``
it leaves its own uncached forward.  The port attends to all frames on both
paths.  It is held to the reference's uncached forward at S < ``encoder_len``
and to the reference's cached path at S = ``encoder_len`` (reduced
``whisper-base``: 16, half of SEQ), and one test keeps the reference's gap
in view.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config.base import all_arch_ids as j_all_arch_ids
from repro.config.base import get_config as j_get_config
from repro.models import encdec as j_encdec
from repro.models import transformer as j_transformer
from repro.models.layers import attention as j_attention
from repro.models.model_api import build as j_build
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.config.base import all_arch_ids as t_all_arch_ids
from repro_torch.config.base import get_config as t_get_config
from repro_torch.models import encdec as t_encdec
from repro_torch.models import transformer as t_transformer
from repro_torch.models.convert import params_from_numpy, state_from_numpy
from repro_torch.models.layers import attention as t_attention
from repro_torch.models.model_api import build as t_build
from repro_torch.models.param import tree_leaves

from test_torch_train import without_links

CPU = "cpu"
BATCH, SEQ, DECODE = 2, 32, 3
HALF = SEQ // 2
ARCHS = j_all_arch_ids()
# Every family is differentiable, the Mamba layers through the state scan's
# ``autograd.Function`` (on the CPU its backward is the plain version).
GRAD_ARCHS = ARCHS
LOGIT_RTOL = 2e-4
ATOL_SHARE = {"encdec": 1e-3, "int8": 2e-3}   # of the largest |logit|; 2e-5 elsewhere
GRAD_TOL = {"encdec": 1e-2}       # of the largest |g|; 1e-3 elsewhere
SMOKE_BAND, INT8_BAND = (2e-2, 2e-3), (0.5, 0.25)
NOISY_LEAVES = ("bq", "bk", "bv", "bias", "scale")


def _reduced(get_config, arch):
    return dataclasses.replace(get_config(arch).reduced(), dtype="float32")


def _path_key(path):
    return "/".join(str(getattr(p, "key", p)) for p in path)


def _params(jm, seed=0):
    """The reference's init as numpy, with biases and norm parameters given
    values away from 0 and 1."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        name = _path_key(path).split("/")[-1]
        if name in NOISY_LEAVES:
            a = a + 0.05 * rng.standard_normal(a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, jm.init(jax.random.PRNGKey(seed)))


def _inputs(cfg, seed=1):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32),
           "targets": rng.integers(0, cfg.vocab_size, (BATCH, SEQ)).astype(np.int32)}
    out["targets"][rng.random((BATCH, SEQ)) < 0.15] = -1
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((BATCH, cfg.encoder_len, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((BATCH, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


def atol_share(cfg):
    key = "int8" if cfg.kv_cache_dtype == "int8" else cfg.family
    return ATOL_SHARE.get(key, 2e-5)


def assert_logits(cfg, ref, got, err_msg=""):
    ref = np.asarray(ref)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    atol = atol_share(cfg) * float(np.abs(ref).max())
    np.testing.assert_allclose(got, ref, rtol=LOGIT_RTOL, atol=atol, err_msg=err_msg)


def j_full_forward(jm, jparams, inputs):
    """The reference's uncached forward on ``inputs``."""
    cfg = jm.cfg
    if cfg.family == "encdec":
        enc_out = j_encdec.encode(jparams, jnp.asarray(inputs["frames"]), cfg)
        return j_encdec.forward(jparams, jnp.asarray(inputs["tokens"]), cfg=cfg, enc_out=enc_out)[0]
    patches = inputs.get("patches")
    return j_transformer.forward(
        jparams, jnp.asarray(inputs["tokens"]), cfg=cfg,
        prefix_embeds=None if patches is None else jnp.asarray(patches),
    )[0]


def t_full_forward(tm, tparams, inputs):
    cfg = tm.cfg
    if cfg.family == "encdec":
        enc_out = t_encdec.encode(tparams, torch.from_numpy(inputs["frames"]), cfg)
        return t_encdec.forward(tparams, torch.from_numpy(inputs["tokens"]), cfg=cfg, enc_out=enc_out)[0]
    patches = inputs.get("patches")
    return t_transformer.forward(
        tparams, torch.from_numpy(inputs["tokens"]), cfg=cfg,
        prefix_embeds=None if patches is None else torch.from_numpy(patches),
    )[0]


def serving_inputs(inputs, prompt):
    """The prompt's inputs without the targets: tokens cut to ``prompt``."""
    out = {k: v for k, v in inputs.items() if k != "targets"}
    out["tokens"] = inputs["tokens"][:, :prompt]
    return out


def j_cached(jm, jparams, inputs, prompt, steps=DECODE):
    """Reference prefill of ``prompt`` tokens, then ``steps`` decode steps
    fed the next true tokens: (logits per step, final state)."""
    state = jm.decode_state_init(BATCH, SEQ)
    logits, state = jax.jit(jm.prefill)(jparams, _j(serving_inputs(inputs, prompt)), state)
    out = [logits]
    step = jax.jit(jm.decode_step)
    for t in range(prompt, prompt + steps):
        logits, state = step(jparams, state, jnp.asarray(inputs["tokens"][:, t:t + 1]))
        out.append(logits)
    return out, state


def t_cached(tm, tparams, inputs, prompt, state=None, steps=DECODE):
    if state is None:
        state = tm.decode_state_init(BATCH, SEQ, device=CPU)
    logits, state = tm.prefill(tparams, _t(serving_inputs(inputs, prompt)), state)
    out = [logits]
    for t in range(prompt, prompt + steps):
        logits, state = tm.decode_step(tparams, state, torch.from_numpy(inputs["tokens"][:, t:t + 1]))
        out.append(logits)
    return out, state


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    name = request.param
    jm, tm = j_build(_reduced(j_get_config, name)), t_build(_reduced(t_get_config, name))
    jparams_np = _params(jm)
    tparams = params_from_numpy(jparams_np, device=CPU)
    return name, jm, tm, _j(jparams_np), tparams, _inputs(jm.cfg)


# --------------------------------------------------------------------- #
# The registry and the full configs
# --------------------------------------------------------------------- #


def test_registry_has_the_reference_ids_in_order():
    assert t_all_arch_ids() == j_all_arch_ids()
    assert len(t_all_arch_ids()) == 10


@pytest.mark.parametrize("name", ARCHS)
def test_full_config_specs_match_the_reference(name):
    """Specs alone: nothing is materialised."""
    jm, tm = j_build(j_get_config(name)), t_build(t_get_config(name))
    assert dataclasses.asdict(jm.cfg) == dataclasses.asdict(tm.cfg)
    assert tm.num_params() == jm.num_params()
    jleaves = jax.tree.leaves(
        jax.tree.map(lambda p: (p.shape, p.axes, p.init, p.scale), jm.specs(),
                     is_leaf=lambda x: hasattr(x, "axes")),
        is_leaf=lambda x: isinstance(x, tuple),
    )
    assert jleaves == [(p.shape, p.axes, p.init, p.scale) for p in tree_leaves(tm.specs())]


# --------------------------------------------------------------------- #
# Reduced configs: forward, prefill and decode
# --------------------------------------------------------------------- #


def test_decode_state_matches_the_reference(arch):
    name, jm, tm, _, _, _ = arch
    jstate = jax.tree.map(lambda a: (a.shape, str(a.dtype)), jm.decode_state_init(BATCH, SEQ))
    tstate = tm.decode_state_init(BATCH, SEQ, device=CPU)
    jflat = {_path_key(p): v for p, v in jax.tree_util.tree_flatten_with_path(
        jstate, is_leaf=lambda x: isinstance(x, tuple))[0]}
    tflat = {k: (tuple(v.shape), str(v.dtype).replace("torch.", "")) for k, v in flatten_with_paths(tstate)}
    assert jflat == tflat, name


def test_forward_matches_the_reference(arch):
    name, jm, tm, jparams, tparams, inputs = arch
    want = j_full_forward(jm, jparams, inputs)
    got = t_full_forward(tm, tparams, inputs)
    assert got.shape == (BATCH, SEQ, tm.cfg.padded_vocab)
    assert_logits(tm.cfg, want, got, name)


def test_prefill_and_decode_match_the_reference(arch):
    """The reference's own prefill and decode, the port's from the
    reference's initial decode state.  For ``whisper-base`` the prompt
    (HALF = 16) is as long as the reduced encoder, where the reference's
    cached path agrees with its uncached forward."""
    name, jm, tm, jparams, tparams, inputs = arch
    jlogits, jstate = j_cached(jm, jparams, inputs, HALF)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jm.decode_state_init(BATCH, SEQ)), device=CPU)
    tlogits, tstate = t_cached(tm, tparams, inputs, HALF, state=tstate)
    for step, (a, b) in enumerate(zip(jlogits, tlogits)):
        assert_logits(tm.cfg, a, b, f"{name} step {step}")
    assert int(jstate["pos"]) == int(tstate["pos"]) == HALF + DECODE
    assert_states(name, tm.cfg, jstate, tstate)


def assert_states(name, cfg, jstate, tstate):
    """Every leaf of the two decode states: int8 values at most one step
    apart, in at most 1 % of places; the rest at the logits' band."""
    for key, a in flatten_with_paths(jax.tree.map(np.asarray, jstate)):
        b = dict(flatten_with_paths(tstate))[key].numpy()
        assert a.dtype == b.dtype, (name, key)
        if a.dtype == np.int8:
            diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01, (name, key, diff.max(), (diff > 0).mean())
        elif key != "pos":
            np.testing.assert_allclose(b, a, rtol=LOGIT_RTOL, atol=atol_share(cfg) * float(np.abs(a).max()),
                                       err_msg=f"{name} {key}")


LONG = 1024   # two query chunks of 512, as a full config's 1024-token prompt
# The axes after the stack's that a block matrix reads: its fan-in.
INPUT_AXES = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1, "w_down": 1}


def _at_input_fan_in(tree):
    """The reference's init with every stacked block matrix rescaled from
    the fan-in of its stack axis (the layer count) to that of its inputs."""
    def leaf(path, a):
        key = _path_key(path)
        axes = INPUT_AXES.get(key.split("/")[-1])
        if axes is None or not key.startswith("blocks"):
            return a
        return a * np.float32(np.sqrt(a.shape[0] / np.prod(a.shape[1:1 + axes])))
    return jax.tree_util.tree_map_with_path(leaf, tree)


def test_int8_prompt_of_two_query_chunks_matches_the_reference():
    """The reduced qwen's int8 cache through a prompt of two query chunks
    and DECODE steps after it, against the reference's, at the bands of
    test_prefill_and_decode_match_the_reference.

    The weights are the reference's init at the fan-in of their inputs.  At
    the init itself (fan-in = the 2 layers) the random model amplifies last
    bits: over 1,024 positions two of layer 0's int8 keys sit one step
    apart (``x / scale`` within a rounding of a half on one side), and in
    layer 1 that has become 170 keys and values up to 12 steps apart and
    logits 7.5 % of the largest apart.  At the fan-in of the inputs the
    same prompt leaves one step in 16 of the 262,912 int8 values and 2.1e-4
    of the largest logit."""
    name = "qwen1.5-32b"
    jm, tm = j_build(_reduced(j_get_config, name)), t_build(_reduced(t_get_config, name))
    jparams_np = _at_input_fan_in(_params(jm))
    jparams, tparams = _j(jparams_np), params_from_numpy(jparams_np, device=CPU)
    tokens = np.random.default_rng(5).integers(0, jm.cfg.vocab_size, (BATCH, LONG + DECODE)).astype(np.int32)
    jstate = jm.decode_state_init(BATCH, LONG + DECODE)
    tstate = state_from_numpy(jax.tree.map(np.asarray, jstate), device=CPU)
    jlogits, jstate = jax.jit(jm.prefill)(jparams, {"tokens": jnp.asarray(tokens[:, :LONG])}, jstate)
    tlogits, tstate = tm.prefill(tparams, {"tokens": torch.from_numpy(tokens[:, :LONG])}, tstate)
    assert_logits(tm.cfg, jlogits, tlogits, f"{name} prefill of {LONG}")
    step = jax.jit(jm.decode_step)
    for t in range(LONG, LONG + DECODE):
        jlogits, jstate = step(jparams, jstate, jnp.asarray(tokens[:, t:t + 1]))
        tlogits, tstate = tm.decode_step(tparams, tstate, torch.from_numpy(tokens[:, t:t + 1]))
        assert_logits(tm.cfg, jlogits, tlogits, f"{name} step {t}")
    assert_states(name, tm.cfg, jstate, tstate)


def test_decode_matches_full_forward(arch):
    """Causality and cache correctness, the port alone, at the bands of
    ``tests/test_arch_smoke.py``: prefill on the first half, then decode
    three tokens against the uncached forward."""
    name, _, tm, _, tparams, inputs = arch
    full = t_full_forward(tm, tparams, inputs)
    rtol, atol = INT8_BAND if tm.cfg.kv_cache_dtype == "int8" else SMOKE_BAND
    logits, state = t_cached(tm, tparams, inputs, HALF)
    np.testing.assert_allclose(logits[0].numpy(), full[:, :HALF].numpy(), rtol=rtol, atol=atol)
    for step, got in enumerate(logits[1:]):
        t = HALF + step
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, t].numpy(), rtol=rtol, atol=atol,
                                   err_msg=f"{name} step {t}")
    assert int(state["pos"]) == HALF + DECODE


# --------------------------------------------------------------------- #
# Training: the loss and every gradient leaf
# --------------------------------------------------------------------- #


def _norm_err(ref, got):
    return float(np.abs(ref - got).max() / max(np.abs(ref).max(), 1e-30)) if ref.size else 0.0


@pytest.mark.parametrize("name", GRAD_ARCHS)
def test_loss_and_gradients_match_the_reference(name):
    jm, tm = j_build(_reduced(j_get_config, name)), t_build(_reduced(t_get_config, name))
    jparams_np = _params(jm)
    batch = _inputs(jm.cfg)
    jdk = jm.dyskew_init()

    def jloss(p):
        return jm.loss(p, _j(batch), dyskew=jdk)
    (jl, jaux), jgrads = jax.value_and_grad(jloss, has_aux=True)(_j(jparams_np))

    tdk = None if jdk is None else state_from_numpy(without_links(jax.tree.map(np.asarray, jdk)), device=CPU)
    flat = flatten_with_paths(params_from_numpy(jparams_np, device=CPU))
    live = {k: v.requires_grad_(True) for k, v in flat}
    tree = {}
    for key, v in live.items():
        node = tree
        *parents, last = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = v
    tl, taux = tm.loss(tree, _t(batch), dyskew=tdk)
    tgrads = torch.autograd.grad(tl, list(live.values()))
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    jflat = dict(flatten_with_paths(jax.tree.map(np.asarray, jgrads)))
    assert sorted(jflat) == sorted(live)
    for key, g in zip(live, tgrads):
        err = _norm_err(jflat[key], g.numpy())
        assert err <= GRAD_TOL.get(jm.cfg.family, 1e-3), (name, key, err)
    assert sorted(jaux["metrics"]) == sorted(taux["metrics"])


# --------------------------------------------------------------------- #
# The int8 KV cache
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_is_bit_equal(dtype):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((4, 64, 8, 128)) * rng.uniform(0.01, 30, (4, 64, 8, 1))).astype(np.float32)
    x[0, 0, 0] = 0.0                       # a zero vector: the 1e-8 floor
    x[1, 1, 1, :4] = [127.0, -127.0, 63.5, -0.5]   # halves: to even
    jx = jnp.asarray(x).astype(jnp.dtype(dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jq, js = j_attention.quantize_kv(jx)
    tq, ts = t_attention.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def _int8_cache(rng, B, S, K, hd):
    k = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, S, K, hd)).astype(np.float32)
    kq, ks = j_attention.quantize_kv(jnp.asarray(k))
    vq, vs = j_attention.quantize_kv(jnp.asarray(v))
    return [np.array(a) for a in (kq, vq, ks, vs)]


def test_int8_attention_arms_match_the_reference():
    rng = np.random.default_rng(3)
    B, S, K, G, hd = 2, 40, 2, 2, 16
    kq, vq, ks, vs = _int8_cache(rng, B, S, K, hd)
    q = rng.standard_normal((B, 24, K, G, hd)).astype(np.float32)
    want = j_attention.chunked_attention(
        jnp.asarray(q), jnp.asarray(kq), jnp.asarray(vq), causal=True, q_offset=8, kv_len=32,
        q_chunk=8, kv_chunk=8, k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = t_attention.chunked_attention(
        torch.from_numpy(q), torch.from_numpy(kq), torch.from_numpy(vq), causal=True, q_offset=8,
        kv_len=32, q_chunk=8, k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    q1 = q[:, :1]
    want = j_attention.decode_attention(jnp.asarray(q1), jnp.asarray(kq), jnp.asarray(vq), 29,
                                        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    got = t_attention.decode_attention(torch.from_numpy(q1), torch.from_numpy(kq), torch.from_numpy(vq), 29,
                                       k_scale=torch.from_numpy(ks), v_scale=torch.from_numpy(vs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def test_int8_cache_is_written_in_place():
    cfg = _reduced(t_get_config, "qwen1.5-32b")
    tm = t_build(cfg)
    state = tm.decode_state_init(BATCH, SEQ, device=CPU)
    entry = state["kv_l0"]
    assert entry["k"].dtype == torch.int8 and entry["k_scale"].dtype == torch.float32
    before = {k: v for k, v in entry.items()}
    params = tm.init(torch.Generator().manual_seed(0), device=CPU)
    _, new = tm.prefill(params, {"tokens": torch.from_numpy(_inputs(cfg)["tokens"][:, :HALF])}, state)
    assert all(new["kv_l0"][k] is before[k] for k in before)
    assert int(entry["k"][:, :, :HALF].abs().max()) == 127 and float(entry["k_scale"][:, :, HALF:].abs().max()) == 0.0
    int8_bytes = sum(v.numel() * v.element_size() for v in entry.values())
    model = t_build(dataclasses.replace(cfg, kv_cache_dtype="model")).decode_state_init(BATCH, SEQ, device=CPU)
    model_bytes = sum(v.numel() * v.element_size() for v in model["kv_l0"].values())
    # float32 here: int8 values and a float32 scale per head_dim 16 vector.
    assert int8_bytes / model_bytes == (16 + 4) / (16 * 4)


# --------------------------------------------------------------------- #
# The encoder-decoder's cross-attention prefill
# --------------------------------------------------------------------- #


@pytest.fixture(scope="module")
def whisper():
    jm, tm = j_build(_reduced(j_get_config, "whisper-base")), t_build(_reduced(t_get_config, "whisper-base"))
    jparams_np = _params(jm)
    return jm, tm, _j(jparams_np), params_from_numpy(jparams_np, device=CPU), _inputs(jm.cfg)


SHORT = 8


def test_encdec_short_prompt_holds_to_the_uncached_forward(whisper):
    """S = 8 < encoder_len = 16: the port's cached prefill and decode
    against the reference's uncached forward over the same tokens."""
    jm, tm, jparams, tparams, inputs = whisper
    assert SHORT < tm.cfg.encoder_len
    want = j_full_forward(jm, jparams, dict(inputs, tokens=inputs["tokens"][:, :SHORT + DECODE]))
    got, state = t_cached(tm, tparams, inputs, SHORT)
    assert_logits(tm.cfg, want[:, :SHORT], got[0], "prefill")
    for step, logits in enumerate(got[1:]):
        assert_logits(tm.cfg, want[:, SHORT + step], logits[:, 0], f"step {SHORT + step}")
    assert int(state["pos"]) == SHORT + DECODE


def test_encdec_full_length_prompt_holds_to_the_cached_path(whisper):
    """S = encoder_len: the reference's cached prefill and decode agree with
    its uncached forward, and the port is held to them."""
    jm, tm, jparams, tparams, inputs = whisper
    T = tm.cfg.encoder_len
    want, _ = j_cached(jm, jparams, inputs, T)
    got, _ = t_cached(tm, tparams, inputs, T)
    for step, (a, b) in enumerate(zip(want, got)):
        assert_logits(tm.cfg, a, b, f"step {step}")


def test_reference_cached_prefill_leaves_its_uncached_forward(whisper):
    """The finding on the reference side, kept in view: at S < encoder_len
    ``repro``'s cached prefill attends to S frames and leaves its own
    uncached forward by far more than any band (22.92 in logits of
    magnitude 31.80 at S = 8, seed 0, before the norm parameters' noise);
    the port's cached prefill does not."""
    jm, tm, jparams, tparams, inputs = whisper
    full = np.asarray(j_full_forward(jm, jparams, dict(inputs, tokens=inputs["tokens"][:, :SHORT + 1])))
    ref_cached, _ = j_cached(jm, jparams, inputs, SHORT, steps=1)
    port_cached, _ = t_cached(tm, tparams, inputs, SHORT, steps=1)
    ref_gap = float(np.abs(np.asarray(ref_cached[0]) - full[:, :SHORT]).max())
    port_gap = float(np.abs(port_cached[0].numpy() - full[:, :SHORT]).max())
    scale = float(np.abs(full).max())
    assert ref_gap > 0.1 * scale, (ref_gap, scale)
    assert port_gap < (atol_share(tm.cfg) + LOGIT_RTOL) * scale, (port_gap, scale)


# --------------------------------------------------------------------- #
# The VLM prefix
# --------------------------------------------------------------------- #


def test_prompt_shorter_than_the_patches_raises():
    cfg = _reduced(t_get_config, "pixtral-12b")
    tm = t_build(cfg)
    params = tm.init(torch.Generator().manual_seed(0), device=CPU)
    inputs = _inputs(cfg)
    short = {"tokens": torch.from_numpy(inputs["tokens"][:, :cfg.num_patches - 1]),
             "patches": torch.from_numpy(inputs["patches"])}
    with pytest.raises(ValueError, match="shorter than its 4 prefix embeddings"):
        tm.prefill(params, short, tm.decode_state_init(BATCH, SEQ, device=CPU))
    with pytest.raises(ValueError, match="prefix"):
        t_transformer.forward(params, short["tokens"], cfg=cfg, prefix_embeds=short["patches"])


def test_prefix_takes_the_first_positions():
    """Positions below P see the patches (changing a token there changes
    nothing), positions from P on see the tokens."""
    cfg = _reduced(t_get_config, "pixtral-12b")
    tm = t_build(cfg)
    params = tm.init(torch.Generator().manual_seed(0), device=CPU)
    inputs = _inputs(cfg)
    toks, patches = torch.from_numpy(inputs["tokens"]), torch.from_numpy(inputs["patches"])
    base, _ = t_transformer.forward(params, toks, cfg=cfg, prefix_embeds=patches)
    under = toks.clone()
    under[:, :cfg.num_patches] = (under[:, :cfg.num_patches] + 1) % cfg.vocab_size
    same, _ = t_transformer.forward(params, under, cfg=cfg, prefix_embeds=patches)
    assert torch.equal(base, same)
    over = toks.clone()
    over[:, cfg.num_patches] = (over[:, cfg.num_patches] + 1) % cfg.vocab_size
    moved, _ = t_transformer.forward(params, over, cfg=cfg, prefix_embeds=patches)
    assert not torch.equal(base[:, cfg.num_patches:], moved[:, cfg.num_patches:])
