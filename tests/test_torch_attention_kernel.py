"""The attention kernel (``repro_torch.kernels.attention``) and the path
that chooses it.

On the CPU: the plain version (``attention/ref.py``) against
``chunked_attention``, which the port ran before and still runs for every
call the kernel cannot take, and against the reference package's
``chunked_attention`` in float32 at the card tests' shapes and inputs
(their batch cut); the choice between the two, by the kernel's own limits
(gradient, dtype, head width) and the device: a CPU call, a call that needs
a gradient, an int8 cache, a float32 call and a head width the kernel is
not built for take ``chunked_attention`` and launch nothing; on ``meta`` an
eligible call is counted as the kernel's record.  On the card (``-m h100``,
skipped elsewhere): the kernel against the plain version in bf16, element
by element within ``ref.band``, at granite's served prefill, at head width
128 over four query heads a kv head, and at ragged lengths; two runs the
same bits; 24 launches a granite prefill, none in a decode step or a train
step.  The reference package does not run on the card, so the kernel is
held to it through the plain version on the same inputs: within
``ref.band`` of the plain version there, and the plain version within
``ref.band(rounding=1)`` of the reference's float32 output here.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.layers.attention import chunked_attention as j_chunked_attention
from repro_torch import kernels
from repro_torch.config.base import get_config
from repro_torch.kernels.attention import ops as attention_ops
from repro_torch.kernels.attention import ref
from repro_torch.kernels.attention.ref import attention_ref
from repro_torch.models.layers import attention as attn_layer
from repro_torch.models.layers.attention import chunked_attention, quantize_kv
from repro_torch.roofline.op_cost import OpCounter

F32_RTOL, F32_ATOL = 1e-5, 1e-6


def _inputs(B, Sq, H, K, hd, S_cache, dtype, seed, device="cpu"):
    """q, k and v drawn a batch element at a time, so that the first b
    elements of a batch are the whole of a batch of b."""
    parts = []
    for b in range(B):
        gen = torch.Generator(device="cpu").manual_seed(seed * 1_000_003 + b)
        parts.append((torch.randn((1, Sq, H, hd), generator=gen), torch.randn((1, S_cache, K, hd), generator=gen),
                      torch.randn((1, S_cache, K, hd), generator=gen)))
    return tuple(torch.cat(t).to(dtype=dtype, device=device) for t in zip(*parts))


def _chunked(q, k, v, *, causal, q_offset=0, kv_len=None, q_chunk=512):
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    out = chunked_attention(q.reshape(B, Sq, K, H // K, hd), k, v, causal=causal, q_offset=q_offset,
                            kv_len=kv_len, q_chunk=q_chunk)
    return out.reshape(B, Sq, H, hd)


def _chunked_band(q, k, v, want, *, causal, q_offset, kv_len):
    """How far, element by element, ``chunked_attention`` may lie from the
    plain version ``want`` in a 16-bit type: ``ref.band`` for the two
    roundings of the probabilities and outputs, and chunked_attention's own
    of the scaled queries (u of each element, which moves a score by at most
    u times the scale times the sum of |q_d k_d|) and of the scores (u |s|).
    A score moves by at most d = u (1 + 2u) (that sum + |s|), so a
    probability by a factor within exp(±2D), D the largest d of the row's
    kept keys, and an output by (1 + u)^2 (exp(2D) - 1) p @ |v| more."""
    u = ref.UNIT[q.dtype]
    B, Sq, H, hd = q.shape
    d = u * (1 + 2 * u) * (ref.scores(q.abs(), k.abs(), kv_len) + ref.scores(q, k, kv_len).abs())
    if causal:
        q_pos = q_offset + torch.arange(Sq)
        d = d.masked_fill(torch.arange(kv_len)[None, :] > q_pos[:, None], 0.0)
    D = d.amax(-1).permute(0, 3, 1, 2).reshape(B, Sq, H, 1)     # the row's, per query head
    w = ref.weighted(ref.probabilities(q, k, causal=causal, q_offset=q_offset, kv_len=kv_len), v.abs().float())
    return (ref.band(q, k, v, want, causal=causal, q_offset=q_offset, kv_len=kv_len)
            + (1 + u) ** 2 * torch.expm1(2 * D) * w)


def _within(got, want, band):
    """(every element of got within band of want, the largest gap's share
    of its band)."""
    share = (got.float() - want.float()).abs() / band
    return bool((share <= 1.0).all()), float(share.max())


# --------------------------------------------------------------------- #
# The plain version against chunked_attention, on the CPU
# --------------------------------------------------------------------- #

#: (Sq, q_offset, S_cache, kv_len): a prompt at the cache's start, and one
#: after earlier positions; both with kv_len below the cache's length and Sq
#: no multiple of the kernel's 128-query tile.
LENGTHS = {"offset_0": (133, 0, 150, 133), "offset_37": (70, 37, 120, 107)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("G", [1, 2, 4, 12])
@pytest.mark.parametrize("hd", [64, 128])
def test_plain_version_matches_chunked_attention(hd, G, causal, lengths, dtype):
    """float32: the same function to float32's rounding (the plain version
    scales the scores, chunked_attention the queries; one takes the softmax
    over the kept keys, the other over the chunk's keys with the rest at
    -1e30).  bf16: element by element within ``_chunked_band``, which adds
    chunked_attention's rounding of its scores to ``ref.band``."""
    Sq, q_offset, S_cache, kv_len = LENGTHS[lengths]
    B, K = 2, 2
    q, k, v = _inputs(B, Sq, K * G, K, hd, S_cache, dtype, seed=hd * 100 + G)
    got = attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    want = _chunked(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len, q_chunk=64)
    assert got.shape == (B, Sq, K * G, hd) and got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        ok, share = _within(want, got, _chunked_band(q, k, v, got, causal=causal, q_offset=q_offset, kv_len=kv_len))
        assert ok, share


def test_plain_version_keeps_exactly_the_kept_keys():
    """Keys past kv_len and above the diagonal change nothing: the plain
    version of a cache with garbage there equals the one without."""
    q, k, v = _inputs(1, 9, 4, 2, 64, 20, torch.float32, seed=3)
    k2, v2 = k.clone(), v.clone()
    k2[:, 13:] = 1e4
    v2[:, 13:] = float("nan")
    a = attention_ref(q, k, v, causal=True, q_offset=4, kv_len=13)
    b = attention_ref(q, k2, v2, causal=True, q_offset=4, kv_len=13)
    assert torch.equal(a, b)
    # Query 0 sits at position 4: keys 0..4, their softmax alone.
    s = (q[0, 0, 0] @ k[0, :5, 0].T) * 64 ** -0.5
    torch.testing.assert_close(a[0, 0, 0], torch.softmax(s, -1) @ v[0, :5, 0], rtol=1e-5, atol=1e-6)


# --------------------------------------------------------------------- #
# Which path a call takes
# --------------------------------------------------------------------- #


@pytest.fixture
def chunked_calls(monkeypatch):
    """Counts the calls of ``chunked_attention`` made by the layer."""
    calls = []
    inner = attn_layer.chunked_attention

    def counted(*args, **kw):
        calls.append(args[0].device.type)
        return inner(*args, **kw)

    monkeypatch.setattr(attn_layer, "chunked_attention", counted)
    return calls


def _layer_call(device, *, dtype=torch.bfloat16, hd=64, grad=False, int8=False):
    """attention_apply's core as a cached prefill of 5 tokens calls it:
    (q, k and v of the cache, the scales of an int8 one)."""
    q, k, v = _inputs(1, 5, 4, 2, hd, 8, dtype, seed=7, device=device)
    k_scale = v_scale = None
    if int8:
        (k, k_scale), (v, v_scale) = quantize_kv(k), quantize_kv(v)
    if grad:
        q.requires_grad_(True)
    return q, k, v, k_scale, v_scale


#: name: (device, options, the path): "kernel" where the call is the
#: kernel's (counted as its record on meta), else chunked_attention's.
DISPATCH = {
    "cpu_bf16": ("cpu", {}, "chunked"),
    "cpu_needs_grad": ("cpu", {"grad": True}, "chunked"),
    "cpu_int8_cache": ("cpu", {"int8": True}, "chunked"),
    "meta_bf16": ("meta", {}, "kernel"),
    "meta_fp16": ("meta", {"dtype": torch.float16}, "kernel"),
    "meta_hd128": ("meta", {"hd": 128}, "kernel"),
    "meta_needs_grad": ("meta", {"grad": True}, "chunked"),
    "meta_int8_cache": ("meta", {"int8": True}, "chunked"),
    "meta_f32": ("meta", {"dtype": torch.float32}, "chunked"),
    "meta_hd96": ("meta", {"hd": 96}, "chunked"),
}


@pytest.mark.parametrize("name", sorted(DISPATCH))
def test_the_path_follows_the_kernels_limits_and_the_device(name, chunked_calls):
    """A CPU call, one that needs a gradient, an int8 cache, a float32 call
    and a width the kernel is not built for take chunked_attention, counted
    op by op; an eligible call off the CPU is the kernel's, and on ``meta``
    (no kernel can run) the counter takes the kernel's record with
    chunked_attention standing in.  Nothing is launched here."""
    device, opts, path = DISPATCH[name]
    q, k, v, k_scale, v_scale = _layer_call(device, **opts)
    kernels.reset_launch_counts()
    with OpCounter() as counter:
        out = attn_layer._attend(q, k, v, causal=True, q_offset=0, kv_len=5, k_scale=k_scale, v_scale=v_scale)
    assert out.shape == q.shape and out.device.type == device
    assert kernels.launch_counts()["attention"] == 0
    assert chunked_calls == [device]
    records = counter.result()["kernels"]
    if path == "kernel":
        assert records == {"attention": {"calls": 1, "flops": 4 * 4 * q.shape[-1] * (1 + 2 + 3 + 4 + 5),
                                         "bytes": records["attention"]["bytes"]}}
        assert counter.result()["dot_flops"] == 0
    else:
        assert "attention" not in records and counter.result()["dot_flops"] > 0
    if opts.get("grad"):
        assert out.requires_grad


def test_takes_names_the_kernels_limits():
    q, k, v = _inputs(1, 3, 2, 1, 64, 3, torch.bfloat16, seed=1)
    assert attention_ops.takes(q, k, v)
    assert not attention_ops.takes(q.float(), k.float(), v.float())
    assert not attention_ops.takes(q, quantize_kv(k)[0], quantize_kv(v)[0])
    assert not attention_ops.takes(q.requires_grad_(True), k, v)
    with torch.no_grad():
        assert attention_ops.takes(q, k, v)


def test_a_cpu_call_through_the_layer_is_chunked_attention(chunked_calls):
    """A served prefill's attention layer on the CPU, in bf16 at head width
    64: chunked_attention, the bits it always gave."""
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), head_dim=64)
    gen = torch.Generator().manual_seed(0)
    from repro_torch.models.param import tree_materialize

    p = tree_materialize(attn_layer.attention_specs(cfg), gen, dtype_override=torch.bfloat16, device="cpu")
    x = torch.randn((2, 6, cfg.d_model), generator=gen).bfloat16()
    cache = {"k": torch.zeros((2, 8, cfg.num_kv_heads, 64), dtype=torch.bfloat16),
             "v": torch.zeros((2, 8, cfg.num_kv_heads, 64), dtype=torch.bfloat16)}
    kernels.reset_launch_counts()
    y, _ = attn_layer.attention_apply(p, x, cfg=cfg, positions=torch.arange(6), cache=cache, cache_index=0)
    assert chunked_calls == ["cpu"] and kernels.launch_counts()["attention"] == 0
    assert y.shape == x.shape and bool(torch.isfinite(y.float()).all())


def test_the_kernel_refuses_cpu_tensors():
    q, k, v = _inputs(1, 3, 2, 1, 64, 3, torch.bfloat16, seed=1)
    from repro_torch.kernels.attention.kernel import attention_fwd

    with pytest.raises(ValueError, match="GPU"):
        attention_fwd(q, k, v, causal=True)


# --------------------------------------------------------------------- #
# On the card
# --------------------------------------------------------------------- #

#: name: (B, Sq, H, K, hd, S_cache, q_offset, kv_len, causal)
CARD = {
    # granite-moe-1b-a400m's served prefill: 64 prompts of 1,024 tokens into
    # a cache of 1,088 (1,024 + 64 decode steps).
    "granite_prefill": (64, 1024, 16, 8, 64, 1088, 0, 1024, True),
    # Head width 128, four query heads a kv head (pixtral-12b's, qwen1.5's).
    "hd128_G4": (4, 1024, 32, 8, 128, 1024, 0, 1024, True),
    # Ragged: Sq and kv_len off the tiles, after 37 earlier positions.
    "ragged_kv_len": (3, 301, 12, 4, 64, 400, 37, 338, True),
    # A cross-attention prefill: 224 queries against 1,500 keys, no mask.
    "cross_hd64": (2, 224, 8, 8, 64, 1500, 0, 1500, False),
}


#: The seed of every card case's inputs.
CARD_SEED = 11
#: The card cases the reference package is held at here, each cut to its
#: first batch elements for the CPU's time (the card's inputs, as far as
#: they go).
REFERENCE_CUT = {"granite_prefill": 1, "hd128_G4": 1, "ragged_kv_len": 3}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", sorted(REFERENCE_CUT))
def test_plain_version_matches_the_reference_package(name, dtype):
    """The reference's ``chunked_attention`` in float32 on a card case's
    inputs.  float32: the plain version in float32 within float32's
    rounding.  bf16: the plain version on the bf16 inputs within
    ``ref.band(rounding=1)`` of the reference's float32 output on the same
    inputs, since only the plain version rounds.  With the card's
    ``ref.band`` of the kernel from the plain version, the kernel lies
    within the two bands' sum of the reference there."""
    _, Sq, H, K, hd, S_cache, q_offset, kv_len, causal = CARD[name]
    q, k, v = _inputs(REFERENCE_CUT[name], Sq, H, K, hd, S_cache, dtype, seed=CARD_SEED)
    B = q.shape[0]
    got = attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)

    def j(t):
        return jnp.asarray(t.float().numpy())

    want = j_chunked_attention(j(q).reshape(B, Sq, K, H // K, hd), j(k), j(v), causal=causal,
                               q_offset=q_offset, kv_len=kv_len)
    want = torch.from_numpy(np.array(want)).reshape(B, Sq, H, hd)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=F32_RTOL, atol=F32_ATOL)
    else:
        band = ref.band(q, k, v, got, causal=causal, q_offset=q_offset, kv_len=kv_len, rounding=1)
        ok, share = _within(want, got, band)
        assert ok, share


#: A kernel that is wrong by one 64-key tile, made from the plain
#: version's probabilities: the tile dropped, or weighted twice.
FAULTS = {"dropped_tile": 0.0, "tile_weighted_twice": 2.0}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_the_band_catches_a_wrong_key_tile(fault):
    """At granite's per-head shape (one prompt of 1,024), an output whose
    rows past key 576 weight keys 512..575 by ``FAULTS[fault]`` (and
    renormalise) lies outside ``ref.band`` of the plain version, and the
    plain version's own bf16 output inside it."""
    _, Sq, H, K, hd, S_cache, q_offset, kv_len, causal = CARD["granite_prefill"]
    q, k, v = _inputs(1, Sq, H, K, hd, S_cache, torch.bfloat16, seed=CARD_SEED)
    plain = attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    band = ref.band(q, k, v, plain, causal=causal, q_offset=q_offset, kv_len=kv_len)
    p = ref.probabilities(q, k, causal=causal, q_offset=q_offset, kv_len=kv_len)
    p[..., 576:, 512:576] *= FAULTS[fault]
    p = p / p.sum(-1, keepdim=True)
    wrong = ref.weighted(p.to(q.dtype).float(), v).to(q.dtype)
    assert _within(plain, plain, band)[0]
    ok, share = _within(wrong, plain, band)
    assert not ok and share > 2.0, share


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this machine: the test runs on the H100")
    return torch.device("cuda", 0)


@pytest.mark.h100
@pytest.mark.parametrize("name", sorted(CARD))
def test_the_kernel_against_the_plain_version(name, cuda_device):
    """bf16.  Element by element within ``ref.band`` of the plain version
    (the two round their probabilities and outputs at different points),
    which ``test_plain_version_matches_the_reference_package`` holds to the
    reference package on the same inputs.  Two runs give the same bits, the
    second with NaN and inf in the cache past kv_len, which
    chunked_attention would read (its masked probabilities of 0 times inf)
    and the kernel does not."""
    from repro_torch.kernels.attention.kernel import attention_fwd

    B, Sq, H, K, hd, S_cache, q_offset, kv_len, causal = CARD[name]
    q, k, v = _inputs(B, Sq, H, K, hd, S_cache, torch.bfloat16, seed=CARD_SEED, device=cuda_device)
    kernels.reset_launch_counts()
    got = attention_fwd(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    # The cache past kv_len may hold anything (what a later step would
    # overwrite): the kernel never reads it.
    k_junk, v_junk = k.clone(), v.clone()
    k_junk[:, kv_len:] = float("nan")
    v_junk[:, kv_len:] = float("inf")
    again = attention_fwd(q, k_junk, v_junk, causal=causal, q_offset=q_offset, kv_len=kv_len)
    del k_junk, v_junk
    torch.cuda.synchronize()
    assert kernels.launch_counts()["attention"] == 2
    assert got.shape == (B, Sq, H, hd) and got.is_contiguous() and bool(torch.isfinite(got.float()).all())
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
    plain = attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    ok, share = _within(got, plain, ref.band(q, k, v, plain, causal=causal, q_offset=q_offset, kv_len=kv_len))
    assert ok, (name, share)


@pytest.mark.h100
def test_a_granite_prefill_launches_the_kernel_once_a_layer(cuda_device):
    """granite-moe-1b-a400m at its published widths and depth: a prefill's
    24 attention layers launch the kernel 24 times; a decode step and a
    train step's forward and backward launch it none."""
    from repro_torch.models.model_api import build
    from repro_torch.train.step import make_prefill_step

    cfg = get_config("granite-moe-1b-a400m")
    model = build(cfg)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    params = model.init(gen, device=cuda_device)
    tokens = torch.randint(0, cfg.vocab_size, (2, 256), generator=gen, device=cuda_device, dtype=torch.int32)
    state = model.decode_state_init(2, 260, device=cuda_device)
    kernels.reset_launch_counts()
    logits, state = make_prefill_step(model)(params, state, {"tokens": tokens})
    torch.cuda.synchronize()
    assert kernels.launch_counts()["attention"] == cfg.num_layers == 24
    kernels.reset_launch_counts()
    model.decode_step(params, state, torch.argmax(logits, dim=-1).to(torch.int32))
    torch.cuda.synchronize()
    assert kernels.launch_counts()["attention"] == 0
    del state, logits
    loss, _ = model.loss(_requiring_grad(params), {"tokens": tokens[:, :128], "targets": tokens[:, 1:129]})
    loss.backward()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["attention"] == 0


def _requiring_grad(tree):
    if isinstance(tree, dict):
        return {k: _requiring_grad(v) for k, v in tree.items()}
    if torch.is_tensor(tree) and tree.is_floating_point():
        return tree.detach().requires_grad_(True)
    return tree
