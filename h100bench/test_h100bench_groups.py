"""Mamba-2's B/C group count: the harness takes it from the configuration
file (``mamba.n_groups``, the published ``ngroups``), 1 where the file has
none, as in the published default.

On the CPU: the layout, the weights' count and ``check_layout`` at each
group count (every file and stand-in keeps the layout it had before the key
was read), and the reference's state-space path and gated norm at one and
two groups.  On
the card (marked ``h100``, skipped elsewhere): the reference alone at
mamba2-1.3b's published widths, sized as the ``batch`` and ``text``
traffic's cells, with its memory, seconds and largest logit gap printed:

    PYTHONPATH=src python -m pytest -q -s -m h100 h100bench/test_h100bench_groups.py
"""

from __future__ import annotations

import json
import math
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from h100bench.conftest import INIT, OPTIMIZER, REPO, TINY_CONFIGS
from h100bench.lib import roofline, weights
from h100bench.reference.decoder import Decoder, ssd
from h100bench.reference.precision import Precision

GRANITE = json.loads((REPO / "h100bench/configs/granite-moe-1b-a400m.json").read_text())
#: mamba2-1.3b as published (hf:state-spaces/mamba2-1.3b, arXiv:2405.21060):
#: 48 layers, d_model 2,048, expand 2, head_dim 64 (64 heads), d_state 128,
#: conv 4, one B/C group, chunk 256, vocabulary 50,277, head tied.  A
#: configuration file of this model under ``configs/`` must hold the same
#: numbers (``test_a_mamba2_1_3b_file_holds_the_published_widths``).
MAMBA2_1_3B = {"name": "mamba2-1.3b", "family": "ssm", "num_layers": 48, "d_model": 2048, "num_heads": 0,
               "num_kv_heads": 0, "d_ff": 0, "vocab_size": 50277, "rope_style": "none", "norm": "rmsnorm",
               "tie_embeddings": True, "dtype": "bfloat16", "remat": True,
               "mamba": {"d_state": 128, "head_dim": 64, "expand": 2, "conv_width": 4, "chunk": 256,
                         "n_groups": 1}}
BC = ("w_B", "w_C", "conv_B", "conv_C")


def with_groups(model, g):
    """``model`` with ``mamba.n_groups`` set to ``g``, or taken out (None)."""
    mamba = {k: v for k, v in model["mamba"].items() if k != "n_groups"}
    return dict(model, mamba=mamba if g is None else dict(mamba, n_groups=g))


def tiny_mamba(g):
    """A 32-wide Mamba-2 of 4 heads (64 inner) and 2 layers, in float32."""
    base = {"name": "tiny-mamba", "family": "ssm", "num_layers": 2, "d_model": 32, "num_heads": 0,
            "num_kv_heads": 0, "d_ff": 0, "vocab_size": 64, "rope_style": "none", "norm": "rmsnorm",
            "tie_embeddings": True, "dtype": "float32", "remat": True,
            "mamba": {"d_state": 8, "head_dim": 16, "expand": 2, "conv_width": 4, "chunk": 4}}
    return with_groups(base, g)


#: case -> (model, what it must give).  ``dims``, ``weights`` and ``active``
#: of the granite file and the tiny-ssm stand-in are what the harness gave
#: before it read ``n_groups``; ``groups`` is the B/C group count, None
#: without a Mamba layer; ``other`` a group count whose program tree
#: ``check_layout`` must refuse; ``raises`` a message the layout must raise.
#: Without the key a file gets 1 group (``mamba2-1.3b-no-key``); 8 groups is
#: the layout the port derives today for 64 heads.
LAYOUT_CASES = {
    "granite-file": (GRANITE["model"], {
        "dims": {"d": 1024, "L": 24, "V": 49155, "Vp": 49280, "H": 16, "K": 8, "hd": 64, "E": 32, "k": 8,
                 "f": 512},
        "weights": 1334756352, "active": 428736512, "groups": None}),
    "tiny-ssm-stand-in": (TINY_CONFIGS["tiny-ssm"]["model"], {
        "dims": {"d": 64, "L": 2, "V": 256, "Vp": 256, "di": 128, "nh": 8, "P": 16, "N": 16, "g": 1, "w": 4,
                 "chunk": 16},
        "weights": 72432, "active": 70656, "groups": 1, "other": 2}),
    "tiny-1-group": (tiny_mamba(1), {"groups": 1, "other": 2}),
    "tiny-2-groups": (tiny_mamba(2), {"groups": 2, "other": 1}),
    "tiny-3-groups": (tiny_mamba(3), {"raises": "does not divide the 4 heads"}),
    "tiny-0-groups": (tiny_mamba(0), {"raises": "does not divide the 4 heads"}),
    "mamba2-1.3b": (MAMBA2_1_3B, {"weights": 1343581184, "active": 1342439424, "groups": 1, "other": 8}),
    "mamba2-1.3b-no-key": (with_groups(MAMBA2_1_3B, None), {
        "weights": 1343581184, "active": 1342439424, "groups": 1, "other": 8}),
    "mamba2-1.3b-8-groups": (with_groups(MAMBA2_1_3B, 8), {
        "weights": 1520086016, "active": 1518600192, "groups": 8, "other": 1}),
}


def meta_tree(model):
    return weights.nest({p: torch.empty(shape, device="meta")
                         for p, (shape, _, _) in weights.layout(model, INIT).items()})


@pytest.mark.parametrize("case", list(LAYOUT_CASES))
def test_the_layout_follows_the_group_count(case):
    model, want = LAYOUT_CASES[case]
    if "raises" in want:
        with pytest.raises(ValueError, match=want["raises"]):
            weights.dims(model)
        return
    z = weights.dims(model)
    lay = weights.layout(model, INIT)
    if "dims" in want:
        assert z == want["dims"]
    if "weights" in want:
        assert sum(math.prod(shape) for shape, _, _ in lay.values()) == want["weights"]
        assert roofline.n_active_params(model) == want["active"]
    g = want["groups"]
    if g is None:
        assert not any(p.endswith(BC) for p in lay)
        return
    L, d, w, n = z["L"], z["d"], z["w"], z["N"]
    assert z["g"] == g
    for leaf in BC:
        wide = w if leaf.startswith("conv") else d
        assert lay[f"blocks/l0/mamba/{leaf}"][0] == (L, wide, g, n)
    ours = meta_tree(model)
    weights.check_layout(ours, meta_tree(model))
    with pytest.raises(ValueError, match="shapes differ at.*w_B"):
        weights.check_layout(ours, meta_tree(with_groups(model, want["other"])))


def test_a_mamba2_1_3b_file_holds_the_published_widths():
    """Any ``configs/mamba2-1.3b*.json`` holds this module's published
    numbers, so the two copies cannot drift apart (none is there yet)."""
    for path in sorted(Path(REPO / "h100bench/configs").glob("mamba2-1.3b*.json")):
        model = json.loads(path.read_text())["model"]
        for key, want in MAMBA2_1_3B.items():
            if isinstance(want, (int, float)) and not isinstance(want, bool):
                assert model[key] == want, (path.name, key)
        assert {k: model["mamba"].get(k, 1 if k == "n_groups" else None) for k in MAMBA2_1_3B["mamba"]} \
            == MAMBA2_1_3B["mamba"], path.name


@pytest.mark.parametrize("g", [1, 2])
def test_the_gated_norm_is_grouped(g):
    """``_mamba_out`` normalises each group's share of the inner width on
    its own (the published ``group_size`` = inner width / groups), against
    a norm written here group by group."""
    model = tiny_mamba(g)
    params = dict(weights.flatten(weights.make_params(model, INIT, {}, 2**31 + 2929, torch.device("cpu"))))
    gen = torch.Generator().manual_seed(2929 + g)
    params["blocks/l0/mamba/norm_scale"] = torch.rand(params["blocks/l0/mamba/norm_scale"].shape, generator=gen) + 0.5
    dec = Decoder(model, params, 1)
    y, z = torch.randn(2, 3, 64, generator=gen), torch.randn(2, 3, 64, generator=gen)
    gated, scale = y * torch.nn.functional.silu(z), params["blocks/l0/mamba/norm_scale"][1]
    want = torch.cat([part / torch.sqrt((part * part).mean(-1, keepdim=True) + 1e-6)
                      for part in gated.split(64 // g, dim=-1)], dim=-1) * scale
    torch.testing.assert_close(dec._mamba_out(1, y, z), want @ params["blocks/l0/mamba/w_out"][1],
                               rtol=1e-5, atol=1e-5)


@torch.no_grad()
def full_logits(dec, tokens):
    """Every position's logits of the whole sequence in one pass."""
    x = dec.embed(tokens)
    for l in range(dec.L):
        x = dec.layer(l, x, None)[0]
    return dec.logits(x)


@pytest.mark.parametrize("g", [1, 2])
def test_prefill_then_decode_is_the_full_forward(g):
    """8 tokens in two chunks of 4: prefill the first chunk through ``ssd``,
    decode the rest through ``mamba_step``; both must give the one pass's
    logits, so both read the same group for each head."""
    model = tiny_mamba(g)
    params = weights.make_params(model, INIT, {}, 2**31 + 29, torch.device("cpu"))
    dec = Decoder(model, dict(weights.flatten(params)), 1)
    tokens = torch.from_numpy(np.random.default_rng(29).integers(1, 64, (3, 8))).to(torch.int32)
    want = full_logits(dec, tokens)
    logits, state, _ = dec.prefill(tokens[:, :4], 8)
    got = [logits]
    for i in range(4, 8):
        got.append(dec.decode(tokens[:, i], state, i)[0])
    torch.testing.assert_close(torch.stack(got, dim=1), want[:, 3:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("g", [1, 2])
def test_the_chunked_scan_is_the_recurrence(g):
    """``ssd`` over two chunks against the recurrence token by token,
    head h reading group h // (heads / groups)."""
    gen = torch.Generator().manual_seed(31 + g)
    b, s, h, p, n = 2, 8, 4, 3, 5
    x = torch.randn(b, s, h, p, generator=gen)
    dt = torch.rand(b, s, h, generator=gen) * 0.5 + 0.05
    A = -torch.rand(h, generator=gen) * 2 - 0.1
    B = torch.randn(b, s, g, n, generator=gen)
    C = torch.randn(b, s, g, n, generator=gen)
    y, final = ssd(x, dt, A, B, C, 4, Precision(None))
    state = torch.zeros(b, h, p, n)
    ys = []
    for t in range(s):
        for head in range(h):
            grp = head // (h // g)
            decay = torch.exp(dt[:, t, head] * A[head])[:, None, None]
            state[:, head] = (state[:, head] * decay
                              + dt[:, t, head, None, None] * x[:, t, head, :, None] * B[:, t, grp, None, :])
        ys.append(torch.stack([state[:, head] @ C[:, t, head // (h // g)][..., None] for head in range(h)],
                              dim=1)[..., 0])
    torch.testing.assert_close(y, torch.stack(ys, dim=1), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(final, state, rtol=1e-5, atol=1e-5)


#: Published mamba2-1.3b's served and trained shapes, as the ``batch`` and
#: ``text`` traffic files give them; two prompts are held to one pass.
HELD_PROMPTS = (0, 63)
#: The widest gap between a decoded logit and the one pass's, over the
#: largest |logit| of the one pass.
GAP_LIMIT = 1e-4


@pytest.mark.h100
def test_the_reference_at_mamba2_1_3b_on_the_card(cuda_device):
    """The reference alone (no program) at the published widths: one round
    of the ``batch`` traffic (64 x 1,024 prompts, 64 greedy steps) prefilled
    and decoded, two prompts held to one pass over their prompt and served
    tokens, then 3 training steps on 8 x 1,024 packed ``text`` rows.  Prints
    the peak memory and seconds of each part and the largest logit gap."""
    from h100bench.lib import traffic
    from h100bench.reference import serve as ref_serve
    from h100bench.reference import train as ref_train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seed = 2**31 + 2900
    model = MAMBA2_1_3B
    doc = {"model": model, "optimizer": OPTIMIZER, "init": INIT, "ep_shards": 1}
    batch = json.loads((REPO / "h100bench/traffic/batch.json").read_text())
    text = json.loads((REPO / "h100bench/traffic/text.json").read_text())
    V, chunk = model["vocab_size"], model["mamba"]["chunk"]
    out = {}

    def clock(name, fn):
        torch.cuda.synchronize(cuda_device)
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize(cuda_device)
        out[name + "_s"] = time.perf_counter() - t0
        return got

    torch.cuda.reset_peak_memory_stats(cuda_device)
    p = ref_serve.params_f32(doc, batch, seed, cuda_device)
    assert sum(t.numel() for t in p.values()) == 1343581184
    dec = Decoder(model, p, 1)
    prompts = torch.from_numpy(traffic.prompts(seed, batch, V, 0)).to(cuda_device)
    S, steps = prompts.shape[1], int(batch["decode_steps"])
    logits, state, _ = clock("prefill", lambda: dec.prefill(prompts, S + steps - 1))
    served, held = [], []

    def decode():
        nonlocal logits
        for i in range(steps):
            tok = logits.argmax(dim=-1)
            served.append(tok)
            held.append(logits[list(HELD_PROMPTS)])
            if i + 1 < steps:
                logits = dec.decode(tok, state, S + i)[0]

    clock("decode", decode)
    out["serve_peak_bytes"] = torch.cuda.max_memory_allocated(cuda_device)
    del state, logits
    served = torch.stack(served, dim=1)
    assert int(served.min()) >= 0 and int(served.max()) < V
    # The one pass reads the prompt and the first 63 served tokens; it is
    # padded to whole chunks with more tokens, which no earlier position sees.
    rows = torch.cat([prompts[list(HELD_PROMPTS)], served[list(HELD_PROMPTS), :-1]], dim=1)
    pad = -rows.shape[1] % chunk
    rows = torch.cat([rows, rows[:, :pad]], dim=1)
    one_pass = full_logits(dec, rows)[:, S - 1:S - 1 + steps]
    stepped = torch.stack(held, dim=1)
    out["logit_gap"] = float((stepped - one_pass).abs().max())
    out["logit_scale"] = float(one_pass.abs().max())
    out["argmax_agree"] = float((stepped.argmax(-1) == one_pass.argmax(-1)).float().mean())
    del dec, p, one_pass, stepped
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(cuda_device)
    rows = ref_train.packed_batches(seed, text, V, 3)
    got = clock("train_3_steps", lambda: ref_train.steps(doc, text, seed, rows, cuda_device))
    out["train_peak_bytes"] = torch.cuda.max_memory_allocated(cuda_device)
    out["train_losses"] = got["loss"]
    out["card"] = torch.cuda.get_device_name(cuda_device)
    print("mamba2_1_3b_reference " + json.dumps(out))
    assert out["logit_gap"] <= GAP_LIMIT * out["logit_scale"], out
    assert all(math.isfinite(v) for v in got["loss"]) and len(got["grad"]) == len(weights.layout(model, INIT))
    assert all(math.isfinite(v) for v in got["change"].values()) and max(got["change"].values()) > 0
