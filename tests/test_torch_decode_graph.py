"""The served decode step with its position on the device, and as a CUDA
graph (``repro_torch.train.decode_graph``).

On the CPU: a one-token step writes the caches, rotates and masks from the
``pos`` tensor with the same bits as the slice write at ``int(pos)`` (the
rule before, frozen below), for a bf16 and an int8 KV cache, a Mamba-2
state, a hybrid and the encoder-decoder's self-attention cache; no step
reads ``pos`` on the host; every model's step returns the state tensors
it was given, as a capture requires; the graphs' keys and their eviction;
kernel launches counted from device records.  On the card (``-m h100``,
skipped elsewhere): the graph's logits, caches, tokens and kernels run
against the eager step's.
"""

from __future__ import annotations

import dataclasses
import types

import pytest
import torch

from repro_torch import kernels, tracing
from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.config.base import get_config
from repro_torch.models import encdec, transformer
from repro_torch.models.model_api import build
from repro_torch.models.param import tree_leaves
from repro_torch.models.perf_flags import PerfFlags, use_flags
from repro_torch.train import decode_graph
from repro_torch.train.step import make_decode_step, make_prefill_step

CPU = torch.device("cpu")
BATCH, PROMPT, STEPS = 2, 12, 4
#: (architecture, what its decode state holds)
ARCHS = {"granite-moe-1b-a400m": "bf16 KV cache, MoE", "qwen1.5-32b": "int8 KV cache",
         "mamba2-1.3b": "Mamba-2 state", "jamba-1.5-large-398b": "hybrid", "whisper-base": "encoder-decoder"}


def slice_positions(decode_state, device):
    """The rule before: one host read of the counter, an int offset at which
    the caches are written by slice."""
    start = int(decode_state["pos"])
    return start, start + torch.arange(1, dtype=torch.int32, device=device)


def _served(arch, device=CPU, seed=0, **replace):
    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    model = build(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, device=device)
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device,
                                      dtype=torch.int32)}
    if cfg.family == "encdec":
        inputs["frames"] = torch.randn((BATCH, cfg.encoder_len, cfg.d_model), generator=gen, device=device)
    return model, params, inputs


def _serve(model, params, inputs, decode, steps=STEPS, wrap=lambda pos: pos):
    """A prefill and ``steps`` greedy steps: (every call's logits, the
    tokens fed, the state after)."""
    state = model.decode_state_init(BATCH, PROMPT + steps + 1, device=inputs["tokens"].device)
    logits, state = make_prefill_step(model)(params, state, inputs)
    out, toks = [logits], []
    for _ in range(steps):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        toks.append(tok)
        logits, state = decode(params, dict(state, pos=wrap(state["pos"])), tok)
        out.append(logits)
    return out, toks, state


_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _same_bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = (t.reshape(-1).view(_INT_OF_SIZE[t.element_size()]) for t in (a, b))
    return torch.equal(a, b)


def _state_leaves(state):
    return [t.as_subclass(torch.Tensor) for t in tree_leaves(state)]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_a_step_writes_from_the_counter_with_the_slice_writes_bits(arch, monkeypatch):
    model, params, inputs = _served(arch)
    if arch == "granite-moe-1b-a400m":
        assert model.cfg.dtype == "bfloat16"
    if arch == "qwen1.5-32b":
        assert model.cfg.kv_cache_dtype == "int8"
    decode = make_decode_step(model)
    got, got_toks, got_state = _serve(model, params, inputs, decode)
    monkeypatch.setattr(transformer, "step_positions", slice_positions)
    monkeypatch.setattr(encdec, "step_positions", slice_positions)
    want, want_toks, want_state = _serve(model, params, inputs, make_decode_step(model))
    assert all(_same_bits(a, b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(got_toks, want_toks))
    assert int(got_state["pos"]) == int(want_state["pos"]) == PROMPT + STEPS
    leaves = list(zip(tree_leaves(got_state), tree_leaves(want_state)))
    assert len(leaves) > 1 and all(_same_bits(a, b) for a, b in leaves)


class NoHostRead(torch.Tensor):
    """A counter that raises where the host would read its value."""

    def _read(self, *args):
        raise AssertionError("the decode step read pos on the host")

    __int__ = __index__ = __float__ = __bool__ = item = tolist = _read


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_a_step_reads_no_counter_on_the_host(arch):
    model, params, inputs = _served(arch)
    wrap = lambda pos: torch.Tensor._make_subclass(NoHostRead, pos)   # noqa: E731
    with pytest.raises(AssertionError, match="read pos"):
        int(wrap(torch.zeros((), dtype=torch.int32)))
    got, toks, state = _serve(model, params, inputs, make_decode_step(model), wrap=wrap)
    want, want_toks, _ = _serve(model, params, inputs, make_decode_step(model))
    assert all(_same_bits(a.as_subclass(torch.Tensor), b) for a, b in zip(got, want))
    assert all(torch.equal(a, b) for a, b in zip(toks, want_toks))
    assert state["pos"].as_subclass(torch.Tensor).tolist() == PROMPT + STEPS


def test_a_cpu_step_runs_eagerly_and_is_counted():
    model, params, inputs = _served("granite-moe-1b-a400m")
    before = dict(tracing.counters())
    _serve(model, params, inputs, make_decode_step(model), steps=3)
    after = tracing.counters()
    assert {k: after[k] - before[k] for k in decode_graph.counts} == {
        "decode_graph_captures": 0, "decode_graph_replays": 0, "decode_eager_steps": 3}


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_every_step_returns_the_state_tensors_it_was_given(arch):
    """What a capture checks: a replay returns the given state, so the step
    must write every state tensor but the counter in place."""
    model, params, inputs = _served(arch)
    state = model.decode_state_init(BATCH, PROMPT + 2, device=CPU)
    logits, state = make_prefill_step(model)(params, state, inputs)
    _, out = model.decode_step(params, state, torch.argmax(logits, dim=-1).to(torch.int32))
    decode_graph.check_in_place(state, out)
    assert out["pos"] is not state["pos"]


def test_a_step_that_returns_a_new_state_tensor_is_refused():
    state = {"pos": torch.zeros((), dtype=torch.int32), "kv_l0": {"k": torch.zeros(2), "v": torch.zeros(2)}}
    decode_graph.check_in_place(state, dict(state, pos=state["pos"] + 1))
    replaced = dict(state, kv_l0=dict(state["kv_l0"], v=state["kv_l0"]["v"] + 1))
    with pytest.raises(ValueError, match=r"\['kv_l0/v'\]"):
        decode_graph.check_in_place(state, replaced)
    with pytest.raises(ValueError, match=r"\['ssm_l0'\]"):
        decode_graph.check_in_place(state, dict(state, ssm_l0=torch.zeros(1)))


def test_the_cache_keeps_the_two_newest_keys_and_recaptures_a_new_one():
    cache = decode_graph.GraphCache()
    captured = []

    def call(key):
        graph = cache.get_or_capture(key, lambda: captured.append(key) or f"graph {key}")
        return "eager" if graph is None else graph

    assert decode_graph.KEEP == 2
    assert [call("a"), call("a"), call("a")] == ["eager", "graph a", "graph a"]
    assert [call("b"), call("b")] == ["eager", "graph b"]
    # Two states in turn: both replay.
    assert [call("a"), call("b"), call("a")] == ["graph a", "graph b", "graph a"]
    assert captured == ["a", "b"]
    # A third: the least recently used key goes with its graph, and comes
    # back as a new key.
    assert call("c") == "eager"
    assert [call("c"), call("b"), call("b"), call("a")] == ["graph c", "eager", "graph b", "eager"]
    assert captured == ["a", "b", "c", "b"]


def test_the_key_names_the_pointers_of_the_state_and_not_its_counter():
    model, params, _ = _served("qwen1.5-32b")
    state = model.decode_state_init(BATCH, 8, device=CPU)
    tok = torch.zeros((BATCH, 1), dtype=torch.int32)
    key = decode_graph.graph_key(params, state, tok)
    # Other token and counter values, the same tensors: the same graph.
    moved = dict(state, pos=state["pos"] + 5)
    assert decode_graph.graph_key(params, moved, tok + 3) == key
    # A fresh state lies elsewhere: another graph.
    other = model.decode_state_init(BATCH, 8, device=CPU)
    assert decode_graph.graph_key(params, other, tok) != key
    # What the capture reads beside the tensors: another graph.
    with use_flags(PerfFlags(moe_scatter_combine=True)):
        assert decode_graph.graph_key(params, state, tok) != key
    assert decode_graph.graph_key(params, state, tok.to(torch.int64)) != key
    assert decode_graph.graph_key(params, state, torch.zeros((BATCH + 1, 1), dtype=torch.int32)) != key
    # Every cache leaf is in the key, the int8 scales too.
    leaves = [path for path, _ in key[-1]]
    assert "kv_l0/k_scale" in leaves and "pos" not in leaves


def test_only_the_device_and_the_process_group_choose_the_graph(monkeypatch):
    """Inputs on a CUDA device are keyed for a graph unless the context has
    a process group; the CPU's never are.  (Stand-ins for the inputs: this
    machine has no CUDA device.)"""
    keyed = []
    monkeypatch.setattr(decode_graph, "graph_key", lambda *a: keyed.append(a) or ("key",))
    monkeypatch.setattr(decode_graph, "Captured", lambda *a: pytest.fail("captured"))
    on_card = types.SimpleNamespace(is_cuda=True)
    on_host = types.SimpleNamespace(is_cuda=False)
    for field in ("group", "ep_group", "fsdp_group", "world_group", None):
        ctx = types.SimpleNamespace(group=None, ep_group=None, fsdp_group=None, world_group=None)
        if field is not None:
            setattr(ctx, field, object())
        calls = []
        step = decode_graph.graphed(lambda p, s, t: calls.append(t) or (t, s), ctx)
        before = decode_graph.counts["decode_eager_steps"]
        step({}, {"pos": on_card}, on_card)
        step({}, {"pos": on_host}, on_host)
        assert len(calls) == 2 and decode_graph.counts["decode_eager_steps"] == before + 2
        # Ungrouped, the card's call was keyed (its first call runs eagerly).
        assert len(keyed) == (field is None), field


def test_kernels_run_are_counted_from_the_device_records_by_wrapper():
    """Each wrapper's launch leaves one record of one of its kernels, a
    graph replay's too; the host's records and other kernels are not
    counted."""
    from torch.autograd import DeviceType

    def evt(key, count, device=DeviceType.CUDA):
        return types.SimpleNamespace(key=key, count=count, device_type=device)

    trace = types.SimpleNamespace(key_averages=lambda: [
        evt("void moe_combine_fwd_kernel<__nv_bfloat16, 8, float, 1>(...)", 7),
        evt("void topk_gating_warp_kernel<float, 4>(...)", 3), evt("void topk_gating_group_kernel<...>", 4),
        evt("histogram_cluster_kernel(int const*, int*, long long, int)", 7),
        evt("void ssd_scan_bwd_kernel<float, 4>(...)", 2), evt("ssd_scan_bwd_decay_kernel(...)", 2),
        evt("dispatch_gather_kernel", 5, DeviceType.CPU), evt("void at::native::elementwise_kernel<...>", 99)])
    assert kernels.launches_in_trace(trace) == {
        "topk_gating": 7, "load_histogram": 7, "dispatch_gather": 0, "ssd_state_scan": 0,
        "ssd_state_scan_bwd": 2, "moe_combine": 7, "moe_combine_bwd": 0, "attention": 0}
    assert set(kernels.DEVICE_KERNELS) == set(kernels.launch_counts())


# ---------------------------------------------------------------------- #
# On the card
# ---------------------------------------------------------------------- #

#: name: (architecture, layers at its published widths; None: its reduced
#: config, as the CPU tests build it)
CARD = {"tiny-moe": ("granite-moe-1b-a400m", None), "tiny-mamba2": ("mamba2-1.3b", None),
        "granite-2-layers": ("granite-moe-1b-a400m", 2)}
CARD_STEPS = 8


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this machine: the test runs on the H100")
    return torch.device("cuda", 0)


def _card_served(name, device):
    arch, layers = CARD[name]
    if layers is None:
        return _served(arch, device)
    cfg = dataclasses.replace(get_config(arch), num_layers=layers)
    model = build(cfg)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init(gen, device=device)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen, device=device, dtype=torch.int32)
    return model, params, {"tokens": tokens}


@pytest.mark.h100
@pytest.mark.parametrize("name", sorted(CARD))
def test_the_graph_gives_the_eager_steps_bits_and_counts(name, cuda_device):
    from torch.profiler import ProfilerActivity, profile

    model, params, inputs = _card_served(name, cuda_device)
    eager = lambda p, s, t: model.decode_step(p, s, t)   # noqa: E731
    kernels.reset_launch_counts()
    want, want_toks, want_state = _serve(model, params, inputs, eager, steps=CARD_STEPS)
    torch.cuda.synchronize()
    want_counts = kernels.launch_counts()
    # The host runs a graphed state's first two steps, eager and captured.
    kernels.reset_launch_counts()
    _serve(model, params, inputs, eager, steps=2)
    torch.cuda.synchronize()
    host_counts = kernels.launch_counts()

    decode = make_decode_step(model)
    held = []
    for round_ in range(2):
        # The first round's state is held, so the second's lies elsewhere:
        # a new key, captured again.
        kernels.reset_launch_counts()
        before = dict(tracing.counters())
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            got, toks, state = _serve(model, params, inputs, decode, steps=CARD_STEPS)
            torch.cuda.synchronize()
        after = tracing.counters()
        assert {k: after[k] - before[k] for k in decode_graph.counts} == {
            "decode_graph_captures": 1, "decode_graph_replays": CARD_STEPS - 2, "decode_eager_steps": 1}, round_
        # The wrappers count the host's calls; the device ran every kernel
        # of the eager run, the replays' included.
        assert kernels.launch_counts() == host_counts, round_
        assert kernels.launches_in_trace(prof) == want_counts, round_
        assert all(torch.equal(a, b) for a, b in zip(toks, want_toks)), round_
        assert all(_same_bits(a, b) for a, b in zip(got, want)), round_
        assert all(_same_bits(a, b) for a, b in zip(_state_leaves(state), _state_leaves(want_state))), round_
        held.append(state)
    assert int(state["pos"]) == PROMPT + CARD_STEPS
    caches = [[t.data_ptr() for path, t in flatten_with_paths(st) if path != "pos"] for st in held]
    assert not set(caches[0]) & set(caches[1])
