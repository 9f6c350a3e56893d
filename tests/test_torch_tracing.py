"""The port's spans and counters (``repro_torch.tracing``) on the CPU.

Under a ``torch.profiler`` a tiny granite-like train step, prefill and
decode step emit the ``dyskew.*`` ranges at the layer boundaries; with no
profiler no range is entered, and the steps give the same bits as with the
module's calls turned into plain null contexts.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import tracing
from repro_torch.config.base import get_config
from repro_torch.kernels import _loader
from repro_torch.models.model_api import build
from repro_torch.models.param import tree_leaves
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train.step import make_decode_step, make_prefill_step, make_train_step, train_state_init

CPU = torch.device("cpu")
LAYERS = 2


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(get_config("granite-moe-1b-a400m").reduced(), dtype="float32", remat=True)
    assert cfg.num_layers == LAYERS and cfg.moe is not None
    return build(cfg)


def _tokens(model, batch=2, seq=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, model.cfg.vocab_size, (batch, seq), generator=g)


def _train(model):
    """One train step from a fixed start: (loss, the new parameters)."""
    state = train_state_init(model, OptimizerConfig(warmup_steps=1, total_steps=4),
                             torch.Generator().manual_seed(0), device=CPU)
    tokens = _tokens(model)
    step = make_train_step(model, OptimizerConfig(warmup_steps=1, total_steps=4))
    new, metrics = step(state, {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)})
    return [metrics["loss"]] + tree_leaves(new["params"])


def _serve(model):
    """A prefill of 2 x 16 and two decode steps: every call's logits."""
    params = model.init(torch.Generator().manual_seed(1), device=CPU)
    tokens = _tokens(model, seed=2)
    state = model.decode_state_init(2, 20, device=CPU)
    logits, state = make_prefill_step(model)(params, state, {"tokens": tokens})
    out = [logits]
    decode = make_decode_step(model)
    for _ in range(2):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        logits, state = decode(params, state, tok)
        out.append(logits)
    return out


def _spans(prof) -> collections.Counter:
    return collections.Counter(e.name for e in prof.events() if e.name.startswith(tracing.PREFIX))


def _profiled(fn, model):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn(model)
    return out, _spans(prof)


def test_a_profiled_train_step_emits_the_step_layer_and_link_spans(model):
    _, spans = _profiled(_train, model)
    # Remat's recompute runs each layer a second time, the link too.
    assert spans == {"dyskew.step.forward": 1, "dyskew.step.backward": 1, "dyskew.step.optimizer": 1,
                     "dyskew.attn": 2 * LAYERS, "dyskew.moe": 2 * LAYERS, "dyskew.moe.link": 2 * LAYERS,
                     "dyskew.head": 1}


def test_profiled_serving_emits_the_layer_spans(model):
    _, spans = _profiled(_serve, model)
    calls = 3
    # One link range a layer and call, a stateless caller's too.
    assert spans == {"dyskew.attn": calls * LAYERS, "dyskew.moe": calls * LAYERS,
                     "dyskew.moe.link": calls * LAYERS, "dyskew.head": calls}


def test_a_backward_runs_on_the_calling_thread_only_while_profiled():
    assert torch.autograd.is_multithreading_enabled()
    with tracing.calling_thread():
        assert torch.autograd.is_multithreading_enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.calling_thread():
            assert not torch.autograd.is_multithreading_enabled()
        assert torch.autograd.is_multithreading_enabled()


def test_counters_read_the_existing_instruments(monkeypatch):
    # The kernel wrappers' launches keep their one read path,
    # ``kernels.launch_counts()``; the decode steps are counted by how they
    # ran.
    assert set(tracing.counters()) == {"kernel_build_s", "decode_graph_captures", "decode_graph_replays",
                                       "decode_eager_steps"}
    monkeypatch.setattr(_loader, "last_build_seconds", 0.0)
    assert tracing.counters()["kernel_build_s"] is None
    monkeypatch.setattr(_loader, "last_build_seconds", 7.25)
    assert tracing.counters()["kernel_build_s"] == 7.25


@pytest.mark.parametrize("fn", [_train, _serve], ids=["train_step", "prefill_and_decode"])
def test_without_a_profiler_nothing_is_entered_or_recorded_and_the_bits_are_the_same(model, monkeypatch, fn):
    def no_range(name):
        raise AssertionError(f"a range {name!r} was entered with no profiler")

    monkeypatch.setattr(tracing, "record_function", no_range)
    assert tracing.span("moe") is tracing.span("attn") and tracing.calling_thread() is tracing.span("head")
    off = fn(model)
    # The same steps with the module's calls as plain null contexts, as if
    # the program had none.
    monkeypatch.setattr(tracing, "span", lambda name: contextlib.nullcontext())
    monkeypatch.setattr(tracing, "calling_thread", contextlib.nullcontext)
    bare = fn(model)
    monkeypatch.undo()
    traced, _ = _profiled(fn, model)
    for a, b, c in zip(off, bare, traced, strict=True):
        assert torch.equal(a, b) and torch.equal(a, c)
