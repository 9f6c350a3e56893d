"""What ``correct`` is decided by, on the CPU at a tiny size: the reference
agrees with the port, its control in a lower precision does not, and every
fault a cell can have turns ``correct`` false.

The tiny models run in float32, where program and reference agree to
float32's rounding; the control is the reference computed with bfloat16
products (the step below float32 on a CPU).  Each fault is planted in the
port's timed path underneath an otherwise whole run of the harness."""

from __future__ import annotations

import time

import pytest
import torch

from h100bench.conftest import TINY_LIMITS
from h100bench.control import readings
from h100bench.run import run_cell

SEED = 2**31 + 777


def run(root, cell):
    return run_cell(cell, SEED, 5.0 if ".serve." in cell else 0.5, False, device="cpu", root=root,
                    started=time.perf_counter())


@pytest.mark.parametrize("cell", ["granite-moe.train.skewed", "mamba2.train.text"])
def test_train_control_fails_where_the_program_passes(tiny_root, cell):
    got = []
    readings(cell, [SEED], [SEED], device="cpu", root=tiny_root, emit=got.append, control="bf16")
    sides = {g["side"]: g for g in got}
    limits = TINY_LIMITS["train"]
    prog, ctrl, half = sides["program"], sides["control_bf16"], sides["fault_half_batch"]
    assert all(prog[k] <= limits[k] for k in limits)
    assert any(ctrl[k] > limits[k] for k in ("loss_gap", "grad_gap", "change_gap"))
    assert any(half[k] > limits[k] for k in ("loss_gap", "grad_gap", "change_gap"))


@pytest.mark.parametrize("cell", ["granite-moe.serve.skewed", "mamba2.serve.batch"])
def test_serve_control_fails_where_the_program_passes(tiny_root, cell):
    got = []
    readings(cell, [SEED], [SEED], device="cpu", root=tiny_root, emit=got.append, control="bf16")
    sides = {g["side"]: g for g in got}
    assert sides["program"]["logit_gap"] <= TINY_LIMITS["serve"]["logit_gap"]
    assert sides["control_bf16"]["logit_gap"] > TINY_LIMITS["serve"]["logit_gap"]


# ----------------------------------------------------------------------- #
# Faults planted underneath a whole run
# ----------------------------------------------------------------------- #

def _train_fault(monkeypatch, fault):
    import repro_torch.data.pipeline as pipeline
    import repro_torch.train.step as step_mod

    real_make = step_mod.make_train_step
    if fault == "altered_token":
        real_next = pipeline.DataPipeline.__next__

        def altered(self):
            batch = real_next(self)
            batch["tokens"] = batch["tokens"].copy()
            batch["tokens"][0, 0] = batch["tokens"][0, 0] % 200 + 1
            return batch

        monkeypatch.setattr(pipeline.DataPipeline, "__next__", altered)
        return

    def make(*a, **kw):
        step = real_make(*a, **kw)

        def broken(state, batch):
            if fault == "unchanged_state":
                _, metrics = step(state, batch)
                return state, metrics
            half = {k: v[: len(v) // 2] for k, v in batch.items()}
            return step(state, half)

        return broken

    monkeypatch.setattr(step_mod, "make_train_step", make)


def _serve_fault(monkeypatch, fault):
    import repro_torch.train.step as step_mod

    real_make = step_mod.make_decode_step

    def make(*a, **kw):
        decode = real_make(*a, **kw)

        def broken(params, state, token):
            if fault == "unchanged_state":
                saved = {k: v.clone() for k, v in _leaves(state)}
                logits, new = decode(params, state, token)
                for k, v in _leaves(new):
                    v.copy_(saved[k])
                return logits, new
            logits, new = decode(params, state, token)
            logits = logits.clone()
            if fault == "altered_token":
                logits[0] = torch.roll(logits[0], 1, dims=-1)
            else:           # half of the batch left out: its rows copy the others'
                half = logits.shape[0] // 2
                logits[half:] = logits[:logits.shape[0] - half]
            return logits, new

        return broken

    monkeypatch.setattr(step_mod, "make_decode_step", make)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    else:
        yield prefix, tree


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_token"])
@pytest.mark.parametrize("cell", ["granite-moe.train.skewed", "mamba2.train.text"])
def test_a_train_fault_turns_correct_false(tiny_root, monkeypatch, cell, fault):
    _train_fault(monkeypatch, fault)
    result, _ = run(tiny_root, cell)
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch", "altered_token"])
@pytest.mark.parametrize("cell", ["granite-moe.serve.skewed", "mamba2.serve.batch"])
def test_a_serve_fault_turns_correct_false(tiny_root, monkeypatch, cell, fault):
    _serve_fault(monkeypatch, fault)
    result, _ = run(tiny_root, cell)
    assert result["correct"] is False, result["checks"]


def test_the_look_reads_every_leaf_of_a_training_program(tiny_root):
    got = []
    readings("granite-moe.train.skewed", [SEED], [], device="cpu", root=tiny_root, emit=got.append, look=True)
    look = got[0]["look"]
    assert set(look) == set(got[0]["leaves"])
    for shares in look.values():
        assert set(shares) == {"moved", "apart", "grad_sign_differs", "apart_one_step", "diff_sq_on_sign_flips",
                               "diff_sq_one_side_moved"}
        assert all(0.0 <= v <= 1.0 for v in shares.values())
    # In float32 the tiny program and reference move the same elements.
    assert max(s["moved"] for s in look.values()) > 0.5
    assert max(s["apart"] for s in look.values()) < 0.5
