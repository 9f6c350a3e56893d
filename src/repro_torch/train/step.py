"""Makers of the serving steps (the training step comes with a later slice).

The steps are plain closures: there is no compile step, and each call runs
eagerly on the device its tensors live on.
"""

from __future__ import annotations

from repro_torch.models.layers.moe import SpmdCtx
from repro_torch.models.model_api import Model


def make_prefill_step(model: Model, ctx: SpmdCtx = SpmdCtx()):
    def prefill_step(params, state, inputs):
        logits, new_state = model.prefill(params, inputs, state, ctx=ctx)
        return logits[:, -1:], new_state

    return prefill_step


def make_decode_step(model: Model, ctx: SpmdCtx = SpmdCtx()):
    def decode_step(params, state, token):
        logits, new_state = model.decode_step(params, state, token, ctx=ctx)
        return logits, new_state

    return decode_step
