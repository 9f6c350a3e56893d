"""Unified model API: specs / init / loss / prefill / decode per family,
for all ten architectures of the registry.

Under a model group (``SpmdCtx.ep_group``) ``init`` and
``decode_state_init`` give a rank the slices its rule table
(``SpmdCtx.rules``) names, and every family runs on them.  Where the
tables are sliced, ``prefill`` and ``decode_step`` return the last
position's logits over the whole vocabulary, (B, 1, V), gathered from the
ranks' columns, as ``repro``'s ``make_prefill_step`` keeps the last
position only: the (B, S, V) gather would move S times the bytes."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch import distributed
from repro_torch._device import DeviceLike
from repro_torch.config.base import ArchConfig
from repro_torch.models import encdec, transformer
from repro_torch.models.layers import basic
from repro_torch.models.layers.moe import KERNEL_OPS, DispatchOps, SpmdCtx
from repro_torch.models.param import tree_abstract, tree_materialize, tree_num_params

MOE_AUX_COEF = 0.01


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    # ---------------- parameters ---------------- #

    def specs(self) -> Dict:
        if self.cfg.family == "encdec":
            return encdec.model_specs(self.cfg)
        return transformer.model_specs(self.cfg)

    def init(self, generator: torch.Generator, dtype=None, device: DeviceLike = None,
             ctx: SpmdCtx = SpmdCtx()) -> Dict:
        """Parameters drawn from ``generator``; with a model group
        (``ctx.ep_group``) each leaf that ``ctx.rules`` slices holds this
        rank's slice."""
        dt = dtype if dtype is not None else transformer.model_dtype(self.cfg)
        shard = (distributed.rank_of(ctx.ep_group), distributed.world_size(ctx.ep_group))
        return tree_materialize(self.specs(), generator, dtype_override=dt, device=device, shard=shard,
                                rules=ctx.rules)

    def abstract_params(self, dtype=None) -> Dict:
        """The parameters as ``meta`` tensors (for the dry-run): the
        shapes and dtypes of ``init``, no generator drawn."""
        dt = dtype if dtype is not None else transformer.model_dtype(self.cfg)
        return tree_abstract(self.specs(), dtype_override=dt)

    def num_params(self) -> int:
        return tree_num_params(self.specs())

    # ---------------- training ------------------ #

    def loss(
        self,
        params: Dict,
        batch: Dict[str, torch.Tensor],
        *,
        dyskew: Optional[Dict] = None,
        ctx: SpmdCtx = SpmdCtx(),
        ops: DispatchOps = KERNEL_OPS,
    ) -> Tuple[torch.Tensor, Dict]:
        """batch: tokens (B,S), targets (B,S), and frames (encdec) or
        patches (vlm).  Returns (loss, aux) with the new link states in
        ``aux["dyskew"]`` when ``dyskew`` is given.  With a data-parallel
        ``ctx.group`` the batch is this rank's rows: the loss and metrics
        are the global ones, and the gradient is this rank's share, so the
        ranks' gradients sum to the global batch's."""
        cfg = self.cfg
        if cfg.family == "encdec":
            enc_out = encdec.encode(params, batch["frames"], cfg, ctx.ep_group)
            logits, aux = encdec.forward(params, batch["tokens"], cfg=cfg, enc_out=enc_out, ctx=ctx)
        else:
            logits, aux = transformer.forward(
                params, batch["tokens"], cfg=cfg, ctx=ctx, dyskew=dyskew,
                prefix_embeds=batch.get("patches"), ops=ops,
            )
        loss = transformer.lm_loss(logits, batch["targets"], group=ctx.group,
                                   vocab=transformer.vocab_group(params, cfg, ctx))
        metrics = dict(aux.get("metrics", {}))
        if "moe_aux_loss" in metrics:
            loss = loss + MOE_AUX_COEF * metrics["moe_aux_loss"]
        metrics["loss"] = loss
        return loss, dict(aux, metrics=metrics)

    # ---------------- serving ------------------- #

    def decode_state_init(self, batch: int, max_seq: int, device: DeviceLike = None,
                          ctx: SpmdCtx = SpmdCtx()) -> Dict:
        dt = transformer.model_dtype(self.cfg)
        if self.cfg.family == "encdec":
            return encdec.decode_state_init(self.cfg, batch, max_seq, dt, device, ctx)
        return transformer.decode_state_init(self.cfg, batch, max_seq, dt, device, ctx)

    def prefill(
        self,
        params: Dict,
        inputs: Dict[str, torch.Tensor],
        state: Dict,
        *,
        ctx: SpmdCtx = SpmdCtx(),
        dyskew: Optional[Dict] = None,
    ) -> Tuple[torch.Tensor, Dict]:
        """Process the prompt, filling caches (in place). Returns
        (logits, new_state); the new link states are dropped, as in
        ``repro`` — call ``transformer.forward`` to carry them.  With the
        tables sliced over a model group the logits are the last
        position's, (B, 1, V)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            enc_out = encdec.encode(params, inputs["frames"], cfg, ctx.ep_group)
            logits, aux = encdec.forward(
                params, inputs["tokens"], cfg=cfg, enc_out=enc_out, decode_state=state, ctx=ctx,
            )
        else:
            logits, aux = transformer.forward(
                params, inputs["tokens"], cfg=cfg, ctx=ctx, dyskew=dyskew,
                decode_state=state, prefix_embeds=inputs.get("patches"),
            )
        return self._served_logits(params, logits, ctx), aux["decode_state"]

    def decode_step(
        self,
        params: Dict,
        state: Dict,
        token: torch.Tensor,            # (B, 1) integer
        *,
        ctx: SpmdCtx = SpmdCtx(),
        dyskew: Optional[Dict] = None,
    ) -> Tuple[torch.Tensor, Dict]:
        """One decode step. Returns (logits (B,1,V), new_state)."""
        if self.cfg.family == "encdec":
            logits, aux = encdec.forward(params, token, cfg=self.cfg, decode_state=state, ctx=ctx)
        else:
            logits, aux = transformer.forward(
                params, token, cfg=self.cfg, ctx=ctx, dyskew=dyskew,
                decode_state=state,
            )
        return self._served_logits(params, logits, ctx), aux["decode_state"]

    def _served_logits(self, params: Dict, logits: torch.Tensor, ctx: SpmdCtx) -> torch.Tensor:
        """The logits as served: with the tables sliced, the ranks' columns
        of the last position joined, else as they are."""
        vocab = transformer.vocab_group(params, self.cfg, ctx)
        return logits if vocab is None else basic.gather_vocab(logits[:, -1:], vocab)

    def dyskew_init(self, ctx: SpmdCtx = SpmdCtx(), device: DeviceLike = None) -> Optional[Dict]:
        if self.cfg.moe is None or self.cfg.family == "encdec":
            return None
        return transformer.dyskew_states_init(self.cfg, ctx, device)


def build(cfg: ArchConfig) -> Model:
    return Model(cfg)
