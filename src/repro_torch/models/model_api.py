"""Unified model API: specs / init / loss / prefill / decode per family,
for all ten architectures of the registry."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch._device import DeviceLike
from repro_torch.config.base import ArchConfig
from repro_torch.models import encdec, transformer
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

    def init(self, generator: torch.Generator, dtype=None, device: DeviceLike = None) -> Dict:
        dt = dtype if dtype is not None else transformer.model_dtype(self.cfg)
        return tree_materialize(self.specs(), generator, dtype_override=dt, device=device)

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
        ``aux["dyskew"]`` when ``dyskew`` is given."""
        cfg = self.cfg
        if cfg.family == "encdec":
            enc_out = encdec.encode(params, batch["frames"], cfg)
            logits, aux = encdec.forward(params, batch["tokens"], cfg=cfg, enc_out=enc_out)
        else:
            logits, aux = transformer.forward(
                params, batch["tokens"], cfg=cfg, ctx=ctx, dyskew=dyskew,
                prefix_embeds=batch.get("patches"), ops=ops,
            )
        loss = transformer.lm_loss(logits, batch["targets"])
        metrics = dict(aux.get("metrics", {}))
        if "moe_aux_loss" in metrics:
            loss = loss + MOE_AUX_COEF * metrics["moe_aux_loss"]
        metrics["loss"] = loss
        return loss, dict(aux, metrics=metrics)

    # ---------------- serving ------------------- #

    def decode_state_init(self, batch: int, max_seq: int, device: DeviceLike = None) -> Dict:
        dt = transformer.model_dtype(self.cfg)
        if self.cfg.family == "encdec":
            return encdec.decode_state_init(self.cfg, batch, max_seq, dt, device)
        return transformer.decode_state_init(self.cfg, batch, max_seq, dt, device)

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
        ``repro`` — call ``transformer.forward`` to carry them."""
        cfg = self.cfg
        if cfg.family == "encdec":
            enc_out = encdec.encode(params, inputs["frames"], cfg)
            logits, aux = encdec.forward(
                params, inputs["tokens"], cfg=cfg, enc_out=enc_out, decode_state=state,
            )
        else:
            logits, aux = transformer.forward(
                params, inputs["tokens"], cfg=cfg, ctx=ctx, dyskew=dyskew,
                decode_state=state, prefix_embeds=inputs.get("patches"),
            )
        return logits, aux["decode_state"]

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
            logits, aux = encdec.forward(params, token, cfg=self.cfg, decode_state=state)
        else:
            logits, aux = transformer.forward(
                params, token, cfg=self.cfg, ctx=ctx, dyskew=dyskew,
                decode_state=state,
            )
        return logits, aux["decode_state"]

    def dyskew_init(self, ctx: SpmdCtx = SpmdCtx(), device: DeviceLike = None) -> Optional[Dict]:
        if self.cfg.moe is None or self.cfg.family == "encdec":
            return None
        return transformer.dyskew_states_init(self.cfg, ctx, device)


def build(cfg: ArchConfig) -> Model:
    return Model(cfg)
