"""Unified model API: specs / init / prefill / decode for the decoder-only
families the port has (training comes with a later slice)."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from repro_torch._device import DeviceLike
from repro_torch.config.base import ArchConfig
from repro_torch.models import transformer
from repro_torch.models.layers.moe import SpmdCtx
from repro_torch.models.param import tree_materialize, tree_num_params


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ArchConfig

    def __post_init__(self):
        if self.cfg.family in ("encdec", "vlm"):
            raise NotImplementedError(
                f"family {self.cfg.family!r} is not ported yet: ROADMAP.md "
                "queue A, 'the other model families'"
            )

    # ---------------- parameters ---------------- #

    def specs(self) -> Dict:
        return transformer.model_specs(self.cfg)

    def init(self, generator: torch.Generator, dtype=None, device: DeviceLike = None) -> Dict:
        dt = dtype if dtype is not None else transformer.model_dtype(self.cfg)
        return tree_materialize(self.specs(), generator, dtype_override=dt, device=device)

    def num_params(self) -> int:
        return tree_num_params(self.specs())

    # ---------------- serving ------------------- #

    def decode_state_init(self, batch: int, max_seq: int, device: DeviceLike = None) -> Dict:
        dt = transformer.model_dtype(self.cfg)
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
        logits, aux = transformer.forward(
            params, inputs["tokens"], cfg=self.cfg, ctx=ctx, dyskew=dyskew,
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
        logits, aux = transformer.forward(
            params, token, cfg=self.cfg, ctx=ctx, dyskew=dyskew,
            decode_state=state,
        )
        return logits, aux["decode_state"]

    def dyskew_init(self, ctx: SpmdCtx = SpmdCtx(), device: DeviceLike = None) -> Optional[Dict]:
        if self.cfg.moe is None:
            return None
        return transformer.dyskew_states_init(self.cfg, ctx, device)


def build(cfg: ArchConfig) -> Model:
    return Model(cfg)
