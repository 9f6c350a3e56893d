"""Encoder-decoder transformer (Whisper-style backbone).

The audio frontend (log-mel + conv subsampling) is a stub: callers pass
precomputed frame embeddings (B, T_enc, d).  Positions are sinusoidal, as
in ``repro``.  Parameters are stacked over the layers on a leading axis
(``enc_blocks`` / ``blocks``, one layer ``l0`` a block), the layout
``repro`` scans over; here the stack is a Python loop over that axis.

At prefill the cross-attention keys and values are built once from the
encoder output and written to ``kv_cross``; the prompt attends to all
``encoder_len`` frames, cached or not.  ``repro``'s cached prefill attends
to the first S frames only (S the prompt length) and so leaves its own
uncached forward whenever S < ``encoder_len``; the port computes the
uncached function on both paths.

Under a model group (``ctx.ep_group``) the layers hold the rank's heads,
ffn width and vocabulary rows as in ``transformer`` (the tied table serves
the embedding and the logits), and the caches the rank's kv heads.  Under
FSDP each layer gathers its data-sliced leaves inside the function that
``checkpoint`` wraps, as ``transformer``'s blocks do.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import distributed
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.config.base import ArchConfig
from repro_torch.models import fsdp
from repro_torch.models.layers import basic
from repro_torch.models.layers.attention import (
    attention_apply,
    attention_specs,
    decode_attention,
    mlp_apply,
    mlp_specs,
)
from repro_torch.models.layers.moe import SpmdCtx
from repro_torch.models.transformer import (
    _stack_specs,
    _take_block,
    _unbind_blocks,
    kv_heads_held,
    model_dtype,
    step_positions,
    vocab_group,
)


def sinusoidal(positions: torch.Tensor, d: int, dtype: torch.dtype) -> torch.Tensor:
    """(S,) → (S, d) standard sin/cos embedding."""
    half = d // 2
    steps = torch.arange(half, dtype=torch.float32, device=positions.device)
    freqs = torch.exp(-math.log(10000.0) * steps / max(half - 1, 1))
    ang = positions[:, None].to(torch.float32) * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _enc_layer_specs(cfg: ArchConfig) -> Dict:
    return {
        "norm1": basic.norm_specs(cfg.d_model, cfg.norm),
        "attn": attention_specs(cfg),
        "norm2": basic.norm_specs(cfg.d_model, cfg.norm),
        "ffn": mlp_specs(cfg),
    }


def _dec_layer_specs(cfg: ArchConfig) -> Dict:
    return {
        "norm1": basic.norm_specs(cfg.d_model, cfg.norm),
        "attn": attention_specs(cfg),
        "norm_x": basic.norm_specs(cfg.d_model, cfg.norm),
        "cross": attention_specs(cfg),
        "norm2": basic.norm_specs(cfg.d_model, cfg.norm),
        "ffn": mlp_specs(cfg),
    }


def model_specs(cfg: ArchConfig) -> Dict:
    return {
        "embed": basic.embedding_specs(cfg.padded_vocab, cfg.d_model),
        "enc_blocks": _stack_specs({"l0": _enc_layer_specs(cfg)}, cfg.encoder_layers),
        "enc_final_norm": basic.norm_specs(cfg.d_model, cfg.norm),
        "blocks": _stack_specs({"l0": _dec_layer_specs(cfg)}, cfg.num_layers),
        "final_norm": basic.norm_specs(cfg.d_model, cfg.norm),
    }


def encode(params: Dict, frames: torch.Tensor, cfg: ArchConfig, ctx: SpmdCtx = SpmdCtx()) -> torch.Tensor:
    """frames: (B, T_enc, d) stubbed frame embeddings → (B, T_enc, d).
    Bidirectional self-attention layers; with ``cfg.remat`` and grad on,
    each layer runs under ``torch.utils.checkpoint`` (its FSDP gathers
    inside, as ``transformer``'s blocks)."""
    group = ctx.ep_group
    plan = fsdp.plan(model_specs(cfg), ctx)
    layer_plan = fsdp.unstacked(plan["enc_blocks"])["l0"]
    dtype = model_dtype(cfg)
    T = frames.shape[1]
    positions = torch.arange(T, dtype=torch.int32, device=frames.device)
    x = frames.to(dtype) + sinusoidal(positions, cfg.d_model, dtype)

    def layer(lp: Dict, x: torch.Tensor) -> torch.Tensor:
        lp = fsdp.gather(lp, layer_plan, ctx)
        h = basic.norm_apply(lp["norm1"], x, cfg.norm)
        a, _ = attention_apply(lp["attn"], h, cfg=cfg, positions=positions, causal=False, group=group)
        x = x + a
        h = basic.norm_apply(lp["norm2"], x, cfg.norm)
        return x + mlp_apply(lp["ffn"], h, cfg, group)

    remat = cfg.remat and torch.is_grad_enabled()
    for bp in _unbind_blocks(params["enc_blocks"], cfg.encoder_layers):
        if remat:
            x = checkpoint(layer, bp["l0"], x, use_reentrant=False, preserve_rng_state=False)
        else:
            x = layer(bp["l0"], x)
    return basic.norm_apply(fsdp.gather(params["enc_final_norm"], plan["enc_final_norm"], ctx), x, cfg.norm)


def decode_state_init(
    cfg: ArchConfig, batch: int, max_seq: int, dtype: torch.dtype,
    device: DeviceLike = None, ctx: SpmdCtx = SpmdCtx(),
) -> Dict:
    """Self-attention caches of ``max_seq`` positions and cross-attention
    caches of ``encoder_len`` frames, per decoder layer, in ``dtype``; the
    rank's kv heads under ``ctx``'s model group."""
    dev = resolve_device(device)
    nb = cfg.num_layers
    K, hd = kv_heads_held(cfg, ctx), cfg.head_dim_

    def kv(seq: int) -> Dict:
        return {name: torch.zeros((nb, batch, seq, K, hd), dtype=dtype, device=dev)
                for name in ("k", "v")}

    return {
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
        "kv_self": kv(max_seq),
        # Cross K/V computed once from the encoder output at prefill.
        "kv_cross": kv(cfg.encoder_len),
    }


def forward(
    params: Dict,
    tokens: torch.Tensor,                    # (B, S)
    *,
    cfg: ArchConfig,
    enc_out: Optional[torch.Tensor] = None,  # (B, T, d); None during decode
    decode_state: Optional[Dict] = None,
    ctx: SpmdCtx = SpmdCtx(),
) -> Tuple[torch.Tensor, Dict]:
    """Decoder forward.  At prefill pass ``enc_out`` (with ``decode_state``
    the cross K/V are built and cached); during decode pass
    ``decode_state`` only, and the step attends to the cached cross K/V.

    MUTATES ``decode_state``: the caches are written in place and the
    returned decode state holds the same tensors (with a new ``pos``).
    """
    if enc_out is None and decode_state is None:
        raise ValueError("encdec.forward needs enc_out, decode_state, or both")
    B, S = tokens.shape
    dtype = model_dtype(cfg)
    dev = tokens.device
    if decode_state is not None and S == 1:
        start, positions = step_positions(decode_state, dev)
    else:
        # Prefill is always from position 0 (single-shot prompt ingestion).
        start = 0
        positions = torch.arange(S, dtype=torch.int32, device=dev)
    group = ctx.ep_group
    vocab = vocab_group(params, cfg, ctx)
    plan = fsdp.plan(model_specs(cfg), ctx)
    layer_plan = fsdp.unstacked(plan["blocks"])["l0"]
    embed = fsdp.gather(params["embed"], plan["embed"], ctx)
    x = basic.embed_apply(embed, tokens, dtype, vocab)
    x = x + sinusoidal(positions, cfg.d_model, dtype)
    hd = cfg.head_dim_

    def layer(b: int, lp: Dict, x: torch.Tensor) -> torch.Tensor:
        lp = fsdp.gather(lp, layer_plan, ctx)
        h = basic.norm_apply(lp["norm1"], x, cfg.norm)
        if decode_state is not None:
            a, _ = attention_apply(
                lp["attn"], h, cfg=cfg, positions=positions,
                cache=_take_block(decode_state["kv_self"], b), cache_index=start, group=group,
            )
        else:
            a, _ = attention_apply(lp["attn"], h, cfg=cfg, positions=positions, group=group)
        x = x + a

        h = basic.norm_apply(lp["norm_x"], x, cfg.norm)
        if enc_out is not None:
            c, _ = attention_apply(
                lp["cross"], h, cfg=cfg, positions=positions, causal=False, kv=enc_out,
                cache=_take_block(decode_state["kv_cross"], b) if decode_state is not None else None,
                cache_index=0, group=group,
            )
        else:
            # The query heads against the cached cross K/V (the rank's).
            cross = _take_block(decode_state["kv_cross"], b)
            H, K = lp["cross"]["wq"].shape[-2], cross["k"].shape[-2]
            sliced = H < cfg.num_heads
            hq = distributed.to_shard(h, group) if sliced else h
            q = torch.einsum("bsd,dhk->bshk", hq, lp["cross"]["wq"].to(h.dtype))
            if cfg.qkv_bias:
                q = q + lp["cross"]["bq"].to(h.dtype)
            att = decode_attention(q.reshape(B, S, K, H // K, hd), cross["k"], cross["v"],
                                   cross["k"].shape[1])
            c = torch.einsum("bshk,hkd->bsd", att.reshape(B, S, H, hd),
                             lp["cross"]["wo"].to(h.dtype))
            if sliced:
                c = distributed.sum_shards(c, group)
        x = x + c

        h = basic.norm_apply(lp["norm2"], x, cfg.norm)
        return x + mlp_apply(lp["ffn"], h, cfg, group)

    # The decode state is updated in place, which a recompute would repeat:
    # remat is for the training forward only.
    remat = cfg.remat and decode_state is None and torch.is_grad_enabled()
    for b, bp in enumerate(_unbind_blocks(params["blocks"], cfg.num_layers)):
        if remat:
            x = checkpoint(layer, b, bp["l0"], x, use_reentrant=False, preserve_rng_state=False)
        else:
            x = layer(b, bp["l0"], x)
    x = basic.norm_apply(fsdp.gather(params["final_norm"], plan["final_norm"], ctx), x, cfg.norm)
    logits = basic.logits_apply(embed, x, cfg.vocab_size, vocab)

    aux: Dict[str, Any] = {"metrics": {}}
    if decode_state is not None:
        aux["decode_state"] = dict(decode_state, pos=decode_state["pos"] + S)
    return logits, aux
