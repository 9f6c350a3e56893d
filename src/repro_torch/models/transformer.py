"""Unified decoder-only transformer covering the dense / MoE / SSM /
hybrid families (plus the VLM prefix-embedding variant): attention or
Mamba-2 mixers with MoE or dense ffn layers.

Layers are grouped into *blocks* of ``period`` layers (period = lcm of the
attention interleave and the MoE every-other layout) and every parameter
leaf is stacked over the blocks on a leading axis, the layout ``repro``
scans over.  Here the block stack is a Python loop over that leading axis,
so carrying weights across from ``repro`` is one copy per leaf.  With
``cfg.remat`` and grad on, each block runs under
``torch.utils.checkpoint``, as ``repro`` wraps its scanned block in
``jax.checkpoint``: the backward recomputes the block, the MoE link's EMA
included, from the same inputs.

Under a model group (``SpmdCtx.ep_group``) each layer holds what the rule
table (``SpmdCtx.rules``) gives a rank and runs on its part, the residual
stream replicated over the group between layers (the MoE layer's input
too).  Under FSDP (the table's ``embed`` / ``expert_embed`` on the data
axes) each block gathers its data-sliced leaves over the data group at the
top of the function that ``checkpoint`` wraps, so remat's recompute
gathers again and no whole weight is saved for the backward; the
embedding table, the final norm and ``lm_head`` are gathered where they
are used (a tied table once for both).  Serving gathers each block once a
prefill and once a decode step.  The logits are then the rank's vocabulary columns: ``lm_loss``
reduces the max, the sum of exps and the gold logit over the group, and
serving gathers only the last position's (``vocab_group``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import distributed, tracing
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.config.base import ArchConfig
from repro_torch.models.layers import basic
from repro_torch.models.layers.attention import (
    attention_apply,
    attention_specs,
    kv_heads_of,
    mlp_apply,
    mlp_specs,
)
from repro_torch.models.layers.mamba2 import (
    mamba_apply,
    mamba_specs,
    mamba_state_init,
)
from repro_torch.models.layers.moe import (
    KERNEL_OPS,
    DispatchOps,
    SpmdCtx,
    moe_apply,
    moe_specs,
    moe_state_init,
)
from repro_torch.models import fsdp
from repro_torch.models.param import ParamSpec, layer_shape, spec, tree_map

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def model_dtype(cfg: ArchConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def block_period(cfg: ArchConfig) -> int:
    period = cfg.attn_period
    if cfg.moe is not None and cfg.moe.layout == "every_other":
        period = int(math.lcm(period, 2))
    return period


def num_blocks(cfg: ArchConfig) -> int:
    period = block_period(cfg)
    assert cfg.num_layers % period == 0, (cfg.num_layers, period)
    return cfg.num_layers // period


# ------------------------------------------------------------------ #
# Parameter specs
# ------------------------------------------------------------------ #


def layer_specs(cfg: ArchConfig, layer_idx: int) -> Dict:
    """Specs for one layer (mixer + ffn + norms)."""
    out: Dict[str, Any] = {
        "norm1": basic.norm_specs(cfg.d_model, cfg.norm),
        "norm2": basic.norm_specs(cfg.d_model, cfg.norm),
    }
    if cfg.is_attention_layer(layer_idx) and cfg.num_heads > 0:
        out["attn"] = attention_specs(cfg)
    else:
        out["mamba"] = mamba_specs(cfg)
    if cfg.is_moe_layer(layer_idx):
        out["moe"] = moe_specs(cfg)
    elif cfg.d_ff > 0:
        out["ffn"] = mlp_specs(cfg)
    else:
        out.pop("norm2")
    return out


def _stack_specs(tree: Any, n: int) -> Any:
    def f(p: ParamSpec) -> ParamSpec:
        return ParamSpec((n,) + p.shape, (None,) + p.axes, p.init, p.scale, p.dtype)
    return tree_map(f, tree)


def model_specs(cfg: ArchConfig) -> Dict:
    period = block_period(cfg)
    nb = num_blocks(cfg)
    block = {f"l{j}": layer_specs(cfg, j) for j in range(period)}
    out = {
        "embed": basic.embedding_specs(cfg.padded_vocab, cfg.d_model),
        "blocks": _stack_specs(block, nb),
        "final_norm": basic.norm_specs(cfg.d_model, cfg.norm),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = {
            "table": spec((cfg.padded_vocab, cfg.d_model), ("vocab", "embed"),
                          scale=0.02)
        }
    return out


# ------------------------------------------------------------------ #
# Runtime state (DySkew MoE links, KV caches, SSM states)
# ------------------------------------------------------------------ #


def moe_layer_positions(cfg: ArchConfig) -> Tuple[int, ...]:
    period = block_period(cfg)
    return tuple(j for j in range(period) if cfg.is_moe_layer(j))


def attn_layer_positions(cfg: ArchConfig) -> Tuple[int, ...]:
    period = block_period(cfg)
    return tuple(
        j for j in range(period)
        if cfg.is_attention_layer(j) and cfg.num_heads > 0
    )


def mamba_layer_positions(cfg: ArchConfig) -> Tuple[int, ...]:
    period = block_period(cfg)
    return tuple(
        j for j in range(period)
        if not (cfg.is_attention_layer(j) and cfg.num_heads > 0)
    )


def dyskew_states_init(cfg: ArchConfig, device: DeviceLike = None) -> Dict:
    """Stacked per-block DySkew link state (``ema_loads``) for every MoE
    position."""
    nb = num_blocks(cfg)
    out = {}
    for j in moe_layer_positions(cfg):
        one = moe_state_init(cfg, device)
        out[f"l{j}"] = tree_map(
            lambda a: a.expand((nb,) + tuple(a.shape)).clone(), one
        )
    return out


def kv_heads_held(cfg: ArchConfig, ctx: SpmdCtx) -> int:
    """The kv heads a rank's attention uses, and its KV cache holds, under
    ``ctx``'s model group and rule table."""
    if cfg.num_heads == 0:
        return 0
    att = attention_specs(cfg)
    heads = layer_shape(att["wq"], ctx.mesh, ctx.rules)[1]
    width = layer_shape(att["wk"], ctx.mesh, ctx.rules)[1]
    return kv_heads_of(cfg, heads, width, 0)[1]


def decode_state_init(
    cfg: ArchConfig, batch: int, max_seq: int, dtype: torch.dtype,
    device: DeviceLike = None, ctx: SpmdCtx = SpmdCtx(),
) -> Dict:
    """KV caches + SSM states + position counter for decode.  With
    ``cfg.kv_cache_dtype == "int8"`` the caches hold int8 values and a
    float32 scale per (block, batch, position, kv head).  Under a model
    group the caches hold the rank's kv heads and the SSM states its heads
    (``kv_heads_held``, ``mamba_state_init``)."""
    dev = resolve_device(device)
    nb = num_blocks(cfg)
    K, hd = kv_heads_held(cfg, ctx), cfg.head_dim_
    int8 = cfg.kv_cache_dtype == "int8"
    kv_dt = torch.int8 if int8 else dtype
    out: Dict[str, Any] = {"pos": torch.zeros((), dtype=torch.int32, device=dev)}
    for j in attn_layer_positions(cfg):
        entry = {
            "k": torch.zeros((nb, batch, max_seq, K, hd), dtype=kv_dt, device=dev),
            "v": torch.zeros((nb, batch, max_seq, K, hd), dtype=kv_dt, device=dev),
        }
        if int8:
            entry["k_scale"] = torch.zeros((nb, batch, max_seq, K), dtype=torch.float32, device=dev)
            entry["v_scale"] = torch.zeros((nb, batch, max_seq, K), dtype=torch.float32, device=dev)
        out[f"kv_l{j}"] = entry
    for j in mamba_layer_positions(cfg):
        one = mamba_state_init(cfg, batch, dtype, dev, ctx)
        out[f"ssm_l{j}"] = tree_map(
            lambda a: a.expand((nb,) + tuple(a.shape)).clone(), one
        )
    return out


def step_positions(decode_state: Dict, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A one-token decode step's (cache index, positions): the counter plus
    ``arange(1)`` on the device, (1,) int64 for the caches' ``index_copy_``
    and (1,) int32 for RoPE and the sinusoids.  Nothing waits for the
    device, so the step can be captured in a CUDA graph; a ``meta`` counter
    stands for every position, as the reference's traced ``pos`` does."""
    positions = decode_state["pos"] + torch.arange(1, dtype=torch.int32, device=device)
    return positions.to(torch.int64), positions


# ------------------------------------------------------------------ #
# Forward pass
# ------------------------------------------------------------------ #


def vocab_group(params: Dict, cfg: ArchConfig, ctx: SpmdCtx) -> distributed.Group:
    """The model group where ``params``' tables are sliced over it (the
    rank's rows of the vocabulary), else None."""
    return ctx.ep_group if params["embed"]["table"].shape[0] < cfg.padded_vocab else None


def _apply_layer(
    lp: Dict,
    x: torch.Tensor,
    j: int,
    *,
    cfg: ArchConfig,
    ctx: SpmdCtx,
    positions: torch.Tensor,
    cache: Optional[Dict],
    cache_index,
    moe_state: Optional[Dict],
    metrics: Dict,
    ops: DispatchOps = KERNEL_OPS,
):
    """One layer: pre-norm mixer + pre-norm ffn with residuals.  For a Mamba
    position ``cache`` is the layer's SSM state, updated in place."""
    new_cache = None
    new_moe_state = None
    h = basic.norm_apply(lp["norm1"], x, cfg.norm)
    if "attn" in lp:
        with tracing.span("attn"):
            attn_out, new_cache = attention_apply(
                lp["attn"], h, cfg=cfg, positions=positions,
                cache=cache, cache_index=cache_index, group=ctx.ep_group,
            )
        x = x + attn_out
    else:
        mamba_out, new_ssm = mamba_apply(lp["mamba"], h, cfg=cfg, state=cache, scan=ops.scan,
                                         group=ctx.ep_group)
        if cache is not None:
            # In place, as the KV caches: the stacked decode state keeps
            # its tensors.
            for key, v in new_ssm.items():
                cache[key].copy_(v)
            new_cache = cache
        x = x + mamba_out

    if "moe" in lp:
        with tracing.span("moe"):
            h = basic.norm_apply(lp["norm2"], x, cfg.norm)
            moe_out, new_moe_state, moe_metrics = moe_apply(
                lp["moe"], h, cfg=cfg, state=moe_state, ctx=ctx, ops=ops
            )
        for k, v in moe_metrics.items():
            metrics[k] = metrics.get(k, 0.0) + v
        x = x + moe_out
    elif "ffn" in lp:
        h = basic.norm_apply(lp["norm2"], x, cfg.norm)
        x = x + mlp_apply(lp["ffn"], h, cfg, group=ctx.ep_group)
    return x, new_cache, new_moe_state


def _take_block(tree: Any, b: int) -> Any:
    """Views of block ``b`` of every stacked leaf (no copy)."""
    return tree_map(lambda a: a[b], tree)


def _unbind_blocks(tree: Any, nb: int) -> List[Any]:
    """The ``nb`` blocks of every stacked leaf as views, from one ``unbind``
    a leaf: its backward stacks the blocks' gradients once, where a view a
    block would add ``nb`` full-size gradients."""
    if isinstance(tree, dict):
        parts = {k: _unbind_blocks(v, nb) for k, v in tree.items()}
        return [{k: v[b] for k, v in parts.items()} for b in range(nb)]
    return list(tree.unbind(0))


def _stack_blocks(trees: List[Any]) -> Any:
    if isinstance(trees[0], dict):
        return {k: _stack_blocks([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees, dim=0)


def forward(
    params: Dict,
    tokens: torch.Tensor,            # (B, S) integer
    *,
    cfg: ArchConfig,
    ctx: SpmdCtx = SpmdCtx(),
    dyskew: Optional[Dict] = None,   # stacked MoE link states
    decode_state: Optional[Dict] = None,
    prefix_embeds: Optional[torch.Tensor] = None,   # (B, P, d) VLM patch stub
    ops: DispatchOps = KERNEL_OPS,
) -> Tuple[torch.Tensor, Dict]:
    """Returns (logits (B,S,V), aux) where aux carries new dyskew states,
    new decode state, and scalar metrics.  Under a model group whose
    tables are sliced the logits are this rank's columns (B,S,V/M)
    (``vocab_group``).

    MUTATES ``decode_state``: the KV caches and the SSM states are updated in
    place and the returned decode state holds the same tensors (with a new
    ``pos``).
    ``dyskew`` is not mutated; the new link states are fresh tensors.
    ``ops`` are the MoE layers' dispatch steps and the Mamba layers' state
    scan (``moe.PLAIN_OPS`` for the plain versions).
    ``prefix_embeds`` take the first P positions in place of the token
    embeddings, cast to the model dtype; a prompt shorter than P raises.
    """
    B, S = tokens.shape
    dtype = model_dtype(cfg)
    dev = tokens.device
    vocab = vocab_group(params, cfg, ctx)
    plan = fsdp.plan(model_specs(cfg), ctx)
    block_plan = fsdp.unstacked(plan["blocks"])

    embed = fsdp.gather(params["embed"], plan["embed"], ctx)
    x = basic.embed_apply(embed, tokens, dtype, vocab)
    if prefix_embeds is not None:
        P = prefix_embeds.shape[1]
        if S < P:
            raise ValueError(
                f"a prompt of {S} tokens is shorter than its {P} prefix embeddings"
            )
        x = torch.cat([prefix_embeds.to(dtype), x[:, P:]], dim=1)

    if decode_state is not None and S == 1:
        cache_index, positions = step_positions(decode_state, dev)
    elif decode_state is not None:
        # Prefill is always from position 0 (single-shot prompt ingestion).
        cache_index = 0
        positions = torch.arange(S, dtype=torch.int32, device=dev)
    else:
        positions = torch.arange(S, dtype=torch.int32, device=dev)
        cache_index = None

    period = block_period(cfg)
    nb = num_blocks(cfg)
    attn_pos = attn_layer_positions(cfg)
    mamba_pos = mamba_layer_positions(cfg)
    moe_pos = moe_layer_positions(cfg)

    def block(b: int, bp: Dict, x: torch.Tensor, moe_in: Dict):
        # Inside the checkpointed function: remat's recompute gathers
        # again, and no whole weight is saved for the backward.
        bp = fsdp.gather(bp, block_plan, ctx)
        metrics: Dict[str, torch.Tensor] = {}
        out_moe = {}
        for j in range(period):
            cache_j = None
            if decode_state is not None and j in attn_pos:
                cache_j = _take_block(decode_state[f"kv_l{j}"], b)
            elif decode_state is not None and j in mamba_pos:
                cache_j = _take_block(decode_state[f"ssm_l{j}"], b)
            x, _, new_moe = _apply_layer(
                bp[f"l{j}"], x, j, cfg=cfg, ctx=ctx, positions=positions,
                cache=cache_j, cache_index=cache_index,
                moe_state=moe_in.get(f"l{j}"), metrics=metrics, ops=ops,
            )
            if new_moe is not None:
                out_moe[f"l{j}"] = new_moe
        return x, metrics, out_moe

    # The decode state is updated in place, which a recompute would repeat:
    # remat is for the training forward only.
    remat = cfg.remat and decode_state is None and torch.is_grad_enabled()
    blocks = _unbind_blocks(params["blocks"], nb)
    moe_blocks = (_unbind_blocks(dyskew, nb) if dyskew is not None
                  else [{} for _ in range(nb)])
    block_metrics: List[Dict[str, torch.Tensor]] = []
    block_moe: List[Dict[str, Any]] = []
    for b in range(nb):
        if remat:
            # No randomness in a block: nothing to stash for the recompute.
            x, metrics, out_moe = checkpoint(
                block, b, blocks[b], x, moe_blocks[b],
                use_reentrant=False, preserve_rng_state=False,
            )
        else:
            x, metrics, out_moe = block(b, blocks[b], x, moe_blocks[b])
        block_metrics.append(metrics)
        block_moe.append(out_moe)

    with tracing.span("head"):
        x = basic.norm_apply(fsdp.gather(params["final_norm"], plan["final_norm"], ctx), x, cfg.norm)
        head = fsdp.gather(params["lm_head"], plan["lm_head"], ctx) if "lm_head" in params else embed
        logits = basic.logits_apply(head, x, cfg.vocab_size, vocab)

    aux: Dict[str, Any] = {
        "metrics": {
            k: torch.stack([m[k] for m in block_metrics]).mean()
            for k in block_metrics[0]
        } if block_metrics and block_metrics[0] else {},
    }
    if dyskew is not None:
        aux["dyskew"] = _stack_blocks(block_moe)
    if decode_state is not None:
        new_state = dict(decode_state)
        new_state["pos"] = decode_state["pos"] + S
        aux["decode_state"] = new_state
    return logits, aux


# ------------------------------------------------------------------ #
# Losses
# ------------------------------------------------------------------ #


def lm_loss(
    logits: torch.Tensor,        # (B, S, V) or this rank's (B, S, V/M)
    targets: torch.Tensor,       # (B, S) integer, -1 = masked
    z_loss: float = 1e-4,
    group: distributed.Group = None,
    vocab: distributed.Group = None,
) -> torch.Tensor:
    """Masked next-token NLL plus ``z_loss``·lse², in float32, over the
    count of unmasked targets.  With a data-parallel ``group`` the rows are
    this rank's part of the global batch: the count is the global one, and
    the value is the global loss, of which this rank's gradient is its
    share (``distributed.with_local_grad``).  With ``vocab`` (the model
    group the logits' columns are sliced over) the max, the sum of exps and
    the gold logit, (B, S) float32 each, are reduced over it: every rank
    gets the same lse and loss, and the gradient of its own columns."""
    mask = (targets >= 0).to(torch.float32)
    tgt = torch.clamp(targets, min=0).to(torch.int64)
    logits32 = logits.to(torch.float32)
    if vocab is None:
        lse = torch.logsumexp(logits32, dim=-1)
        gold = torch.gather(logits32, -1, tgt[..., None])[..., 0]
    else:
        cols = logits32.shape[-1]
        # The max only shifts the exponent: lse does not depend on it.
        top = distributed.all_max(logits32.detach().amax(dim=-1), vocab)
        col = tgt - distributed.rank_of(vocab) * cols
        mine = (col >= 0) & (col < cols)
        gold_part = torch.gather(logits32, -1, col.clamp(0, cols - 1)[..., None])[..., 0]
        sums = distributed.sum_shards(torch.stack([
            torch.exp(logits32 - top[..., None]).sum(dim=-1), torch.where(mine, gold_part, 0.0)]), vocab)
        lse = top + torch.log(sums[0])
        gold = sums[1]
    nll = (lse - gold) * mask
    zl = z_loss * torch.square(lse) * mask
    if group is None:
        denom = torch.clamp(mask.sum(), min=1.0)
        return (nll.sum() + zl.sum()) / denom
    local = nll.sum() + zl.sum()
    total, count = distributed.all_sum(torch.stack([local.detach(), mask.sum()]), group)
    return distributed.with_local_grad(total, local) / torch.clamp(count, min=1.0)
