"""Grouped-query attention with a chunked softmax and a KV cache.

The prefill path walks the queries in chunks, which bounds the float32
score matrix to (q_chunk × Skv) per head; the matrix products go to
``torch.einsum`` as ``repro`` leaves them to its compiler.  Decode attends
a single query step against the cache.

Under a model group (``group``) the layers hold what the rule table gives a
rank, and tell it from their leaves' shapes against the config's: a rank's
H/M query heads (``wq``, ``bq``, ``wo``), with its K/M kv heads where M
divides K, else the whole kv leaves of which it uses the heads its query
heads map to (``kv_heads_of``: starcoder2's 2 kv heads at M 4 give ranks 0-1
kv head 0 and ranks 2-3 kv head 1; MQA always kv head 0).  The replicated
input of the column-sharded projections, and whole kv leaves a rank uses
for its share only, go through ``to_shard``; ``wo`` is row-sharded and its
partial output summed by ``sum_shards``.  The KV cache holds the rank's kv
heads.  ``mlp_apply`` splits the ffn's width the same way (``w_gate`` /
``w_up`` by columns, ``w_down`` by rows, then ``sum_shards``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import distributed
from repro_torch.config.base import ArchConfig
from repro_torch.models.layers.basic import act, apply_rope
from repro_torch.models.param import spec
from repro_torch.models.perf_flags import get_flags

NEG_INF = -1e30


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization per (batch, pos, kv-head) vector.
    x: (B, S, K, hd) → (int8 values, float32 scales (B, S, K)).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    x32 = x.to(torch.float32)
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    q = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    # The scale is cast to the working type before the product, as repro's
    # chunked attention does.
    return q.to(dtype) * scale[..., None].to(dtype)


def attention_specs(cfg: ArchConfig) -> Dict:
    d, hd = cfg.d_model, cfg.head_dim_
    H, K = cfg.num_heads, cfg.num_kv_heads
    out = {
        "wq": spec((d, H, hd), ("embed", "heads", None)),
        "wk": spec((d, K, hd), ("embed", "kv_heads", None)),
        "wv": spec((d, K, hd), ("embed", "kv_heads", None)),
        "wo": spec((H, hd, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = spec((H, hd), ("heads", None), init="zeros")
        out["bk"] = spec((K, hd), ("kv_heads", None), init="zeros")
        out["bv"] = spec((K, hd), ("kv_heads", None), init="zeros")
    return out


def kv_heads_of(cfg: ArchConfig, heads: int, kv_width: int, rank: int) -> Tuple[int, int]:
    """(first kv head, kv heads) that a rank holding ``heads`` of the
    query heads (its rank-th block) and ``kv_width`` of the kv heads uses:
    all of them where its kv leaves are its own slice or whole with whole
    query heads, else the kv heads its query heads map to.  A rank whose
    query heads straddle kv groups unevenly raises."""
    H, K = cfg.num_heads, cfg.num_kv_heads
    G = H // K
    if heads == H or kv_width < K:
        return 0, kv_width
    if heads % G == 0:
        return rank * heads // G, heads // G
    if G % heads == 0:
        return rank * heads // G, 1
    raise NotImplementedError(
        f"{heads} query heads a rank straddle the {K} kv groups of {G} heads: a kv layout the port "
        "has no slice for (ROADMAP.md queue A)")


def _project_qkv(p: Dict, x: torch.Tensor, cfg: ArchConfig, kv: Optional[torch.Tensor] = None):
    """q from ``x``; k and v from ``kv`` (cross-attention) or ``x``."""
    src = x if kv is None else kv
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", src, p["wk"].to(src.dtype))
    v = torch.einsum("bsd,dhk->bshk", src, p["wv"].to(src.dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(x.dtype)
        k = k + p["bk"].to(x.dtype)
        v = v + p["bv"].to(x.dtype)
    return q, k, v


def _pick_chunk(n: int, target: int) -> int:
    # Largest divisor of n that is <= target (sequence lengths need not be
    # powers of two).
    for c in range(min(target, n), 0, -1):
        if n % c == 0:
            return c
    return n


def chunked_attention(
    q: torch.Tensor,              # (B, Sq, K, G, hd) grouped query heads
    k: torch.Tensor,              # (B, Skv, K, hd)
    v: torch.Tensor,              # (B, Skv, K, hd)
    *,
    causal: bool,
    q_offset: int = 0,            # absolute position of q[0]
    kv_len: Optional[int] = None,  # valid kv prefix length
    q_chunk: int = 512,
    k_scale: Optional[torch.Tensor] = None,   # (B, Skv, K) for int8 caches
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax attention, one query chunk at a time. Returns (B,Sq,K,G,hd).

    Scores and the softmax are float32; the probabilities are cast to the
    working type for the product with ``v``.  Where ``repro`` streams over
    kv chunks with running accumulators, each query chunk here takes one
    softmax over its whole kv range: the same function, one pass, so there
    is no kv chunk size to choose.  int8 ``k``/``v`` are dequantized once a
    query chunk, over the kv range that chunk reads.
    """
    B, Sq, K, G, hd = q.shape
    Skv = k.shape[1]
    q = q * hd ** -0.5
    q_chunk = _pick_chunk(Sq, q_chunk)
    # H1 (perf): kv positions beyond a causal chunk's last query are fully
    # masked — skipping them is exact.
    causal_skip = get_flags().causal_skip and causal
    k_pos_all = torch.arange(Skv, dtype=torch.int32, device=q.device)

    outs = []
    for q0 in range(0, Sq, q_chunk):
        qblk = q[:, q0:q0 + q_chunk]
        q_pos = q_offset + q0 + torch.arange(q_chunk, dtype=torch.int32, device=q.device)
        n_kv = min(Skv, q_offset + q0 + q_chunk) if causal_skip else Skv
        k_pos = k_pos_all[:n_kv]
        kblk, vblk = k[:, :n_kv], v[:, :n_kv]
        if kblk.dtype == torch.int8:
            kblk = _dequantize(kblk, k_scale[:, :n_kv], qblk.dtype)
            vblk = _dequantize(vblk, v_scale[:, :n_kv], qblk.dtype)
        s = torch.einsum("bqkgh,bckh->bkgqc", qblk, kblk).to(torch.float32)
        mask = None
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
        if kv_len is not None:
            live = (k_pos < kv_len)[None, :]
            mask = live if mask is None else torch.logical_and(mask, live)
        if mask is not None:
            s = s.masked_fill_(torch.logical_not(mask), NEG_INF)
        p = torch.softmax(s, dim=-1).to(qblk.dtype)
        outs.append(torch.einsum("bkgqc,bckh->bqkgh", p, vblk))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def decode_attention(
    q: torch.Tensor,             # (B, 1, K, G, hd)
    k_cache: torch.Tensor,       # (B, S, K, hd) — model dtype or int8
    v_cache: torch.Tensor,
    kv_len: int,                 # valid cache length (inclusive)
    k_scale: Optional[torch.Tensor] = None,   # (B, S, K) for int8 caches
    v_scale: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """One query step against the cache.  An int8 cache enters the products
    as int8 values cast to ``q``'s type, without its scales: scores scale
    linearly in k, so ``k_scale`` multiplies the float32 scores, and
    ``v_scale`` the probabilities, in ``repro``'s order."""
    hd = q.shape[-1]
    kc = k_cache.to(q.dtype) if k_cache.dtype == torch.int8 else k_cache
    s = torch.einsum("bqkgh,bckh->bkgqc", q * hd ** -0.5, kc)
    s = s.to(torch.float32)
    if k_scale is not None:
        s = s * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    pos = torch.arange(k_cache.shape[1], device=q.device)
    s = s.masked_fill_((pos >= kv_len)[None, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    vc = v_cache.to(q.dtype) if v_cache.dtype == torch.int8 else v_cache
    if v_scale is not None:
        p = p * v_scale.permute(0, 2, 1)[:, :, None, None, :].to(p.dtype)
    return torch.einsum("bkgqc,bckh->bqkgh", p, vc)


def attention_apply(
    p: Dict,
    x: torch.Tensor,             # (B, S, d)
    *,
    cfg: ArchConfig,
    positions: torch.Tensor,     # (S,) or (B, S)
    causal: bool = True,
    cache: Optional[Dict] = None,  # {'k','v'[,'k_scale','v_scale']}
    cache_index: Optional[int] = None,              # write offset
    kv: Optional[torch.Tensor] = None,  # cross-attention source (B, Skv, d)
    q_chunk: int = 512,
    group: distributed.Group = None,    # the model group
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention, or cross-attention to ``kv`` (no RoPE).  Returns
    (output (B,S,d), updated cache or None).

    MUTATES ``cache``: the fresh keys and values (int8 values and float32
    scales where the cache holds ``k_scale``) are written in place at
    ``cache_index``, and the returned cache holds the same tensors.  The
    query attends to every key written up to the end of this write: for a
    cross-attention cache that is all of ``kv``, whatever the query length
    (``repro`` attends to the first S positions only, S the query length,
    which leaves its own uncached forward when S < Skv).
    """
    B, S, _ = x.shape
    hd = cfg.head_dim_
    H = p["wq"].shape[-2]                  # this rank's query heads
    sliced = H < cfg.num_heads
    if sliced:
        rank = distributed.rank_of(group)
        lo, K = kv_heads_of(cfg, H, p["wk"].shape[-2], rank)
        x = distributed.to_shard(x, group)
        if kv is not None:
            kv = distributed.to_shard(kv, group)
        if p["wk"].shape[-2] == cfg.num_kv_heads:
            # Whole kv leaves: this rank's kv heads of them, each rank's
            # part of their gradient summed over the group.
            names = [n for n in ("wk", "wv", "bk", "bv") if n in p]
            p = dict(p, **{n: distributed.to_shard(p[n], group)[..., lo:lo + K, :] for n in names})
    else:
        K = cfg.num_kv_heads
    G = H // K

    q, k, v = _project_qkv(p, x, cfg, kv)
    if kv is None:
        pos_b = positions if positions.ndim == 2 else positions[None, :]
        q = apply_rope(q, pos_b, cfg.rope_theta, cfg.rope_style)
        k = apply_rope(k, pos_b, cfg.rope_theta, cfg.rope_style)

    qg = q.reshape(B, S, K, G, hd)

    new_cache = None
    if cache is not None:
        idx = cache_index if cache_index is not None else 0
        end = idx + k.shape[1]
        k_scale = v_scale = None
        if "k_scale" in cache:
            kq, k_scale_new = quantize_kv(k)
            vq, v_scale_new = quantize_kv(v)
            cache["k"][:, idx:end] = kq
            cache["v"][:, idx:end] = vq
            cache["k_scale"][:, idx:end] = k_scale_new
            cache["v_scale"][:, idx:end] = v_scale_new
            k_scale, v_scale = cache["k_scale"], cache["v_scale"]
        else:
            cache["k"][:, idx:end] = k
            cache["v"][:, idx:end] = v
        new_cache = dict(cache)
        k_cache, v_cache = cache["k"], cache["v"]
        if S == 1:
            out = decode_attention(qg, k_cache, v_cache, end,
                                   k_scale=k_scale, v_scale=v_scale)
        else:
            out = chunked_attention(
                qg, k_cache, v_cache, causal=causal, q_offset=idx,
                kv_len=end, q_chunk=q_chunk, k_scale=k_scale, v_scale=v_scale,
            )
    else:
        out = chunked_attention(qg, k, v, causal=causal, q_chunk=q_chunk)

    out = out.reshape(B, S, H, hd)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return (distributed.sum_shards(y, group) if sliced else y), new_cache


# ------------------------------- MLP ---------------------------------- #

def mlp_specs(cfg: ArchConfig, d_ff: Optional[int] = None) -> Dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    if cfg.mlp_act in ("swiglu", "geglu"):
        return {
            "w_gate": spec((d, f), ("embed", "mlp")),
            "w_up": spec((d, f), ("embed", "mlp")),
            "w_down": spec((f, d), ("mlp", "embed")),
        }
    return {
        "w_up": spec((d, f), ("embed", "mlp")),
        "w_down": spec((f, d), ("mlp", "embed")),
    }


def mlp_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig, group: distributed.Group = None) -> torch.Tensor:
    """The ffn; under a model group ``group`` with its width sliced, this
    rank's columns and rows, the partial output summed over the group."""
    sliced = p["w_up"].shape[-1] < cfg.d_ff
    if sliced:
        x = distributed.to_shard(x, group)
    if cfg.mlp_act in ("swiglu", "geglu"):
        inner = "silu" if cfg.mlp_act == "swiglu" else "gelu"
        h = act(inner, x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    else:
        h = act(cfg.mlp_act, x @ p["w_up"].to(x.dtype))
    y = h @ p["w_down"].to(x.dtype)
    return distributed.sum_shards(y, group) if sliced else y
