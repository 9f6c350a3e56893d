"""Grouped-query attention with a chunked softmax and a KV cache.

The prefill path walks the queries in chunks, which bounds the float32
score matrix to (q_chunk × Skv) per head; the matrix products go to
``torch.einsum`` as ``repro`` leaves them to its compiler.  Decode attends
a single query step against the cache.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.config.base import ArchConfig
from repro_torch.models.layers.basic import act, apply_rope
from repro_torch.models.param import spec
from repro_torch.models.perf_flags import get_flags

NEG_INF = -1e30


def quantize_kv(x: torch.Tensor):
    raise NotImplementedError(
        "the int8 KV cache is not ported yet: ROADMAP.md queue A, "
        "'the other model families (int8 KV cache, encdec, VLM prefix)'"
    )


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


def _project_qkv(p: Dict, x: torch.Tensor, cfg: ArchConfig):
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(x.dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(x.dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(x.dtype))
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
) -> torch.Tensor:
    """Softmax attention, one query chunk at a time. Returns (B,Sq,K,G,hd).

    Scores and the softmax are float32; the probabilities are cast to the
    working type for the product with ``v``.  Where ``repro`` streams over
    kv chunks with running accumulators, each query chunk here takes one
    softmax over its whole kv range: the same function, one pass, so there
    is no kv chunk size to choose.
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
        s = torch.einsum("bqkgh,bckh->bkgqc", qblk, k[:, :n_kv]).to(torch.float32)
        mask = None
        if causal:
            mask = q_pos[:, None] >= k_pos[None, :]
        if kv_len is not None:
            live = (k_pos < kv_len)[None, :]
            mask = live if mask is None else torch.logical_and(mask, live)
        if mask is not None:
            s = s.masked_fill_(torch.logical_not(mask), NEG_INF)
        p = torch.softmax(s, dim=-1).to(qblk.dtype)
        outs.append(torch.einsum("bkgqc,bckh->bqkgh", p, v[:, :n_kv]))
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def decode_attention(
    q: torch.Tensor,             # (B, 1, K, G, hd)
    k_cache: torch.Tensor,       # (B, S, K, hd)
    v_cache: torch.Tensor,
    kv_len: int,                 # valid cache length (inclusive)
) -> torch.Tensor:
    hd = q.shape[-1]
    s = torch.einsum("bqkgh,bckh->bkgqc", q * hd ** -0.5, k_cache)
    s = s.to(torch.float32)
    pos = torch.arange(k_cache.shape[1], device=q.device)
    s = s.masked_fill_((pos >= kv_len)[None, None, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgqc,bckh->bqkgh", p, v_cache)


def attention_apply(
    p: Dict,
    x: torch.Tensor,             # (B, S, d)
    *,
    cfg: ArchConfig,
    positions: torch.Tensor,     # (S,) or (B, S)
    causal: bool = True,
    cache: Optional[Dict] = None,  # {'k','v'}
    cache_index: Optional[int] = None,              # write offset
    q_chunk: int = 512,
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Self-attention. Returns (output (B,S,d), updated cache or None).

    MUTATES ``cache``: the fresh keys and values are written into
    ``cache['k']`` / ``cache['v']`` in place at ``cache_index``, and the
    returned cache holds the same tensors.
    """
    B, S, _ = x.shape
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    G = H // K

    q, k, v = _project_qkv(p, x, cfg)
    pos_b = positions if positions.ndim == 2 else positions[None, :]
    q = apply_rope(q, pos_b, cfg.rope_theta, cfg.rope_style)
    k = apply_rope(k, pos_b, cfg.rope_theta, cfg.rope_style)

    qg = q.reshape(B, S, K, G, hd)

    new_cache = None
    if cache is not None:
        if "k_scale" in cache:
            quantize_kv(k)
        idx = cache_index if cache_index is not None else 0
        k_cache, v_cache = cache["k"], cache["v"]
        k_cache[:, idx:idx + S] = k
        v_cache[:, idx:idx + S] = v
        new_cache = {"k": k_cache, "v": v_cache}
        kv_len = idx + S
        if S == 1:
            out = decode_attention(qg, k_cache, v_cache, kv_len)
        else:
            out = chunked_attention(
                qg, k_cache, v_cache, causal=causal, q_offset=idx,
                kv_len=kv_len, q_chunk=q_chunk,
            )
    else:
        out = chunked_attention(qg, k, v, causal=causal, q_chunk=q_chunk)

    out = out.reshape(B, S, H, hd)
    y = torch.einsum("bshk,hkd->bsd", out, p["wo"].to(x.dtype))
    return y, new_cache


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


def mlp_apply(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.mlp_act in ("swiglu", "geglu"):
        inner = "silu" if cfg.mlp_act == "swiglu" else "gelu"
        h = act(inner, x @ p["w_gate"].to(x.dtype)) * (x @ p["w_up"].to(x.dtype))
    else:
        h = act(cfg.mlp_act, x @ p["w_up"].to(x.dtype))
    return h @ p["w_down"].to(x.dtype)
