"""Norms, activations, embeddings, positional encodings.

Under a model group whose ``vocab`` rule slices the tables, a rank holds
rows ``[m·V/M, (m+1)·V/M)`` of the (padded) vocabulary: ``embed_apply``
looks up the tokens in its rows, zeros for the others, and sums the
ranks' parts; ``logits_apply`` gives the logits of its columns, the pad
columns masked where they fall in its rows (on the last rank only); and
``gather_vocab`` joins the ranks' columns of a few positions.  A tied
table serves both."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch import distributed
from repro_torch.models.param import spec


# ----------------------------- norms --------------------------------- #

def norm_specs(d: int, kind: str) -> Dict:
    if kind == "rmsnorm":
        return {"scale": spec((d,), (None,), init="ones")}
    return {
        "scale": spec((d,), (None,), init="ones"),
        "bias": spec((d,), (None,), init="zeros"),
    }


def norm_apply(p: Dict, x: torch.Tensor, kind: str, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x32 = x.to(torch.float32)
    if kind == "rmsnorm":
        var = torch.mean(x32 * x32, dim=-1, keepdim=True)
        y = x32 * torch.rsqrt(var + eps) * p["scale"].to(torch.float32)
    else:
        mu = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.var(x32, dim=-1, keepdim=True, unbiased=False)
        y = (x32 - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(dt)


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        # repro's gelu is the tanh approximation (the jax.nn.gelu default).
        return F.gelu(x, approximate="tanh")
    if name == "silu":
        return F.silu(x)
    if name == "relu2":
        r = F.relu(x)
        return r * r
    raise ValueError(name)


# --------------------------- embeddings ------------------------------- #

def embedding_specs(vocab_padded: int, d: int) -> Dict:
    return {"table": spec((vocab_padded, d), ("vocab", "embed"), scale=1.0)}


def embed_apply(p: Dict, tokens: torch.Tensor, dtype: torch.dtype,
                group: distributed.Group = None) -> torch.Tensor:
    """The tokens' rows of the table; with ``group`` (the table is this
    rank's rows of the vocabulary) each rank's rows, zeros for the tokens
    outside them, summed over the group: one rank adds each row and the
    others exact zeros."""
    table = p["table"].to(dtype)
    tokens = tokens.to(torch.int64)
    if group is None:
        return table[tokens]
    rows = table.shape[0]
    local = tokens - distributed.rank_of(group) * rows
    inside = (local >= 0) & (local < rows)
    x = torch.where(inside[..., None], table[local.clamp(0, rows - 1)], 0.0)
    return distributed.sum_shards(x, group)


def logits_apply(p: Dict, x: torch.Tensor, true_vocab: int,
                 group: distributed.Group = None) -> torch.Tensor:
    """Tied/untied output head; pad-vocab logits masked to the type's
    lowest finite value.  With ``group`` the table is this rank's rows of
    the vocabulary and the logits its columns."""
    table = p["table"].to(x.dtype)
    rows = table.shape[0]
    first = 0
    if group is not None:
        x = distributed.to_shard(x, group)
        first = distributed.rank_of(group) * rows
    logits = torch.matmul(x, table.t())
    pad = true_vocab - first             # this rank's first pad column
    if pad < rows:
        # In place: at full width the logits are the largest tensor of a
        # prefill, and a second copy of them would be the peak of memory.
        # ``fill_`` with a number: an assigned number would become a tensor
        # on the host for a CUDA tensor and on the device for a ``meta``
        # one, and be written by different ops.
        logits[..., max(pad, 0):].fill_(torch.finfo(logits.dtype).min)
    return logits


def gather_vocab(logits: torch.Tensor, group: distributed.Group) -> torch.Tensor:
    """The ranks' columns of ``logits`` joined in rank order (one
    all-gather): the whole vocabulary's."""
    if group is None:
        return logits
    return distributed.gather_shards(logits.movedim(-1, 0), group).movedim(0, -1)


# ------------------------------ RoPE ---------------------------------- #

def rope_freqs(head_dim: int, theta: float, style: str, device=None) -> torch.Tensor:
    """Inverse frequencies. 'half' (ChatGLM 2-d RoPE) rotates only the
    first half of the head dim; 'full' rotates everything."""
    rot = head_dim if style == "full" else head_dim // 2
    exponent = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exponent)


def apply_rope(
    x: torch.Tensor,            # (..., S, n, head_dim)
    positions: torch.Tensor,    # (..., S) int32
    theta: float,
    style: str,
) -> torch.Tensor:
    """Rotates interleaved pairs (0, 1), (2, 3), ... of the head dim, as
    ``repro`` does — not the half-split layout."""
    if style == "none":
        return x
    hd = x.shape[-1]
    rot = hd if style == "full" else hd // 2
    inv = rope_freqs(hd, theta, style, device=x.device)      # (rot/2,)
    ang = positions[..., None].to(torch.float32) * inv       # (..., S, rot/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    xr = x[..., :rot].to(torch.float32)
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    rotated = torch.stack([r1, r2], dim=-1).reshape(xr.shape)
    if rot == hd:
        return rotated.to(x.dtype)
    return torch.cat([rotated.to(x.dtype), x[..., rot:]], dim=-1)
