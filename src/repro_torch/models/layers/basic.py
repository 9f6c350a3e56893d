"""Norms, activations, embeddings, positional encodings."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

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


def embed_apply(p: Dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return p["table"].to(dtype)[tokens.to(torch.int64)]


def logits_apply(p: Dict, x: torch.Tensor, true_vocab: int) -> torch.Tensor:
    """Tied/untied output head; pad-vocab logits masked to the type's
    lowest finite value."""
    table = p["table"].to(x.dtype)
    logits = torch.matmul(x, table.t())
    vpad = table.shape[0]
    if vpad != true_vocab:
        # In place: at full width the logits are the largest tensor of a
        # prefill, and a second copy of them would be the peak of memory.
        # ``fill_`` with a number: an assigned number would become a tensor
        # on the host for a CUDA tensor and on the device for a ``meta``
        # one, and be written by different ops.
        logits[..., true_vocab:].fill_(torch.finfo(logits.dtype).min)
    return logits


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
