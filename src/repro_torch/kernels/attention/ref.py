"""Plain PyTorch version of the attention kernel's arithmetic, in one pass,
and the band that holds the kernel to it element by element.

q (B, Sq, H, hd); k, v (B, Skv, K, hd), query head h reading kv head
h // (H // K).  The scores are the products of the inputs summed in float32
(float64 stays float64), times ``hd ** -0.5``; the softmax over the kept
keys is taken there; the probabilities are rounded to the working type and
their product with v is summed in float32 and rounded once.  The kernel
streams the keys with a running maximum and sum (of the unrounded
probabilities), rounds each probability before the product with v, and
divides by the sum at the end.

The band (``band``).  Let p be the exact probabilities, W = p @ |v| (per
output element) and u the working type's unit roundoff (2^-8 for bf16,
2^-11 for fp16).  Each rounding of a probability moves it by at most u of
itself, so a version that rounds them once lies within u W of the exact
sum before its output is rounded, and two such versions within 2u W of
each other; rounding the output moves it by at most u of itself.  Where n
versions of the n + 1 compared round (n = 2: the kernel against the plain
version; n = 1: the plain version against a float32 one), the outputs
differ by at most

    (1 + u) (n u + F) W + n u / (1 - u) |ref|,

F being float32's share: each score is a sum of hd products (both sides,
and the kernel's scale folded into its exponent), which moves it by at most
(2 hd + 3) eps A, A the largest scaled sum of |q_d k_d|, and a probability
by twice that on each side; the sums over n_kv keys, the exponentials and
the division add (5 n_kv + 64) eps.  eps = 2^-23, twice float32's unit
roundoff, for the tensor cores' sums.
"""

from __future__ import annotations

from typing import Optional

import torch

#: The unit roundoff of each working type: a rounding moves a value by at
#: most this share of itself.
UNIT = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
#: float32's share per operation, doubled for the tensor cores' sums.
F32_EPS = 2.0 ** -23


def scores(q: torch.Tensor, k: torch.Tensor, kv_len: int) -> torch.Tensor:
    """(B, K, G, Sq, kv_len) scaled scores in float32 (float64 stays)."""
    B, Sq, H, hd = q.shape
    K = k.shape[2]
    acc = torch.promote_types(q.dtype, torch.float32)
    qg = q.to(acc).reshape(B, Sq, K, H // K, hd)
    return torch.einsum("bqkgh,bckh->bkgqc", qg, k[:, :kv_len].to(acc)) * hd ** -0.5


def probabilities(q: torch.Tensor, k: torch.Tensor, *, causal: bool, q_offset: int = 0,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    """The softmax over the kept keys, (B, K, G, Sq, kv_len) in float32
    (float64 stays): keys ``j < kv_len``, and where causal those with
    ``j <= q_offset + i``; every query keeps at least key 0."""
    Sq = q.shape[1]
    kv_len = k.shape[1] if kv_len is None else kv_len
    s = scores(q, k, kv_len)
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)
        k_pos = torch.arange(kv_len, device=q.device)
        s = s.masked_fill(k_pos[None, :] > q_pos[:, None], float("-inf"))
    return torch.softmax(s, dim=-1)


def weighted(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(B, K, G, Sq, kv_len) weights times v's first kv_len positions,
    summed in p's type → (B, Sq, H, hd)."""
    B, K, G, Sq, kv_len = p.shape
    out = torch.einsum("bkgqc,bckh->bqkgh", p, v[:, :kv_len].to(p.dtype))
    return out.reshape(B, Sq, K * G, v.shape[-1])


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
                  q_offset: int = 0, kv_len: Optional[int] = None) -> torch.Tensor:
    """(B, Sq, H, hd) in q's type: keys ``j < kv_len`` (all of them by
    default), and where causal those with ``j <= q_offset + i``; every
    query keeps at least key 0."""
    p = probabilities(q, k, causal=causal, q_offset=q_offset, kv_len=kv_len)
    return weighted(p.to(q.dtype).to(p.dtype), v).to(q.dtype)


def band(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, ref: torch.Tensor, *, causal: bool,
         q_offset: int = 0, kv_len: Optional[int] = None, rounding: int = 2) -> torch.Tensor:
    """How far, element by element, an output may lie from ``ref`` (the
    plain version's, (B, Sq, H, hd)) when ``rounding`` of the two round
    their probabilities and outputs to q's type (the module's docstring):
    float32, (B, Sq, H, hd).  Computed a batch element at a time, so that
    the float32 probabilities of one are alive at once."""
    u = UNIT[q.dtype]
    hd = q.shape[-1]
    kv_len = k.shape[1] if kv_len is None else kv_len
    out = torch.empty(ref.shape, dtype=torch.float32, device=ref.device)
    for b in range(q.shape[0]):
        qb, kb, vb = q[b:b + 1], k[b:b + 1], v[b:b + 1]
        a = float(scores(qb.abs(), kb.abs(), kv_len).max())
        f32 = F32_EPS * (4.0 * (2 * hd + 3) * a + 5.0 * kv_len + 64.0)
        p = probabilities(qb, kb, causal=causal, q_offset=q_offset, kv_len=kv_len).float()
        w = weighted(p, vb.abs().float())
        out[b] = ((1.0 + u) * (rounding * u + f32) * w + rounding * u / (1.0 - u) * ref[b].float().abs())[0]
    return out
