"""The plain decoder: the two configurations' layers from their equations.

A stack of L identical layers, each a pre-norm mixer and, where the model
has one, a pre-norm feed-forward, both added to the residual stream:

- attention: grouped-query (kv head of query head h is h // (H/K)), rotary
  positions on interleaved pairs (0, 1), (2, 3), ... at ``rope_theta``,
  causal softmax at 1/sqrt(head_dim);
- Mamba-2 (arXiv:2405.21060): z, x, B, C and dt from the input, a causal
  depthwise convolution and SiLU on x, B and C, dt = softplus(dt + bias),
  A = -exp(A_log), the state-space dual over chunks (written here in the
  paper's own minimal chunked form), D skip, gated by SiLU(z), RMS-normed
  over each B/C group's share of the inner width (the published gated
  norm's ``group_size``), projected out; one step of the recurrence when
  decoding;
- top-k MoE: softmax router in float32, the k most probable experts (ties
  to the lower id), their weights renormalised, each expert a SwiGLU, picks
  over an expert's capacity dropped (``link``).

RMSNorm is x / sqrt(mean(x²) + 1e-6) · scale.  The head is the final norm
and a product with ``lm_head`` (or the tied embedding), over the true
vocabulary.  Everything is float32; ``prec`` rounds the operands of every
matrix product for the control.  Weights are a flat ``{path: tensor}`` in
the program's tree (``lib.weights``), stacked over the layers.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from h100bench.reference import link as linkmod
from h100bench.reference.precision import Precision

F32 = torch.float32
EPS = 1e-6
Z_LOSS = 1e-4
MOE_AUX_COEF = 0.01
Q_CHUNK = 128
#: Rows a Mamba-2 prefill runs at once: the chunk matrices of a whole
#: served batch do not fit beside the rest (rows are independent there).
ROW_BLOCK = 8


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + EPS) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, n, hd); pairs (2i, 2i+1) rotated by position / theta^(2i/hd)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32, device=x.device) / hd))
    ang = positions.to(F32)[:, None] * inv                      # (S, hd/2)
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1).reshape(x.shape)


def causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution along the sequence: out[t] =
    sum_i kernel[i] · x[t - (w-1) + i], zeros before the start."""
    w, S = kernel.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, w - 1, 0))
    return sum(pad[:, i:i + S] * kernel[i] for i in range(w))


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) → (..., T, T): out[i, j] = a[j+1] + ... + a[i] for j <= i,
    -inf above the diagonal."""
    T = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones(T, T, dtype=torch.bool, device=a.device))
    return out.masked_fill(~mask, float("-inf"))


def ssd(x, dt, A, B, C, chunk, prec: Precision):
    """The chunked state-space dual (the Mamba-2 paper's minimal listing).
    x (b, s, h, p), dt (b, s, h), A (h,), B and C (b, s, g, n) with head h
    reading group h // (h/g).  Returns (y (b, s, h, p), final state
    (b, h, p, n))."""
    b, s, h, p = x.shape
    g = B.shape[2]
    B = B.repeat_interleave(h // g, dim=2)
    C = C.repeat_interleave(h // g, dim=2)
    c = s // chunk
    X = (x * dt[..., None]).reshape(b, c, chunk, h, p)
    Ad = (A * dt).reshape(b, c, chunk, h).permute(0, 3, 1, 2)          # (b, h, c, l)
    B = B.reshape(b, c, chunk, h, -1)
    C = C.reshape(b, c, chunk, h, -1)
    A_cs = torch.cumsum(Ad, dim=-1)
    # Inside each chunk: y = (C B^T ∘ decay) X.
    L = torch.exp(segsum(Ad))                                          # (b, h, c, l, m)
    CB = prec.einsum("bclhn,bcmhn->bhclm", C, B)
    y = prec.einsum("bhclm,bcmhp->bclhp", CB * L, X)
    del L, CB
    # Each chunk's own state, the recurrence over chunks, its output.
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)                    # (b, h, c, l)
    states = prec.einsum("bclhn,bhcl,bclhp->bchpn", B, decay_states, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    decay_chunk = torch.exp(segsum(F.pad(A_cs[..., -1], (1, 0))))       # (b, h, c+1, c+1)
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states, final = new_states[:, :-1], new_states[:, -1]
    y = y + prec.einsum("bclhn,bchpn,bhcl->bclhp", C, states, torch.exp(A_cs))
    return y.reshape(b, s, h, p), final


class Decoder:
    def __init__(self, model: Dict, params: Dict[str, torch.Tensor], ep_shards: int,
                 prec: Optional[Precision] = None):
        self.m = model
        self.p = params
        self.prec = prec or Precision(None)
        self.ep_shards = ep_shards
        self.L = model["num_layers"]
        self.V = model["vocab_size"]
        self.d = model["d_model"]
        self.attn = bool(model.get("num_heads", 0))
        self.moe = model.get("moe")
        self.mamba = model.get("mamba")
        self.head = params.get("lm_head/table", params["embed/table"])[: self.V]

    def w(self, name: str, l: int) -> torch.Tensor:
        return self.p["blocks/l0/" + name][l]

    # ---------------- mixers ---------------- #

    def attention(self, l: int, h: torch.Tensor, start: int, cache: Optional[Dict]) -> torch.Tensor:
        """Self-attention of h (B, S, d) at positions start.. ; with
        ``cache`` ({"k", "v"} (B, Smax, K, hd)) the new keys and values are
        written at ``start`` and the query attends over the cache."""
        P = self.prec
        B, S, _ = h.shape
        theta = float(self.m.get("rope_theta", 10000.0))
        pos = torch.arange(start, start + S, device=h.device)
        q = rope(P.einsum("bsd,dhk->bshk", h, self.w("attn/wq", l)), pos, theta)
        k = rope(P.einsum("bsd,dhk->bshk", h, self.w("attn/wk", l)), pos, theta)
        v = P.einsum("bsd,dhk->bshk", h, self.w("attn/wv", l))
        if cache is not None:
            cache["k"][:, start:start + S] = k
            cache["v"][:, start:start + S] = v
            k, v = cache["k"][:, :start + S], cache["v"][:, :start + S]
        H, K, hd = q.shape[2], k.shape[2], q.shape[3]
        k = k.repeat_interleave(H // K, dim=2)
        v = v.repeat_interleave(H // K, dim=2)
        kpos = torch.arange(k.shape[1], device=h.device)
        outs = []
        for q0 in range(0, S, Q_CHUNK):
            qb = q[:, q0:q0 + Q_CHUNK]
            s = P.einsum("bqhk,bchk->bhqc", qb * hd ** -0.5, k)
            qpos = pos[q0:q0 + Q_CHUNK]
            s = s.masked_fill(kpos[None, :] > qpos[:, None], float("-inf"))
            outs.append(P.einsum("bhqc,bchk->bqhk", torch.softmax(s, dim=-1), v))
        out = torch.cat(outs, dim=1)
        return P.einsum("bshk,hkd->bsd", out, self.w("attn/wo", l))

    def _mamba_in(self, l: int, h: torch.Tensor):
        P = self.prec
        B, S, d = h.shape
        z = P.einsum("bsd,de->bse", h, self.w("mamba/w_z", l))
        xp = P.einsum("bsd,de->bse", h, self.w("mamba/w_x", l))
        Bp = P.einsum("bsd,dgn->bsgn", h, self.w("mamba/w_B", l)).reshape(B, S, -1)
        Cp = P.einsum("bsd,dgn->bsgn", h, self.w("mamba/w_C", l)).reshape(B, S, -1)
        dt = F.softplus(P.einsum("bsd,dh->bsh", h, self.w("mamba/w_dt", l)) + self.w("mamba/dt_bias", l))
        return z, xp, Bp, Cp, dt

    def _mamba_out(self, l: int, y: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
        g = self.w("mamba/w_B", l).shape[1]
        scale = self.w("mamba/norm_scale", l).unflatten(-1, (g, -1))
        y = rmsnorm((y * F.silu(z)).unflatten(-1, (g, -1)), scale).flatten(-2)
        return self.prec.einsum("bse,ed->bsd", y, self.w("mamba/w_out", l))

    def mamba_full(self, l: int, h: torch.Tensor, want_state: bool = False):
        """The whole sequence; with ``want_state`` also the decode state
        after it (the SSM state and the last w-1 inputs of each conv)."""
        B, S, _ = h.shape
        mc = self.mamba
        g, n = self.w("mamba/w_B", l).shape[1:]
        nh = self.w("mamba/w_dt", l).shape[-1]
        z, xp, Bp, Cp, dt = self._mamba_in(l, h)
        cx = self.w("mamba/conv_x", l)
        cB = self.w("mamba/conv_B", l).reshape(cx.shape[0], -1)
        cC = self.w("mamba/conv_C", l).reshape(cx.shape[0], -1)
        xc = F.silu(causal_conv(xp, cx)).reshape(B, S, nh, -1)
        Bc = F.silu(causal_conv(Bp, cB)).reshape(B, S, g, n)
        Cc = F.silu(causal_conv(Cp, cC)).reshape(B, S, g, n)
        A = -torch.exp(self.w("mamba/A_log", l))
        y, final = ssd(xc, dt, A, Bc, Cc, min(mc["chunk"], S), self.prec)
        y = y + xc * self.w("mamba/D", l)[:, None]
        out = self._mamba_out(l, y.reshape(B, S, -1), z)
        if not want_state:
            return out, None
        w = cx.shape[0]
        return out, {"ssm": final, "x": xp[:, S - (w - 1):], "B": Bp[:, S - (w - 1):], "C": Cp[:, S - (w - 1):]}

    def mamba_step(self, l: int, h: torch.Tensor, st: Dict) -> torch.Tensor:
        """One token (B, 1, d) through the recurrence; ``st`` is updated."""
        B = h.shape[0]
        g, n = self.w("mamba/w_B", l).shape[1:]
        nh = self.w("mamba/w_dt", l).shape[-1]
        z, xp, Bp, Cp, dt = self._mamba_in(l, h)
        cx = self.w("mamba/conv_x", l)
        cB = self.w("mamba/conv_B", l).reshape(cx.shape[0], -1)
        cC = self.w("mamba/conv_C", l).reshape(cx.shape[0], -1)

        def conv(key, new, kernel):
            full = torch.cat([st[key], new], dim=1)                     # (B, w, C)
            st[key] = full[:, 1:]
            return F.silu((full * kernel).sum(dim=1))

        xc = conv("x", xp, cx).reshape(B, nh, -1)
        Bc = conv("B", Bp, cB).reshape(B, g, n).repeat_interleave(nh // g, dim=1)
        Cc = conv("C", Cp, cC).reshape(B, g, n).repeat_interleave(nh // g, dim=1)
        dt1 = dt[:, 0]
        A = -torch.exp(self.w("mamba/A_log", l))
        st["ssm"] = (st["ssm"] * torch.exp(dt1 * A)[..., None, None]
                     + (dt1[..., None, None] * xc[..., None]) * Bc[:, :, None, :])
        y = torch.einsum("bhpn,bhn->bhp", st["ssm"], Cc) + xc * self.w("mamba/D", l)[:, None]
        return self._mamba_out(l, y.reshape(B, 1, -1), z)

    # ---------------- feed-forward ---------------- #

    def swiglu(self, x, w_gate, w_up, w_down):
        P = self.prec
        return P.einsum("tf,fd->td", F.silu(P.einsum("td,df->tf", x, w_gate)) * P.einsum("td,df->tf", x, w_up),
                        w_down)

    def moe_layer(self, l: int, h: torch.Tensor, link: Dict):
        """(y, new link, readings) for h (B, S, d); every token of the call
        is one group."""
        P, mc = self.prec, self.moe
        B, S, d = h.shape
        T, E, k = B * S, mc["num_experts"], mc["top_k"]
        x = h.reshape(T, d)
        probs = torch.softmax(P.einsum("td,de->te", x, self.w("moe/router", l)), dim=-1)
        picks = torch.argsort(probs.detach(), dim=-1, descending=True, stable=True)[:, :k]
        wts = torch.gather(probs, -1, picks)
        wts = wts / torch.clamp(wts.sum(-1, keepdim=True), min=1e-9)
        loads = torch.bincount(picks.reshape(-1), minlength=E).to(F32)
        adaptive = mc.get("adaptive", True)
        new_link, distribute = linkmod.tick(link, loads, d, adaptive)
        c_static, c_buf = linkmod.capacities(mc.get("capacity_factor", 1.25), T, k, E, adaptive)
        cap = linkmod.expert_capacity(new_link["ema"], distribute, c_static, c_buf)
        keep = linkmod.kept(picks, cap)
        # Kept picks in expert order, each expert's SwiGLU on its rows.
        flat_e = picks.reshape(-1)
        flat_keep = keep.reshape(-1)
        order = torch.argsort(torch.where(flat_keep, flat_e, E), stable=True)
        counts = torch.bincount(flat_e[flat_keep], minlength=E).tolist()
        n_kept = sum(counts)
        order = order[:n_kept]
        rows = x[order // k]
        outs, at = [], 0
        for e, c in enumerate(counts):
            if c:
                outs.append(self.swiglu(rows[at:at + c], self.w("moe/w_gate", l)[e], self.w("moe/w_up", l)[e],
                                        self.w("moe/w_down", l)[e]))
            at += c
        contrib = torch.zeros((T * k, d), dtype=x.dtype, device=x.device)
        if outs:
            contrib = contrib.index_put((order,), torch.cat(outs))
        y = (contrib.reshape(T, k, d) * (wts * keep)[..., None]).sum(dim=1)
        shard_loads = loads.reshape(self.ep_shards, -1).sum(-1)
        readings = {
            "dropped": 1.0 - keep.to(F32).mean(),
            "imbalance": shard_loads.max() / torch.clamp(shard_loads.mean(), min=1.0),
            "distribute": distribute.to(F32).mean(),
            "aux": E * torch.sum(loads / torch.clamp(loads.sum(), min=1.0) * probs.mean(dim=0)),
        }
        return y.reshape(B, S, d), new_link, readings

    def ffn(self, l: int, x: torch.Tensor, link: Optional[Dict]):
        """The MoE feed-forward where the model has one; a ``link`` of None
        is a fresh one for this call (serving)."""
        if not self.moe:
            return x, link, {}
        h = rmsnorm(x, self.w("norm2/scale", l))
        fresh = link is None
        if fresh:
            link = linkmod.link_init(self.ep_shards, self.moe["num_experts"], x.device)
        y, link, r = self.moe_layer(l, h, link)
        return x + y, (None if fresh else link), r

    # ---------------- whole model ---------------- #

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.p["embed/table"][tokens.to(torch.int64)]

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        return self.prec.einsum("...d,vd->...v", rmsnorm(x, self.p["final_norm/scale"]), self.head)

    def layer(self, l: int, x: torch.Tensor, link: Optional[Dict]):
        h = rmsnorm(x, self.w("norm1/scale", l))
        x = x + (self.attention(l, h, 0, None) if self.attn else self.mamba_full(l, h)[0])
        return self.ffn(l, x, link)

    def links_init(self, device) -> Optional[List[Dict]]:
        if not self.moe:
            return None
        return [linkmod.link_init(self.ep_shards, self.moe["num_experts"], device) for _ in range(self.L)]

    def loss(self, tokens: torch.Tensor, targets: torch.Tensor, links: Optional[List[Dict]]):
        """The training loss (masked NLL + 1e-4·lse² over the unmasked
        targets, plus 0.01 × the layers' mean load-balancing loss), the new
        links and the layers' mean readings.  Each layer is recomputed in
        the backward (checkpointed), as memory needs."""
        x = self.embed(tokens)
        new_links, readings = [], []
        for l in range(self.L):
            link = links[l] if links is not None else None
            if torch.is_grad_enabled():
                x, nl, r = checkpoint(self.layer, l, x, link, use_reentrant=False)
            else:
                x, nl, r = self.layer(l, x, link)
            new_links.append(nl)
            readings.append(r)
        logits = self.logits(x)
        mask = (targets >= 0).to(F32)
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets.clamp(min=0).to(torch.int64)[..., None])[..., 0]
        loss = (((lse - gold) + Z_LOSS * lse * lse) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        mean = {}
        if readings and readings[0]:
            mean = {key: torch.stack([r[key] for r in readings]).mean() for key in readings[0]}
            loss = loss + MOE_AUX_COEF * mean["aux"]
        return loss, (new_links if links is not None else None), mean

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor, max_seq: int):
        """Prompts (B, S) in one call (a fresh link in every MoE layer):
        the last position's logits (B, V), the decode state and the layers'
        mean readings."""
        B, S = tokens.shape
        x = self.embed(tokens)
        state: List[Dict] = []
        readings = []
        for l in range(self.L):
            h = rmsnorm(x, self.w("norm1/scale", l))
            if self.attn:
                K, hd = self.w("attn/wk", l).shape[1:]
                cache = {"k": torch.zeros((B, max_seq, K, hd), dtype=F32, device=x.device),
                         "v": torch.zeros((B, max_seq, K, hd), dtype=F32, device=x.device)}
                x = x + self.attention(l, h, 0, cache)
                state.append(cache)
            else:
                parts = [self.mamba_full(l, h[r:r + ROW_BLOCK], want_state=True) for r in range(0, B, ROW_BLOCK)]
                x = x + torch.cat([o for o, _ in parts])
                state.append({k: torch.cat([st[k] for _, st in parts]) for k in parts[0][1]})
                del parts
            x, _, r = self.ffn(l, x, None)
            readings.append(r)
        return self.logits(x[:, -1]), state, _mean(readings)

    @torch.no_grad()
    def decode(self, token: torch.Tensor, state: List[Dict], pos: int):
        """One token a row (B,) at position ``pos``: (logits (B, V), the
        layers' mean readings); ``state`` is updated."""
        x = self.embed(token[:, None])
        readings = []
        for l in range(self.L):
            h = rmsnorm(x, self.w("norm1/scale", l))
            if self.attn:
                x = x + self.attention(l, h, pos, state[l])
            else:
                x = x + self.mamba_step(l, h, state[l])
            x, _, r = self.ffn(l, x, None)
            readings.append(r)
        return self.logits(x[:, 0]), _mean(readings)


def _mean(readings: List[Dict]) -> Dict:
    if not readings or not readings[0]:
        return {}
    return {key: torch.stack([r[key] for r in readings]).mean() for key in readings[0]}
