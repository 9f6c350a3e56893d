"""Mamba-2 (SSD — state-space duality) layer.

Train/prefill uses the chunked SSD algorithm (arXiv:2405.21060): quadratic
attention-like computation inside fixed-size chunks, linear recurrent state
passing between chunks, so memory is O(chunk²) per chunk instead of O(S²).
Decode is the O(1) recurrent update.

Where ``repro`` fuses a chunk's quadratic part, its incoming-state output
and its new state into one ``lax.scan`` body, ``ssd_chunked`` here runs the
algorithm's four stages, each over all chunks at once but for the
recurrence: (a) every chunk's own output, state contribution and decay;
(b) the recurrence over chunks, in the hand-written ``ssd_state_scan``
kernel (through ``repro_torch.kernels.ssd_scan.ops.state_scan``); (c) each
chunk's output from the state entering it; (d) the final state.

It has two arms.  Without grad (serving) it writes its intermediates in
place and through ``out=``.  With grad on and an input that requires grad
(training) it computes the same products out of place, since autograd
refuses ``out=`` and in-place changes to what it saved, and the scan runs as
``StateScan``, whose backward is the hand-written ``ssd_state_scan_bwd``
kernel on the card.  Both arms round the same operations in the same order.

Under a model group (``group``) whose ``ssm_heads`` / ``mlp`` rules slice
the layer, a rank holds nh/M heads: its columns of ``w_z`` / ``w_x`` /
``conv_x`` / ``w_dt`` and its ``dt_bias`` / ``A_log`` / ``D``, its rows of
``w_out``, whose partial output ``sum_shards`` adds up.  The scan runs on
the rank's heads.  ``w_B`` / ``w_C`` / ``conv_B`` / ``conv_C`` and
``norm_scale`` stay whole, and a rank uses the B/C groups of its heads
(``mamba_heads_of``) and its part of the norm's scale, through
``to_shard``.  The gated RMSNorm's sum of squares over ``d_inner`` is
summed over the group.  The decode state holds the rank's heads and groups.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import distributed
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.config.base import ArchConfig
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.models.layers.basic import norm_apply
from repro_torch.models.param import layer_shape, spec

#: (states (C, H, P, N), decay (C, H)) → (C, H, P, N) float32 exclusive prefix.
Scan = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def _dims(cfg: ArchConfig):
    mc = cfg.mamba
    d = cfg.d_model
    di = mc.d_inner(d)
    nh = mc.num_heads(d)
    hd = mc.head_dim
    g = max(nh // 8, 1)            # B/C groups (GQA-style state sharing)
    n = mc.d_state
    return d, di, nh, hd, g, n


def mamba_specs(cfg: ArchConfig) -> Dict:
    d, di, nh, hd, g, n = _dims(cfg)
    w = cfg.mamba.conv_width
    return {
        "w_z": spec((d, di), ("embed", "mlp")),
        "w_x": spec((d, di), ("embed", "mlp")),
        "w_B": spec((d, g, n), ("embed", None, None)),
        "w_C": spec((d, g, n), ("embed", None, None)),
        "w_dt": spec((d, nh), ("embed", "ssm_heads")),
        "dt_bias": spec((nh,), ("ssm_heads",), init="zeros"),
        "A_log": spec((nh,), ("ssm_heads",), init="zeros"),
        "D": spec((nh,), ("ssm_heads",), init="ones"),
        "conv_x": spec((w, di), ("conv", "mlp"), scale=0.5),
        "conv_B": spec((w, g, n), ("conv", None, None), scale=0.5),
        "conv_C": spec((w, g, n), ("conv", None, None), scale=0.5),
        "norm_scale": spec((di,), (None,), init="ones"),
        "w_out": spec((di, d), ("mlp", "embed")),
    }


def mamba_heads_of(cfg: ArchConfig, heads: int, rank: int) -> Tuple[int, int]:
    """(first B/C group, groups) that a rank holding ``heads`` of the nh
    heads (its rank-th block) uses.  A block of heads that straddles the
    groups unevenly raises."""
    _, _, nh, _, g, _ = _dims(cfg)
    hpg = nh // g
    if heads == nh:
        return 0, g
    if heads % hpg == 0:
        return rank * heads // hpg, heads // hpg
    if hpg % heads == 0:
        return rank * heads // hpg, 1
    raise NotImplementedError(
        f"{heads} Mamba heads a rank straddle the {g} B/C groups of {hpg} heads: a layout the port has "
        "no slice for (ROADMAP.md queue A)")


def mamba_layout(cfg: ArchConfig, mesh, rules) -> Tuple[int, int, int]:
    """(heads, inner width, B/C groups) a rank of ``mesh`` (``{axis:
    size}``) uses under ``rules``; heads and width that are not sliced
    together raise."""
    d, di, nh, hd, g, n = _dims(cfg)
    specs = mamba_specs(cfg)
    heads = layer_shape(specs["w_dt"], mesh, rules)[-1]
    width = layer_shape(specs["w_x"], mesh, rules)[-1]
    if width != heads * hd:
        raise NotImplementedError(
            f"the rule table gives a rank {heads} of {nh} Mamba heads but {width} of {di} inner "
            "channels: the port slices them together (ROADMAP.md queue A)")
    return heads, width, mamba_heads_of(cfg, heads, 0)[1]


def _causal_conv(x: torch.Tensor, kernel: torch.Tensor, window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv along axis 1. x: (B, S, C), kernel: (W, C);
    the left context is ``window`` (B, W-1, C), zeros where it is None."""
    w = kernel.shape[0]
    S = x.shape[1]
    if window is None:
        pad = F.pad(x, (0, 0, w - 1, 0))
    else:
        pad = torch.cat([window.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(w):
        out = out + pad[:, i : i + S, :] * kernel[i]
    return out


def ssd_chunked(
    x: torch.Tensor,     # (B, S, H, P)
    dt: torch.Tensor,    # (B, S, H)  (post-softplus)
    A: torch.Tensor,     # (H,)  (negative)
    Bm: torch.Tensor,    # (B, S, G, N)
    Cm: torch.Tensor,    # (B, S, G, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,   # (B, H, P, N)
    scan: Optional[Scan] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD. Returns (y (B,S,H,P) in x's type, final_state (B,H,P,N)
    float32).  ``scan`` runs the recurrence over chunks; the default is
    ``ssd_ops.state_scan`` (the CUDA kernel for CUDA tensors, with its
    backward under grad)."""
    scan = ssd_ops.state_scan if scan is None else scan
    grad = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, dt, A, Bm, Cm, h0))
    Bsz, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    assert S % chunk == 0, (S, chunk)
    nc = S // chunk
    L = chunk
    f32 = torch.float32
    dev = x.device

    # Views with the heads split into (group, head in group): head h is
    # (h // hpg, h % hpg), the head_group map of ``repro``.
    xc = x.reshape(Bsz, nc, L, G, hpg, P)
    dtc = dt.reshape(Bsz, nc, L, H).to(f32)
    Bc = Bm.reshape(Bsz, nc, L, G, N)
    Cc = Cm.reshape(Bsz, nc, L, G, N)

    # ---- (a) every chunk at once: decays, own output, own state ---------- #
    da_cs = torch.cumsum(dtc * A.to(f32), dim=2)            # (B,nc,L,H)
    da_total = da_cs[:, :, -1, :]                           # (B,nc,H)

    # Intra-chunk (quadratic within chunk).  The exponent is clamped as in
    # ``repro``: entries with l < m are masked out afterwards.
    seg = da_cs.permute(0, 1, 3, 2)                         # (B,nc,H,L)
    diff = seg[..., :, None] - seg[..., None, :]            # (B,nc,H,L,M)
    CB = torch.einsum("bclgn,bcmgn->bcglm", Cc, Bc).to(f32)                # (B,nc,G,L,M)
    dt_m = dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    if grad:
        smat = (diff.clamp(max=0.0).exp().view(Bsz, nc, G, hpg, L, L) * CB[:, :, :, None])
        smat = (smat.view(Bsz, nc, H, L, L) * dt_m).tril()
    else:
        smat = diff.clamp_(max=0.0).exp_()
        smat.view(Bsz, nc, G, hpg, L, L).mul_(CB[:, :, :, None])
        smat.mul_(dt_m)
        smat.tril_()
    del CB, diff
    xh = x.reshape(Bsz, nc, L, H, P).permute(0, 1, 3, 2, 4).to(f32)        # (B,nc,H,M,P)
    y_intra = torch.matmul(smat, xh)                                       # (B,nc,H,L,P)
    del smat, xh

    # The chunk's own contribution to the state leaving it,
    #   s_c[b, h, p, n] = sum_l x[l, h, p] * w_in[l, h] * B[l, g(h), n],
    # as one product per (chunk, batch, group), written straight into the
    # scan's input in (chunk, batch * head, P, N) order.  The scan runs over
    # [h0, s_0, ..., s_{nc-1}] with decays [0, d_0, ..., d_{nc-1}]: its
    # exclusive prefix at c + 1 is then the state entering chunk c, h0
    # included, and the kernel needs no initial-state input.
    w_in = torch.exp(da_total[:, :, None, :] - da_cs) * dtc                 # (B,nc,L,H)
    x_l = xc.permute(1, 0, 3, 4, 5, 2)
    w_l = w_in.reshape(Bsz, nc, L, G, hpg).permute(1, 0, 3, 4, 2)[..., None, :]
    Bt = Bc.permute(1, 0, 3, 2, 4).to(f32).reshape(nc * Bsz * G, L, N)
    d_own = torch.exp(da_total).permute(1, 0, 2).reshape(nc, Bsz * H)
    if grad:
        xw = (x_l * w_l).reshape(nc * Bsz * G, hpg * P, L)
        first = (torch.zeros((1, Bsz * H, P, N), dtype=f32, device=dev) if h0 is None
                 else h0.reshape(1, Bsz * H, P, N).to(f32))
        states = torch.cat([first, torch.bmm(xw, Bt).view(nc, Bsz * H, P, N)])
        decay = torch.cat([d_own.new_zeros((1, Bsz * H)), d_own])
    else:
        xw = torch.empty((nc, Bsz, G, hpg, P, L), dtype=f32, device=dev)
        torch.mul(x_l, w_l, out=xw)
        states = torch.empty((nc + 1, Bsz * H, P, N), dtype=f32, device=dev)
        if h0 is None:
            states[0].zero_()
        else:
            states[0].copy_(h0.reshape(Bsz * H, P, N))
        torch.bmm(xw.view(nc * Bsz * G, hpg * P, L), Bt, out=states[1:].view(nc * Bsz * G, hpg * P, N))
        decay = torch.zeros((nc + 1, Bsz * H), dtype=f32, device=dev)
        decay[1:] = d_own
    del xw, Bt, d_own

    # ---- (b) the recurrence over chunks ---------------------------------- #
    prefix = scan(states, decay)                            # (nc+1, B*H, P, N)

    # ---- (c) each chunk's output from the state entering it -------------- #
    #   y_state[l, h, p] = exp(da_cs[l, h]) * sum_n C[l, g(h), n] * h_in[h, p, n]
    Ct = Cc.permute(1, 0, 3, 2, 4).to(f32).reshape(nc * Bsz * G, L, N)
    h_in = prefix[1:].view(nc * Bsz * G, hpg * P, N)
    y_state = torch.bmm(Ct, h_in.transpose(1, 2))          # (nc*B*G, L, hpg*P)
    del Ct
    y_state = y_state.view(nc, Bsz, G, L, hpg, P).permute(1, 0, 3, 2, 4, 5)
    y_terms = (y_intra.view(Bsz, nc, G, hpg, L, P).permute(0, 1, 4, 2, 3, 5), y_state,
               torch.exp(da_cs).view(Bsz, nc, L, G, hpg, 1))
    if grad:
        y = torch.addcmul(*y_terms).to(x.dtype).contiguous()
    else:
        y = torch.empty((Bsz, nc, L, G, hpg, P), dtype=x.dtype, device=dev)
        torch.addcmul(*y_terms, out=y)
    del y_intra, y_state, y_terms

    # ---- (d) the final state: one more step after the last chunk --------- #
    hT = torch.addcmul(states[nc], prefix[nc], decay[nc][:, None, None])
    return y.view(Bsz, S, H, P), hT.view(Bsz, H, P, N)


def mamba_apply(
    p: Dict,
    xin: torch.Tensor,                 # (B, S, d)
    *,
    cfg: ArchConfig,
    state: Optional[Dict] = None,      # decode state {"ssm", "conv_x", "conv_B", "conv_C"}
    scan: Optional[Scan] = None,
    group: distributed.Group = None,   # the model group
) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Full-sequence (train/prefill) when state is None or S > 1; single-step
    decode otherwise. Returns (y (B,S,d), new_state or None).  ``state`` is
    not mutated: the new state is made of fresh tensors.  ``scan`` goes to
    ``ssd_chunked`` (the decode step runs no scan)."""
    d, di, nh, hd, g, n = _dims(cfg)
    mc = cfg.mamba
    w = mc.conv_width
    B, S, _ = xin.shape
    dtype = xin.dtype
    f32 = torch.float32

    w_B, w_C, conv_B, conv_C, scale = p["w_B"], p["w_C"], p["conv_B"], p["conv_C"], p["norm_scale"]
    nh_all, hpg = nh, nh // g
    nh = p["w_dt"].shape[-1]                                        # this rank's heads
    sliced = nh < nh_all
    g_lo = h_lo = 0
    if sliced:
        rank = distributed.rank_of(group)
        h_lo = rank * nh
        if p["w_x"].shape[-1] != nh * hd:
            raise NotImplementedError(f"{nh} Mamba heads a rank with {p['w_x'].shape[-1]} inner channels: the "
                                      "port slices them together (ROADMAP.md queue A)")
        g_lo, g = mamba_heads_of(cfg, nh, rank)
        xin = distributed.to_shard(xin, group)
        # Whole leaves this rank uses for its heads only.
        w_B, w_C, conv_B, conv_C = (distributed.to_shard(t, group)[:, g_lo:g_lo + g]
                                    for t in (w_B, w_C, conv_B, conv_C))
        scale = distributed.to_shard(scale, group)[h_lo * hd:(h_lo + nh) * hd]
        di = nh * hd

    z = xin @ p["w_z"].to(dtype)                                   # (B,S,di)
    xproj = xin @ p["w_x"].to(dtype)                               # (B,S,di)
    Bproj = xin @ w_B.to(dtype).reshape(d, g * n)                  # (B,S,g*n)
    Cproj = xin @ w_C.to(dtype).reshape(d, g * n)
    dt = xin @ p["w_dt"].to(dtype)                                 # (B,S,nh)

    A = -torch.exp(p["A_log"].to(f32))
    dt = F.softplus(dt.to(f32) + p["dt_bias"].to(f32))
    D = p["D"].to(f32)
    conv_x = p["conv_x"].to(dtype)
    conv_B = conv_B.to(dtype).reshape(w, g * n)
    conv_C = conv_C.to(dtype).reshape(w, g * n)

    if state is None or S > 1:
        # Full-sequence path (train, or prefill seeding a decode state).
        # Conv left-context comes from the carried window (zeros at pos 0).
        st = state or {}
        xconv = F.silu(_causal_conv(xproj, conv_x, st.get("conv_x")))
        Bco = F.silu(_causal_conv(Bproj, conv_B, st.get("conv_B"))).reshape(B, S, g, n)
        Cco = F.silu(_causal_conv(Cproj, conv_C, st.get("conv_C"))).reshape(B, S, g, n)
        xh = xconv.reshape(B, S, nh, hd)
        y, hT = ssd_chunked(
            xh, dt, A, Bco, Cco, min(mc.chunk, S), h0=st.get("ssm"), scan=scan,
        )
        y = y + xh.to(f32) * D[None, None, :, None]
        if state is not None:
            # Carry conv windows (last w-1 pre-activation inputs) + state.
            def tail(win, xs):
                return torch.cat([win.to(dtype), xs], dim=1)[:, -(w - 1):, :]

            new_state = {
                "ssm": hT,
                "conv_x": tail(state["conv_x"], xproj),
                "conv_B": tail(state["conv_B"], Bproj),
                "conv_C": tail(state["conv_C"], Cproj),
            }
        else:
            new_state = None
    else:
        # Decode: roll conv windows, recurrent SSM update. S == 1.
        def conv_step(window, xt, kernel):
            # window: (B, w-1, C); xt: (B, 1, C)
            full = torch.cat([window.to(dtype), xt], dim=1)        # (B, w, C)
            out = torch.einsum("bwc,wc->bc", full, kernel)
            return full[:, 1:], out[:, None]

        cw_x, xconv = conv_step(state["conv_x"], xproj, conv_x)
        cw_B, Bco = conv_step(state["conv_B"], Bproj, conv_B)
        cw_C, Cco = conv_step(state["conv_C"], Cproj, conv_C)
        xconv = F.silu(xconv)
        Bco = F.silu(Bco).reshape(B, g, n)
        Cco = F.silu(Cco).reshape(B, g, n)
        xh = xconv.reshape(B, nh, hd)

        head_group = (h_lo + torch.arange(nh, device=xin.device)) // hpg - g_lo
        dt1 = dt[:, 0]                                             # (B,nh)
        da = torch.exp(dt1 * A)                                    # (B,nh)
        Bh = Bco[:, head_group]                                    # (B,nh,n)
        Ch = Cco[:, head_group].to(f32)
        h_prev = state["ssm"]                                      # (B,nh,hd,n)
        h_new = h_prev * da[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", Bh * dt1[..., None], xh.to(f32)
        )
        y = torch.einsum("bhpn,bhn->bhp", h_new, Ch)
        y = y + xh.to(f32) * D[None, :, None]
        y = y[:, None]                                             # (B,1,nh,hd)
        new_state = {"ssm": h_new, "conv_x": cw_x, "conv_B": cw_B, "conv_C": cw_C}

    y = y.reshape(B, S, di).to(dtype)
    y = y * F.silu(z)
    if not sliced:
        y = norm_apply({"scale": scale}, y, "rmsnorm")
        return y @ p["w_out"].to(dtype), new_state
    # The gated RMSNorm over all of d_inner: the sum of squares of the
    # rank's channels summed over the group, used for the rank's channels
    # only (its gradient summed back by ``to_shard``).
    y32 = y.to(f32)
    ss = distributed.sum_shards(torch.sum(y32 * y32, dim=-1, keepdim=True), group)
    var = distributed.to_shard(ss, group) / (nh_all * hd)
    y = (y32 * torch.rsqrt(var + 1e-6) * scale.to(f32)).to(dtype)
    return distributed.sum_shards(y @ p["w_out"].to(dtype), group), new_state


def mamba_state_init(
    cfg: ArchConfig, batch: int, dtype: torch.dtype, device: DeviceLike = None, ctx=None,
) -> Dict:
    """A layer's decode state; under ``ctx``'s model group (a
    ``moe.SpmdCtx``) the rank's heads and B/C groups."""
    d, di, nh, hd, g, n = _dims(cfg)
    if ctx is not None and ctx.ep_group is not None:
        nh, di, g = mamba_layout(cfg, ctx.mesh, ctx.rules)
    w = cfg.mamba.conv_width
    device = resolve_device(device)
    return {
        "ssm": torch.zeros((batch, nh, hd, n), dtype=torch.float32, device=device),
        "conv_x": torch.zeros((batch, w - 1, di), dtype=dtype, device=device),
        "conv_B": torch.zeros((batch, w - 1, g * n), dtype=dtype, device=device),
        "conv_C": torch.zeros((batch, w - 1, g * n), dtype=dtype, device=device),
    }
