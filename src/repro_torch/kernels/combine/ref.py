"""Plain PyTorch versions of the MoE combine: the loop the port has always
run (``moe_combine_ref``, the CPU's combine and ``PLAIN_OPS``'s), and the
CUDA kernels' contract (``moe_combine_contract`` and
``moe_combine_bwd_ref``), which the card checks hold the kernels to.

All take ``y_flat`` (S, d), the expert outputs by slot; ``slot_tk`` (T, k),
each pick's slot, ``S`` where the pick was dropped; ``gate_w`` (T, k), the
picks' gate weights.  A kept slot belongs to one pick.
"""

from __future__ import annotations

from typing import Tuple

import torch


def moe_combine_ref(y_flat: torch.Tensor, slot_tk: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """(T, d) in y_flat's type: for each pick in order, the output plus the
    gathered row times the weight cast to y_flat's type, each product and
    sum rounded to that type.  A dropped pick's weight is 0 and its row the
    last slot's (unrolled over k to bound the gathers' temporaries)."""
    S = y_flat.shape[0]
    T, k = slot_tk.shape
    keep = slot_tk < S
    y = torch.zeros((T, y_flat.shape[1]), dtype=y_flat.dtype, device=y_flat.device)
    for j in range(k):
        sj = torch.clamp(slot_tk[:, j], max=S - 1)
        wj = (gate_w[:, j] * keep[:, j]).to(y_flat.dtype)
        y = y + y_flat[sj] * wj[:, None]
    return y


def _kept(y_flat: torch.Tensor, slot_tk: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keep, a slot to gather for every pick: its own where kept, else 0)."""
    keep = (slot_tk >= 0) & (slot_tk < y_flat.shape[0])
    return keep, torch.where(keep, slot_tk, 0).to(torch.int64)


def moe_combine_contract(y_flat: torch.Tensor, slot_tk: torch.Tensor, gate_w: torch.Tensor) -> torch.Tensor:
    """What the forward kernel computes: ``y[t] = sum_j w[t, j] *
    y_flat[slot[t, j]]`` over the kept picks, in pick order, in float32
    (float64 stays float64) with each product and sum rounded there, then
    rounded once to y_flat's type.  A dropped pick adds nothing.  In float32
    and float64 this is ``moe_combine_ref`` bit for bit (the loop adds an
    exact zero for a dropped pick), wherever ``y_flat`` is finite.
    Differentiable: autograd gives the slots' gradient the kernel's bits."""
    acc = torch.promote_types(y_flat.dtype, torch.float32)
    T, k = slot_tk.shape
    y = torch.zeros((T, y_flat.shape[1]), dtype=acc, device=y_flat.device)
    if y_flat.shape[0] == 0:
        return y.to(y_flat.dtype)
    keep, safe = _kept(y_flat, slot_tk)
    w = gate_w.to(acc)
    for j in range(k):
        term = y_flat[safe[:, j]].to(acc) * w[:, j, None]
        y = torch.where(keep[:, j, None], y + term, y)
    return y.to(y_flat.dtype)


def moe_combine_bwd_ref(
    dy: torch.Tensor, y_flat: torch.Tensor, slot_tk: torch.Tensor, gate_w: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """What the backward kernel computes, from the contract's derivative:
    ``d_y_flat[s] = w[t, j] * dy[t]`` (in float32, rounded once to y_flat's
    type) for the pick (t, j) that owns slot s, 0 for a slot no pick owns;
    ``d_w[t, j] = <dy[t], y_flat[slot[t, j]]>`` summed in float32, 0 for a
    dropped pick.  Returns ``(d_y_flat (S, d), d_w (T, k))``, d_w in the
    accumulation type (float32, or float64)."""
    acc = torch.promote_types(y_flat.dtype, torch.float32)
    (S, d), (T, k) = y_flat.shape, slot_tk.shape
    keep, safe = _kept(y_flat, slot_tk)
    g = dy.to(acc)
    # Row S parks the dropped picks' writes and is cut off.
    d_y_flat = torch.zeros((S + 1, d), dtype=y_flat.dtype, device=y_flat.device)
    dest = torch.where(keep, slot_tk.to(torch.int64), S).reshape(-1)
    d_y_flat[dest] = (g[:, None, :] * gate_w.to(acc)[:, :, None]).to(y_flat.dtype).reshape(T * k, d)
    if S == 0:
        return d_y_flat[:S], torch.zeros((T, k), dtype=acc, device=y_flat.device)
    rows = y_flat[safe.reshape(-1)].reshape(T, k, d).to(acc)
    d_w = torch.where(keep, (rows * g[:, None, :]).sum(dim=-1), 0.0)
    return d_y_flat[:S], d_w
