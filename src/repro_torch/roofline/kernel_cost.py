"""The work of each hand-written kernel, from the shapes and dtypes of its
inputs alone: the record a kernel's wrapper gives an active
``op_cost.OpCounter`` in place of the ops of whichever version ran, so that
the CUDA kernel on the card and its plain version on ``meta`` or the host
are counted the same.

Bytes count each input read once and each output written once; FLOPs count
the arithmetic the kernel does on them.  ``chip_smoke.py`` takes the same
numbers for the kernels' bounds.  ``dispatch_gather`` is the one kernel
whose traffic depends on the data (it reads no row for an empty slot, and a
row once however many slots it feeds): from shapes alone every slot counts
as filled, ``S·D`` read and ``S·D`` written, plus the index and mask
bytes.  The combine's traffic depends on the data too (it reads no row for
a dropped pick): from shapes alone every pick counts as kept."""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class KernelCost:
    name: str
    flops: int
    bytes: int


def topk_gating(logits: torch.Tensor, k: int) -> KernelCost:
    """(T, E) logits read; (T, k) float32 weights and int32 ids written.
    A row: exp, subtract, divide and a sum an element, k compare rounds."""
    T, E = logits.shape
    return KernelCost("topk_gating", T * E * (4 + k), T * E * logits.element_size() + T * k * 8)


def load_histogram(ids: torch.Tensor, num_dest: int) -> KernelCost:
    """(N,) int32 ids read (the wrapper's cast is its own), (E,) float32
    counts written; one add an id."""
    n = ids.numel()
    return KernelCost("load_histogram", n, n * 4 + num_dest * 4)


def dispatch_gather(x: torch.Tensor, src: torch.Tensor) -> KernelCost:
    """Every one of the S slots filled: S rows of x read and S rows
    written, with the int32 source and bool mask of each slot."""
    S, row = src.shape[0], x.shape[1] * x.element_size()
    return KernelCost("dispatch_gather", 0, 2 * S * row + 5 * S)


def ssd_state_scan(states: torch.Tensor) -> KernelCost:
    """The exclusive prefix: the last chunk's plane and decay reach no
    output, so C - 1 planes and decays are read and C float32 planes
    written, with a multiply and an add an element read."""
    C, H, P, N = states.shape
    plane, live = H * P * N, max(C - 1, 0)
    return KernelCost(
        "ssd_state_scan", 2 * live * plane,
        live * plane * states.element_size() + live * H * 4 + C * plane * 4,
    )


def ssd_state_scan_bwd(g: torch.Tensor, states_dtype: torch.dtype) -> KernelCost:
    """g[1..C-1] and out[1..C-2] read with decay[1..C-2]; d_states (C planes
    in the states' dtype) and d_decay written.  An element of a live chunk:
    the adjoint's multiply and add and d_decay's."""
    C, H, P, N = g.shape
    plane, live = H * P * N, max(C - 2, 0)
    return KernelCost(
        "ssd_state_scan_bwd", 4 * live * plane,
        ((C - 1) + live) * plane * 4 + live * H * 4 + C * plane * states_dtype.itemsize + C * H * 4,
    )


def moe_combine(y_flat: torch.Tensor, slot_tk: torch.Tensor) -> KernelCost:
    """Every pick kept: T·k rows of y_flat read and T rows of y written,
    with each pick's int32 slot and float32 weight; a multiply and an add
    an element of a pick."""
    (T, k), d = slot_tk.shape, y_flat.shape[1]
    row = d * y_flat.element_size()
    return KernelCost("moe_combine", 2 * T * k * d, T * k * row + T * row + 8 * T * k)


def moe_combine_bwd(y_flat: torch.Tensor, slot_tk: torch.Tensor) -> KernelCost:
    """Every pick kept: dy (T rows) and T·k rows of y_flat read, all S rows
    of d_y_flat written (a kept pick's scaled dy, or zeros), each pick's
    slot and weight read and d_w written, and a byte a slot of ownership;
    d_w's multiply and add and d_y_flat's multiply an element of a pick."""
    (T, k), (S, d) = slot_tk.shape, y_flat.shape
    row = d * y_flat.element_size()
    return KernelCost("moe_combine_bwd", 3 * T * k * d,
                      T * row + T * k * row + S * row + 12 * T * k + S)


def attention(q: torch.Tensor, k: torch.Tensor, causal: bool, q_offset: int, kv_len: int) -> KernelCost:
    """The attention forward over the pairs of a query and a key it keeps
    (keys below ``kv_len``, and where causal none past the query's
    position): the score and the value products, 2 · hd FLOPs each a pair
    and head (the softmax's few operations a pair are not counted).  q read
    and the output written once; of k and v the keys some query keeps, read
    once for the heads that share them."""
    B, Sq, H, hd = q.shape
    K, e = k.shape[2], q.element_size()
    if causal:
        # Query i keeps min(kv_len, q_offset + i + 1) keys.
        lo, hi = q_offset + 1, q_offset + Sq
        c = min(max(kv_len, lo - 1), hi)
        pairs = (lo + c) * (c - lo + 1) // 2 + (hi - c) * kv_len
        n_kv = min(kv_len, hi)
    else:
        pairs, n_kv = Sq * kv_len, kv_len
    return KernelCost("attention", 4 * B * H * hd * pairs,
                      2 * B * Sq * H * hd * e + 2 * B * n_kv * K * hd * k.element_size())
