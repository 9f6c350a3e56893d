"""Sums whose float order is fixed, so a card and a host give the same bits.

The link's decisions compare float32 sums: a sibling mean against an
instance's own count, a planned makespan against the one before, base loads
ranked against each other.  One ulp moves a comparison that sits on a tie,
and one moved comparison changes every later tick.  PyTorch does not fix
the order of its sums across devices: ``index_add_`` and
``index_put_(accumulate=True)`` on CUDA add a slot's items in a tree or by
atomics, ``sum`` over a short axis is a tree on CUDA and a loop on the
host, and CUDA divides by a Python number through its reciprocal.

``scatter_add`` and ``sum_last`` add in index order, one slot at a time,
from the slot's starting value, which is also how XLA on the host adds a
scatter and a short reduction.  ``torch.segment_reduce`` on a 2-D input
gives one thread (or one host loop) to each segment and column and walks
the segment in order, on both devices; those two functions bring their
operands into that shape.  ``sum_windows``, for one long sum, takes the
tree XLA on the host takes; ``sum_all`` adds pairwise in a fixed tree.
None of them waits for the device.
"""

from __future__ import annotations

import torch


def _segment_sums(values: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """(L, M) values in consecutive segments of ``lengths`` rows → (S, M)
    sums, each added row by row from 0."""
    return torch.segment_reduce(values, "sum", lengths=lengths, axis=0, unsafe=True)


def scatter_add(base: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``base.at[index].add(values)`` with each slot's adds in item order.

    Slot ``d`` ends as ``(((base[d] + v_i) + v_j) + ...)`` over the items
    ``i < j < ...`` with ``index == d``.  ``base`` is (n,), ``index`` and
    ``values`` (num_items,); returns a new (n,) tensor of ``base``'s dtype.
    """
    n = base.shape[0]
    slots = torch.cat([torch.arange(n, device=base.device), index.to(torch.int64)])
    vals = torch.cat([base, values.to(base.dtype)])
    # The stable sort keeps each slot's base first and its items in order.
    order = torch.argsort(slots, stable=True)
    # Integer counts add exactly in any order; unlike bincount this does
    # not ask the device for the largest slot first.
    lengths = torch.zeros(n, dtype=torch.int64, device=base.device).scatter_add_(
        0, slots, torch.ones_like(slots)
    )
    return _segment_sums(vals[order].unsqueeze(1), lengths).squeeze(1)


def sum_last(x: torch.Tensor, keepdim: bool = False) -> torch.Tensor:
    """Sum over the last axis, element 0 first, for every leading index."""
    size = x.shape[-1]
    cols = x.reshape(-1, size).transpose(0, 1).contiguous()
    lengths = torch.full((1,), size, dtype=torch.int64, device=x.device)
    out = _segment_sums(cols, lengths).reshape(x.shape[:-1])
    return out.unsqueeze(-1) if keepdim else out


def sum_all(x: torch.Tensor) -> torch.Tensor:
    """Sum of every element as a 0-dim tensor, by a pairwise tree in
    row-major order: each level adds element ``2i`` to ``2i + 1`` (an odd
    level gets a zero at its end, which adds exactly).  The tree keeps the
    error of a long sum near one rounding per level, where one run in
    order would pile up one per element."""
    flat = x.reshape(-1)
    if flat.numel() == 0:
        return flat.new_zeros(())
    while flat.numel() > 1:
        if flat.numel() % 2:
            flat = torch.cat([flat, flat.new_zeros(1)])
        flat = flat[0::2] + flat[1::2]
    return flat.reshape(())


#: The window of XLA's CPU tree-reduction rewrite.
XLA_REDUCE_WINDOW = 32


def sum_windows(x: torch.Tensor) -> torch.Tensor:
    """Sum of every element as a 0-dim tensor, in the order XLA on the host
    adds a long reduce.  XLA rewrites a reduce of more than 32 elements into
    a reduce-window of 32 with stride 32, whose zero padding is split with
    the odd zero at the end, and repeats that until at most 32 partial sums
    remain, which one plain reduce adds.  Each window and the last reduce
    add in order from 0."""
    flat = x.reshape(-1)
    w = XLA_REDUCE_WINDOW
    while flat.numel() > w:
        pad = -flat.numel() % w
        flat = torch.nn.functional.pad(flat, (pad // 2, pad - pad // 2))
        flat = sum_last(flat.reshape(-1, w))
    return sum_last(flat.reshape(1, -1)).reshape(())


def div(x: torch.Tensor, k: float) -> torch.Tensor:
    """``x / k`` rounded once, as on the host.  The divisor goes to the
    device as a tensor: CUDA multiplies by the reciprocal of a Python
    number, which differs from the quotient in the last bit."""
    return x / torch.full((), k, dtype=x.dtype, device=x.device)
