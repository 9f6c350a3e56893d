"""FSDP's gathers in the forward: the leaves a rank holds sliced over the
data axes, made whole before a layer uses them.

Under a rule table that puts ``embed`` / ``expert_embed`` on ``data`` (or
``("pod", "data")``, ``repro``'s ``default_rules``) a rank holds a slice
of every weight's d_model dimension (``param.leaf_slices``).  ``plan``
names, for each leaf of a spec tree, its dimension sliced over the data
axes with those axes, and ``gather`` all-gathers each such leaf over the
data group (``distributed.gather_fsdp``, whose backward reduce-scatters the
gradient to the rank's slice).  A dimension sliced over the fused ``(data,
model)`` (H6) is gathered over the world in mesh order.  What the model
axis alone slices stays sliced: the layers run on their part of it.
"""

from __future__ import annotations

from typing import Any

from repro_torch import distributed
from repro_torch.models.param import dp_part, leaf_slices, tree_map


def plan(specs: Any, ctx) -> Any:
    """The tree of ``specs`` with, at each leaf, its slices over the data
    axes under ``ctx``'s mesh and rules (``()``: the leaf is whole over
    them)."""
    mesh = ctx.mesh
    return tree_map(lambda p: tuple(s for s in leaf_slices(p, mesh, ctx.rules) if dp_part(s[1])), specs)


def unstacked(slices: Any) -> Any:
    """``plan``'s slices of a block stack as a block's (the leading block
    axis dropped)."""
    return tree_map(lambda leaf: tuple((dim - 1, axes) for dim, axes in leaf), slices)


def gather(tree: Any, slices: Any, ctx) -> Any:
    """``tree`` with each leaf that ``slices`` (``plan``'s, at the same
    keys) names gathered whole over the data axes."""
    if isinstance(tree, dict):
        return {k: gather(tree[k], slices[k], ctx) for k in tree}
    for dim, axes in slices:
        if "model" in axes:
            if ctx.world_group is None:
                raise ValueError(f"a dimension sliced over {axes} needs SpmdCtx.world_group")
            tree = distributed.gather_fsdp(tree, dim, ctx.data_group, ctx.world_group)
        else:
            tree = distributed.gather_fsdp(tree, dim, ctx.data_group)
    return tree
