"""Parameter specs with logical axis names.

Every model parameter is declared as a ``ParamSpec`` carrying its shape and
*logical* axis names ("embed", "heads", "mlp", "experts", "vocab", ...).
The names are kept so that spec trees read the same as in ``repro``.  Of
the rule table that maps them to mesh axes (``repro``'s ``default_rules``)
the port carries one rule, ``experts`` → ``model``: a leaf whose leading
named axis is ``experts`` (a stack of per-expert matrices: ``w_gate``,
``w_up``, ``w_down``) is sliced over the mesh's model axis, rank m holding
experts ``[m·E/M, (m+1)·E/M)`` (``expert_axes``, ``slice_experts``).  The
router's ``experts`` axis is its output, and stays whole on every rank: its
softmax and top-k need all E logits.  The other rules (heads, mlp, vocab;
``embed`` FSDP over ``data``) are ``ROADMAP.md`` queue A.  ``tree_abstract`` builds a spec tree as
``meta`` tensors, which the dry-run traces where ``repro`` lowers
``ShapeDtypeStruct``s: shapes and dtypes, nothing allocated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch._device import DeviceLike, resolve_device

Axes = Tuple[Optional[str], ...]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Axes
    init: str = "normal"            # normal | zeros | ones
    scale: Optional[float] = None   # default: 1/sqrt(fan_in)
    dtype: Any = torch.float32

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def spec(shape: Sequence[int], axes: Sequence[Optional[str]], *,
         init: str = "normal", scale: Optional[float] = None,
         dtype: Any = torch.float32) -> ParamSpec:
    return ParamSpec(tuple(shape), tuple(axes), init, scale, dtype)


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def tree_map(f: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``f`` to every leaf of a nested dict, visiting keys in sorted
    order (so that anything drawn from a generator is drawn in one order)."""
    if isinstance(tree, dict):
        return {k: tree_map(f, tree[k]) for k in sorted(tree)}
    return f(tree)


def tree_leaves(tree: Any) -> List[Any]:
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def expert_axis(p: ParamSpec) -> Optional[int]:
    """The axis of ``p`` that the model axis slices: its ``experts`` axis
    where that is its leading named axis, else None."""
    named = [i for i, a in enumerate(p.axes) if a is not None]
    return named[0] if named and p.axes[named[0]] == "experts" else None


def expert_axes(tree: Any, prefix: str = "") -> Dict[str, int]:
    """{``/``-joined key path: axis} of the spec tree's leaves that the
    model axis slices."""
    if isinstance(tree, dict):
        out: Dict[str, int] = {}
        for k in sorted(tree):
            out.update(expert_axes(tree[k], f"{prefix}{k}/"))
        return out
    axis = expert_axis(tree)
    return {} if axis is None else {prefix[:-1]: axis}


def expert_shard(a: Any, axis: int, rank: int, size: int) -> Any:
    """Rank ``rank``'s ``E/size`` experts of ``a`` (a tensor or an array)
    along ``axis``: a view."""
    experts = a.shape[axis]
    if experts % size:
        raise ValueError(f"a model axis of {size} does not divide {experts} experts")
    n = experts // size
    return a[(slice(None),) * axis + (slice(rank * n, (rank + 1) * n),)]


def slice_experts(tree: Any, axes: Dict[str, int], rank: int, size: int, prefix: str = "") -> Any:
    """``tree`` (tensors or arrays, keyed as the spec tree of ``axes``)
    with each leaf that ``axes`` names cut to rank ``rank``'s experts of a
    model axis of ``size`` (views); the other leaves as they are."""
    if isinstance(tree, dict):
        return {k: slice_experts(tree[k], axes, rank, size, f"{prefix}{k}/") for k in tree}
    axis = axes.get(prefix[:-1])
    return tree if axis is None else expert_shard(tree, axis, rank, size)


def tree_materialize(
    tree: Any,
    generator: torch.Generator,
    dtype_override: Any = None,
    device: DeviceLike = None,
    shard: Tuple[int, int] = (0, 1),
) -> Any:
    """Real initialization: normal leaves are drawn in float32 from
    ``generator`` on the generator's own device, leaf by leaf in sorted
    key order, scaled by ``scale`` or 1/sqrt(fan_in), then cast and put on
    ``device`` (a host generator gives the same weights on every device).
    ``shard`` = (model rank, model axis): each expert leaf is drawn whole
    and sliced to the rank's experts, so a rank's shard is the slice of
    the one-process init at the same seed."""
    dev = resolve_device(device)

    def make(p: ParamSpec) -> torch.Tensor:
        dt = dtype_override if dtype_override is not None else p.dtype
        if p.init == "zeros":
            out = torch.zeros(p.shape, dtype=dt, device=dev)
        elif p.init == "ones":
            out = torch.ones(p.shape, dtype=dt, device=dev)
        else:
            fan_in = p.shape[0] if len(p.shape) >= 2 else max(p.shape[-1], 1)
            scale = p.scale if p.scale is not None else 1.0 / math.sqrt(fan_in)
            out = scale * torch.randn(p.shape, generator=generator, dtype=torch.float32, device=generator.device)
        axis = expert_axis(p)
        if axis is not None and shard[1] > 1:
            out = expert_shard(out, axis, *shard).clone()
        return out.to(device=dev, dtype=dt)

    return tree_map(make, tree)


def tree_abstract(tree: Any, dtype_override: Any = None) -> Any:
    """``meta`` tensors of every leaf's shape and dtype (or
    ``dtype_override``): no allocation, no generator."""
    def make(p: ParamSpec) -> torch.Tensor:
        dt = dtype_override if dtype_override is not None else p.dtype
        return torch.empty(p.shape, dtype=dt, device="meta")

    return tree_map(make, tree)


def tree_num_params(tree: Any) -> int:
    return sum(math.prod(p.shape) for p in tree_leaves(tree))
