"""Parameter specs with logical axis names.

Every model parameter is declared as a ``ParamSpec`` carrying its shape and
*logical* axis names ("embed", "heads", "mlp", "experts", "vocab", ...).
The names are kept so that spec trees read the same as in ``repro``; the
rule table that maps them to mesh axes is not carried over, since one card
has no mesh to shard over.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, Optional, Sequence, Tuple

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


def tree_materialize(
    tree: Any,
    generator: torch.Generator,
    dtype_override: Any = None,
    device: DeviceLike = None,
) -> Any:
    """Real initialization: normal leaves are drawn in float32 from
    ``generator`` on the generator's own device, leaf by leaf in sorted
    key order, scaled by ``scale`` or 1/sqrt(fan_in), then cast and put on
    ``device`` (a host generator gives the same weights on every device)."""
    dev = resolve_device(device)

    def make(p: ParamSpec) -> torch.Tensor:
        dt = dtype_override if dtype_override is not None else p.dtype
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dt, device=dev)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dt, device=dev)
        fan_in = p.shape[0] if len(p.shape) >= 2 else max(p.shape[-1], 1)
        scale = p.scale if p.scale is not None else 1.0 / math.sqrt(fan_in)
        draw = torch.randn(p.shape, generator=generator, dtype=torch.float32, device=generator.device)
        return (scale * draw).to(device=dev, dtype=dt)

    return tree_map(make, tree)


def tree_num_params(tree: Any) -> int:
    return sum(math.prod(p.shape) for p in tree_leaves(tree))
