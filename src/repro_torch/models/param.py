"""Parameter specs with logical axis names, and the rule table that maps
them to the mesh.

Every model parameter is declared as a ``ParamSpec`` carrying its shape and
*logical* axis names ("embed", "heads", "mlp", "experts", "vocab", ...),
as in ``repro``.  A rule table maps a logical axis to mesh axes, and
``resolve_pspec`` applies it with ``repro``'s semantics: a dimension that
its mesh axes do not divide falls back to replication (what lets MQA's
single kv head or starcoder2's 2 kv heads run on a wider model axis), and
a mesh axis is used at most once a leaf, the first named axis winning.

The port's mesh shards over its ``model`` axis only.  ``default_rules`` is
``repro``'s table with ``embed`` / ``expert_embed`` → None: FSDP over
``data`` is ``ROADMAP.md`` queue A, and a table that names another mesh
axis than ``model`` raises.  Under a model group of M ranks, rank m holds
slice m of the axis that a leaf's resolved spec puts on ``model``
(``shard_axes``, ``slice_shards``): ``experts`` of the expert stacks,
``heads`` / ``kv_heads`` of attention, ``mlp`` of the dense ffn and of
Mamba's inner width, ``vocab`` of the tables, ``ssm_heads`` of Mamba's
per-head leaves.  ``expert_rules`` is the experts-only layout
(``repro``'s H6 table less FSDP and less the vocab rule).  The router's
``experts`` axis follows ``embed`` there, and stays whole whatever the
table: its softmax and top-k need all E logits (``expert_axis``).
``tree_abstract`` builds a spec tree as ``meta`` tensors, which the
dry-run traces where ``repro`` lowers ``ShapeDtypeStruct``s: shapes and
dtypes, nothing allocated.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import torch

from repro_torch._device import DeviceLike, resolve_device

Axes = Tuple[Optional[str], ...]
MeshAxes = Union[None, str, Tuple[str, ...]]
Rules = Mapping[Optional[str], MeshAxes]


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


def default_rules() -> Dict[Optional[str], MeshAxes]:
    """``repro``'s ``default_rules(multi_pod=False)`` as the port carries
    it: every model-axis rule, and ``embed`` / ``expert_embed`` → None
    (FSDP over ``data`` is ``ROADMAP.md`` queue A)."""
    return {
        "embed": None,
        "expert_embed": None,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "ssm_heads": "model",
        "conv": None,
        None: None,
    }


def expert_rules() -> Dict[Optional[str], MeshAxes]:
    """The experts-only layout: ``experts`` → ``model`` and every other axis
    whole."""
    return {ax: (rule if ax == "experts" else None) for ax, rule in default_rules().items()}


def resolve_pspec(p: ParamSpec, mesh: Mapping[str, int], rules: Rules) -> Tuple[MeshAxes, ...]:
    """Logical axes → mesh axes a dimension (``repro``'s ``resolve_pspec``
    on a ``{mesh axis: size}`` dict): a dimension its mesh axes do not
    divide is replicated, and a mesh axis is used at most once."""
    out: List[MeshAxes] = []
    used: set = set()
    for dim, ax in zip(p.shape, p.axes):
        mesh_axes = rules.get(ax, None)
        if mesh_axes is None:
            out.append(None)
            continue
        names = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
        names = tuple(n for n in names if n in mesh and n not in used)
        size = math.prod(mesh[n] for n in names) if names else 1
        if names and dim % size == 0:
            out.append(names if len(names) > 1 else names[0])
            used.update(names)
        else:
            out.append(None)
    return tuple(out)


def expert_axis(p: ParamSpec) -> Optional[int]:
    """The axis of ``p`` that the model axis slices under ``expert_rules``:
    its ``experts`` axis where that is its leading named axis, else None."""
    named = [i for i, a in enumerate(p.axes) if a is not None]
    return named[0] if named and p.axes[named[0]] == "experts" else None


def expert_axes(tree: Any, prefix: str = "") -> Dict[str, int]:
    """{``/``-joined key path: axis} of the spec tree's leaves that the
    model axis slices under ``expert_rules``."""
    if isinstance(tree, dict):
        out: Dict[str, int] = {}
        for k in sorted(tree):
            out.update(expert_axes(tree[k], f"{prefix}{k}/"))
        return out
    axis = expert_axis(tree)
    return {} if axis is None else {prefix[:-1]: axis}


def model_axis(p: ParamSpec, model: int, rules: Rules) -> Optional[int]:
    """The axis of ``p`` that a model axis of ``model`` ranks slices under
    ``rules`` (None: the leaf is whole on every rank).  A rule naming
    another mesh axis than ``model`` raises: the port shards nothing else
    yet."""
    for ax in p.axes:
        names = rules.get(ax, None)
        names = () if names is None else (names,) if isinstance(names, str) else tuple(names)
        if any(n != "model" for n in names):
            raise NotImplementedError(
                f"the rule {ax!r} → {rules[ax]!r} names a mesh axis the port does not shard over: "
                "FSDP over the data group is ROADMAP.md queue A")
    if model == 1 or ("experts" in p.axes and expert_axis(p) is None):
        # The router: its experts axis is its output, whole on every rank.
        return None
    spec = resolve_pspec(p, {"model": model}, rules)
    return next((i for i, names in enumerate(spec) if names is not None), None)


def shard_axes(tree: Any, model: int, rules: Rules, prefix: str = "") -> Dict[str, int]:
    """{``/``-joined key path: axis} of the spec tree's leaves that a model
    axis of ``model`` ranks slices under ``rules``."""
    if isinstance(tree, dict):
        out: Dict[str, int] = {}
        for k in sorted(tree):
            out.update(shard_axes(tree[k], model, rules, f"{prefix}{k}/"))
        return out
    axis = model_axis(tree, model, rules)
    return {} if axis is None else {prefix[:-1]: axis}


def local_shape(p: ParamSpec, model: int, rules: Rules) -> Tuple[int, ...]:
    """The shape of a rank's slice of ``p``."""
    axis = model_axis(p, model, rules)
    if axis is None:
        return p.shape
    return p.shape[:axis] + (p.shape[axis] // model,) + p.shape[axis + 1:]


def take_shard(a: Any, axis: int, rank: int, size: int) -> Any:
    """Rank ``rank``'s slice of ``a`` (a tensor or an array) along
    ``axis``, of ``size`` equal slices: a view."""
    whole = a.shape[axis]
    if whole % size:
        raise ValueError(f"a model axis of {size} does not divide {whole} (axis {axis} of {tuple(a.shape)})")
    n = whole // size
    return a[(slice(None),) * axis + (slice(rank * n, (rank + 1) * n),)]


def expert_shard(a: Any, axis: int, rank: int, size: int) -> Any:
    """Rank ``rank``'s ``E/size`` experts of ``a`` along ``axis``: a view."""
    if a.shape[axis] % size:
        raise ValueError(f"a model axis of {size} does not divide {a.shape[axis]} experts")
    return take_shard(a, axis, rank, size)


def slice_shards(tree: Any, axes: Dict[str, int], rank: int, size: int, prefix: str = "") -> Any:
    """``tree`` (tensors or arrays, keyed as the spec tree of ``axes``)
    with each leaf that ``axes`` names cut to rank ``rank``'s slice along
    its axis, of a model axis of ``size`` (views); the other leaves as they
    are."""
    if isinstance(tree, dict):
        return {k: slice_shards(tree[k], axes, rank, size, f"{prefix}{k}/") for k in tree}
    axis = axes.get(prefix[:-1])
    return tree if axis is None else take_shard(tree, axis, rank, size)


def tree_materialize(
    tree: Any,
    generator: torch.Generator,
    dtype_override: Any = None,
    device: DeviceLike = None,
    shard: Tuple[int, int] = (0, 1),
    rules: Optional[Rules] = None,
) -> Any:
    """Real initialization: normal leaves are drawn in float32 from
    ``generator`` on the generator's own device, leaf by leaf in sorted
    key order, scaled by ``scale`` or 1/sqrt(fan_in), then cast and put on
    ``device`` (a host generator gives the same weights on every device).
    ``shard`` = (model rank, model axis): each leaf that ``rules``
    (default ``default_rules()``) slices is drawn whole and sliced to the
    rank's part, so a rank's shard is the slice of the one-process init at
    the same seed."""
    rules = default_rules() if rules is None else rules
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
        axis = model_axis(p, shard[1], rules)
        if axis is not None:
            out = take_shard(out, axis, *shard).clone()
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
