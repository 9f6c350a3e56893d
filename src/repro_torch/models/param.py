"""Parameter specs with logical axis names, and the rule table that maps
them to the mesh.

Every model parameter is declared as a ``ParamSpec`` carrying its shape and
*logical* axis names ("embed", "heads", "mlp", "experts", "vocab", ...),
as in ``repro``.  A rule table maps a logical axis to mesh axes, and
``resolve_pspec`` applies it with ``repro``'s semantics: a dimension that
its mesh axes do not divide falls back to replication (what lets MQA's
single kv head or starcoder2's 2 kv heads run on a wider model axis), and
a mesh axis is used at most once a leaf, the first named axis winning.

``default_rules`` is ``repro``'s table: FSDP of ``embed`` /
``expert_embed`` over ``data`` (``("pod", "data")`` for two pods) and the
model axis for ``experts``, ``heads`` / ``kv_heads``, ``mlp``, ``vocab``
and ``ssm_heads``.  On a mesh ``{axis: size}`` a rank holds, of each leaf,
the slices ``leaf_slices`` names: each sliced dimension with the mesh axes
it is sliced over, over ``data`` on its d_model, over ``model`` on another
dimension, over both on two dimensions, or over the fused ``(data,
model)`` on one (H6), the slice index in mixed radix, data-major
(``slice_index``).  ``shard_axes`` / ``slice_shards`` /
``tree_materialize`` cut whole leaves to a rank's slices.  The forward
gathers the data-sliced dimensions first (``models/fsdp.py``), so a layer
sees ``layer_shape``: whole over data, sliced over model.
``model_rules`` is the model axis alone (``embed`` whole) and
``expert_rules`` the experts-only layout.  The router's ``experts`` axis
stays whole whatever the table: its softmax and top-k need all E logits.
``tree_abstract`` builds a rank's leaves as ``meta`` tensors, which the
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


def default_rules(multi_pod: bool = False) -> Dict[Optional[str], MeshAxes]:
    """``repro``'s ``default_rules(multi_pod)``: FSDP of every weight's
    d_model dimension over ``data`` (``("pod", "data")`` for two pods),
    and the model axis for heads, kv heads, the ffn's width, the
    vocabulary, the experts and Mamba's heads."""
    fsdp: MeshAxes = ("pod", "data") if multi_pod else ("data",)
    return {
        "embed": fsdp,
        "expert_embed": fsdp,
        "vocab": "model",
        "heads": "model",
        "kv_heads": "model",
        "mlp": "model",
        "experts": "model",
        "ssm_heads": "model",
        "conv": None,
        None: None,
    }


def model_rules() -> Dict[Optional[str], MeshAxes]:
    """The model axis alone: ``default_rules`` with ``embed`` /
    ``expert_embed`` whole (no FSDP)."""
    return dict(default_rules(), embed=None, expert_embed=None)


def expert_rules() -> Dict[Optional[str], MeshAxes]:
    """The experts-only layout: ``experts`` → ``model`` and every other axis
    whole."""
    return {ax: (rule if ax == "experts" else None) for ax, rule in model_rules().items()}


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


#: One sliced dimension of a leaf: (dim, the mesh axes it is sliced over,
#: outermost first).  A rank holds slice ``slice_index`` of ``slice_size``.
Slice = Tuple[int, Tuple[str, ...]]
#: The data-parallel axes, outermost first: a rank's data group spans them.
DP_AXES = ("pod", "data")


def dp_part(axes: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in axes if a in DP_AXES)


def leaf_slices(p: ParamSpec, mesh: Mapping[str, int], rules: Rules) -> Tuple[Slice, ...]:
    """The dimensions of ``p`` that a rank of ``mesh`` holds a slice of
    under ``rules`` (``resolve_pspec``; a dimension over mesh axes of one
    rank in all left out), each with its mesh axes.  The router's ``experts`` axis stays whole: its
    softmax and top-k need all E logits.  A rule naming a mesh axis that
    ``mesh`` lacks raises, and so does a slice over part of the data axes
    (``data`` without ``pod``): a rank's data group spans them all."""
    for ax in p.axes:
        names = rules.get(ax, None)
        names = () if names is None else (names,) if isinstance(names, str) else tuple(names)
        missing = [n for n in names if n not in mesh]
        if missing:
            raise ValueError(f"the rule {ax!r} → {rules[ax]!r} names mesh axes {missing} that the mesh "
                             f"{dict(mesh)} lacks")
    router = "experts" in p.axes and expert_axis(p) is None
    dp = tuple(a for a in DP_AXES if mesh.get(a, 1) > 1)
    out: List[Slice] = []
    for dim, names in enumerate(resolve_pspec(p, mesh, rules)):
        if names is None or (router and p.axes[dim] == "experts"):
            continue
        names = (names,) if isinstance(names, str) else names
        if slice_size(names, mesh) == 1:
            continue
        if dp_part(names) and tuple(a for a in dp_part(names) if mesh[a] > 1) != dp:
            raise NotImplementedError(
                f"{p.axes[dim]!r} sliced over {names} on a mesh {dict(mesh)}: a rank's data group spans {dp}")
        out.append((dim, names))
    return tuple(out)


def slice_size(axes: Sequence[str], mesh: Mapping[str, int]) -> int:
    return math.prod(mesh[a] for a in axes)


def slice_index(axes: Sequence[str], mesh: Mapping[str, int], coords: Mapping[str, int]) -> int:
    """A rank's slice over ``axes``: its coordinates in mixed radix, the
    first axis outermost (``PartitionSpec(("data", "model"))`` orders a
    fused dimension ``d·M + m``)."""
    index = 0
    for a in axes:
        index = index * mesh[a] + coords.get(a, 0)
    return index


def shard_axes(tree: Any, mesh: Mapping[str, int], rules: Rules, prefix: str = "") -> Dict[str, Tuple[Slice, ...]]:
    """{``/``-joined key path: its ``leaf_slices``} of the spec tree's
    leaves that a rank of ``mesh`` holds a slice of under ``rules``."""
    if isinstance(tree, dict):
        out: Dict[str, Tuple[Slice, ...]] = {}
        for k in sorted(tree):
            out.update(shard_axes(tree[k], mesh, rules, f"{prefix}{k}/"))
        return out
    slices = leaf_slices(tree, mesh, rules)
    return {prefix[:-1]: slices} if slices else {}


def sliced_shape(shape: Sequence[int], slices: Sequence[Slice], mesh: Mapping[str, int]) -> Tuple[int, ...]:
    out = list(shape)
    for dim, axes in slices:
        out[dim] //= slice_size(axes, mesh)
    return tuple(out)


def local_shape(p: ParamSpec, mesh: Mapping[str, int], rules: Rules) -> Tuple[int, ...]:
    """The shape of a rank's slice of ``p``."""
    return sliced_shape(p.shape, leaf_slices(p, mesh, rules), mesh)


def layer_shape(p: ParamSpec, mesh: Mapping[str, int], rules: Rules) -> Tuple[int, ...]:
    """The shape a layer sees: whole over the data axes, which the forward
    gathers first (``models/fsdp.py``), a slice of what the model axis
    alone slices."""
    return sliced_shape(p.shape, [s for s in leaf_slices(p, mesh, rules) if not dp_part(s[1])], mesh)


def take_shard(a: Any, axis: int, rank: int, size: int) -> Any:
    """Rank ``rank``'s slice of ``a`` (a tensor or an array) along
    ``axis``, of ``size`` equal slices: a view."""
    whole = a.shape[axis]
    if whole % size:
        raise ValueError(f"a mesh axis of {size} does not divide {whole} (axis {axis} of {tuple(a.shape)})")
    n = whole // size
    return a[(slice(None),) * axis + (slice(rank * n, (rank + 1) * n),)]


def expert_shard(a: Any, axis: int, rank: int, size: int) -> Any:
    """Rank ``rank``'s ``E/size`` experts of ``a`` along ``axis``: a view."""
    if a.shape[axis] % size:
        raise ValueError(f"a model axis of {size} does not divide {a.shape[axis]} experts")
    return take_shard(a, axis, rank, size)


def take_slices(a: Any, slices: Sequence[Slice], mesh: Mapping[str, int], coords: Mapping[str, int]) -> Any:
    """The rank at ``coords``'s slice of ``a`` along each of ``slices``: a
    view."""
    for dim, axes in slices:
        a = take_shard(a, dim, slice_index(axes, mesh, coords), slice_size(axes, mesh))
    return a


def slice_shards(tree: Any, axes: Mapping[str, Tuple[Slice, ...]], mesh: Mapping[str, int],
                 coords: Mapping[str, int], prefix: str = "") -> Any:
    """``tree`` (tensors or arrays, keyed as the spec tree of ``axes``,
    ``shard_axes``' map) with each leaf that ``axes`` names cut to the
    rank at ``coords``'s slices (views); the other leaves as they are."""
    if isinstance(tree, dict):
        return {k: slice_shards(tree[k], axes, mesh, coords, f"{prefix}{k}/") for k in tree}
    slices = axes.get(prefix[:-1])
    return tree if not slices else take_slices(tree, slices, mesh, coords)


def tree_materialize(
    tree: Any,
    generator: torch.Generator,
    dtype_override: Any = None,
    device: DeviceLike = None,
    mesh: Optional[Mapping[str, int]] = None,
    coords: Optional[Mapping[str, int]] = None,
    rules: Optional[Rules] = None,
) -> Any:
    """Real initialization: normal leaves are drawn in float32 from
    ``generator`` on the generator's own device, leaf by leaf in sorted
    key order, scaled by ``scale`` or 1/sqrt(fan_in), then cast and put on
    ``device`` (a host generator gives the same weights on every device).
    With ``mesh`` (``{axis: size}``) each leaf that ``rules`` (default
    ``default_rules()``) slices is drawn whole and cut to the slices of the
    rank at ``coords``, so a rank's leaves are slices of the one-process
    init at the same seed."""
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
        slices = leaf_slices(p, mesh, rules) if mesh is not None else ()
        if slices:
            out = take_slices(out, slices, mesh, coords or {}).clone()
        return out.to(device=dev, dtype=dt)

    return tree_map(make, tree)


def tree_abstract(tree: Any, dtype_override: Any = None, mesh: Optional[Mapping[str, int]] = None,
                  rules: Optional[Rules] = None) -> Any:
    """``meta`` tensors of every leaf's shape (a rank's slice under
    ``mesh`` and ``rules``, as ``tree_materialize``) and dtype (or
    ``dtype_override``): no allocation, no generator."""
    rules = default_rules() if rules is None else rules

    def make(p: ParamSpec) -> torch.Tensor:
        dt = dtype_override if dtype_override is not None else p.dtype
        shape = local_shape(p, mesh, rules) if mesh is not None else p.shape
        return torch.empty(shape, dtype=dt, device="meta")

    return tree_map(make, tree)


def tree_num_params(tree: Any) -> int:
    return sum(math.prod(p.shape) for p in tree_leaves(tree))
