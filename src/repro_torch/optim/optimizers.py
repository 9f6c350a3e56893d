"""Optimizers: AdamW (float32 states), Adafactor (factored second moment),
SGD, plus the learning-rate schedule and global-norm clipping.

Self-contained; state trees follow the parameter tree (nested dicts of
tensors), and an update writes each parameter back in its own dtype, as
``repro.optim.optimizers`` does: there is no float32 master copy.  Every
function here works on values, under ``torch.no_grad``.

On a mesh (``Shards``) a sliced leaf holds this rank's slice of the whole
leaf along each sliced dimension: over the data axes (FSDP), the model
axis, both on two dimensions, or the fused (data, model) on one.  What
reads a whole leaf sums its slices over exactly the ranks that slice it:
the global norm (one ``all_reduce`` of the sliced leaves' sums of squares
a span, over the model group, the data group or both; the replicated
leaves are counted once, as every rank holds them whole) and Adafactor's
update RMS.  Adafactor factors over the last two dims of the WHOLE leaf
(and decides ``_factored`` on its whole shape): where a sliced dimension
is one of them, the row and column means across it are summed over the
ranks that slice it.  AdamW is element-wise and needs nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch import distributed
from repro_torch.core.ordered_sums import div
from repro_torch.models.param import Slice, slice_size, tree_leaves


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"            # adamw | adafactor | sgd
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 0.01
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    # Adafactor
    factored_dim_threshold: int = 128
    # min lr fraction for cosine decay
    min_lr_frac: float = 0.1


def zip_map(f: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``f`` over the leaves of ``tree`` and the nodes at the same keys of
    each tree in ``rest`` (which may be deeper there: a state dict at a
    parameter's place), in sorted key order."""
    if isinstance(tree, dict):
        return {k: zip_map(f, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return f(tree, *rest)


def unzip(tree: Any, like: Any, n: int) -> Tuple[Any, ...]:
    """A tree of n-tuples at the leaves of ``like`` → n trees."""
    if isinstance(like, dict):
        parts = {k: unzip(tree[k], like[k], n) for k in like}
        return tuple({k: parts[k][i] for k in like} for i in range(n))
    return tuple(tree)


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup + cosine decay."""
    step = step.to(torch.float32)
    warm = torch.clamp(div(step, max(cfg.warmup_steps, 1)), max=1.0)
    prog = torch.clamp(
        div(step - cfg.warmup_steps, max(cfg.total_steps - cfg.warmup_steps, 1)),
        0.0, 1.0,
    )
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


@dataclasses.dataclass(frozen=True)
class Shards:
    """The parameter leaves sliced over the mesh: ``leaves`` is a tree at
    the parameters' leaves of each one's ``param.leaf_slices`` (``()``:
    whole on every rank), ``mesh`` the mesh's sizes, ``group`` the data
    group (over the pod and data axes) and ``ep_group`` the model group."""

    leaves: Any
    mesh: Mapping[str, int]
    group: Any = None
    ep_group: Any = None

    def size(self, slices: Sequence[Slice]) -> int:
        """The ranks the slices of one or more dimensions span."""
        return math.prod(slice_size(axes, self.mesh) for _, axes in slices)

    def sum(self, t: torch.Tensor, slices: Sequence[Slice]) -> torch.Tensor:
        """``t`` summed over exactly the ranks that ``slices`` span (the
        model group, the data group, or both: the world), detached."""
        axes = {a for _, names in slices for a in names}
        if "model" in axes:
            t = distributed.all_sum(t, self.ep_group)
        if axes - {"model"}:
            t = distributed.all_sum(t, self.group)
        return t


def _slices(params: Any, shards: Optional[Shards]) -> Any:
    """Each parameter leaf's slices (``()`` everywhere without
    ``shards``)."""
    return shards.leaves if shards is not None else zip_map(lambda p: (), params)


def _whole_shape(p: torch.Tensor, slices: Sequence[Slice], shards: Optional[Shards]) -> Tuple[int, ...]:
    shape = list(p.shape)
    for dim, axes in slices:
        shape[dim] *= slice_size(axes, shards.mesh)
    return tuple(shape)


def _span(slices: Sequence[Slice]) -> Tuple[bool, bool]:
    """(over the data axes, over the model axis) of a leaf's slices."""
    axes = {a for _, names in slices for a in names}
    return bool(axes - {"model"}), "model" in axes


def global_norm(tree: Any, shards: Optional[Shards] = None) -> torch.Tensor:
    """The norm of the whole tree, the leaves added in tree order: a
    sliced leaf's sum of squares summed over exactly the ranks that slice
    it, once (one sum for the leaves of each span)."""
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)]
    if shards is not None:
        by_span: Dict[Tuple[bool, bool], List[Tuple[int, Tuple[Slice, ...]]]] = {}
        for i, slices in enumerate(tree_leaves(shards.leaves)):
            if slices:
                by_span.setdefault(_span(slices), []).append((i, slices))
        for _, leaves in sorted(by_span.items()):
            summed = shards.sum(torch.stack([sq[i] for i, _ in leaves]), [s for _, sl in leaves for s in sl])
            for j, (i, _) in enumerate(leaves):
                sq[i] = summed[j]
    return torch.sqrt(sum(sq))


def clip_by_global_norm(tree: Any, max_norm: float, shards: Optional[Shards] = None) -> Tuple[Any, torch.Tensor]:
    norm = global_norm(tree, shards)
    # A tensor numerator: ``float / tensor`` multiplies by the reciprocal.
    scale = torch.clamp(torch.full_like(norm, max_norm) / torch.clamp(norm, min=1e-9), max=1.0)
    return zip_map(lambda g: g * scale.to(g.dtype), tree), norm


# ---------------------------- AdamW ----------------------------------- #


def adamw_init(params: Any) -> Dict:
    def zeros32(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": zip_map(zeros32, params), "v": zip_map(zeros32, params)}


def adamw_update(
    cfg: OptimizerConfig, grads: Any, state: Dict, params: Any, step: torch.Tensor,
) -> Tuple[Any, Dict]:
    lr = lr_schedule(cfg, step)
    t = step.to(torch.float32) + 1.0
    bc1 = 1 - torch.pow(cfg.b1, t)
    bc2 = 1 - torch.pow(cfg.b2, t)

    def upd(p, g, m, v):
        g32 = g.to(torch.float32)
        m = cfg.b1 * m + (1 - cfg.b1) * g32
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g32)
        mh = m / bc1
        vh = v / bc2
        p32 = p.to(torch.float32)
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), m, v

    out = zip_map(upd, params, grads, state["m"], state["v"])
    new_p, new_m, new_v = unzip(out, params, 3)
    return new_p, {"m": new_m, "v": new_v}


# --------------------------- Adafactor -------------------------------- #


def _factored(shape: Tuple[int, ...], threshold: int) -> bool:
    return len(shape) >= 2 and shape[-1] >= threshold and shape[-2] >= threshold


def adafactor_init(params: Any, cfg: OptimizerConfig, shards: Optional[Shards] = None) -> Dict:
    def init_one(p, slices):
        shape, dev = tuple(p.shape), p.device
        if _factored(_whole_shape(p, slices, shards), cfg.factored_dim_threshold):
            return {
                "vr": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),   # row
                "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32, device=dev),
            }
        return {"v": torch.zeros(shape, dtype=torch.float32, device=dev)}

    return {"v": zip_map(init_one, params, _slices(params, shards))}


def adafactor_update(
    cfg: OptimizerConfig, grads: Any, state: Dict, params: Any, step: torch.Tensor,
    shards: Optional[Shards] = None,
) -> Tuple[Any, Dict]:
    lr = lr_schedule(cfg, step)
    t = step.to(torch.float32) + 1.0
    decay = 1.0 - torch.pow(t, -0.8)

    def mean(x, dim, across):
        """The mean over ``dim`` (None: all of ``x``); over the whole
        leaf's where ``across`` (the slices of that dimension, or of all of
        the leaf's) names any: the ranks' sums summed over them."""
        if not across:
            return torch.mean(x) if dim is None else torch.mean(x, dim=dim)
        total = shards.sum(torch.sum(x) if dim is None else torch.sum(x, dim=dim), across)
        count = x.numel() if dim is None else x.shape[dim]
        return total / float(count * shards.size(across))

    def upd(p, g, v, slices):
        g32 = torch.square(g.to(torch.float32)) + 1e-30
        last = g.ndim - 1

        def of(dim):
            return [s for s in slices if s[0] == dim]

        if "vr" in v:
            vr = decay * v["vr"] + (1 - decay) * mean(g32, -1, of(last))
            vc = decay * v["vc"] + (1 - decay) * mean(g32, -2, of(last - 1))
            rfac = vr / torch.clamp(mean(vr, -1, of(last - 1))[..., None], min=1e-30)
            precond = torch.rsqrt(torch.clamp(rfac[..., None] * vc[..., None, :], min=1e-30))
            new_v = {"vr": vr, "vc": vc}
        else:
            vv = decay * v["v"] + (1 - decay) * g32
            precond = torch.rsqrt(torch.clamp(vv, min=1e-30))
            new_v = {"v": vv}
        u = g.to(torch.float32) * precond
        # Update clipping (RMS <= 1), per Adafactor.
        rms = torch.sqrt(mean(torch.square(u), None, slices) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        p32 = p.to(torch.float32)
        delta = u + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), new_v

    out = zip_map(upd, params, grads, state["v"], _slices(params, shards))
    new_p, new_v = unzip(out, params, 2)
    return new_p, {"v": new_v}


# ---------------------------- unified --------------------------------- #


def opt_init(cfg: OptimizerConfig, params: Any, shards: Optional[Shards] = None) -> Dict:
    if cfg.name == "adamw":
        return adamw_init(params)
    if cfg.name == "adafactor":
        return adafactor_init(params, cfg, shards)
    if cfg.name == "sgd":
        return {}
    raise ValueError(cfg.name)


def opt_update(
    cfg: OptimizerConfig, grads: Any, state: Dict, params: Any, step: torch.Tensor,
    shards: Optional[Shards] = None,
) -> Tuple[Any, Dict, Dict]:
    """Returns (new_params, new_state, stats).  ``shards``: the leaves
    sliced over a model group (None: every leaf whole)."""
    grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip, shards)
    if cfg.name == "adamw":
        new_p, new_s = adamw_update(cfg, grads, state, params, step)
    elif cfg.name == "adafactor":
        new_p, new_s = adafactor_update(cfg, grads, state, params, step, shards)
    elif cfg.name == "sgd":
        lr = lr_schedule(cfg, step)
        new_p = zip_map(
            lambda p, g: (p.to(torch.float32) - lr * g.to(torch.float32)).to(p.dtype),
            params, grads,
        )
        new_s = state
    else:
        raise ValueError(cfg.name)
    return new_p, new_s, {"grad_norm": gnorm, "lr": lr_schedule(cfg, step)}
