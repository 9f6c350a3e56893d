"""Optimizers: AdamW (float32 states), Adafactor (factored second moment),
SGD, plus the learning-rate schedule and global-norm clipping.

Self-contained; state trees follow the parameter tree (nested dicts of
tensors), and an update writes each parameter back in its own dtype, as
``repro.optim.optimizers`` does: there is no float32 master copy.  Every
function here works on values, under ``torch.no_grad``.

Under a model group (``Shards``) an expert leaf holds this rank's slice
of the whole leaf.  What reads a whole leaf sums its slices over the group:
the global norm (one ``all_reduce`` of the expert leaves' sums of squares;
the replicated leaves are counted once, as every rank holds them whole)
and Adafactor's update RMS (one ``all_reduce`` an expert leaf).  AdamW is
element-wise and needs nothing.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch import distributed
from repro_torch.core.ordered_sums import div
from repro_torch.models.param import tree_leaves


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
    """The parameter leaves sliced over a model group: ``leaves`` is a tree
    of bools at the parameters' leaves (True: this rank holds a slice),
    ``group`` the model group."""

    leaves: Any
    group: Any


def global_norm(tree: Any, shards: Optional[Shards] = None) -> torch.Tensor:
    """The norm of the whole tree, the leaves added in tree order."""
    sq = [torch.sum(torch.square(g.to(torch.float32))) for g in tree_leaves(tree)]
    if shards is not None:
        mine = [i for i, sliced in enumerate(tree_leaves(shards.leaves)) if sliced]
        if mine:
            summed = distributed.all_sum(torch.stack([sq[i] for i in mine]), shards.group)
            for j, i in enumerate(mine):
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


def adafactor_init(params: Any, cfg: OptimizerConfig) -> Dict:
    def init_one(p):
        shape, dev = tuple(p.shape), p.device
        if _factored(shape, cfg.factored_dim_threshold):
            return {
                "vr": torch.zeros(shape[:-1], dtype=torch.float32, device=dev),   # row
                "vc": torch.zeros(shape[:-2] + shape[-1:], dtype=torch.float32, device=dev),
            }
        return {"v": torch.zeros(shape, dtype=torch.float32, device=dev)}

    return {"v": zip_map(init_one, params)}


def adafactor_update(
    cfg: OptimizerConfig, grads: Any, state: Dict, params: Any, step: torch.Tensor,
    shards: Optional[Shards] = None,
) -> Tuple[Any, Dict]:
    lr = lr_schedule(cfg, step)
    t = step.to(torch.float32) + 1.0
    decay = 1.0 - torch.pow(t, -0.8)
    sliced = shards.leaves if shards is not None else zip_map(lambda p: False, params)

    def mean_square(u, whole):
        if whole:
            return torch.mean(torch.square(u))
        # A slice: the whole leaf's sum over its element count.
        total = distributed.all_sum(torch.sum(torch.square(u)), shards.group)
        return total / float(u.numel() * distributed.world_size(shards.group))

    def upd(p, g, v, part):
        g32 = torch.square(g.to(torch.float32)) + 1e-30
        if "vr" in v:
            vr = decay * v["vr"] + (1 - decay) * torch.mean(g32, dim=-1)
            vc = decay * v["vc"] + (1 - decay) * torch.mean(g32, dim=-2)
            rfac = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True), min=1e-30)
            precond = torch.rsqrt(torch.clamp(rfac[..., None] * vc[..., None, :], min=1e-30))
            new_v = {"vr": vr, "vc": vc}
        else:
            vv = decay * v["v"] + (1 - decay) * g32
            precond = torch.rsqrt(torch.clamp(vv, min=1e-30))
            new_v = {"v": vv}
        u = g.to(torch.float32) * precond
        # Update clipping (RMS <= 1), per Adafactor.
        rms = torch.sqrt(mean_square(u, not part) + 1e-30)
        u = u / torch.clamp(rms, min=1.0)
        p32 = p.to(torch.float32)
        delta = u + cfg.weight_decay * p32
        return (p32 - lr * delta).to(p.dtype), new_v

    out = zip_map(upd, params, grads, state["v"], sliced)
    new_p, new_v = unzip(out, params, 2)
    return new_p, {"v": new_v}


# ---------------------------- unified --------------------------------- #


def opt_init(cfg: OptimizerConfig, params: Any) -> Dict:
    if cfg.name == "adamw":
        return adamw_init(params)
    if cfg.name == "adafactor":
        return adafactor_init(params, cfg)
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
