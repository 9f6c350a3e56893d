"""Optimizer-state ``ParamSpec`` trees: shapes and dtypes of the state each
parameter gets (factored Adafactor moments drop the corresponding axis).
The logical axis names are carried as in ``models/param.py``, as
``repro`` names them.  A state leaf is sliced as its parameter is
(``opt_state_slices``), not by its own axes: a factored router's column
moment keeps only the ``experts`` axis, which the router holds whole."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.param import ParamSpec, tree_map
from repro_torch.optim.optimizers import OptimizerConfig, _factored, zip_map


def opt_state_specs(cfg: OptimizerConfig, param_specs: Any) -> Any:
    if cfg.name == "adamw":
        def f32(p: ParamSpec) -> ParamSpec:
            return ParamSpec(p.shape, p.axes, "zeros", None, torch.float32)
        return {"m": tree_map(f32, param_specs), "v": tree_map(f32, param_specs)}
    if cfg.name == "adafactor":
        def fac(p: ParamSpec):
            if _factored(p.shape, cfg.factored_dim_threshold):
                return {
                    "vr": ParamSpec(p.shape[:-1], p.axes[:-1], "zeros", None, torch.float32),
                    "vc": ParamSpec(p.shape[:-2] + p.shape[-1:], p.axes[:-2] + p.axes[-1:],
                                    "zeros", None, torch.float32),
                }
            return {"v": ParamSpec(p.shape, p.axes, "zeros", None, torch.float32)}
        return {"v": tree_map(fac, param_specs)}
    if cfg.name == "sgd":
        return {}
    raise ValueError(cfg.name)


def opt_state_slices(cfg: OptimizerConfig, param_specs: Any, param_slices: Any) -> Any:
    """The slices of ``opt_state_specs``' leaves (``param.leaf_slices``' form)
    from their parameters' (``param_slices``, a tree at the parameters'
    leaves): AdamW's moments and an unfactored second moment as the
    parameter; a factored row moment without its last dimension, a column
    moment without its second to last."""
    if cfg.name == "adamw":
        return {"m": param_slices, "v": param_slices}
    if cfg.name == "adafactor":
        def fac(p: ParamSpec, slices):
            if not _factored(p.shape, cfg.factored_dim_threshold):
                return {"v": slices}
            last = len(p.shape) - 1
            return {"vr": tuple((d, ax) for d, ax in slices if d != last),
                    "vc": tuple((d if d < last - 1 else d - 1, ax) for d, ax in slices if d != last - 1)}
        return {"v": zip_map(fac, param_specs, param_slices)}
    if cfg.name == "sgd":
        return {}
    raise ValueError(cfg.name)
