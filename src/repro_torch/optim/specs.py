"""Optimizer-state ``ParamSpec`` trees: shapes and dtypes of the state each
parameter gets (factored Adafactor moments drop the corresponding axis).
The logical axis names are carried as in ``models/param.py``; there is no
mesh to map them to."""

from __future__ import annotations

from typing import Any

import torch

from repro_torch.models.param import ParamSpec, tree_map
from repro_torch.optim.optimizers import OptimizerConfig, _factored


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
