"""The system under test: the port's configuration object built from a
configuration file, and the port's kernel counters.  The drivers and this
module are the only parts of the benchmark that import ``repro_torch``."""

from __future__ import annotations

from typing import Dict

import torch


def arch_config(model: Dict):
    """The port's ``ArchConfig`` with exactly the file's ``model`` fields."""
    from repro_torch.config.base import ArchConfig, MambaConfig, MoEConfig

    kw = dict(model)
    if kw.get("moe") is not None:
        kw["moe"] = MoEConfig(**kw["moe"])
    if kw.get("mamba") is not None:
        kw["mamba"] = MambaConfig(**kw["mamba"])
    return ArchConfig(**kw)


def spmd_ctx(doc: Dict):
    """One process, one token group, ``ep_shards`` link instances."""
    from repro_torch.models.layers.moe import SpmdCtx

    return SpmdCtx(num_groups=1, num_ep_shards=int(doc["ep_shards"]))


def launch_counts() -> Dict[str, int]:
    from repro_torch import kernels

    return dict(kernels.launch_counts())


def reset_launch_counts() -> None:
    from repro_torch import kernels

    kernels.reset_launch_counts()


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
