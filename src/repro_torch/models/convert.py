"""Carry parameter and state trees across from numpy.

``repro`` keeps parameters, DySkew link state and decode state as nested
dicts of arrays; pulled to the host they are nested dicts of numpy arrays
with the same keys and shapes as the port's trees (the MoE links' state
machines aside, which the port does not carry), so carrying them across
is one copy per leaf.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.models.param import tree_map


def _is_bfloat16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def params_from_numpy(tree: Any, device: DeviceLike = None, dtype: Any = torch.float32) -> Any:
    """Nested dict of numpy arrays → nested dict of tensors of ``dtype`` on
    ``device``.  numpy has no bfloat16 of its own, so every leaf goes
    through float32 (exact for bfloat16 and float16 values)."""
    dev = resolve_device(device)

    def leaf(a: Any) -> torch.Tensor:
        a32 = np.array(a, dtype=np.float32, order="C")
        return torch.from_numpy(a32).to(device=dev, dtype=dtype)

    return tree_map(leaf, tree)


def state_from_numpy(tree: Any, device: DeviceLike = None) -> Any:
    """Nested dict of numpy arrays → tensors on ``device`` with each leaf's
    own type: int32 stays int32, int8 int8 (an int8 KV cache), float32
    float32, bool bool; a bfloat16 leaf (an extension type in numpy) goes
    through float32 and is cast back."""
    dev = resolve_device(device)

    def leaf(a: Any) -> torch.Tensor:
        a = np.asarray(a)
        if _is_bfloat16(a):
            t = torch.from_numpy(np.array(a, dtype=np.float32, order="C"))
            return t.to(device=dev, dtype=torch.bfloat16)
        return torch.from_numpy(np.array(a, order="C")).to(dev)

    return tree_map(leaf, tree)
