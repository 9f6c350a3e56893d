"""The port's mesh: one H100, axes ``data`` 1 and ``model`` 1.

``repro.launch.mesh`` lays a TPU pod out as (data 16, model 16) and two pods
as (pod 2, data 16, model 16).  One card has nothing to shard over; the
functions keep the reference's names so the dry-run reads the same.  A
layout across cards is the multi-GPU slice (``ROADMAP.md`` queue A): it
raises here rather than quietly giving one card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

_MULTI_GPU = ("a layout across several cards is the multi-GPU slice (ROADMAP.md queue A, "
              "torch.distributed on four H100s); this mesh is one card")


@dataclasses.dataclass(frozen=True)
class Mesh:
    axes: Tuple[str, ...] = ("data", "model")
    sizes: Tuple[int, ...] = (1, 1)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        raise NotImplementedError(_MULTI_GPU)
    return Mesh()


def dp_axes(multi_pod: bool) -> Tuple[str, ...]:
    if multi_pod:
        raise NotImplementedError(_MULTI_GPU)
    return ("data",)


def dp_size(mesh: Mesh) -> int:
    n = 1
    for ax in ("pod", "data"):
        n *= mesh.shape.get(ax, 1)
    return n


def model_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)
