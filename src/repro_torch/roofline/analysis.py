"""Roofline terms of one step, from the op counter's totals.

Three terms per (arch × shape × mesh) cell, in seconds:

  compute    = FLOPs_global            / (chips × peak bf16 FLOP/s)
  memory     = bytes_global            / (chips × HBM bytes/s)
  collective = collective_bytes_global / (chips × NVLink bytes/s)

The port's counterpart of ``repro.roofline.analysis``, with its formulas
over the H100 constants of ``hw``.  FLOPs and bytes come from
``op_cost.trace_cost`` (global: the counter sees the whole step).  One card
runs no collective, so ``collective_bytes_global`` is 0 on the single mesh;
``collective_wire_bytes`` keeps the reference's ring model for the
multi-GPU slice, whose ``torch.distributed`` calls are still to be counted.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.roofline import hw

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16, "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1,
    "s4": 1, "u4": 1,
}

COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


def shape_bytes(dtype: str, dims: str) -> int:
    """Bytes of an array written as an HLO-style dtype and comma-separated
    dims ("bf16", "128,4096"); 0 for an unknown dtype."""
    b = _DTYPE_BYTES.get(dtype)
    if b is None:
        return 0
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * b


def collective_wire_bytes(kind: str, result_bytes: float, group: int) -> float:
    """Wire bytes a device sends for one collective of ``result_bytes`` over
    a group of ``group`` devices, ring model:

      all-reduce         2·O·(S-1)/S     (O = operand = result)
      all-gather         R·(S-1)/S
      reduce-scatter     R·(S-1)
      all-to-all         R·(S-1)/S
      collective-permute R
    """
    S = max(group, 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (S - 1) / S
    if kind == "all-gather":
        return result_bytes * (S - 1) / S
    if kind == "reduce-scatter":
        return result_bytes * (S - 1)
    if kind == "all-to-all":
        return result_bytes * (S - 1) / S
    if kind == "collective-permute":
        return float(result_bytes)
    raise ValueError(f"unknown collective {kind!r}")


@dataclasses.dataclass
class RooflineTerms:
    chips: int
    flops_global: float
    hbm_bytes_global: float
    collective_bytes_global: float
    by_kind: Dict[str, int]
    model_flops: float = 0.0

    @property
    def t_compute(self) -> float:
        return self.flops_global / (self.chips * hw.PEAK_FLOPS_BF16)

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes_global / (self.chips * hw.HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_global / (self.chips * hw.NVLINK_BW)

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.t_compute,
            "memory": self.t_memory,
            "collective": self.t_collective,
        }
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / counted FLOPs: the remat and redundancy waste."""
        if self.flops_global <= 0:
            return 0.0
        return self.model_flops / self.flops_global

    @property
    def roofline_fraction(self) -> float:
        """The dominant term over the sum of the terms: the most of the
        step bound one term can be if the terms do not overlap."""
        tot = self.t_compute + self.t_memory + self.t_collective
        if tot <= 0:
            return 0.0
        return max(self.t_compute, self.t_memory, self.t_collective) / tot

    def as_dict(self) -> Dict:
        return {
            "chips": self.chips,
            "flops_global": self.flops_global,
            "hbm_bytes_global": self.hbm_bytes_global,
            "collective_bytes_global": self.collective_bytes_global,
            "collective_by_kind": self.by_kind,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
        }


def model_flops_estimate(n_active_params: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (inference forward)."""
    mult = 6.0 if kind == "train" else 2.0
    return mult * n_active_params * tokens


def analyze(cost: Dict, chips: int, model_flops: float) -> RooflineTerms:
    """Roofline terms from ``op_cost.trace_cost``'s totals.  One card runs
    no collective: its bytes are 0 of every kind."""
    return RooflineTerms(
        chips=chips,
        flops_global=float(cost["flops"]),
        hbm_bytes_global=float(cost["bytes"]),
        collective_bytes_global=0.0,
        by_kind={k: 0 for k in COLLECTIVE_KINDS},
        model_flops=model_flops,
    )
