"""The numbers ``correct`` is decided by, each against its limit.

Training (the program's first steps against the reference's on the same
rows):

- ``loss_gap``: the largest relative gap of a step's loss.
- ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient as the optimizer got it (the program's from its first moment
  after one step, m / (1 - b1)), over the larger of the reference's norm of
  that leaf and of the median leaf.
- ``change_gap``: the same for the norm of each leaf's change over the
  checked steps.  Leaves whose reference gradient is under a thousandth of
  the median leaf's move by round-off alone and are left out.
- ``grad_diff``, ``change_diff``: the worst leaf's norm of the difference
  between the program's and the reference's first gradient (or last
  weights), over the same floor; ``*_median``: the median leaf's.  Norms
  hide unbiased rounding, which adds in quadrature: a difference does not.
- ``rows_unmatched``: rows of the program's first batches that the
  reference's own packing lacks (exact).

Serving: ``logit_gap``, the widest gap by which a served token's logit lies
below the reference's best over a round; ``tokens_out_of_vocab`` (exact).

A number is compared where the configuration file gives it a limit; it
passes when it is finite and at most the limit.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, Optional

SMALL_GRAD = 1e-3


def rel_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves=None) -> float:
    keys = sorted(leaves if leaves is not None else ref)
    if not keys:
        return float("nan")
    floor = statistics.median(ref[k] for k in keys)
    return max(abs(prog[k] - ref[k]) / max(ref[k], floor, 1e-30) for k in keys)


def train_numbers(prog: Dict, ref: Dict) -> Dict[str, float]:
    loss_gap = max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog["loss"], ref["loss"]))
    g_med = statistics.median(ref["grad"].values())
    moving = [k for k, g in ref["grad"].items() if g >= SMALL_GRAD * g_med]
    out = {
        "loss_gap": loss_gap,
        "grad_gap": rel_gaps(prog["grad"], ref["grad"]),
        "change_gap": rel_gaps(prog["change"], ref["change"], moving),
    }
    if "grad_diff" in ref:
        for name, diff, norms, keys in (("grad", ref["grad_diff"], ref["grad"], None),
                                        ("change", ref["change_diff"], ref["change"], moving)):
            per_leaf = rel_diffs(diff, norms, keys)
            out[f"{name}_diff"] = max(per_leaf.values())
            out[f"{name}_diff_median"] = statistics.median(per_leaf.values())
    return out


def rel_diffs(diff: Dict[str, float], ref: Dict[str, float], leaves=None) -> Dict[str, float]:
    """Each leaf's norm of the difference over the larger of its reference
    norm and the median leaf's."""
    keys = sorted(leaves if leaves is not None else ref)
    floor = statistics.median(ref[k] for k in keys)
    return {k: diff[k] / max(ref[k], floor, 1e-30) for k in keys}


def judged(numbers: Dict[str, float], limits: Dict[str, Optional[float]]) -> Dict[str, Dict]:
    """The compared numbers with their limits, in a fixed order."""
    out = {}
    for name in sorted(limits):
        if limits[name] is None:
            continue
        out[name] = {"value": numbers.get(name, float("nan")), "limit": limits[name]}
    return out


def passes(checks: Dict[str, Dict]) -> bool:
    return bool(checks) and all(
        isinstance(c["value"], (int, float)) and math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
