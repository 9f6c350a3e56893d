"""Quickstart: the DySkew adaptive link in 40 lines.

Creates 4 sibling link instances, feeds a skewed stream of work items, and
watches the state machines detect the skew and redistribute.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import List, Optional

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core import AdaptiveLink, AdaptiveLinkConfig, DySkewConfig, Policy


def run(device: Optional[str] = None, ticks: int = 8) -> List[float]:
    """Prints one line a tick; returns each tick's makespan."""
    dev = resolve_device(device)
    link = AdaptiveLink(AdaptiveLinkConfig(
        dyskew=DySkewConfig(policy=Policy.LATE, n_strikes=3, theta=0.5),
        num_instances=4,
    ), device=dev)
    state = link.init_state()

    print("tick | states (0=INIT 1=DECIDING 2=DRAIN 3=DIST 5=DIST_TERM) | makespan")
    makespans = []
    for tick in range(ticks):
        # 32 items, all arriving at producer 0 (severe partition skew).
        costs = torch.full((32,), 0.1, dtype=torch.float32, device=dev)
        sizes = torch.full((32,), 1e3, dtype=torch.float32, device=dev)
        producer = torch.zeros(32, dtype=torch.int32, device=dev)
        state, plan = link.step(state, costs, sizes, producer)
        loads = np.zeros(4)
        np.add.at(loads, plan.dest.cpu().numpy(), costs.cpu().numpy())
        makespans.append(float(loads.max()))
        print(f"{tick:4d} | {state['state'].cpu().numpy()} | {loads.max():.2f} "
              f"(balanced would be {float(costs.sum()) / 4:.2f})")

    print("\nThe LATE policy processed locally for 3 strikes, drained, then "
          "committed to distributed mode — makespan drops 4x.")
    return makespans


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    run(ap.parse_args().device)
