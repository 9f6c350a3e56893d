"""Serving example: continuous batching with DySkew request scheduling vs
round-robin under a skewed request mix (some requests generate 10x more
tokens — the serving analogue of heavy UDF rows).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_dyskew [--device cpu]
"""

from __future__ import annotations

import argparse
from typing import Dict, Optional

import numpy as np

from repro_torch.serving.engine import Request, ServeConfig, ServingEngine


def run(device: Optional[str] = None, n_requests: int = 96) -> Dict[str, Dict]:
    """Prints one line a scheduler; returns each scheduler's results."""
    rng = np.random.default_rng(7)
    requests = [
        Request(
            rid=i,
            prompt_len=int(rng.integers(64, 512)),
            # every 6th request is a long generation (skewed decode cost)
            max_new_tokens=int(rng.integers(400, 600)) if i % 6 == 0
            else int(rng.integers(20, 80)),
            arrival=float(i) * 0.015,
        )
        for i in range(n_requests)
    ]

    out = {}
    for sched in ("round_robin", "dyskew"):
        res = ServingEngine(ServeConfig(num_replicas=4, scheduler=sched), device=device).run(
            [Request(**r.__dict__) for r in requests]  # fresh copies
        )
        out[sched] = res
        print(f"{sched:12s} mean={res['mean_latency']:.2f}s "
              f"p99={res['p99_latency']:.2f}s migrations={res['migrations']} "
              f"migrated={res['migrated_gb']:.2f}GB")
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    run(ap.parse_args().device)
