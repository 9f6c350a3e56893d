"""Serving launcher CLI: continuous batching with the DySkew scheduler.

  python -m repro_torch.launch.serve --requests 64

runs the scheduler's link on the GPU; ``--device cpu`` runs it on the host.
``--arch`` and ``--reduced`` are parsed and unused, as in ``repro``.
"""

from __future__ import annotations

import argparse

import numpy as np

from repro_torch.serving.engine import Request, ServeConfig, ServingEngine


def requests(count: int):
    """The launcher's request mix (seed 0): prompts of 64–511 tokens, every
    seventh request a long generation."""
    rng = np.random.default_rng(0)
    return [
        Request(
            rid=i,
            prompt_len=int(rng.integers(64, 512)),
            max_new_tokens=int(rng.integers(300, 400)) if i % 7 == 0
            else int(rng.integers(20, 60)),
            arrival=float(i) * 0.02,
        )
        for i in range(count)
    ]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="starcoder2-3b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--replicas", type=int, default=4)
    ap.add_argument("--scheduler", default="dyskew",
                    choices=["dyskew", "round_robin", "least_loaded"])
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = ServeConfig(num_replicas=args.replicas, scheduler=args.scheduler)
    res = ServingEngine(cfg, device=args.device).run(requests(args.requests))
    for k, v in res.items():
        print(f"{k}: {v:.4f}" if isinstance(v, float) else f"{k}: {v}")


if __name__ == "__main__":
    main()
