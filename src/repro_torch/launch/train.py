"""Training launcher CLI.

  python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
      --steps 4 --batch 8 --seq 1024

runs on the GPU; ``--device cpu --reduced`` runs the same-family small
config in float32 on the host.
"""

from __future__ import annotations

import argparse
import dataclasses

from repro_torch.config.base import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train.loop import LoopConfig, train


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")

    data_cfg = DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch,
    )
    opt_cfg = OptimizerConfig(
        name=cfg.optimizer, lr=args.lr,
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps,
    )
    loop_cfg = LoopConfig(
        steps=args.steps, log_every=args.log_every,
        checkpoint_dir=args.ckpt,
    )

    def log(step, m):
        print(f"step {step:5d}  loss={m['loss']:.4f} "
              f"gnorm={m.get('grad_norm', 0):.3f} lr={m.get('lr', 0):.2e} "
              + (f"moe_drop={m['moe_dropped_frac']:.3f} " if 'moe_dropped_frac' in m else "")
              + f"wall={m['wall_s']}s")

    out = train(cfg, data_cfg, opt_cfg, loop_cfg, on_metrics=log, device=args.device)
    h = out["history"]
    print(f"done: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}")


if __name__ == "__main__":
    main()
