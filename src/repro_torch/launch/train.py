"""Training launcher CLI.

  python -m repro_torch.launch.train --arch granite-moe-1b-a400m \
      --steps 4 --batch 8 --seq 1024

runs on the GPU; ``--device cpu --reduced`` runs the same-family small
config in float32 on the host.  Ranks on a (data, model) mesh:

  python -m repro_torch.launch.train ... --ranks 4 [--model 2]
  torchrun --nproc-per-node 4 -m repro_torch.launch.train ... [--model 4]

``--ranks N`` spawns N local processes that meet over a ``FileStore`` in a
temporary directory; under ``torchrun`` (``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` set) each process is one rank.  On the GPU each rank takes
its own card over NCCL (more ranks than cards raise), with ``--device cpu``
the ranks meet over gloo.  ``--model M`` makes the mesh (data ranks / M,
model M): the M ranks of a model group train on the same rows, each with
its slice of every leaf ``repro``'s ``default_rules`` shard over the model
axis (E/M of the experts, H/M of the heads, the ffn's width and the
vocabulary split M ways, with ``resolve_pspec``'s fallback to whole leaves).  ``--batch`` is the global batch, split
over the data ranks; rank 0 logs and checkpoints.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist

from repro_torch.config.base import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import init_ranks, rank_device, run_ranks, torchrun_env
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train.loop import LoopConfig, train

#: Seconds a spawned rank may take (``--ranks``) before the launcher stops it.
RANK_TIMEOUT_S = 6 * 3600


def train_ranks(
    rank: int, world: int, cfg, data_cfg: DataConfig, opt_cfg: OptimizerConfig, loop_cfg: LoopConfig, *,
    init_method: str, device: Optional[str] = None, local_rank: Optional[int] = None,
    on_metrics: Optional[Callable[[int, Dict], None]] = None, model: int = 1,
) -> Dict:
    """Rank ``rank`` of ``world`` on a mesh with a model axis of ``model``:
    join the process group (the device's backend), run
    ``train/loop.py::train`` on this rank's rows, leave the group.  Returns
    the loop's output."""
    dev = rank_device(device, rank if local_rank is None else local_rank)
    mesh = init_ranks(rank, world, device=dev, init_method=init_method, model=model)
    try:
        return train(cfg, data_cfg, opt_cfg, loop_cfg, on_metrics=on_metrics, device=dev, mesh=mesh)
    finally:
        dist.destroy_process_group()


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8, help="the global batch, over all ranks")
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", type=str, default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--ranks", type=int, default=1, help="ranks to spawn on this machine")
    ap.add_argument("--model", type=int, default=1, help="the model axis: ranks that share a batch and split the model")
    return ap.parse_args(argv)


def configs(args: argparse.Namespace):
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    data_cfg = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, global_batch=args.batch)
    opt_cfg = OptimizerConfig(
        name=cfg.optimizer, lr=args.lr,
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps,
    )
    loop_cfg = LoopConfig(steps=args.steps, log_every=args.log_every, checkpoint_dir=args.ckpt)
    return cfg, data_cfg, opt_cfg, loop_cfg


def log(step: int, m: Dict) -> None:
    print(f"step {step:5d}  loss={m['loss']:.4f} "
          f"gnorm={m.get('grad_norm', 0):.3f} lr={m.get('lr', 0):.2e} "
          + (f"moe_drop={m['moe_dropped_frac']:.3f} " if 'moe_dropped_frac' in m else "")
          + f"wall={m['wall_s']}s", flush=True)


def report(out: Dict) -> None:
    h = out["history"]
    print(f"done: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f}", flush=True)


def _spawned(rank: int, world: int, init_method: str, argv) -> None:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    args = parse(argv)
    out = train_ranks(rank, world, *configs(args), init_method=init_method, device=args.device,
                      on_metrics=log, model=args.model)
    if rank == 0:
        report(out)


def spawn_ranks(argv, world: int, device: Optional[str]) -> None:
    """``world`` local processes of ``_spawned``; raises if any fails or a
    wait outlasts ``RANK_TIMEOUT_S``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"--ranks {world} over NCCL needs {world} cards; this machine has "
                           f"{torch.cuda.device_count()}")
    run_ranks(_spawned, world, argv, timeout=RANK_TIMEOUT_S)


def main(argv=None) -> None:
    args = parse(argv)
    env = torchrun_env()
    if env is not None:
        rank, world, local = env
        out = train_ranks(rank, world, *configs(args), init_method="env://", device=args.device,
                          local_rank=local, on_metrics=log, model=args.model)
        if rank == 0:
            report(out)
    elif args.ranks > 1:
        spawn_ranks(sys.argv[1:] if argv is None else argv, args.ranks, args.device)
    else:
        report(train(*configs(args), on_metrics=log, device=args.device))


if __name__ == "__main__":
    main()
