"""End-to-end training example: ~100M-param MoE with DySkew adaptive
dispatch against the static-capacity baseline.

The MoE is granite-moe family (32 experts, top-8) scaled to ~100M params;
DySkew's per-EP-shard state machines manage expert capacity live during
training.  With ``--ranks N`` each mode trains on N data-parallel ranks
(``launch/train.py::train_ranks``; NCCL on the GPU, one card a rank, gloo
with ``--device cpu``), each rank on its rows of the global batch.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_moe_dyskew --steps 200
"""

from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional

import torch

from repro_torch.config.base import ArchConfig, MoEConfig
from repro_torch.data.pipeline import DataConfig
from repro_torch.launch.mesh import run_ranks
from repro_torch.launch.train import RANK_TIMEOUT_S, train_ranks
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train.loop import LoopConfig, train


def make_cfg(adaptive: bool, layers: int = 8, d_model: int = 512) -> ArchConfig:
    # ~100M params: 8 layers, d=512, 32 experts × ff 512 top-8.
    return ArchConfig(
        name="moe-100m", family="moe", num_layers=layers, d_model=d_model,
        num_heads=8, num_kv_heads=4, d_ff=512, vocab_size=8192,
        rope_style="full", norm="rmsnorm", mlp_act="swiglu",
        moe=MoEConfig(num_experts=32, top_k=8, expert_ff=512,
                      capacity_factor=1.0, adaptive=adaptive),
        optimizer="adamw", dtype="float32", remat=False,
    )


def _log(step: int, m: Dict) -> None:
    print(f"  step {step:4d} loss={m['loss']:.4f} "
          f"dropped={m.get('moe_dropped_frac', 0):.4f} "
          f"imbalance={m.get('moe_shard_imbalance', 0):.2f}", flush=True)


def _train_rank(rank: int, world: int, init_method: str, job: Dict) -> Optional[List[Dict]]:
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    out = train_ranks(rank, world, job["cfg"], job["data"], job["opt"], job["loop"],
                      init_method=init_method, device=job["device"], on_metrics=_log)
    return out["history"] if rank == 0 else None


def run(steps: int = 200, batch: int = 8, seq: int = 256, device: Optional[str] = None,
        ranks: int = 1, layers: int = 8, d_model: int = 512) -> Dict[str, List[Dict]]:
    """Trains both modes; returns each mode's history."""
    out = {}
    for mode in ("dyskew", "static"):
        cfg = make_cfg(adaptive=(mode == "dyskew"), layers=layers, d_model=d_model)
        job = {
            "cfg": cfg,
            "data": DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch, seed=1),
            "opt": OptimizerConfig(name="adamw", lr=1e-3, warmup_steps=20, total_steps=steps),
            "loop": LoopConfig(steps=steps, log_every=max(steps // 10, 1)),
            "device": device,
        }
        print(f"\n=== {mode} dispatch ===", flush=True)
        if ranks > 1:
            h = run_ranks(_train_rank, ranks, job, timeout=RANK_TIMEOUT_S)[0]
        else:
            h = train(job["cfg"], job["data"], job["opt"], job["loop"], on_metrics=_log,
                      device=device)["history"]
        out[mode] = h
        print(f"{mode}: loss {h[0]['loss']:.3f} -> {h[-1]['loss']:.3f}, "
              f"final dropped={h[-1].get('moe_dropped_frac', 0):.4f}", flush=True)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default=None, help="torch device (default: the GPU)")
    ap.add_argument("--ranks", type=int, default=1, help="data-parallel ranks to spawn")
    a = ap.parse_args()
    run(a.steps, a.batch, a.seq, a.device, a.ranks)
