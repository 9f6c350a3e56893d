"""Training loop: data pipeline → train step → checkpoint / telemetry.

Runs on one device (``device``, ``None`` = the GPU): DySkew data balancing
in the pipeline, async checkpointing, and per-step DySkew MoE telemetry.
Each history entry also carries ``data_wait_s``, the seconds the loop spent
blocked on the pipeline for that step's batch.

On a (data D, model M) mesh (``launch/mesh.py::init_ranks``) every rank
runs the same seeded ``DataPipeline`` and takes the rows ``[d·B/D,
(d+1)·B/D)`` of each global batch by its DATA index d, one token group a
data rank, so the M ranks of a model group hold the same tokens and each
its slice of what ``repro``'s ``default_rules`` shard over ``model``
(experts, heads, kv heads, the ffn's width, the vocabulary, Mamba's heads;
``num_ep_shards`` = M); the metrics are the global ones on every rank, and
only rank 0 calls ``on_metrics`` and writes the checkpoint's replicated
state (the sliced leaves gathered over its model group).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional

import torch

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.config.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, DataPipeline
from repro_torch.launch.mesh import Mesh
from repro_torch.models.layers.moe import SpmdCtx
from repro_torch.models.model_api import build
from repro_torch.models.param import shard_axes
from repro_torch.optim.optimizers import OptimizerConfig
from repro_torch.train.step import StepConfig, make_train_step, train_state_init, train_state_specs


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: Optional[str] = None
    seed: int = 0


def train(
    cfg: ArchConfig,
    data_cfg: DataConfig,
    opt_cfg: OptimizerConfig,
    loop_cfg: LoopConfig,
    on_metrics: Optional[Callable[[int, Dict], None]] = None,
    device: DeviceLike = None,
    mesh: Mesh = Mesh(),
) -> Dict:
    dev = resolve_device(device)
    model = build(cfg)
    data, shards = mesh.shape["data"], mesh.shape["model"]
    if data_cfg.global_batch % data:
        raise ValueError(f"a global batch of {data_cfg.global_batch} rows does not split over {data} data ranks")
    rows = data_cfg.global_batch // data
    lo = mesh.data_rank * rows
    ctx = SpmdCtx(num_groups=data, num_ep_shards=shards, group=mesh.group, ep_group=mesh.ep_group)
    step_fn = make_train_step(model, opt_cfg, StepConfig(), ctx)
    # Drawn on the host: the same weights on every device.
    gen = torch.Generator().manual_seed(loop_cfg.seed)
    state = train_state_init(model, opt_cfg, gen, ctx, dev)

    ckpt = None
    start_step = 0
    if loop_cfg.checkpoint_dir:
        ckpt = CheckpointManager(loop_cfg.checkpoint_dir, group=mesh.group, ep_group=mesh.ep_group,
                                 shards=shard_axes(train_state_specs(model, opt_cfg), shards, ctx.rules))
        if ckpt.latest_step() is not None:
            state = ckpt.restore(state)
            start_step = int(state["step"])

    pipe = DataPipeline(data_cfg, device=dev).start()
    history = []
    t0 = time.time()
    try:
        for step in range(start_step, loop_cfg.steps):
            t_wait = time.perf_counter()
            batch = next(pipe)
            if data > 1:
                batch = {k: v[lo:lo + rows] for k, v in batch.items()}
            data_wait_s = time.perf_counter() - t_wait
            state, metrics = step_fn(state, batch)
            if (step + 1) % loop_cfg.log_every == 0 or step == start_step:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step + 1
                m["wall_s"] = round(time.time() - t0, 1)
                m["data_wait_s"] = data_wait_s
                history.append(m)
                if on_metrics and mesh.rank == 0:
                    on_metrics(step + 1, m)
            if ckpt and (step + 1) % loop_cfg.checkpoint_every == 0:
                ckpt.save(step + 1, state)
        if ckpt:
            ckpt.save(loop_cfg.steps, state, blocking=True)
    finally:
        pipe.stop()
    return {"state": state, "history": history}
