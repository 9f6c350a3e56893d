"""The port's mesh: ranks over ``torch.distributed`` with axes ``data`` and
``model``, and ``pod`` outside them, laid out as ``repro.launch.mesh``
lays out TPU pods.

``repro`` lays a pod out as (data 16, model 16) and two pods as (pod 2,
data 16, model 16) (``make_production_mesh``).  Here one process is the
mesh (data 1, model 1), and ``init_ranks`` makes rank ``r`` of a (pod P,
data D, model M) mesh after ``torch.distributed.init_process_group``, with
``r = (p·D + d)·M + m`` (the model index innermost, as ``jax.make_mesh``
orders devices) and three process groups: the **data group** of the P·D
ranks with the same ``m``, over ``(pod, data)`` (the loss's and the
gradients' sums, the link's loads, and FSDP's all-gathers and
reduce-scatters of the leaves ``repro``'s ``default_rules`` put on
``data``), the **model group** of the M ranks with the same ``(p, d)``
(the slices of experts, heads, ffn width, vocabulary and Mamba heads) and
the **world** in mesh order (H6's fused ``(data, model)`` slices).  The
ranks of a model group hold the same rows of every batch.  The backend
follows the device, NCCL for ``cuda`` (one card a rank) and gloo for
``cpu``, with no fallback from one to the other; ``backend="fake"``
(``torch.testing``'s fake process group) makes the groups of one rank of a
pod in one process, for the dry-run, whose collectives on ``meta``
tensors move nothing.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue as queue_mod
import tempfile
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    axes: Tuple[str, ...] = ("data", "model")
    sizes: Tuple[int, ...] = (1, 1)
    #: The data group: the ranks with this rank's model index, over
    #: ``(pod, data)`` (None: one process).
    group: Any = None
    #: The global rank, ``data_rank · M + model_rank``.
    rank: int = 0
    #: The model group: the ranks with this rank's pod and data index
    #: (None: one process).
    ep_group: Any = None
    #: Every rank in mesh order (None: one process).
    world: Any = None

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axes, self.sizes))

    @property
    def data_rank(self) -> int:
        """The rank's index in its data group, ``p·D + d``."""
        return self.rank // self.shape["model"]

    @property
    def model_rank(self) -> int:
        return self.rank % self.shape["model"]

    @property
    def coords(self) -> Dict[str, int]:
        """The rank's index on each axis."""
        out, r = {}, self.rank
        for ax, n in reversed(list(zip(self.axes, self.sizes))):
            out[ax] = r % n
            r //= n
        return {ax: out[ax] for ax in self.axes}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """``repro``'s pod meshes as a description (no groups): (data 16,
    model 16), or (pod 2, data 16, model 16)."""
    if multi_pod:
        return Mesh(axes=("pod", "data", "model"), sizes=(2, 16, 16))
    return Mesh(axes=("data", "model"), sizes=(16, 16))


def mesh_ctx(mesh: Mesh, rules=None, num_groups: Optional[int] = None):
    """The layers' ``SpmdCtx`` on ``mesh``'s groups: one token group a data
    rank (or ``num_groups``), an expert-parallel shard a model rank, ``rules``
    (default: ``repro``'s ``default_rules`` for the mesh, FSDP on)."""
    from repro_torch.models.layers.moe import SpmdCtx
    from repro_torch.models.param import default_rules

    pods = mesh.shape.get("pod", 1)
    return SpmdCtx(num_groups=dp_size(mesh) if num_groups is None else num_groups,
                   num_ep_shards=model_size(mesh), group=mesh.group, ep_group=mesh.ep_group,
                   rules=default_rules(multi_pod="pod" in mesh.shape) if rules is None else rules,
                   pods=pods, world_group=mesh.world)


def dp_axes(multi_pod: bool) -> Tuple[str, ...]:
    return ("pod", "data") if multi_pod else ("data",)


def dp_size(mesh: Mesh) -> int:
    n = 1
    for ax in ("pod", "data"):
        n *= mesh.shape.get(ax, 1)
    return n


def model_size(mesh: Mesh) -> int:
    return mesh.shape.get("model", 1)


def backend_for(device: torch.device) -> str:
    """NCCL for CUDA tensors, gloo for host tensors."""
    if device.type == "cuda":
        return "nccl"
    if device.type == "cpu":
        return "gloo"
    raise ValueError(f"no torch.distributed backend for device {device}")


def rank_device(device: Optional[str], local_rank: int) -> torch.device:
    """The device of a rank: ``device`` as named (``None`` = the GPU), with
    ``cuda`` given the rank's own card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank)
    return dev


def init_ranks(
    rank: int,
    world: int,
    *,
    device: torch.device,
    init_method: Optional[str],
    backend: Optional[str] = None,
    model: int = 1,
    pod: int = 1,
) -> Mesh:
    """``init_process_group`` for rank ``rank`` of ``world`` on ``device``;
    returns the mesh (pod ``pod``, data ``world / (pod · model)``, model
    ``model``; no pod axis where ``pod`` is 1) with its three groups (see
    the module docstring), made by ``new_group`` on every rank in the same
    order (the whole world where a group spans it).  ``backend`` defaults
    to ``backend_for(device)``: naming ``gloo`` for CUDA tensors puts
    several ranks on one card (gloo stages each collective through the
    host).  NCCL takes a card a rank and raises when the ranks outnumber
    the cards.  ``fake`` needs no ``init_method`` and no device: the
    process is rank ``rank`` alone."""
    if model < 1 or pod < 1 or world % (model * pod):
        raise ValueError(f"a model axis of {model} over {pod} pod(s) does not divide {world} ranks")
    backend = backend or backend_for(device)
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if device.type != "cuda" or device.index is None or device.index >= cards:
            raise RuntimeError(
                f"NCCL takes one card a rank: rank {rank} of {world} asks for {device}, and "
                f"this machine has {cards} card(s); run at most {cards} ranks, or gloo"
            )
        torch.cuda.set_device(device)
    if backend == "fake":
        from torch.testing._internal.distributed.fake_pg import FakeStore

        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    else:
        dist.init_process_group(backend, init_method=init_method, rank=rank, world_size=world)
    dp = world // model
    groups = {}
    for kind, members in (("model", [[q * model + m for m in range(model)] for q in range(dp)]),
                          ("data", [[q * model + m for q in range(dp)] for m in range(model)])):
        for ranks in members:
            g = dist.group.WORLD if len(ranks) == world else dist.new_group(ranks)
            if rank in ranks:
                groups[kind] = g
    if pod > 1:
        axes, sizes = ("pod", "data", "model"), (pod, dp // pod, model)
    else:
        axes, sizes = ("data", "model"), (dp, model)
    return Mesh(axes=axes, sizes=sizes, group=groups["data"], rank=rank, ep_group=groups["model"],
                world=dist.group.WORLD)


def torchrun_env() -> Optional[Tuple[int, int, int]]:
    """(rank, world, local rank) from ``torchrun``'s environment, or None
    outside it."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    return (int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
            int(os.environ.get("LOCAL_RANK", os.environ["RANK"])))


def _rank_main(fn: Callable[..., Any], rank: int, world: int, init_method: str, args: Tuple, results) -> None:
    try:
        results.put((rank, fn(rank, world, init_method, *args), None))
    except BaseException:
        results.put((rank, None, traceback.format_exc()))
        raise


def run_ranks(fn: Callable[..., Any], world: int, *args: Any, timeout: float,
              store_dir: Optional[str] = None) -> List[Any]:
    """``fn(rank, world, init_method, *args)`` in ``world`` spawned
    processes that meet over a ``FileStore`` in ``store_dir`` (a new
    temporary directory by default); their results in rank order.  ``fn``
    and ``args`` are pickled (``fn`` by its import path).  A rank that
    raises or dies, or a wait longer than ``timeout`` seconds, fails the
    call; every process is stopped before it returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_", dir=store_dir) as tmp:
        init_method = "file://" + os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main, args=(fn, r, world, init_method, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        out: Dict[int, Any] = {}
        try:
            # Drained before the joins: a rank's put may wait on the pipe.
            waited = 0.0
            while len(out) < world:
                try:
                    rank, value, error = results.get(timeout=1.0)
                except queue_mod.Empty:
                    waited += 1.0
                    dead = {r: p.exitcode for r, p in enumerate(procs) if r not in out and p.exitcode is not None}
                    if dead:
                        raise RuntimeError(f"ranks ended before they sent a result (rank: exit code): {dead}")
                    if waited > timeout:
                        missing = sorted(set(range(world)) - set(out))
                        raise RuntimeError(f"ranks {missing} sent nothing in {timeout} s") from None
                    continue
                if error is not None:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{error}")
                out[rank] = value
                waited = 0.0
            for p in procs:
                p.join(timeout)
                if p.is_alive() or p.exitcode != 0:
                    raise RuntimeError(f"a rank of {world} ended with {p.exitcode}")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [out[r] for r in range(world)]
