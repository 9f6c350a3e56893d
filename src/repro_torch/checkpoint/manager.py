"""Checkpointing: async, atomic, keep-K.

  * the state tree (nested dicts of tensors) is saved as one .npz under a
    step directory, ``step_XXXXXXXX/shard_host0.npz`` plus ``meta.json``,
    with each leaf under its ``/``-joined key path: the layout of
    ``repro.checkpoint.manager``, so a float32 checkpoint written by
    ``repro`` restores here;
  * numpy has no bfloat16: a bfloat16 leaf is stored as its raw 16 bits
    (uint16) and ``meta.json`` names its dtype;
  * writes go to a temp directory that is atomically renamed on success, so
    a crash mid-write never corrupts the latest checkpoint;
  * saving is asynchronous: the snapshot to host memory happens on the
    caller's thread, the write on a background thread, and the caller blocks
    only on the previous save's completion;
  * retention: keep the newest K checkpoints;
  * elastic across data-parallel ranks (``group``): the state is replicated,
    so rank 0 writes it and every rank restores it, whatever the number of
    ranks that wrote it (one process, 2 ranks, 4).  The leaves under
    ``RANK_LOCAL`` differ from rank to rank (the error-feedback residual of
    ``allreduce_compressed``): each rank writes its own, as
    ``step_XXXXXXXX.rank<r>of<R>.npz`` beside the step directory, and reads
    back the file of its rank at the same world size.  Restored onto
    another world size, or where that file is missing, such a leaf starts
    at zero: a residual is what one rank's quantization left over, and has
    no meaning for another split of the batch.
  * elastic across the model axis (``ep_group``, with ``shards``, the
    ``{key path: axis}`` of the state's sliced leaves, ``param.shard_axes``
    of the train state's specs under the rule table): each rank holds its
    slice of such a leaf along its own axis, so ``save`` all-gathers each
    one over the model group of data rank 0 and the file holds whole
    leaves, as one process writes them; ``restore`` slices each for the
    restoring rank's model index.  A
    checkpoint written at (data 1, model 2) restores at (data 1, model 4),
    at (data 2, model 1) and in one process.  The rank files of a mesh
    with a model axis are named by the global rank and both axes,
    ``rank<r>of<D>x<M>``.  The MoE links keep one state machine an
    expert-parallel shard: restored onto another shard count, a link leaf
    (under ``dyskew/``, shaped by its shard count) starts from ``like``'s,
    since the shards it described are not this mesh's; ``ema_loads``, an
    expert's, comes back.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import distributed
from repro_torch.models.param import take_shard

BF16_RAW = "bfloat16"
#: Top-level keys of a train state that each rank holds for itself.
RANK_LOCAL = ("grad_residual",)


def flatten_with_paths(tree: Any, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key path, leaf) in sorted key order, paths joined by ``/``."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(flatten_with_paths(tree[k], f"{prefix}{k}/"))
        return out
    return [(prefix[:-1], tree)]


def _unflatten_like(like: Any, leaves: Dict[str, Any], prefix: str = "") -> Any:
    if isinstance(like, dict):
        return {k: _unflatten_like(like[k], leaves, f"{prefix}{k}/") for k in sorted(like)}
    return leaves[prefix[:-1]]


def _to_host(t: Any) -> Tuple[np.ndarray, Optional[str]]:
    """A host copy (of a host tensor too: the caller may write to it while
    the save runs); a bfloat16 leaf as its raw bits."""
    t = torch.as_tensor(t).detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(np.uint16), BF16_RAW
    return t.to("cpu", copy=True).numpy(), None


def _split(state: Any) -> Tuple[Any, Any]:
    """(replicated part, rank-local part) of a state dict."""
    if not isinstance(state, dict):
        return state, {}
    return ({k: v for k, v in state.items() if k not in RANK_LOCAL},
            {k: v for k, v in state.items() if k in RANK_LOCAL})


def _snapshot(tree: Any) -> Tuple[List[Tuple[str, np.ndarray]], Dict[str, str]]:
    leaves, raw = [], {}
    for key, leaf in flatten_with_paths(tree):
        arr, kind = _to_host(leaf)
        leaves.append((key, arr))
        if kind is not None:
            raw[key] = kind
    return leaves, raw


def _from_host(arr: np.ndarray, kind: Optional[str], ref: torch.Tensor, key: str) -> torch.Tensor:
    if kind == BF16_RAW:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if tuple(t.shape) != tuple(ref.shape):
        raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)}, expected {tuple(ref.shape)}")
    return t.to(device=ref.device, dtype=ref.dtype)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, group: distributed.Group = None,
                 ep_group: distributed.Group = None, shards: Optional[Dict[str, int]] = None):
        self.directory = directory
        self.keep = keep
        self.ep_group = ep_group
        self.shards = shards or {}
        self.data_rank = distributed.rank_of(group)
        self.model_rank = distributed.rank_of(ep_group)
        self.model_size = distributed.world_size(ep_group)
        data = distributed.world_size(group)
        self.rank = self.data_rank * self.model_size + self.model_rank
        self.world = data * self.model_size
        self._tag = f"of{data}" if self.model_size == 1 else f"of{data}x{self.model_size}"
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    def _rank_file(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.rank{self.rank}{self._tag}.npz")

    def _whole(self, replicated: Any) -> Any:
        """The replicated part with each sliced leaf gathered whole over
        the model group along its axis (only data rank 0's group, which
        writes)."""
        if self.ep_group is None or self.data_rank != 0:
            return replicated
        leaves = {}
        for key, leaf in flatten_with_paths(replicated):
            if key in self.shards:
                axis = self.shards[key]
                leaf = distributed.gather_shards(leaf.movedim(axis, 0), self.ep_group).movedim(0, axis)
            leaves[key] = leaf
        return _unflatten_like(replicated, leaves)

    # ------------------------- save -------------------------- #

    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Async atomic save. Blocks only if a previous save is running.
        Rank 0 writes the replicated state; every rank its ``RANK_LOCAL``
        leaves, if the state has any."""
        self.wait()
        replicated, local = _split(state)
        replicated = self._whole(replicated)
        # Snapshot to host memory on the caller's thread.
        leaves, raw = _snapshot(replicated) if self.rank == 0 else ([], {})
        local_leaves, local_raw = _snapshot(local) if local else ([], {})

        def _write():
            if local_leaves:
                path = self._rank_file(step)
                tmp = path + ".tmp.npz"
                np.savez(tmp, **dict(local_leaves), __dtypes__=np.array(json.dumps(local_raw)))
                os.replace(tmp, path)              # atomic commit
            if self.rank != 0:
                self._gc()
                return
            final = os.path.join(self.directory, f"step_{step:08d}")
            tmp = final + ".tmp"
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "shard_host0.npz"), **dict(leaves))
            meta = {
                "step": step,
                "time": time.time(),
                "keys": [k for k, _ in leaves],
                "dtypes": raw,
                "world": self.world,
            }
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                # The same step saved again (a loop's last step on its
                # checkpoint interval): swap the new one in, then drop
                # the old.
                old = final + ".old"
                os.rename(final, old)
                os.rename(tmp, final)
                shutil.rmtree(old)
            else:
                os.rename(tmp, final)      # atomic commit
            self._gc()

        t = threading.Thread(target=_write, daemon=True)
        t.start()
        self._pending = t
        if blocking:
            self.wait()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _gc(self) -> None:
        """Rank 0 drops the step directories past the newest K, each rank
        its own rank files past its newest K."""
        if self.rank == 0:
            for s in self.all_steps()[: -self.keep]:
                shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)
        mine = sorted(int(name[5:13]) for name in os.listdir(self.directory)
                      if name.endswith(f".rank{self.rank}{self._tag}.npz"))
        for s in mine[: -self.keep]:
            try:
                os.remove(self._rank_file(s))
            except FileNotFoundError:
                pass

    # ------------------------ restore ------------------------ #

    def all_steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and name[5:].isdigit():
                out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Any, step: Optional[int] = None) -> Any:
        """Restore into the structure of ``like``: each leaf comes back with
        the dtype and on the device of ``like``'s leaf at its path, a
        sliced leaf as this rank's slice.  The ``RANK_LOCAL`` leaves of
        ``like`` come from this rank's file at this mesh shape, or start at
        zero (see the module docstring)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            raw = json.load(f).get("dtypes", {})
        replicated, local = _split(like)
        out = {}
        with np.load(os.path.join(path, "shard_host0.npz")) as data:
            for key, leaf in flatten_with_paths(replicated):
                arr = data[key]
                if key in self.shards:
                    arr = take_shard(arr, self.shards[key], self.model_rank, self.model_size)
                ref = torch.as_tensor(leaf)
                if key.startswith("dyskew/") and arr.shape != tuple(ref.shape):
                    out[key] = ref.clone()
                    continue
                out[key] = _from_host(arr, raw.get(key), ref, key)
        restored = _unflatten_like(replicated, out)
        if local:
            local_out = {}
            rank_file = self._rank_file(step)
            if os.path.exists(rank_file):
                with np.load(rank_file) as data:
                    local_raw = json.loads(str(data["__dtypes__"]))
                    for key, leaf in flatten_with_paths(local):
                        local_out[key] = _from_host(data[key], local_raw.get(key), torch.as_tensor(leaf), key)
            else:
                for key, leaf in flatten_with_paths(local):
                    local_out[key] = torch.zeros_like(torch.as_tensor(leaf))
            restored = dict(restored, **_unflatten_like(local, local_out))
        return restored
