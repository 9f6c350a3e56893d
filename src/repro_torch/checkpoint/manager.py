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
  * retention: keep the newest K checkpoints.
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

BF16_RAW = "bfloat16"


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


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: Optional[threading.Thread] = None

    # ------------------------- save -------------------------- #

    def save(self, step: int, state: Any, blocking: bool = False) -> None:
        """Async atomic save. Blocks only if a previous save is running."""
        self.wait()
        # Snapshot to host memory on the caller's thread.
        leaves, raw = [], {}
        for key, leaf in flatten_with_paths(state):
            arr, kind = _to_host(leaf)
            leaves.append((key, arr))
            if kind is not None:
                raw[key] = kind

        def _write():
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
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"), ignore_errors=True)

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
        the dtype and on the device of ``like``'s leaf at its path."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            raw = json.load(f).get("dtypes", {})
        out = {}
        with np.load(os.path.join(path, "shard_host0.npz")) as data:
            for key, leaf in flatten_with_paths(like):
                ref = torch.as_tensor(leaf)
                arr = data[key]
                if raw.get(key) == BF16_RAW:
                    t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
                else:
                    t = torch.from_numpy(np.array(arr, copy=True))
                if tuple(t.shape) != tuple(ref.shape):
                    raise ValueError(f"{key}: checkpoint shape {tuple(t.shape)}, expected {tuple(ref.shape)}")
                out[key] = t.to(device=ref.device, dtype=ref.dtype)
        return _unflatten_like(like, out)
