"""Plain PyTorch version of the load histogram."""

from __future__ import annotations

import torch


def load_histogram_ref(ids: torch.Tensor, num_dest: int) -> torch.Tensor:
    """(N,) integer ids → (num_dest,) float32 counts; ids outside
    [0, num_dest) count nowhere."""
    ids = ids.reshape(-1).to(torch.int64)
    ok = (ids >= 0) & (ids < num_dest)
    out = torch.zeros((num_dest,), dtype=torch.float32, device=ids.device)
    # float32 adds of 1.0 are exact below 2^24 ids per destination.
    return out.index_put_(
        (torch.where(ok, ids, torch.zeros_like(ids)),),
        ok.to(torch.float32),
        accumulate=True,
    )
