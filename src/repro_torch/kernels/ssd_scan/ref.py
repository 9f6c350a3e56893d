"""Plain PyTorch version of the SSD inter-chunk state scan."""

from __future__ import annotations

import torch


def ssd_state_scan_ref(states: torch.Tensor, decay: torch.Tensor) -> torch.Tensor:
    """(C, H, P, N), (C, H) → (C, H, P, N) float32 prefix states: ``out[c]``
    is the state entering chunk c, ``out[0] == 0``, and after it
    ``h = h * decay[c] + states[c]``.  The last chunk's state and decay reach
    no output and are not read."""
    d = decay.to(torch.float32)
    out = torch.empty(states.shape, dtype=torch.float32, device=states.device)
    h = torch.zeros(states.shape[1:], dtype=torch.float32, device=states.device)
    for c in range(states.shape[0]):
        out[c] = h
        if c + 1 < states.shape[0]:
            h = h * d[c][:, None, None] + states[c].to(torch.float32)
    return out
