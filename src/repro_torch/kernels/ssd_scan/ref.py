"""Plain PyTorch versions of the SSD inter-chunk state scan and its backward."""

from __future__ import annotations

from typing import Tuple

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


def ssd_state_scan_bwd_ref(
    g: torch.Tensor, out: torch.Tensor, decay: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The scan's backward.  g: (C, H, P, N) gradient of the prefix, out: the
    forward's prefix, decay: (C, H).  Returns float32 ``(d_states (C, H, P,
    N), d_decay (C, H))``.

    With ``a`` the adjoint of the state leaving chunk c, ``a[C-2] = g[C-1]``
    and ``a[c] = g[c+1] + decay[c+1] * a[c+1]``; ``d_states[c] = a[c]`` and
    ``d_decay[c] = sum_{p,n} a[c] * out[c]`` for c <= C-2.  The last chunk's
    state and decay reach no output (both gradients 0 there), and
    ``out[0] == 0``, so ``d_decay[0] = 0`` without a read.  The multiply and
    the add are rounded one by one, as the CUDA kernel rounds them, so the
    two give the same ``d_states``."""
    C = g.shape[0]
    d = decay.to(torch.float32)
    d_states = torch.zeros(g.shape, dtype=torch.float32, device=g.device)
    d_decay = torch.zeros((C, g.shape[1]), dtype=torch.float32, device=g.device)
    if C < 2:
        return d_states, d_decay
    a = g[C - 1].to(torch.float32)
    for c in range(C - 2, -1, -1):
        d_states[c] = a
        if c == 0:
            break
        d_decay[c] = (a * out[c]).sum(dim=(1, 2))
        a = g[c] + a * d[c][:, None, None]
    return d_states, d_decay
