"""Hand-written Hopper kernels for the technique's hot data-movement paths.

dispatch     — routing-plan gather (the redistribution data movement)
histogram    — destination load counts (skew-model input, every step)
topk_gating  — fused softmax + top-k routing
combine      — the MoE combine: each token's kept picks' expert outputs,
               weighted and summed, and its backward (training)
ssd_scan     — Mamba-2 inter-chunk state scan (every Mamba layer's prefill
               and training forward) and its backward (training)

Each kernel ships kernel.py (the CUDA launch wrapper, which counts its
launches), ref.py (the plain PyTorch version) and ops.py (CUDA tensor →
kernel or raise; CPU tensor → plain version); the scan's backward has a
wrapper of its own, ssd_scan/kernel_bwd.py, under the ``autograd.Function``
in ssd_scan/ops.py, and so has the combine's backward,
combine/kernel_bwd.py, under combine/ops.py's.  The CUDA C++ sources live in
csrc/ and are built for sm_90a at first use by ``_loader``.
"""

from __future__ import annotations

from typing import Dict

from repro_torch.kernels.combine import kernel as _combine
from repro_torch.kernels.combine import kernel_bwd as _combine_bwd
from repro_torch.kernels.dispatch import kernel as _dispatch
from repro_torch.kernels.histogram import kernel as _histogram
from repro_torch.kernels.ssd_scan import kernel as _ssd_scan
from repro_torch.kernels.ssd_scan import kernel_bwd as _ssd_scan_bwd
from repro_torch.kernels.topk_gating import kernel as _topk_gating

_MODULES = {
    "topk_gating": _topk_gating,
    "load_histogram": _histogram,
    "dispatch_gather": _dispatch,
    "ssd_state_scan": _ssd_scan,
    "ssd_state_scan_bwd": _ssd_scan_bwd,
    "moe_combine": _combine,
    "moe_combine_bwd": _combine_bwd,
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches made by each wrapper since the last reset."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0
