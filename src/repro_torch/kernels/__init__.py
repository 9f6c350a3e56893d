"""Hand-written Hopper kernels for the technique's hot data-movement paths.

dispatch     — routing-plan gather (the redistribution data movement)
histogram    — destination load counts (skew-model input, every step)
topk_gating  — fused softmax + top-k routing
combine      — the MoE combine: each token's kept picks' expert outputs,
               weighted and summed, and its backward (training)
ssd_scan     — Mamba-2 inter-chunk state scan (every Mamba layer's prefill
               and training forward) and its backward (training)
attention    — softmax attention's forward for a call that needs no
               gradient (a served prefill, an encoder), scores in registers

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

from repro_torch.kernels.attention import kernel as _attention
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
    "attention": _attention,
}


#: The device kernels each wrapper launches, as the profiler names them:
#: each launch leaves one record of one of them.
DEVICE_KERNELS = {
    "topk_gating": ("topk_gating_group_kernel", "topk_gating_warp_kernel"),
    "load_histogram": ("histogram_block_kernel", "histogram_cluster_kernel"),
    "dispatch_gather": ("dispatch_gather_kernel", "dispatch_bytes_kernel"),
    "ssd_state_scan": ("ssd_scan_vec_kernel", "ssd_scan_scalar_kernel"),
    "ssd_state_scan_bwd": ("ssd_scan_bwd_kernel",),
    "moe_combine": ("moe_combine_fwd_kernel",),
    "moe_combine_bwd": ("moe_combine_bwd_kernel",),
    "attention": ("attention_fwd_kernel",),
}


def launch_counts() -> Dict[str, int]:
    """Kernel launches made by each wrapper since the last reset: the
    wrappers' calls.  A CUDA graph's replay calls none; the kernels it runs
    are counted by ``launches_in_trace``."""
    return {name: mod.launches for name, mod in _MODULES.items()}


def reset_launch_counts() -> None:
    for mod in _MODULES.values():
        mod.launches = 0


def launches_in_trace(prof) -> Dict[str, int]:
    """The launches of each wrapper's kernels among the device records of a
    finished ``torch.profiler.profile``: the kernels that ran, a CUDA
    graph's replays included."""
    from torch.autograd import DeviceType

    out = dict.fromkeys(_MODULES, 0)
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            for name, device_names in DEVICE_KERNELS.items():
                if any(k in evt.key for k in device_names):
                    out[name] += evt.count
    return out
