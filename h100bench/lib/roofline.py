"""The yardstick's arithmetic, frozen here so that no later change to the
program moves it.

Copied from ``src/repro_torch/roofline/kernel_cost.py``, ``hw.py`` and
``analysis.py::model_flops_estimate`` at commit a36dd41 (the work of each
hand-written kernel from its shapes, the H100 data-sheet peaks, MODEL_FLOPS),
rewritten to take the shapes as numbers.  One departure: the gather's bytes
are those these inputs need, not the most they could.  The kernel writes
every slot (zeros for an empty one) and reads a token's row once however
many slots it feeds, so a call reads at most T rows: the source counts a
read for every slot, which at the buffer's 2x headroom would put a share
of this bound above 100 %.
"""

from __future__ import annotations

from typing import Dict

# NVIDIA H100 SXM 80GB data sheet, dense rates, at the full 700 W limit.
PEAK_FLOPS_BF16 = 989e12
PEAK_FLOPS_FP32 = 67e12
HBM_BW = 3.35e12

#: Device kernel names of the port's hand-written kernels, by family.
MOE_KERNELS = {
    "topk_gating": ("topk_gating_group_kernel", "topk_gating_warp_kernel"),
    "load_histogram": ("histogram_block_kernel", "histogram_cluster_kernel"),
    "dispatch_gather": ("dispatch_gather_kernel", "dispatch_bytes_kernel"),
}
SCAN_KERNELS = {
    "ssd_state_scan": ("ssd_scan_vec_kernel", "ssd_scan_scalar_kernel"),
    "ssd_state_scan_bwd": ("ssd_scan_bwd_kernel", "ssd_scan_bwd_decay_kernel"),
}


def kernel_of(name: str, families: Dict[str, tuple]) -> str:
    """The family a device kernel's name belongs to, or ''."""
    for fam, names in families.items():
        if any(n in name for n in names):
            return fam
    return ""


def bound_s(flops: float, nbytes: float, peak_flops: float = PEAK_FLOPS_BF16) -> float:
    """The least time the chip could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / HBM_BW)


def topk_gating(T: int, E: int, k: int, elem: int) -> Dict[str, float]:
    """(T, E) logits read; (T, k) float32 weights and int32 ids written."""
    return {"flops": T * E * (4 + k), "bytes": T * E * elem + T * k * 8}


def load_histogram(n: int, num_dest: int) -> Dict[str, float]:
    """(n,) int32 ids read, (num_dest,) float32 counts written."""
    return {"flops": n, "bytes": n * 4 + num_dest * 4}


def dispatch_gather(S: int, T: int, row_bytes: int) -> Dict[str, float]:
    """S slots written, at most T distinct rows read, the int32 source and
    bool mask of each slot."""
    return {"flops": 0, "bytes": S * row_bytes + T * row_bytes + 5 * S}


def ssd_state_scan(C: int, H: int, P: int, N: int, elem: int) -> Dict[str, float]:
    """C - 1 planes and decays read, C float32 planes written."""
    plane, live = H * P * N, max(C - 1, 0)
    return {"flops": 2 * live * plane, "bytes": live * plane * elem + live * H * 4 + C * plane * 4}


def ssd_state_scan_bwd(C: int, H: int, P: int, N: int, states_elem: int) -> Dict[str, float]:
    """g[1..C-1] and out[1..C-2] read with decay[1..C-2]; d_states and
    d_decay written (both of the backward's kernels)."""
    plane, live = H * P * N, max(C - 2, 0)
    return {"flops": 4 * live * plane,
            "bytes": ((C - 1) + live) * plane * 4 + live * H * 4 + C * plane * states_elem + C * H * 4}


def model_flops(n_active: int, tokens: int, kind: str) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (a forward)."""
    return (6.0 if kind == "train" else 2.0) * n_active * tokens


def n_active_params(model: Dict) -> int:
    """Parameters a token's matrix products use: every block matrix but the
    experts a token is not routed to, and the output head (the embedding's
    lookup is no product).  From the configuration file alone."""
    from h100bench.lib.weights import dims, layout

    z = dims(model)
    total = 0
    for path, (shape, kind, _) in layout(model, {"embed_scale": 1.0, "head_scale": 1.0,
                                                  "router_scale": 1.0}).items():
        if kind != "normal" or path == "embed/table" or "conv_" in path:
            continue
        n = 1
        for s in shape:
            n *= s
        if path.split("/")[-1] in ("w_gate", "w_up", "w_down") and "/moe/" in path:
            n = n // z["E"] * z["k"]
        total += n
    if model.get("tie_embeddings", False):
        total += z["Vp"] * z["d"]
    return total
