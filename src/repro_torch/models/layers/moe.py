"""Mixture-of-Experts with DySkew adaptive dispatch.

This is the paper's technique mapped onto an accelerator: token → expert
routing under expert parallelism is exactly the 'rows → workers' problem of
Snowpark UDFs — arbitrary routing skew, opaque downstream cost, and a fixed
set of parallel consumers (the EP shards).

Mapping:
  row            → token
  worker         → expert-parallel shard
  link instance  → per-EP-shard state machine, carried across steps
  legacy static  → uniform per-expert capacity (drops overflow, GShard)
  DySkew         → load-proportional effective capacity inside a fixed
                   buffer: idle shards' unused capacity is reassigned to
                   hot experts when the state machines commit to
                   redistribution (EAGER for training, LATE selectable)

Shapes are fully static: the dispatch buffer is (E, C_buf, d) with
C_buf = headroom × uniform capacity; the *effective* per-expert capacity is
data, not shape.  Dispatch is gather-based (sort by expert, rank within
segment).  The three steps that ``repro`` has Pallas kernels for — router
softmax/top-k/renormalise, per-expert counts, buffer build — go through
``repro_torch.kernels``: hand-written CUDA kernels for tensors on the GPU,
their plain versions for tensors on the CPU.  The expert matrix products
stay batched ``torch`` products.

One card holds one token group: ``SpmdCtx.num_groups`` must be 1.  The
expert-parallel shards remain as the link's sibling instances (the state
machines observe per-shard loads), though all experts live on one device.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch._device import DeviceLike, resolve_device
from repro_torch.config.base import ArchConfig
from repro_torch.core import state_machine
from repro_torch.core.types import DySkewConfig, Policy, link_state_init
from repro_torch.kernels.dispatch import ops as dispatch_ops
from repro_torch.kernels.dispatch.ref import dispatch_gather_ref
from repro_torch.kernels.histogram import ops as histogram_ops
from repro_torch.kernels.histogram.ref import load_histogram_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_ref
from repro_torch.kernels.topk_gating import ops as gating_ops
from repro_torch.kernels.topk_gating.ref import topk_gating_ref
from repro_torch.models.param import spec
from repro_torch.models.perf_flags import get_flags


@dataclasses.dataclass(frozen=True)
class SpmdCtx:
    """Static layout facts the layers need."""

    num_groups: int = 1        # token groups; one card holds exactly one
    num_ep_shards: int = 1     # expert-parallel shards (link instances)


@dataclasses.dataclass(frozen=True)
class DispatchOps:
    """The three dispatch steps and the Mamba layers' state scan as
    callables.  The default sends GPU tensors through the CUDA kernels (the
    scan with its backward kernel under grad); ``PLAIN_OPS`` names the plain
    PyTorch versions, for holding the kernel path against them on the same
    device (under grad the plain scan is differentiated by autograd)."""

    gating: Callable = gating_ops.gating            # (logits, k) -> (w, idx)
    histogram: Callable = histogram_ops.histogram   # (ids, E) -> counts
    dispatch: Callable = dispatch_ops.dispatch      # (x, src, valid) -> buf
    scan: Callable = ssd_ops.state_scan             # (states, decay) -> prefix


KERNEL_OPS = DispatchOps()
PLAIN_OPS = DispatchOps(topk_gating_ref, load_histogram_ref, dispatch_gather_ref, ssd_state_scan_ref)


def moe_dyskew_config(adaptive: bool) -> DySkewConfig:
    """EAGER = adaptive capacity from step 0 (the Snowpark policy);
    NEVER = the static uniform-capacity baseline."""
    return DySkewConfig(
        policy=Policy.EAGER_SNOWPARK if adaptive else Policy.NEVER,
        n_strikes=2,
        theta=0.7,
        # Token 'rows' are uniform d_model-sized vectors: the batch-density
        # heavy-row guard must never fire here.
        min_batch_density_frac=0.0,
        heavy_row_bytes=float("inf"),
    )


def moe_specs(cfg: ArchConfig) -> Dict:
    assert cfg.moe is not None
    d, E, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.expert_ff
    return {
        "router": spec((d, E), ("embed", "experts"), scale=0.02),
        "w_gate": spec((E, d, f), ("experts", "expert_embed", None)),
        "w_up": spec((E, d, f), ("experts", "expert_embed", None)),
        "w_down": spec((E, f, d), ("experts", None, "expert_embed")),
    }


def moe_state_init(cfg: ArchConfig, ctx: SpmdCtx, device: DeviceLike = None) -> Dict:
    """Carried DySkew state for ONE MoE layer (stack across layers outside)."""
    assert cfg.moe is not None
    dev = resolve_device(device)
    dk = moe_dyskew_config(cfg.moe.adaptive)
    return {
        "link": link_state_init(ctx.num_ep_shards, dk, dev),
        "ema_loads": torch.full(
            (cfg.moe.num_experts,), 1.0 / cfg.moe.num_experts,
            dtype=torch.float32, device=dev,
        ),
    }


def capacities(cfg: ArchConfig, tokens_per_group: int) -> Tuple[int, int]:
    """(uniform effective capacity, buffer capacity with DySkew headroom)."""
    moe = cfg.moe
    c_static = max(
        1,
        int(moe.capacity_factor * tokens_per_group * moe.top_k / moe.num_experts),
    )
    headroom = 2 if moe.adaptive else 1
    return c_static, c_static * headroom


def dispatch_plan(
    flat_e: torch.Tensor,            # (N,) int32 expert of each (token, pick)
    counts: torch.Tensor,            # (E,) float32 routed tokens per expert
    cap_e: torch.Tensor,             # (E,) int32 effective capacity
    *,
    c_buf: int,
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routing plan: sort the picks by expert (stable, so a token keeps
    its arrival order inside an expert), rank each inside its expert's
    segment, keep those under the expert's capacity.

    Returns (order (N,), slot_sorted (N,), keep (N,) bool, src (E*c_buf,)
    int32, valid (E*c_buf,) bool): pick ``order[i]`` goes to buffer slot
    ``slot_sorted[i]`` if ``keep[i]``; slot ``s`` is fed by token ``src[s]``
    where ``valid[s]``.
    """
    E = counts.shape[0]
    N = flat_e.shape[0]
    n_slots = E * c_buf
    dev = flat_e.device
    flat_e64 = flat_e.to(torch.int64)
    order = torch.argsort(flat_e64, stable=True)           # (N,)
    sorted_e = flat_e64[order]
    # float32 cumsum cast to int32: exact below 2^24 routed tokens.
    seg_start = torch.cat(
        [counts.new_zeros(1), torch.cumsum(counts, dim=-1)[:-1]]
    ).to(torch.int32)
    ranks = torch.arange(N, device=dev) - seg_start[sorted_e]
    keep = ranks < cap_e[sorted_e]
    # Rejected picks are parked in the extra column n_slots, which is
    # sliced off below; duplicate writes land only there.
    slot_sorted = torch.where(
        keep, sorted_e * c_buf + ranks, torch.full_like(ranks, n_slots)
    )
    tok_sorted = (order // top_k).to(torch.int32)
    src = torch.zeros(n_slots + 1, dtype=torch.int32, device=dev)
    src[slot_sorted] = tok_sorted
    filled = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    filled[slot_sorted] = True
    return order, slot_sorted, keep, src[:n_slots], filled[:n_slots]


def moe_apply(
    p: Dict,
    x: torch.Tensor,                 # (B, S, d)
    *,
    cfg: ArchConfig,
    state: Dict,                     # from moe_state_init
    ctx: SpmdCtx = SpmdCtx(),
    ops: DispatchOps = KERNEL_OPS,
) -> Tuple[torch.Tensor, Dict, Dict]:
    """Returns (y, new_state, metrics); ``state`` is left as it was."""
    if ctx.num_groups != 1:
        raise ValueError(
            f"num_groups={ctx.num_groups}: one device holds one token group"
        )
    moe = cfg.moe
    B, S, d = x.shape
    E, k = moe.num_experts, moe.top_k
    T = B * S
    N = T * k
    c_static, c_buf = capacities(cfg, T)
    n_slots = E * c_buf
    dev = x.device

    xt = x.reshape(T, d)

    # ---- Router ------------------------------------------------------- #
    logits = xt @ p["router"].to(x.dtype)                  # (T, E)
    gate_w, gate_e = ops.gating(logits, k)                 # (T, k) f32 / i32

    # ---- Sibling-observable load metrics (per EP shard) --------------- #
    flat_e = gate_e.reshape(N)
    counts = ops.histogram(flat_e, E)                      # (E,) float32
    loads_e = counts
    n_ep = ctx.num_ep_shards
    shard_loads = loads_e.reshape(n_ep, E // n_ep).sum(dim=-1)   # (n_ep,)

    # ---- DySkew state machines (one per EP shard) --------------------- #
    dk = moe_dyskew_config(moe.adaptive)
    bytes_per_row = torch.full_like(shard_loads, 2.0 * d)
    new_link, distribute = state_machine.tick(
        state["link"],
        dk,
        rows_this_tick=shard_loads,
        sync_time_this_tick=shard_loads,   # cost ∝ tokens (uniform experts)
        batch_density=shard_loads,
        bytes_per_row=bytes_per_row,
        signal_this_tick=shard_loads > 0,
    )
    total_load = torch.clamp(loads_e.sum(), min=1.0)
    ema = 0.9 * state["ema_loads"] + 0.1 * loads_e / total_load
    new_state = {"link": new_link, "ema_loads": ema}

    # ---- Effective capacity: the redistribution decision --------------- #
    # Static mode: uniform c_static. Distributing: load-proportional caps
    # inside the same total budget (idle capacity flows to hot experts).
    # torch.round is half-to-even, as the reference's rounding is.
    adaptive_caps = torch.clamp(
        torch.round(ema * E * c_static), 1, c_buf
    ).to(torch.int32)
    expert_shard = torch.arange(E, device=dev) // (E // n_ep)
    use_adaptive = distribute[expert_shard]                # (E,)
    cap_e = torch.where(
        use_adaptive, adaptive_caps, torch.full_like(adaptive_caps, c_static)
    )

    # ---- Sorted gather dispatch ---------------------------------------- #
    order, slot_sorted, keep, src, valid = dispatch_plan(
        flat_e, counts, cap_e, c_buf=c_buf, top_k=k
    )

    buf = ops.dispatch(xt, src, valid).reshape(E, c_buf, d)

    # ---- Expert computation -------------------------------------------- #
    h = F.silu(torch.bmm(buf, p["w_gate"].to(x.dtype))) * torch.bmm(
        buf, p["w_up"].to(x.dtype)
    )
    y_flat = torch.bmm(h, p["w_down"].to(x.dtype)).reshape(n_slots, d)

    if get_flags().moe_scatter_combine:
        # ---- H9 combine: weights placed on the slots, then one
        # scatter-add of the weighted expert outputs by source token.
        w_sorted = gate_w.reshape(N)[order] * keep
        w_slot = torch.zeros(n_slots + 1, dtype=torch.float32, device=dev)
        w_slot.index_add_(0, slot_sorted, w_sorted.to(torch.float32))
        contrib = y_flat * w_slot[:n_slots, None].to(x.dtype)
        y = torch.zeros((T, d), dtype=x.dtype, device=dev)
        y.index_add_(0, src.to(torch.int64), contrib)
    else:
        # ---- Combine (unrolled over k to bound gather temporaries) ----- #
        slot_unsorted = torch.empty_like(slot_sorted)
        slot_unsorted[order] = slot_sorted
        keep_unsorted = torch.empty_like(keep)
        keep_unsorted[order] = keep
        slot_tk = slot_unsorted.reshape(T, k)
        keep_tk = keep_unsorted.reshape(T, k)
        y = torch.zeros((T, d), dtype=x.dtype, device=dev)
        for j in range(k):
            sj = torch.clamp(slot_tk[:, j], max=n_slots - 1)
            wj = (gate_w[:, j] * keep_tk[:, j]).to(x.dtype)
            y = y + y_flat[sj] * wj[:, None]

    # ---- Telemetry ------------------------------------------------------ #
    dropped = 1.0 - keep.to(torch.float32).mean()
    imbalance = shard_loads.max() / torch.clamp(shard_loads.mean(), min=1.0)
    # Standard load-balancing auxiliary loss (Switch/GShard): E·Σ f_e·P_e.
    # The fused gating keeps the full probabilities to itself, and this
    # metric needs their mean, so it takes its own softmax of the logits.
    frac_tokens = loads_e / total_load
    mean_prob = torch.softmax(logits.to(torch.float32), dim=-1).mean(dim=0)
    aux_loss = E * torch.sum(frac_tokens * mean_prob)
    metrics = {
        "moe_dropped_frac": dropped,
        "moe_shard_imbalance": imbalance,
        "moe_distribute_frac": distribute.to(torch.float32).mean(),
        "moe_aux_loss": aux_loss,
    }
    return y.reshape(B, S, d), new_state, metrics
