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

Shapes are fully static: the dispatch buffer is (E, G·C_buf, d) for G token
groups with C_buf = headroom × uniform capacity of a group; the *effective*
per-expert capacity is data, not shape.  Dispatch is gather-based (sort by
group and expert, rank within segment).  The three steps that ``repro`` has
Pallas kernels for — router softmax/top-k/renormalise, per-expert counts,
buffer build — and the default combine go through ``repro_torch.kernels``:
hand-written CUDA kernels for tensors on the GPU, their plain versions for
tensors on the CPU.  The expert matrix products stay batched ``torch``
products.

Token groups follow ``repro``'s G axis: each group has its own capacity,
sort, ranks and buffer rows, and the link reads the loads summed over all
groups.  Each kernel still launches once a layer: the gating on all the
tokens, the histogram on ids offset by ``g·E`` into ``G·E`` bins, the gather
into all groups' slots.  Across data-parallel ranks (``SpmdCtx.group``) a
rank holds ``num_groups / world`` of the groups and one ``all_reduce`` a
layer sums the groups' counts and the router's mean probabilities, so the
link state and ``ema_loads`` are the same bits on every rank and equal to
one process's run with all G groups.

Across the expert-parallel ranks of a model group (``SpmdCtx.ep_group``,
``num_ep_shards`` = its size M) the layout is GSPMD's for ``repro``'s
mesh: the M ranks hold the same tokens, and rank m holds experts
``[m·E/M, (m+1)·E/M)`` of ``w_gate`` / ``w_up`` / ``w_down``.  Gating,
histogram, the link's tick and the routing plan run whole on every rank,
the same bits on each; the slots are expert-major, so a shard's slots are
one contiguous range of ``src`` / ``valid``, and the gather kernel fills
only those.  The default combine all-gathers the expert outputs over the
group and combines them as one process does; H9 (``moe_scatter_combine``)
adds this rank's weighted outputs by token and all-reduces the partial
``y`` (T·d on the wire instead of E·C·d).  No token moves between ranks.  The router stays whole on every
rank, where ``repro``'s spec shards its experts axis too: its softmax and
top-k need all E logits, and the replicated product computes the same
function.  The M link instances are the shards' state machines, ticked on
the same summed loads on every rank.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import distributed, tracing
from repro_torch._device import DeviceLike, resolve_device
from repro_torch.config.base import ArchConfig
from repro_torch.core import state_machine
from repro_torch.core.types import DySkewConfig, Policy, link_state_init
from repro_torch.kernels.combine import ops as combine_ops
from repro_torch.kernels.combine.ref import moe_combine_ref
from repro_torch.kernels.dispatch import ops as dispatch_ops
from repro_torch.kernels.dispatch.ref import dispatch_gather_ref
from repro_torch.kernels.histogram import ops as histogram_ops
from repro_torch.kernels.histogram.ref import load_histogram_ref
from repro_torch.kernels.ssd_scan import ops as ssd_ops
from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_ref
from repro_torch.kernels.topk_gating import ops as gating_ops
from repro_torch.kernels.topk_gating.ref import topk_gating_ref
from repro_torch.models.param import Rules, model_rules, spec
from repro_torch.models.perf_flags import get_flags


@dataclasses.dataclass(frozen=True)
class SpmdCtx:
    """Static layout facts the layers need."""

    num_groups: int = 1        # token groups over all data-parallel ranks
    num_ep_shards: int = 1     # expert-parallel shards (link instances)
    group: Any = None          # the data group, over (pod, data) (None: one process)
    ep_group: Any = None       # the model group the parameters are sharded over
    #: The rule table of the mesh's layout (``param.model_rules()`` where
    #: None: the model axis alone): which leaves a rank holds a slice of.
    rules: Optional[Rules] = None
    #: The pods the data group spans (``mesh``'s ``pod`` axis where > 1).
    pods: int = 1
    #: Every rank in mesh order: the fused (data, model) slices' gathers
    #: (H6).
    world_group: Any = None
    #: The data group where the batch is replicated over it (``group``
    #: None, ``repro``'s ``batch_axes=()``): it then only gathers FSDP's
    #: leaves.
    fsdp_group: Any = None

    def __post_init__(self):
        if self.rules is None:
            object.__setattr__(self, "rules", model_rules())
        if self.ep_group is not None and distributed.world_size(self.ep_group) != self.num_ep_shards:
            raise ValueError(
                f"num_ep_shards={self.num_ep_shards} against a model group of "
                f"{distributed.world_size(self.ep_group)} rank(s): each rank holds one shard"
            )

    @property
    def data_group(self) -> Any:
        """The group FSDP gathers over."""
        return self.group if self.fsdp_group is None else self.fsdp_group

    @property
    def mesh(self) -> Dict[str, int]:
        """The mesh's axes and sizes as the groups give them."""
        dp = distributed.world_size(self.data_group)
        out = {"pod": self.pods, "data": dp // self.pods} if self.pods > 1 else {"data": dp}
        out["model"] = distributed.world_size(self.ep_group)
        return out

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index on each axis of ``mesh``: its data group's
        index splits into (pod, data)."""
        mesh = self.mesh
        dp = distributed.rank_of(self.data_group)
        out = {"pod": dp // mesh["data"], "data": dp % mesh["data"]} if "pod" in mesh else {"data": dp}
        return dict(out, model=distributed.rank_of(self.ep_group))


@dataclasses.dataclass(frozen=True)
class DispatchOps:
    """The three dispatch steps, the Mamba layers' state scan and the MoE
    combine as callables.  The default sends GPU tensors through the CUDA
    kernels (the scan and the combine with their backward kernels under
    grad); ``PLAIN_OPS`` names the plain PyTorch versions, for holding the
    kernel path against them on the same device (under grad the plain scan
    and the plain combine loop are differentiated by autograd)."""

    gating: Callable = gating_ops.gating            # (logits, k) -> (w, idx)
    histogram: Callable = histogram_ops.histogram   # (ids, E) -> counts
    dispatch: Callable = dispatch_ops.dispatch      # (x, src, valid) -> buf
    scan: Callable = ssd_ops.state_scan             # (states, decay) -> prefix
    combine: Callable = combine_ops.combine         # (y_flat, slot_tk, gate_w) -> y


KERNEL_OPS = DispatchOps()
PLAIN_OPS = DispatchOps(topk_gating_ref, load_histogram_ref, dispatch_gather_ref, ssd_state_scan_ref,
                        moe_combine_ref)


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


def group_keys(flat_e: torch.Tensor, num_experts: int) -> torch.Tensor:
    """(G, N) expert ids → (G·N,) ids of the (group, expert) bins,
    ``g·E + e``; at one group the ids themselves."""
    G = flat_e.shape[0]
    if G == 1:
        return flat_e.reshape(-1)
    offs = torch.arange(G, dtype=flat_e.dtype, device=flat_e.device) * num_experts
    return (flat_e + offs[:, None]).reshape(-1)


def dispatch_plan(
    flat_e: torch.Tensor,            # (G, N) or (N,) int32 expert of each (token, pick)
    counts: torch.Tensor,            # (G, E) or (E,) float32 routed picks per expert
    cap_e: torch.Tensor,             # (E,) int32 effective capacity
    *,
    c_buf: int,
    top_k: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The routing plan of G groups of N picks each: sort each group's
    picks by expert (stable, so a token keeps its arrival order inside an
    expert), rank each inside its (group, expert) segment, keep those under
    the expert's capacity.  One stable sort of the (group, expert) keys
    does it for all groups at once.

    Slots are expert-major, ``(e·G + g)·c_buf + rank``, so the buffer is
    (E, G·c_buf, d) as the expert products take it; token ``t`` of group
    ``g`` is row ``g·Tg + t`` of the flattened tokens.

    Returns (order (G·N,), slot_sorted (G·N,), keep (G·N,) bool, src
    (G·E·c_buf,) int32, valid (G·E·c_buf,) bool): pick ``order[i]`` (of the
    flattened picks) goes to buffer slot ``slot_sorted[i]`` if ``keep[i]``;
    slot ``s`` is fed by token ``src[s]`` where ``valid[s]``.  One-dimensional
    ``flat_e`` and ``counts`` are one group.
    """
    if flat_e.ndim == 1:
        flat_e, counts = flat_e[None], counts[None]
    G, N = flat_e.shape
    E = counts.shape[-1]
    n_slots = G * E * c_buf
    dev = flat_e.device
    keys = group_keys(flat_e, E).to(torch.int64)
    order = torch.argsort(keys, stable=True)               # (G·N,)
    sorted_k = keys[order]
    # float32 cumsum cast to int32: exact below 2^24 routed tokens.
    flat_counts = counts.reshape(-1)
    seg_start = torch.cat(
        [flat_counts.new_zeros(1), torch.cumsum(flat_counts, dim=-1)[:-1]]
    ).to(torch.int32)
    ranks = torch.arange(G * N, device=dev) - seg_start[sorted_k]
    if G == 1:                      # a key is its expert and its slot block
        sorted_e = block = sorted_k
    else:
        sorted_e = sorted_k % E
        block = sorted_e * G + sorted_k // E
    keep = ranks < cap_e[sorted_e]
    # Rejected picks are parked in the extra column n_slots, which is
    # sliced off below; duplicate writes land only there.
    slot_sorted = torch.where(
        keep, block * c_buf + ranks, torch.full_like(ranks, n_slots)
    )
    # Flattened pick i is token i // k of the flattened tokens.
    tok_sorted = (order // top_k).to(torch.int32)
    src = torch.zeros(n_slots + 1, dtype=torch.int32, device=dev)
    src[slot_sorted] = tok_sorted
    filled = torch.zeros(n_slots + 1, dtype=torch.bool, device=dev)
    filled[slot_sorted] = True
    return order, slot_sorted, keep, src[:n_slots], filled[:n_slots]


class ScatterByToken(torch.autograd.Function):
    """``forward(rows, src, valid, T)`` → (T, d): row ``s`` added to token
    ``src[s]`` where ``valid[s]`` (``dispatch_backward``'s segment sum, the
    same bits from run to run); backward the gather of the gradient by
    ``src``, an empty slot's row getting zero."""

    @staticmethod
    def forward(ctx, rows, src, valid, num_tokens):
        ctx.save_for_backward(src, valid)
        return dispatch_ops.dispatch_backward(rows, src, valid, num_tokens)

    @staticmethod
    def backward(ctx, dy):
        src, valid = ctx.saved_tensors
        return dispatch_gather_ref(dy, src, valid), None, None, None


def moe_apply(
    p: Dict,
    x: torch.Tensor,                 # (B, S, d)
    *,
    cfg: ArchConfig,
    state: Dict,                     # from moe_state_init
    ctx: SpmdCtx = SpmdCtx(),
    ops: DispatchOps = KERNEL_OPS,
) -> Tuple[torch.Tensor, Dict, Dict]:
    """Returns (y, new_state, metrics); ``state`` is left as it was.

    With ``ctx.group`` the metrics are the global ones, the same on every
    rank, and ``moe_aux_loss`` has the global value with this rank's share
    of its gradient (``distributed.with_local_grad``)."""
    moe = cfg.moe
    B, S, d = x.shape
    E, k = moe.num_experts, moe.top_k
    G = ctx.num_groups
    world = distributed.world_size(ctx.group)
    T = B * S
    if G < 1 or G % world or T % (G // world):
        raise ValueError(
            f"num_groups={G}: {world} rank(s) of {T} tokens each do not split "
            "into equal token groups"
        )
    Gl = G // world                                        # this rank's groups
    Tg = T // Gl
    N = Tg * k
    c_static, c_buf = capacities(cfg, Tg)
    n_slots = Gl * E * c_buf
    dev = x.device
    ep = ctx.ep_group
    shards = distributed.world_size(ep)
    if E % shards:
        raise ValueError(f"num_ep_shards={shards} does not divide the {E} experts")
    El = E // shards                                       # this rank's experts
    if p["w_gate"].shape[0] != El:
        raise ValueError(f"{p['w_gate'].shape[0]} experts held a rank, against {E} over {shards} shard(s)")
    # This rank's slots: its experts' blocks of the expert-major buffer.
    n_local = n_slots // shards
    lo = distributed.rank_of(ep) * n_local

    xt = x.reshape(T, d)

    # ---- Router ------------------------------------------------------- #
    logits = xt @ p["router"].to(x.dtype)                  # (T, E)
    gate_w, gate_e = ops.gating(logits, k)                 # (T, k) f32 / i32

    # ---- Sibling-observable load metrics (per EP shard) --------------- #
    flat_e = gate_e.reshape(Gl, N)
    counts = ops.histogram(group_keys(flat_e, E), Gl * E).reshape(Gl, E)
    if ctx.group is None:
        all_counts = counts
    else:
        # One all_reduce a layer: every group's counts (this rank's rows
        # filled, the others zero) and the router's mean probabilities
        # over this rank's tokens (every rank holds as many).
        local_prob = torch.softmax(logits.to(torch.float32), dim=-1).mean(dim=0)
        rank = distributed.rank_of(ctx.group)
        mine = counts.new_zeros((G, E))
        mine[rank * Gl:(rank + 1) * Gl] = counts
        summed = distributed.all_sum(
            torch.cat([mine.reshape(-1), local_prob.detach()]), ctx.group
        )
        all_counts = summed[:G * E].reshape(G, E)
    # Global expert loads: the sum over all groups, whole numbers in
    # float32, so every rank gets the same bits.
    loads_e = all_counts[0] if G == 1 else all_counts.sum(dim=0)
    n_ep = ctx.num_ep_shards
    shard_loads = loads_e.reshape(n_ep, E // n_ep).sum(dim=-1)   # (n_ep,)

    with tracing.span("moe.link"):
        # ---- DySkew state machines (one per EP shard) ----------------- #
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

        # ---- Effective capacity: the redistribution decision ----------- #
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

    # Each rank's gradient of ``xt`` through the gather covers its own
    # slots: ``to_shard`` sums them over the model group.
    src_l, valid_l = src[lo:lo + n_local], valid[lo:lo + n_local]
    buf = ops.dispatch(distributed.to_shard(xt, ep), src_l, valid_l).reshape(El, Gl * c_buf, d)

    # ---- Expert computation -------------------------------------------- #
    h = F.silu(torch.bmm(buf, p["w_gate"].to(x.dtype))) * torch.bmm(
        buf, p["w_up"].to(x.dtype)
    )
    y_local = torch.bmm(h, p["w_down"].to(x.dtype)).reshape(n_local, d)

    if get_flags().moe_scatter_combine:
        # ---- H9 combine: the weights placed on the slots (each kept pick
        # owns its slot: a plain write, the drop column cut off), then the
        # weighted expert outputs summed by source token, partial on each
        # rank and summed over the model group.  The sum by token is
        # ``dispatch_backward``'s deterministic segment sum (float32, one
        # rounding), the transpose of the gather: no atomics, the same bits
        # from run to run, and its gradient the gather of ``dy``.
        w_sorted = distributed.to_shard(gate_w, ep).reshape(-1)[order] * keep
        w_slot = torch.zeros(n_slots + 1, dtype=torch.float32, device=dev)
        w_slot[slot_sorted] = w_sorted.to(torch.float32)
        contrib = y_local * w_slot[lo:lo + n_local, None].to(x.dtype)
        y = distributed.sum_shards(ScatterByToken.apply(contrib, src_l, valid_l, T), ep)
    else:
        # ---- Combine: each token's picks by slot, a rejected pick at the
        # parked slot n_slots, and the kept picks' outputs summed by weight.
        y_flat = distributed.gather_shards(y_local, ep)    # (n_slots, d)
        slot_tk = torch.empty_like(slot_sorted)
        slot_tk[order] = slot_sorted
        y = ops.combine(y_flat, slot_tk.reshape(T, k), gate_w)

    # ---- Telemetry ------------------------------------------------------ #
    if ctx.group is None:
        dropped = 1.0 - keep.to(torch.float32).mean()
    else:
        # A segment keeps min(count, capacity) picks: every group's kept
        # picks from the summed counts, as whole numbers.
        kept = torch.minimum(all_counts, cap_e.to(torch.float32)).sum()
        dropped = 1.0 - kept / float(G * N)
    imbalance = shard_loads.max() / torch.clamp(shard_loads.mean(), min=1.0)
    # Standard load-balancing auxiliary loss (Switch/GShard): E·Σ f_e·P_e.
    # The fused gating keeps the full probabilities to itself, and this
    # metric needs their mean, so it takes its own softmax of the logits.
    frac_tokens = loads_e / total_load
    if ctx.group is None:
        mean_prob = torch.softmax(logits.to(torch.float32), dim=-1).mean(dim=0)
    else:
        # The mean over all ranks' tokens, with this rank's share of its
        # gradient (on one rank the local mean, bit for bit).
        mean_prob = distributed.with_local_grad(summed[G * E:], local_prob) / float(world)
    aux_loss = E * torch.sum(frac_tokens * mean_prob)
    metrics = {
        "moe_dropped_frac": dropped,
        "moe_shard_imbalance": imbalance,
        "moe_distribute_frac": distribute.to(torch.float32).mean(),
        "moe_aux_loss": aux_loss,
    }
    return y.reshape(B, S, d), new_state, metrics
