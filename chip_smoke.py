#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for sm_90a).

    python3 chip_smoke.py

builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` with ``nvcc``,
holds each (the state scan's backward too) against its plain PyTorch
version on the card, runs the DySkew MoE dispatch and one full-width
Mamba-2 layer through the kernels and through the plain versions side by
side, and then serves two models at full
width and depth (random weights from a seed), each with one prefill of 8
prompts of 1024 tokens and 32 greedy decode steps through
``make_prefill_step`` / ``make_decode_step``: ``granite-moe-1b-a400m``,
whose 24 MoE layers run the three dispatch kernels, and ``mamba2-1.3b``,
whose 48 Mamba-2 layers run the state-scan kernel in every prefill.

The ``families`` phase serves the other model families the same way, at
full width: ``whisper-base`` whole (8 prompts of 224 tokens against 8 ×
1500 encoder frames; in float32 its cached prefill and 3 decode steps are
held to its uncached forward), ``pixtral-12b`` whole (256 patch positions
a prompt), ``qwen1.5-32b`` with 32 of its 64 layers and its int8 KV cache
(beside a bf16-cache run of the same tokens) and ``kimi-k2-1t-a32b`` with
1 of its 61 layers, whose 384 experts run the three MoE kernels (held
against the plain versions on the same prompt); then these four configs and
granite-20b, chatglm3-6b and starcoder2-3b, reduced, card against host.

Then it holds the card against the host on the DySkew link and the
Snowpark UDF simulator, in one process: ``AdaptiveLink.step`` and every
planner at 32 × 4,096 and 1,024 × 1,048,576 items (two card runs must be
identical and equal to ``device="cpu"``), and four simulator runs, each on
the card and on the host, whose ``QueryResult``s (rtol 1e-9, counts
exactly) and per-tick distribute masks must be equal: the full Fig. 4
TPCx-BB suite on 4 nodes, 256 open-loop tenants on batched ticks, a
worker crash beside one pipeline scenario, and ``claims``: the runs of the
reference's claim tests (Fig. 4's four quick queries, the §III.B heavy-row
case unguarded and guarded, the Never and Eager policies, deadline-aware
against weight-only admission), the same bits on card and host, each band
checked on the card's numbers.

Last it trains: the DySkew data pipeline's 64 batches of 8 × 1024 tokens on
8 data-parallel shards, card against host; the serving engine's scheduler
(``launch/serve.py``'s defaults and one fair-share, deadline-aware
configuration), card against host; and ``granite-moe-1b-a400m`` at full
width and depth through ``train/loop.py::train`` (AdamW, remat, 4 steps of
8 × 1024 tokens fed by the pipeline), after step 1's gradients through the
kernels have been held against those through the plain versions and
against a second kernel run; then the same 4 steps of the reduced config on
the card and on the host, and a checkpoint round trip on the card.  Then
``train_mamba`` trains ``mamba2-1.3b`` the same way through the state scan
and its hand-written backward: step 1 in float32 against autograd through
the plain scan (with a control that drops the decay's gradient, which must
fail the band) and against a second kernel run, 4 bf16 steps through the
loop, counted, and reduced ``mamba2-1.3b`` and ``jamba-1.5-large-398b``
(Adafactor), card against host.

Then ``ranks`` checks the token groups and the data axis on the one card:
granite's prefill (8 × 1024) and one train step at 8 token groups on a
skewed router, each MoE kernel once a layer as at one group and the kernel
path against the plain versions, G 1 and G 8 apart; two full granite steps
through ``launch/train.py``'s path on a real NCCL group of one rank, the
same bits as no group; four ranks sharing the card over gloo (gloo stages
each all_reduce through the host: not NCCL's times), granite at full width
with 6 of its 24 layers in float32, plain and compressed reduction, held to
the one-process run at num_groups 4, ``ema_loads`` the same bits on every
rank (over NCCL too, a card a rank, where the machine has four cards); and
the collectives each step issued, as the op counter records them, with the
data-parallel step's ``t_collective``.

``expert_parallel`` checks the model axis: granite at full width and depth
served (8 × 1024 prefill, 32 greedy decode steps, both combines) on a
one-rank NCCL mesh whose model group of one runs the model group's
collectives, the same bits as no group with either combine (its two train
steps are ``ranks``' loop on that mesh); then four gloo ranks sharing the
card as (data 1, model 4) under the reference's layout less FSDP (``model_rules``:
a quarter of the experts, heads, ffn width, vocabulary and Mamba heads a
rank), serving granite (both combines, H9 twice: the same bits),
starcoder2-3b and mamba2-1.3b at full width and depth (the last two 8
decode steps), each held to one process: every layer, fed one process's
output of the layer before, within four bf16 roundings (MoE rows whose
router picks other experts only at near ties), the same bits on every rank,
the full-depth logits against one process's a reading (a random model's
rounding cascades through the layers); and training granite in float32 at
the depth reckoned from the free card, at most EP_MAX_LAYERS (loss and ``grad_norm`` within 1e-3);
then the experts-only layout at 2 layers, served with the
default combine bit for bit and trained; and the model
group's collectives of each prefill and train step, as the op counter
records them, against what they issue, with ``t_collective``.

``fsdp`` checks FSDP of ``embed`` over the data group under the
reference's whole table (``default_rules``): granite served (8 × 1024
prefill, 32 decode steps) and trained one float32 step on a one-rank NCCL
mesh with data and model groups of one, the same bits as no group; four
gloo ranks sharing the card as (data 4, model 1), granite served at 12
of its 24 layers (each rank its 2 prompts, 8 decode steps) and trained at
FSDP_LAYERS, then as (data 2, model 2), granite trained (and with H2: the
gathers at half the bytes) and mamba2-1.3b served at 24 of its 48 layers, each held to one process (every layer from
one process's input within LAYER_TOL, loss and ``grad_norm`` within 1e-3,
``ema_loads`` within EMA_PICK_SHARE's bound, each parameter within 2 · lr) and each step's
gathers and reduce-scatters held to what it issues (``fsdp_issued``).

Last, ``roofline`` runs the dry-run (``launch/dryrun.py``: every cell of
the six configs served or trained on one card, and POD_CELLS on a pod's
rank in a process of their own, counted on ``meta`` tensors) and counts
six steps at full width with ``roofline/op_cost.py``, once on the card and
once on ``meta``, where the counts must be equal and each kernel's records
must equal its launches: granite's and mamba2's prefill of 8 x 1024, one
decode step of each, and one train step of each at 8 x 1024.  Each step's
``mfu`` is MODEL_FLOPS (6·N·D to train, 2·N·D to serve) over its measured
seconds at the bf16 peak.

Standard output is one JSON object per line:

    {"phase": "device", ...}     card, power limit, torch and CUDA versions
    {"phase": "build", ...}      seconds to build the kernel library
    {"phase": "gating_sweep"}    the gating kernel over E, k, T and dtype
    {"phase": "kernel_checks"}   every kernel against its plain version
    {"phase": "moe", ...}        moe_apply, kernel path against plain path
    {"phase": "mamba", ...}      one Mamba-2 layer, kernel scan against plain
    {"phase": "serve", ...}      per model: rates, memory, launches
    {"phase": "families", ...}   per model of the other families, as serve, with its checks
    {"phase": "families_reduced"} seven configs reduced, card against host
    {"phase": "profile", ...}    only with --profile: device time by kernel
    {"phase": "link", ...}       AdaptiveLink.step and the planners, card against host
    {"phase": "sim", ...}        Fig. 4, 256 tenants, faults, pipeline, the paper's claims
                                 (bands on the card's numbers), card against host
    {"phase": "data_pipeline"}   DataPipeline batches and link plans, card against host
    {"phase": "serving_engine"}  ServingEngine results, card against host
    {"phase": "train", ...}      step 1 kernel against plain, 4 full steps, reduced
                                 steps card against host, checkpoint round trip
    {"phase": "train_mamba"}     mamba2-1.3b: step 1 kernel against plain scan, 4
                                 full steps, reduced mamba2 and jamba card against host
    {"phase": "profile", ...}    with --profile, also one traced train step of each
    {"phase": "roofline_step"}   the data-parallel step of ``ranks`` (c): its collectives
                                 counted and priced (t_collective)
    {"phase": "ranks", ...}      token groups on the card, one NCCL rank against no group,
                                 four gloo ranks against one process, launches, seconds
    {"phase": "expert_parallel_depth"}  the model axis's train depth, reckoned
    {"phase": "expert_parallel"} one NCCL rank's model group against no group; four gloo
                                 ranks at (data 1, model 4), the reference's layout and the
                                 experts alone, served and trained against one process;
                                 the model group's collectives; launches, seconds
    {"phase": "fsdp_depth"}      the fsdp phase's train depth and parameters a rank
    {"phase": "fsdp_readings"}   the ranks' readings, printed before the checks
    {"phase": "fsdp", ...}       one NCCL rank against no group; four gloo ranks at (4, 1)
                                 and (2, 2), with H2, against one process; records,
                                 wire bytes, t_collective, seconds
    {"phase": "roofline_pod_cell"}  a pod rank's cell (on meta, a fake process group):
                                 per-rank peak GB, fits_hbm, t_collective, records
    {"phase": "roofline_cell"}   the dry-run of each cell of the six configs served or
                                 trained (launch/dryrun.py, on meta): status, counts,
                                 roofline terms, peak GB, fits_hbm
    {"phase": "roofline_step"}   granite and mamba2 prefill, a decode step and a train
                                 step, each counted by roofline/op_cost.py on the card
                                 and on meta (equal), its records equal to its
                                 launches, with mfu, the counted terms and peaks
    {"phase": "roofline", ...}   how many cells ran and the phase's seconds
    {"phase": "script", ...}     the whole script's seconds
    {"kernels": [...]}           per kernel: time, bound, launches, error
    <name>, <power limit>        as nvidia-smi prints them
    {"ok": true, "device": {...}}

Any failed check raises and the exit code is non-zero; without a GPU the
script exits with code 1 before it prints anything.  Times are medians of
repeated runs timed with CUDA events after a warm-up; the calls of one run
are captured in a CUDA graph and the replay is timed, so a time is the
card's and not the host's time to enqueue (that is ``host_ms``, beside it).
``bound_ms`` is the
least time the card could take: bytes that must move over 3.35 TB/s (each
input read once, each output written once; for the gather, only the rows
this run's plan names) or operations over 67 TFLOP/s float32, whichever is
larger.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

MOE_ARCH = "granite-moe-1b-a400m"
SSM_ARCH = "mamba2-1.3b"
KIMI_ARCH = "kimi-k2-1t-a32b"
HYBRID_ARCH = "jamba-1.5-large-398b"
PREFILL_BATCH, PREFILL_LEN, DECODE_STEPS = 8, 1024, 32
EP_SHARDS = 8

REPLACES = {
    "topk_gating": "src/repro/kernels/topk_gating/kernel.py:51",
    "load_histogram": "src/repro/kernels/histogram/kernel.py:38",
    "dispatch_gather": "src/repro/kernels/dispatch/kernel.py:49",
    "ssd_state_scan": "src/repro/kernels/ssd_scan/kernel.py:43",
    "ssd_state_scan_bwd": "src/repro/models/layers/mamba2.py:132 (no Pallas backward: "
                          "repro differentiates this lax.scan)",
    "moe_combine": "src/repro/models/layers/moe.py moe_apply (no Pallas kernel: XLA's gathers)",
    "moe_combine_bwd": "src/repro/models/layers/moe.py moe_apply (no Pallas kernel: autodiff of XLA's gathers)",
    "attention": "none: repro's chunked attention is XLA's (src/repro/models/layers/attention.py)",
}
SOURCES = {
    "topk_gating": "src/repro_torch/kernels/csrc/topk_gating.cu",
    "load_histogram": "src/repro_torch/kernels/csrc/histogram.cu",
    "dispatch_gather": "src/repro_torch/kernels/csrc/dispatch.cu",
    "ssd_state_scan": "src/repro_torch/kernels/csrc/ssd_state_scan.cu",
    "ssd_state_scan_bwd": "src/repro_torch/kernels/csrc/ssd_state_scan.cu",
    "moe_combine": "src/repro_torch/kernels/csrc/combine.cu",
    "moe_combine_bwd": "src/repro_torch/kernels/csrc/combine.cu",
    "attention": "src/repro_torch/kernels/csrc/attention.cu",
}

# The device kernels of csrc/, as the profiler names them.
PORT_KERNEL_NAMES = (
    "topk_gating_group_kernel", "topk_gating_warp_kernel", "histogram_block_kernel",
    "histogram_cluster_kernel", "dispatch_gather_kernel", "dispatch_bytes_kernel",
    "ssd_scan_vec_kernel", "ssd_scan_scalar_kernel", "ssd_scan_bwd_kernel", "ssd_scan_bwd_decay_kernel",
    "moe_combine_fwd_kernel", "moe_combine_bwd_kernel", "attention_fwd_kernel",
)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(torch, fn, iters: int = 20, reps: int = 5, warmup: int = 3, graph: bool = True) -> float:
    """Median over ``reps`` of the mean time of ``iters`` back-to-back calls.

    The ``iters`` calls are captured once in a CUDA graph and each rep times
    one replay, so the host enqueues nothing inside the timed span and the
    time is what the card needs per call, launch gaps included.
    ``graph=False`` times eager calls instead, for a call that synchronises
    with the host and so cannot be captured; for a small input that time is
    the host's."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()

    def eager():
        for _ in range(iters):
            fn()

    run = eager
    if graph:
        captured = torch.cuda.CUDAGraph()
        with torch.cuda.graph(captured):
            eager()
        run = captured.replay
        run()
        torch.cuda.synchronize()
    means = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run()
        end.record()
        torch.cuda.synchronize()
        means.append(start.elapsed_time(end) / iters)
    if graph:
        del captured, run   # gives the graph's memory pool back
    return statistics.median(means)


def host_ms(torch, fn, iters: int = 200) -> float:
    """Host time to enqueue one call (no synchronisation inside the loop):
    where it equals the event time, the host and not the card sets the pace."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e3


def bound(bytes_moved: int, operations: int):
    """The least ms the card could take: bytes over the HBM rate or float32
    operations over the peak outside the tensor cores (``roofline/hw.py``),
    whichever is larger."""
    from repro_torch.roofline import hw

    by_bytes = bytes_moved / hw.HBM_BW * 1e3
    by_ops = operations / hw.PEAK_FLOPS_FP32 * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


# --------------------------------------------------------------------- #
# Phase 3: every kernel against its plain version
# --------------------------------------------------------------------- #


def gating_path(logits, k, general=False) -> str:
    """Which kernel the wrapper launches for these logits: the path is
    chosen in Python, from the shape and the base pointer."""
    from repro_torch.kernels.topk_gating.kernel import PATH_GROUP, VECTOR_BYTES, launch_shape

    aligned = not general and logits.data_ptr() % VECTOR_BYTES == 0
    path, _ = launch_shape(logits.shape[1], k, logits.element_size(), aligned)
    return "group" if path == PATH_GROUP else "warp"


def gating_check(torch, name, logits, k, general=False):
    """One call of the kernel against the plain version; returns the
    largest weight error."""
    from repro_torch.kernels.topk_gating.kernel import topk_gating
    from repro_torch.kernels.topk_gating.ref import topk_gating_ref

    w, idx = topk_gating(logits, k=k, general=general)
    torch.cuda.synchronize()
    wr, idxr = topk_gating_ref(logits, k)
    check(w.dtype == torch.float32 and idx.dtype == torch.int32, f"{name}: types")
    check(w.shape == wr.shape and idx.shape == idxr.shape, f"{name}: shapes")
    check(torch.equal(idx, idxr), f"{name}: top-k indices differ from the plain version")
    # rtol 1e-5 / atol 1e-6: float32 softmax sums taken in another order.
    check(torch.allclose(w, wr, rtol=1e-5, atol=1e-6), f"{name}: weights differ")
    return float((w - wr).abs().max()) if w.numel() else 0.0


def gating_case(torch, name, logits, k, timed, general=False):
    from repro_torch.kernels.topk_gating.kernel import topk_gating
    from repro_torch.kernels.topk_gating.ref import topk_gating_ref

    T, E = logits.shape
    out = {
        "kernel": "topk_gating", "case": name, "shape": [T, E, k],
        "dtype": str(logits.dtype).replace("torch.", ""),
        "path": gating_path(logits, k, general),
        "max_abs_err": gating_check(torch, name, logits, k, general),
    }
    if timed:
        from repro_torch.roofline import kernel_cost

        cost = kernel_cost.topk_gating(logits, k)
        nbytes = cost.bytes
        b_ms, by = bound(cost.bytes, cost.flops)
        one = torch.zeros(1, device=logits.device)
        timed_fns = {
            "kernel_ms": lambda: topk_gating(logits, k=k),
            # The warp path (one warp a row), on the same input.
            "general_ms": lambda: topk_gating(logits, k=k, general=True),
            # The floor any launch pays in this harness: one captured fill_.
            "node_ms": lambda: one.fill_(1.0),
        }
        # Three interleaved rounds: a slow moment of the host (which starts
        # each replay) then shows as one outlier, not as a difference.
        runs = {key: [] for key in ("kernel_ms", "general_ms", "node_ms", "host_ms", "general_host_ms")}
        for _ in range(3):
            for key, fn in timed_fns.items():
                runs[key].append(time_ms(torch, fn))
            runs["host_ms"].append(host_ms(torch, timed_fns["kernel_ms"]))
            runs["general_host_ms"].append(host_ms(torch, timed_fns["general_ms"]))
        out.update({key: statistics.median(v) for key, v in runs.items()})
        out["runs"] = runs
        out.update(
            plain_ms=time_ms(torch, lambda: topk_gating_ref(logits, k)),
            library_ms=None,   # no single call: softmax, topk and a division
            library_note="softmax+topk+renormalise (3 calls, no tie order): %.6f ms" % time_ms(
                torch, lambda: _softmax_topk(torch, logits, k)),
            bytes=nbytes, bound_ms=b_ms, bound_by=by,
        )
    return out


def gating_sweep(torch, gen):
    """The group path's shapes and their edges: E 8 to 256 in bfloat16 and
    in float32 on the 1/64 grid, k 1, 2, 8 and min(E, 32), T on either side
    of a warp's rows (a part-filled last warp).  Emits one line, one
    [case, path, max_abs_err] a case, and returns the largest error."""
    rows = []
    for E in (8, 16, 32, 64, 128, 256):
        for dtype in ("bfloat16", "float32"):
            for k in sorted({1, 2, 8, min(E, 32)}):
                for T in (1, 7, 8, 9, 8191, 8192):
                    x = torch.randn((T, E), generator=gen, device="cuda")
                    x = x.bfloat16() if dtype == "bfloat16" else torch.round(x * 64) / 64
                    name = f"T{T}_E{E}_k{k}_{dtype}"
                    rows.append([name, gating_path(x, k), gating_check(torch, name, x, k)])
    paths = {p: sum(r[1] == p for r in rows) for p in ("group", "warp")}
    emit({"phase": "gating_sweep", "cases": len(rows), "paths": paths, "rows": rows})
    return max(r[2] for r in rows), paths


def gating_edge_cases(torch, gen):
    """Ties inside one lane's 16 bytes and across the lanes of a group,
    rows where exp underflows to 0 for most experts (ties at 0, to the lower
    index), and logits off the 16-byte grid, which the warp path must take;
    each on both paths where the shape allows, with the expected picks of
    the tie rows written out."""
    from repro_torch.kernels.topk_gating.kernel import topk_gating

    cases = []
    ties = torch.zeros((5, 32), device="cuda")
    ties[1, [3, 11, 27]] = 2.0          # across lanes (bf16: lanes 0, 1, 3)
    ties[1, [1, 5]] = 1.0               # inside lane 0's 16 bytes
    ties[2] = torch.arange(16, device="cuda").repeat_interleave(2).float()
    ties[3, 31] = 1.0
    ties[4, 8:16] = 3.0                 # one bf16 lane's whole vector
    want = [[0, 1, 2, 3, 4, 5, 6, 7], [3, 11, 27, 1, 5, 0, 2, 4],
            [30, 31, 28, 29, 26, 27, 24, 25], [31, 0, 1, 2, 3, 4, 5, 6],
            [8, 9, 10, 11, 12, 13, 14, 15]]
    # Underflow: most experts far below the row's maximum (exp gives 0 or a
    # subnormal), a few live ones.
    T, E = 4096, 32
    deep = -150.0 + 50.0 * torch.rand((T, E), generator=gen, device="cuda")
    live = torch.rand((T, E), generator=gen, device="cuda") < 0.08
    under = torch.round(torch.where(live, torch.randn((T, E), generator=gen, device="cuda"), deep) * 64) / 64
    under[0] = -200.0
    under[0, 17] = 0.0                  # one live expert, 31 zeros
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        for general in (False, True):
            suffix = "_warp" if general else ""
            cases.append(gating_case(torch, f"ties_E32_{tag}{suffix}", ties.to(dtype), 8, False, general))
            _, idx = topk_gating(ties.to(dtype), k=8, general=general)
            check(idx.tolist() == want, f"ties_E32_{tag}{suffix}: ties must go to the lower index")
            cases.append(gating_case(torch, f"underflow_T{T}_E{E}_{tag}{suffix}", under.to(dtype), 8, False, general))
        _, idx = topk_gating(under.to(dtype), k=8)
        check(idx[0].tolist() == [17, 0, 1, 2, 3, 4, 5, 6], f"underflow_{tag}: zeros to the lower index")
        # A view one element off the 16-byte grid: the warp path takes it.
        flat = torch.randn(8192 * 32 + 1, generator=gen, device="cuda")
        flat = flat.bfloat16() if dtype == torch.bfloat16 else torch.round(flat * 64) / 64
        shifted = flat[1:].view(8192, 32)
        case = gating_case(torch, f"misaligned_T8192_E32_{tag}", shifted, 8, False)
        check(case["path"] == "warp", f"misaligned_{tag}: the group path took a misaligned row")
        cases.append(case)
    return cases


def _softmax_topk(torch, logits, k):
    w, idx = torch.topk(torch.softmax(logits.float(), -1), k)
    return w / w.sum(-1, keepdim=True).clamp(min=1e-9), idx


def histogram_case(torch, name, ids, E, timed):
    from repro_torch.kernels.histogram.kernel import load_histogram
    from repro_torch.kernels.histogram.ref import load_histogram_ref

    out_k = load_histogram(ids, num_dest=E)
    torch.cuda.synchronize()
    out_r = load_histogram_ref(ids, E)
    check(out_k.dtype == torch.float32 and out_k.shape == (E,), f"{name}: type or shape")
    check(torch.equal(out_k, out_r), f"{name}: counts differ from the plain version")
    out = {
        "kernel": "load_histogram", "case": name, "shape": [ids.numel(), E],
        "max_abs_err": float((out_k - out_r).abs().max()),
    }
    if timed:
        from repro_torch.roofline import kernel_cost

        in_range = ids[(ids >= 0) & (ids < E)]
        cost = kernel_cost.load_histogram(ids, E)
        nbytes = cost.bytes
        b_ms, by = bound(cost.bytes, cost.flops)
        out.update(
            kernel_ms=time_ms(torch, lambda: load_histogram(ids, num_dest=E)),
            host_ms=host_ms(torch, lambda: load_histogram(ids, num_dest=E)),
            plain_ms=time_ms(torch, lambda: load_histogram_ref(ids, E)),
            # bincount reads its largest id back on the host: not capturable.
            library_ms=time_ms(torch, lambda: torch.bincount(in_range, minlength=E), graph=False),
            library_timed="eager",
            bytes=nbytes, bound_ms=b_ms, bound_by=by,
        )
    return out


def dispatch_controls(torch, x, src, valid):
    """Three runs that split the gather's time between re-reads of ``x``,
    the buffer's stores and the card's store rate, timed in the same call as
    the kernel: ``resident_ms`` keeps the mask but maps every source into
    the first 64 rows of ``x`` (the re-reads then surely hit L2),
    ``zeros_ms`` leaves every slot empty (stores alone), ``fill_ms`` is
    ``zero_()`` on a buffer of the same size."""
    from repro_torch.kernels.dispatch.kernel import dispatch_gather

    resident = src % min(64, x.shape[0])
    empty = torch.zeros_like(valid)
    buf = torch.empty((src.numel(), x.shape[1]), dtype=x.dtype, device=x.device)
    out = {
        "resident_ms": time_ms(torch, lambda: dispatch_gather(x, resident, valid)),
        "zeros_ms": time_ms(torch, lambda: dispatch_gather(x, src, empty)),
        "fill_ms": time_ms(torch, lambda: buf.zero_()),
    }
    del resident, empty, buf
    return out


def dispatch_case(torch, name, x, src, valid, timed, controls=False):
    from repro_torch.kernels.dispatch.kernel import dispatch_gather
    from repro_torch.kernels.dispatch.ref import dispatch_gather_ref

    out_k = dispatch_gather(x, src, valid)
    torch.cuda.synchronize()
    out_r = dispatch_gather_ref(x, src, valid)
    check(out_k.dtype == x.dtype and out_k.shape == out_r.shape, f"{name}: type or shape")
    # By value, not by bits: the kernel stores +0 for an empty slot where
    # the plain version's multiply can give -0.
    check(torch.equal(out_k, out_r), f"{name}: buffer differs from the plain version")
    T, D = x.shape
    out = {
        "kernel": "dispatch_gather", "case": name, "shape": [T, D, src.numel()],
        "dtype": str(x.dtype).replace("torch.", ""),
        "valid_frac": float((valid != 0).float().mean()) if src.numel() else 0.0,
        "max_abs_err": float((out_k.float() - out_r.float()).abs().max()) if src.numel() else 0.0,
    }
    if timed:
        from repro_torch.roofline import kernel_cost

        # The kernel's share of bound counts what this plan reads: each
        # distinct source row once, no row for an empty slot.  The op
        # counter's record counts from shapes alone, every slot filled.
        row = D * x.element_size()
        live = valid != 0
        rows_read = int(torch.unique(src[live]).numel())
        nbytes = rows_read * row + src.numel() * row + src.numel() * 5
        b_ms, by = bound(nbytes, 0)
        shape_only = kernel_cost.dispatch_gather(x, src)
        out.update(shape_bytes=shape_only.bytes, shape_bound_ms=bound(shape_only.bytes, shape_only.flops)[0])
        src64 = src.to(torch.int64)
        out.update(
            kernel_ms=time_ms(torch, lambda: dispatch_gather(x, src, valid)),
            host_ms=host_ms(torch, lambda: dispatch_gather(x, src, valid), iters=20),
            plain_ms=time_ms(torch, lambda: dispatch_gather_ref(x, src, valid)),
            # The gather alone; it reads a row for the empty slots too and
            # applies no mask.
            library_ms=time_ms(torch, lambda: torch.index_select(x, 0, src64)),
            bytes=nbytes, bound_ms=b_ms, bound_by=by,
        )
        del src64
        if controls:
            out["controls"] = dispatch_controls(torch, x, src, valid)
    del out_k, out_r
    return out


def ssd_case(torch, name, states, decay, timed):
    from repro_torch.kernels.ssd_scan.kernel import ssd_state_scan
    from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_ref

    out_k = ssd_state_scan(states, decay)
    torch.cuda.synchronize()
    out_r = ssd_state_scan_ref(states, decay)
    check(out_k.dtype == torch.float32 and out_k.shape == states.shape, f"{name}: type or shape")
    # Bit for bit: the kernel rounds the multiply and the add one by one,
    # as the plain version's two tensor operations do.
    check(torch.equal(out_k, out_r), f"{name}: prefix differs from the plain version")
    check(bool((out_k[0] == 0).all()), f"{name}: the first prefix must be zero")
    C, H, P, N = states.shape
    out = {
        "kernel": "ssd_state_scan", "case": name, "shape": [C, H, P, N],
        "dtype": str(states.dtype).replace("torch.", ""),
        "max_abs_err": float((out_k - out_r).abs().max()) if out_k.numel() else 0.0,
    }
    if timed:
        # The prefix is exclusive: states[C-1] and decay[C-1] reach no
        # output, so C-1 planes and their decays are read and C planes
        # written, with a multiply and an add per element read.
        from repro_torch.roofline import kernel_cost

        cost = kernel_cost.ssd_state_scan(states)
        nbytes = cost.bytes
        b_ms, by = bound(cost.bytes, cost.flops)
        out.update(
            kernel_ms=time_ms(torch, lambda: ssd_state_scan(states, decay)),
            host_ms=host_ms(torch, lambda: ssd_state_scan(states, decay)),
            plain_ms=time_ms(torch, lambda: ssd_state_scan_ref(states, decay)),
            library_ms=None,   # no single PyTorch call computes this prefix
            bytes=nbytes, bound_ms=b_ms, bound_by=by,
        )
    del out_k, out_r
    return out


#: d_decay, kernel against the plain backward: a sum over the P * N plane of
#: each (c, h), taken in another order (a thread's four products, a warp's
#: shuffle tree, the block's warps, the blocks in order) than the plain
#: version's.  rtol 1e-5 and an absolute 1e-5 of the largest |d_decay|.
BWD_DECAY_RTOL = 1e-5


def ssd_bwd_case(torch, name, g, out, decay, states_dtype, timed):
    """The scan's backward kernel against its plain version on one input:
    d_states EQUAL (in the states' dtype), d_decay within BWD_DECAY_RTOL,
    and a second kernel run the same bits."""
    from repro_torch.kernels.ssd_scan.kernel_bwd import ssd_state_scan_bwd
    from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_bwd_ref

    ds_k, dd_k = ssd_state_scan_bwd(g, out, decay, states_dtype)
    ds_k2, dd_k2 = ssd_state_scan_bwd(g, out, decay, states_dtype)
    torch.cuda.synchronize()
    ds_r, dd_r = ssd_state_scan_bwd_ref(g, out, decay)
    ds_r = ds_r.to(states_dtype)
    check(ds_k.dtype == states_dtype and ds_k.shape == g.shape, f"{name}: d_states type or shape")
    check(dd_k.dtype == torch.float32 and dd_k.shape == decay.shape, f"{name}: d_decay type or shape")
    # Bit for bit: the adjoint's multiply and add are rounded one by one, as
    # the plain version's two tensor operations are, and bfloat16 is rounded
    # to nearest even, as PyTorch casts.
    check(torch.equal(ds_k, ds_r), f"{name}: d_states differ from the plain version")
    scale = float(dd_r.abs().max()) if dd_r.numel() else 0.0
    check(torch.allclose(dd_k, dd_r, rtol=BWD_DECAY_RTOL, atol=BWD_DECAY_RTOL * max(scale, 1e-30)),
          f"{name}: d_decay differs from the plain version")
    check(torch.equal(ds_k, ds_k2) and torch.equal(dd_k, dd_k2), f"{name}: two kernel runs differ")
    C, H, P, N = g.shape
    res = {
        "kernel": "ssd_state_scan_bwd", "case": name, "shape": [C, H, P, N],
        "dtype": str(states_dtype).replace("torch.", ""),
        "max_abs_err": float((dd_k - dd_r).abs().max()) if dd_k.numel() else 0.0,
        "d_decay_max_rel_err": float((dd_k - dd_r).abs().max()) / scale if scale else 0.0,
        "d_states_equal": True, "runs_equal": True,
    }
    if timed:
        # g[1..C-1] and out[1..C-2] are read with decay[1..C-2]; d_states
        # (C planes) and d_decay written.  Per element of a live chunk: the
        # adjoint's multiply and add, and d_decay's multiply and add.
        from repro_torch.roofline import kernel_cost

        cost = kernel_cost.ssd_state_scan_bwd(g, states_dtype)
        nbytes = cost.bytes
        b_ms, by = bound(cost.bytes, cost.flops)
        res.update(
            kernel_ms=time_ms(torch, lambda: ssd_state_scan_bwd(g, out, decay, states_dtype)),
            host_ms=host_ms(torch, lambda: ssd_state_scan_bwd(g, out, decay, states_dtype)),
            plain_ms=time_ms(torch, lambda: ssd_state_scan_bwd_ref(g, out, decay)),
            library_ms=None,   # no single PyTorch call computes this backward
            bytes=nbytes, bound_ms=b_ms, bound_by=by,
        )
    del ds_k, dd_k, ds_k2, dd_k2, ds_r, dd_r
    return res


def ssd_bwd_inputs(torch, gen, states, decay):
    """The backward's inputs for a forward on ``states`` and ``decay``: the
    prefix the scan kernel makes, and a prefix gradient drawn from ``gen``."""
    from repro_torch.kernels.ssd_scan.kernel import ssd_state_scan

    out = ssd_state_scan(states, decay)
    g = torch.randn(states.shape, generator=gen, device="cuda")
    return g, out


def served_scan_inputs(torch, gen):
    """The scan's input at the served shape, as the layer builds it: one
    ``ssd_chunked`` of a 8 x 1024 bfloat16 prompt at mamba2-1.3b's widths
    (64 heads of 64, 8 groups, d_state 128, chunk 128) hands the scan
    (9, 512, 64, 128) float32 states, [h0, s_0, ..., s_7] over batch x
    heads.  Its decays are redrawn in (0, 1): at random weights they are all
    but zero, and the scan would carry nothing."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_ref
    from repro_torch.models.layers.mamba2 import ssd_chunked

    B, S, H, P, G, N = PREFILL_BATCH, PREFILL_LEN, 64, 64, 8, 128

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    seen = []

    def capture(states, decay):
        seen.append(states)
        return ssd_state_scan_ref(states, decay)

    bf16 = torch.bfloat16
    ssd_chunked(F.silu(randn(B, S, H, P)).to(bf16), F.softplus(randn(B, S, H) - 3.0),
                -torch.ones(H, device="cuda"), F.silu(randn(B, S, G, N)).to(bf16),
                F.silu(randn(B, S, G, N)).to(bf16), 128,
                h0=torch.zeros((B, H, P, N), device="cuda"), scan=capture)
    (states,) = seen
    decay = torch.rand(states.shape[:2], generator=gen, device="cuda")
    return states, decay


def main_path_plan(torch, gen, arch, tokens: int, dtype):
    """Inputs of the three kernels as one MoE layer of ``arch`` makes them:
    router logits of random activations, the picks' expert ids, and the
    routing plan at the uniform capacity."""
    from repro_torch.config.base import get_config
    from repro_torch.kernels.histogram.ref import load_histogram_ref
    from repro_torch.kernels.topk_gating.ref import topk_gating_ref
    from repro_torch.models.layers.moe import capacities, dispatch_plan

    cfg = get_config(arch)
    d, E, k = cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k
    x = torch.randn((tokens, d), generator=gen, device="cuda", dtype=torch.float32).to(dtype)
    router = (0.02 * torch.randn((d, E), generator=gen, device="cuda")).to(dtype)
    logits = x @ router
    _, idx = topk_gating_ref(logits, k)
    flat_e = idx.reshape(-1)
    counts = load_histogram_ref(flat_e, E)
    c_static, c_buf = capacities(cfg, tokens)
    cap = torch.full((E,), c_static, dtype=torch.int32, device="cuda")
    _, _, _, src, valid = dispatch_plan(flat_e, counts, cap, c_buf=c_buf, top_k=k)
    return x, logits, flat_e.contiguous(), src.contiguous(), valid.contiguous()


#: The combine's weight gradients against the contract's: a dot product of
#: d float32 products, summed by lanes and a shuffle tree in the kernel and
#: by one PyTorch sum in the contract; held to 2^-13 of the sum of the
#: products' magnitudes (two orders of d <= 7,168 terms part by far less).
COMBINE_DW_RTOL = 2.0 ** -13
#: The benchmark's granite serve cell: rounds of 64 prompts of 1,024.
COMBINE_SERVE_PROMPTS = 64


def same_bits(torch, a, b) -> bool:
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}
    return a.dtype == b.dtype and torch.equal(a.view(ints[a.element_size()]), b.view(ints[b.element_size()]))


def combine_random(torch, gen, T, k, S, d, dtype, p_keep=0.8):
    """A combine's inputs with each pick kept at ``p_keep`` (at most S of
    them, each on a slot of its own; S for a dropped pick), random rows,
    weights and gradient."""
    picked = torch.nonzero(torch.rand((T * k,), generator=gen, device="cuda") < p_keep).squeeze(1)[:S]
    slot = torch.full((T * k,), S, dtype=torch.int32, device="cuda")
    slot[picked] = torch.randperm(max(S, 1), generator=gen, device="cuda")[:picked.numel()].to(torch.int32)
    return (torch.randn((S, d), generator=gen, device="cuda").to(dtype), slot.view(T, k),
            torch.rand((T, k), generator=gen, device="cuda"),
            torch.randn((T, d), generator=gen, device="cuda").to(dtype))


def combine_plan(torch, gen, arch, tokens: int, dtype, alpha: float = 0.6):
    """A combine's inputs as one MoE layer of ``arch`` makes them: the
    routing plan at the uniform capacity for router logits of random
    activations skewed by a Zipf ``alpha`` bias (picks over capacity
    dropped), random expert outputs for every slot, and a random gradient
    of the output."""
    import numpy as np

    from repro_torch.config.base import get_config
    from repro_torch.kernels.histogram.ref import load_histogram_ref
    from repro_torch.kernels.topk_gating.ref import topk_gating_ref
    from repro_torch.models.layers.moe import capacities, dispatch_plan

    cfg = get_config(arch)
    d, E, k = cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k
    x = torch.randn((tokens, d), generator=gen, device="cuda")
    router = 0.02 * torch.randn((d, E), generator=gen, device="cuda")
    probs = 1.0 / np.arange(1, E + 1) ** alpha
    bias = torch.tensor(np.log(probs / probs.sum()), dtype=torch.float32, device="cuda")
    w, idx = topk_gating_ref(x @ router + (bias - bias.mean()), k)
    flat_e = idx.reshape(-1)
    c_static, c_buf = capacities(cfg, tokens)
    cap = torch.full((E,), c_static, dtype=torch.int32, device="cuda")
    order, slot_sorted, _, _, _ = dispatch_plan(flat_e, load_histogram_ref(flat_e, E), cap, c_buf=c_buf, top_k=k)
    slot = torch.empty_like(slot_sorted)
    slot[order] = slot_sorted
    S = E * c_buf
    del x, router, idx, flat_e, order, slot_sorted
    return (torch.randn((S, d), generator=gen, device="cuda").to(dtype), slot.reshape(tokens, k).to(torch.int32),
            w, torch.randn((tokens, d), generator=gen, device="cuda").to(dtype))


def combine_case(torch, name, y_flat, slot, w, dy, timed):
    """The combine's two kernels on one input, each against the contract
    (``combine/ref.py``) and against the plain loop (``PLAIN_OPS.combine``,
    differentiated by autograd), and each run twice for the same bits.

    Forward: the contract's bits; in float32 the loop's bits too, in
    bfloat16 within (3k + 1) bfloat16 half-steps (2^-8) of the sum of the
    picks' magnitudes, the most the loop's k weight casts, k products and k
    sums can move it.  Backward: d_y_flat the contract's bits (and the
    loop's in float32; in bfloat16 within 2^-6 of |w dy|, the loop's cast
    weight and rounded product); d_w within ``COMBINE_DW_RTOL`` of the sum
    of its products' magnitudes against the contract (and the loop's in
    float32; in bfloat16 2^-6 of it, the loop's rounded products and sum).
    Returns a row for each kernel."""
    from repro_torch.kernels.combine.kernel import moe_combine
    from repro_torch.kernels.combine.kernel_bwd import moe_combine_bwd
    from repro_torch.kernels.combine.ref import moe_combine_bwd_ref, moe_combine_contract, moe_combine_ref

    (S, d), (T, k) = y_flat.shape, slot.shape
    f32 = y_flat.dtype == torch.float32
    kept = int((slot < S).sum())
    y_k, y_k2 = moe_combine(y_flat, slot, w), moe_combine(y_flat, slot, w)
    torch.cuda.synchronize()
    check(y_k.dtype == y_flat.dtype and tuple(y_k.shape) == (T, d), f"{name}: y type or shape")
    check(same_bits(torch, y_k, y_k2), f"{name}: two forward runs differ")
    check(torch.equal(y_k, moe_combine_contract(y_flat, slot, w)), f"{name}: y differs from the contract")
    y_loop = moe_combine_ref(y_flat, slot, w)
    mag = moe_combine_contract(y_flat.abs().float(), slot, w.abs())
    fwd_err = (y_k.float() - y_loop.float()).abs()
    band = (3 * k + 1) * 2.0 ** -8 * mag
    if f32:
        check(torch.equal(y_k, y_loop), f"{name}: y differs from the loop in float32")
    else:
        check(bool((fwd_err <= band).all()), f"{name}: y off the loop's band")
    fwd = {"kernel": "moe_combine", "case": name, "shape": [T, k, S, d],
           "dtype": str(y_flat.dtype).replace("torch.", ""), "kept_frac": kept / max(T * k, 1),
           "contract_equal": True, "runs_equal": True,
           "max_abs_err": float(fwd_err.max()) if fwd_err.numel() else 0.0,
           "loop_band_used": float((fwd_err / band.clamp_min(1e-30)).max()) if fwd_err.numel() else 0.0}
    del y_k2, y_loop, mag, fwd_err, band

    dyf_k, dw_k = moe_combine_bwd(dy, y_flat, slot, w)
    dyf_k2, dw_k2 = moe_combine_bwd(dy, y_flat, slot, w)
    torch.cuda.synchronize()
    check(dyf_k.dtype == y_flat.dtype and dyf_k.shape == y_flat.shape, f"{name}: d_y_flat type or shape")
    check(dw_k.dtype == torch.float32 and dw_k.shape == w.shape, f"{name}: d_w type or shape")
    check(same_bits(torch, dyf_k, dyf_k2) and same_bits(torch, dw_k, dw_k2), f"{name}: two backward runs differ")
    del dyf_k2, dw_k2
    dyf_c, dw_c = moe_combine_bwd_ref(dy, y_flat, slot, w)
    check(torch.equal(dyf_k, dyf_c), f"{name}: d_y_flat differs from the contract")
    dw_mag = moe_combine_bwd_ref(dy.abs(), y_flat.abs(), slot, w)[1]
    dw_err = float((dw_k - dw_c).abs().max()) if dw_k.numel() else 0.0
    check(bool(((dw_k - dw_c).abs() <= COMBINE_DW_RTOL * dw_mag).all()), f"{name}: d_w off the contract ({dw_err})")
    del dyf_c, dw_c
    yf = y_flat.clone().requires_grad_(True)
    ww = w.clone().requires_grad_(True)
    with torch.enable_grad():
        dyf_l, dw_l = torch.autograd.grad(moe_combine_ref(yf, slot, ww), (yf, ww), dy)
    del yf, ww
    dw_l_err = (dw_k - dw_l).abs()
    if f32:
        check(torch.equal(dyf_k, dyf_l), f"{name}: d_y_flat differs from the loop's in float32")
        check(bool((dw_l_err <= COMBINE_DW_RTOL * dw_mag).all()), f"{name}: d_w off the loop's")
    else:
        wdy = moe_combine_bwd_ref(dy.abs(), y_flat, slot, w.abs())[0].float()
        check(bool(((dyf_k.float() - dyf_l.float()).abs() <= 2.0 ** -6 * wdy).all()),
              f"{name}: d_y_flat off the loop's band")
        check(bool((dw_l_err <= 2.0 ** -6 * dw_mag).all()), f"{name}: d_w off the loop's band")
        del wdy
    bwd = {"kernel": "moe_combine_bwd", "case": name, "shape": [T, k, S, d], "dtype": fwd["dtype"],
           "kept_frac": fwd["kept_frac"], "d_y_flat_contract_equal": True, "runs_equal": True,
           "max_abs_err": dw_err, "d_w_loop_max_abs_err": float(dw_l_err.max()) if dw_l_err.numel() else 0.0,
           "d_w_rtol": COMBINE_DW_RTOL}
    del dyf_k, dw_k, dyf_l, dw_l, dw_l_err, dw_mag
    if timed:
        row = d * y_flat.element_size()
        fwd_bytes = kept * row + T * row + 8 * T * k
        bwd_bytes = T * row + kept * row + S * row + 12 * T * k + S
        b_ms, by = bound(fwd_bytes, 2 * kept * d)
        fwd.update(kernel_ms=time_ms(torch, lambda: moe_combine(y_flat, slot, w)),
                   host_ms=host_ms(torch, lambda: moe_combine(y_flat, slot, w), iters=20),
                   plain_ms=time_ms(torch, lambda: moe_combine_ref(y_flat, slot, w)),
                   library_ms=None,   # no single PyTorch call computes this sum
                   bytes=fwd_bytes, bound_ms=b_ms, bound_by=by)
        # The wrapper's call: its ownership bytes (a fill and a scatter) and
        # the kernel.  The plain time is the loop's autograd backward, eager:
        # its index gradients sort and walk the clamped dropped picks.
        b_ms, by = bound(bwd_bytes, 3 * kept * d)
        yf = y_flat.clone().requires_grad_(True)
        ww = w.clone().requires_grad_(True)
        with torch.enable_grad():
            y_graph = moe_combine_ref(yf, slot, ww)
        bwd.update(kernel_ms=time_ms(torch, lambda: moe_combine_bwd(dy, y_flat, slot, w)),
                   host_ms=host_ms(torch, lambda: moe_combine_bwd(dy, y_flat, slot, w), iters=20),
                   plain_ms=time_ms(torch, lambda: torch.autograd.grad(y_graph, (yf, ww), dy, retain_graph=True),
                                    iters=3, reps=3, warmup=1, graph=False),
                   plain_timed="eager", library_ms=None,
                   bytes=bwd_bytes, bound_ms=b_ms, bound_by=by)
        del y_graph, yf, ww
    return [fwd, bwd]


def combine_checks(torch, gen):
    """The combine at the main path's shapes (granite trained and served:
    its train step, its serve prefill, a decode step; kimi-k2's d_model
    7,168), timed, then awkward shapes."""
    cases = []
    for name, arch, tokens in (("train", MOE_ARCH, TRAIN_BATCH * TRAIN_SEQ),
                               ("prefill", MOE_ARCH, COMBINE_SERVE_PROMPTS * PREFILL_LEN),
                               ("decode", MOE_ARCH, COMBINE_SERVE_PROMPTS),
                               ("kimi_train", KIMI_ARCH, TRAIN_BATCH * TRAIN_SEQ)):
        inputs = combine_plan(torch, gen, arch, tokens, torch.bfloat16)
        cases += combine_case(torch, f"{name}_bf16", *inputs, timed=True)
        if name == "train":
            cases += combine_case(torch, "train_f32", *(t.float() if t.is_floating_point() else t
                                                        for t in inputs), timed=True)
        del inputs
        torch.cuda.empty_cache()
    for name, (T, k, S, d, dtype, p) in {
        "T1_k1": (1, 1, 4, 64, torch.bfloat16, 1.1),
        "T33_k32_f32": (33, 32, 2000, 128, torch.float32, 0.7),
        "T1500_two_vectors_a_lane": (1500, 8, 20000, 1024, torch.bfloat16, 0.8),
        "d1000_f32_ragged_piece": (300, 8, 3000, 1000, torch.float32, 0.8),
        "d1001_bf16_scalar": (77, 3, 400, 1001, torch.bfloat16, 0.7),
        "d7_f32_scalar": (50, 4, 300, 7, torch.float32, 0.7),
        "all_dropped": (40, 8, 500, 256, torch.bfloat16, 0.0),
        "all_kept": (40, 8, 320, 256, torch.bfloat16, 1.1),
        "T0": (0, 8, 64, 128, torch.bfloat16, 0.8),
    }.items():
        cases += combine_case(torch, name, *combine_random(torch, gen, T, k, S, d, dtype, p), timed=False)
    y_flat, slot, w, dy = combine_random(torch, gen, 60, 4, 500, 64, torch.float32)
    shifted = torch.empty(y_flat.numel() + 1, device="cuda")[1:].view(y_flat.shape)   # 4 bytes off the grid
    shifted.copy_(y_flat)
    cases += combine_case(torch, "misaligned_y_flat", shifted, slot, w, dy, timed=False)
    del y_flat, slot, w, dy, shifted
    torch.cuda.empty_cache()
    return cases


#: (name, B, Sq, H, K, hd, S_cache, q_offset, kv_len, causal, timed): the
#: attention kernel at granite's served prefill (64 prompts of 1,024 into a
#: cache of 1,088) and at head width 128 (pixtral-12b's 8 x 1,024 prefill,
#: 32 heads over 8), timed; then the other served shapes and ragged ones.
ATTENTION_CASES = (
    ("granite_prefill", 64, 1024, 16, 8, 64, 1088, 0, 1024, True, True),
    ("hd128_G4", 8, 1024, 32, 8, 128, 1024, 0, 1024, True, True),
    ("whisper_encoder", 8, 1500, 8, 8, 64, 1500, 0, 1500, False, False),
    ("whisper_cross", 8, 224, 8, 8, 64, 1500, 0, 1500, False, False),
    ("kimi_prefill_G8", 8, 1024, 64, 8, 128, 1056, 0, 1024, True, False),
    ("ragged_offset_37", 3, 301, 12, 4, 64, 400, 37, 338, True, False),
    ("ragged_hd128_G12", 2, 77, 24, 2, 128, 100, 5, 82, True, False),
    ("full_ragged_kv", 2, 130, 6, 3, 128, 300, 0, 211, False, False),
    ("Sq1", 2, 1, 8, 2, 128, 50, 20, 21, True, False),
    ("Sq_past_kv_len", 2, 40, 4, 2, 64, 64, 30, 50, True, False),
)
def attention_case(torch, name, q, k, v, causal, q_offset, kv_len, timed):
    """The attention kernel against the plain version (``attention/ref.py``),
    element by element within ``ref.band`` (the two round their
    probabilities and outputs at different points), and run twice for the
    same bits; its largest gap from ``chunked_attention`` (the path the port
    ran before, which rounds its scores too) is printed, not checked.
    Timed: the kernel, both of them, and ``F.scaled_dot_product_attention``
    as the library's yardstick (the port never calls it), against the
    larger of the products' time at the bf16 peak and the bytes' at the
    HBM rate (``kernel_cost.attention``)."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention.kernel import attention_fwd
    from repro_torch.kernels.attention.ref import attention_ref
    from repro_torch.kernels.attention.ref import band as attention_band
    from repro_torch.models.layers.attention import chunked_attention
    from repro_torch.roofline import hw, kernel_cost

    B, Sq, H, hd = q.shape
    K = k.shape[2]

    def chunked():
        return chunked_attention(q.reshape(B, Sq, K, H // K, hd), k, v, causal=causal, q_offset=q_offset,
                                 kv_len=kv_len).reshape(B, Sq, H, hd)

    def kernel():
        return attention_fwd(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)

    def plain():
        return attention_ref(q, k, v, causal=causal, q_offset=q_offset, kv_len=kv_len)

    got = kernel()
    # The cache past kv_len may hold anything: the kernel never reads it.
    junk_k, junk_v = k.clone(), v.clone()
    junk_k[:, kv_len:] = float("nan")
    junk_v[:, kv_len:] = float("inf")
    again = attention_fwd(q, junk_k, junk_v, causal=causal, q_offset=q_offset, kv_len=kv_len)
    torch.cuda.synchronize()
    check(got.shape == q.shape and got.dtype == q.dtype and got.is_contiguous(), f"attention {name}: out")
    check(bool(torch.isfinite(got.float()).all()), f"attention {name}: out not finite")
    check(same_bits(torch, got, again), f"attention {name}: two runs differ, the second with NaN past kv_len")
    del again, junk_k, junk_v
    want = plain()
    band = attention_band(q, k, v, want, causal=causal, q_offset=q_offset, kv_len=kv_len)
    gap = (got.float() - want.float()).abs()
    share = float((gap / band).max())
    check(share <= 1.0, f"attention {name}: a gap {share} times its band off the plain version")
    late = band[:, Sq // 2:]
    row = {"kernel": "attention", "case": name, "shape": [B, Sq, H, K, hd, k.shape[1]],
           "dtype": str(q.dtype).replace("torch.", ""), "causal": causal, "q_offset": q_offset,
           "kv_len": kv_len, "runs_equal": True, "max_abs_err": float(gap.max()), "band_share": share,
           "band_max": float(band.max()), "band_median_late_rows": float(late.median()),
           "chunked_max_abs_err": float((got.float() - chunked().float()).abs().max())}
    del got, want, band, gap, late
    torch.cuda.empty_cache()
    if timed:
        cost = kernel_cost.attention(q, k, causal, q_offset, kv_len)
        by_ops, by_bytes = cost.flops / hw.PEAK_FLOPS_BF16 * 1e3, cost.bytes / hw.HBM_BW * 1e3
        # SDPA's layout, made once outside the timed calls; its causal mask
        # is the top-left one, which is this case's where q_offset is 0 and
        # the keys are the queries.
        qt = q.transpose(1, 2).contiguous()
        kt, vt = (t[:, :kv_len].transpose(1, 2).contiguous() for t in (k, v))

        def library():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

        row.update(kernel_ms=time_ms(torch, kernel), host_ms=host_ms(torch, kernel, iters=50),
                   plain_ms=time_ms(torch, plain, iters=2, reps=3, warmup=1),
                   chunked_ms=time_ms(torch, chunked, iters=2, reps=3, warmup=1),
                   library_ms=time_ms(torch, library) if q_offset == 0 and Sq == kv_len else None,
                   flops=cost.flops, bytes=cost.bytes, bound_ms=max(by_ops, by_bytes),
                   bound_by="operations" if by_ops >= by_bytes else "bytes")
        row["tflops"] = cost.flops / (row["kernel_ms"] * 1e-3) / 1e12
        row["bound_share"] = row["bound_ms"] / row["kernel_ms"]
        del qt, kt, vt
        torch.cuda.empty_cache()
    return row


def attention_checks(torch, gen):
    """The attention kernel at ATTENTION_CASES' shapes in bf16, then fp16,
    and q read through strides that are not the contiguous ones."""
    cases = []
    for name, B, Sq, H, K, hd, S_cache, q_offset, kv_len, causal, timed in ATTENTION_CASES:
        q = torch.randn((B, Sq, H, hd), generator=gen, device="cuda").bfloat16()
        k, v = (torch.randn((B, S_cache, K, hd), generator=gen, device="cuda").bfloat16() for _ in range(2))
        cases.append(attention_case(torch, name, q, k, v, causal, q_offset, kv_len, timed))
        del q, k, v
        torch.cuda.empty_cache()
    q, k, v = (torch.randn((2, 200, 4, 64), generator=gen, device="cuda").half() for _ in range(3))
    cases.append(attention_case(torch, "fp16_G1", q, k, v, True, 0, 200, False))
    # q as a slice of a wider (B, S, 3, H, hd) buffer: read through its strides.
    wide = torch.randn((2, 150, 3, 8, 64), generator=gen, device="cuda").bfloat16()
    k, v = (torch.randn((2, 150, 2, 64), generator=gen, device="cuda").bfloat16() for _ in range(2))
    cases.append(attention_case(torch, "strided_q", wide[:, :, 1], k, v, True, 0, 150, False))
    del q, k, v, wide
    torch.cuda.empty_cache()
    return cases


def phase_kernel_checks(torch):
    from repro_torch.kernels.dispatch.kernel import WARPS_PER_BLOCK, launch_blocks
    from repro_torch.kernels.histogram.kernel import SINGLE_BLOCK_MAX
    from repro_torch.kernels.topk_gating.kernel import topk_gating

    gen = torch.Generator(device="cuda").manual_seed(1234)
    cases = []

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    def randint(lo, hi, n):
        return torch.randint(lo, hi, (n,), generator=gen, device="cuda", dtype=torch.int32)

    # ---- the main path's shapes: one MoE layer at prefill and at decode
    E, k = 32, 8
    for label, tokens in (("prefill", PREFILL_BATCH * PREFILL_LEN), ("decode", PREFILL_BATCH)):
        x, logits, flat_e, src, valid = main_path_plan(torch, gen, MOE_ARCH, tokens, torch.bfloat16)
        cases.append(gating_case(torch, f"{label}_bf16", logits, k, timed=True))
        check(cases[-1]["path"] == "group", f"gating {label}: the served shape must take the group path")
        cases.append(gating_case(torch, f"{label}_bf16_warp", logits, k, False, general=True))
        cases.append(histogram_case(torch, label, flat_e, E, timed=True))
        served = label == "prefill"
        cases.append(dispatch_case(torch, f"{label}_bf16", x, src, valid, timed=True, controls=served))
        cases.append(dispatch_case(torch, f"{label}_f32", x.float(), src, valid, timed=True, controls=served))
        if served:
            # A rank of the expert_parallel phase gathers only its shard's
            # slots: the first EP_MODEL-th of the expert-major buffer.
            n = src.numel() // EP_MODEL
            cases.append(dispatch_case(torch, f"{label}_bf16_shard{EP_MODEL}", x, src[:n], valid[:n], timed=True))
        del x, logits, flat_e, src, valid
    torch.cuda.empty_cache()

    # ---- kimi-k2's MoE layer (the families phase): 384 experts, top-8,
    # d_model 7168; the gating takes the warp path (a row is 48 vectors).
    E, k = 384, 8
    for label, tokens in (("kimi_prefill", PREFILL_BATCH * PREFILL_LEN), ("kimi_decode", PREFILL_BATCH)):
        x, logits, flat_e, src, valid = main_path_plan(torch, gen, KIMI_ARCH, tokens, torch.bfloat16)
        cases.append(gating_case(torch, f"{label}_bf16", logits, k, timed=True))
        check(cases[-1]["path"] == "warp", f"gating {label}: 384 experts must take the warp path")
        cases.append(histogram_case(torch, label, flat_e, E, timed=True))
        cases.append(dispatch_case(torch, f"{label}_bf16", x, src, valid, timed=True))
        del x, logits, flat_e, src, valid
        torch.cuda.empty_cache()

    # ---- awkward shapes.  float32 logits sit on a grid of 1/64, so that two
    # logits are equal (a tie, which must go to the lower index) or far
    # enough apart that no rounding of the softmax can reorder them.
    def grid(t):
        return torch.round(t * 64) / 64

    sweep_err, sweep_paths = gating_sweep(torch, gen)
    cases.append({"kernel": "topk_gating", "case": "sweep", "paths": sweep_paths,
                  "max_abs_err": sweep_err})
    cases.extend(gating_edge_cases(torch, gen))
    cases.append(gating_case(torch, "T1000_E384_k8_f32", grid(randn(1000, 384)), 8, False))
    cases.append(gating_case(torch, "T1000_E384_k8_bf16", randn(1000, 384).bfloat16(), 8, False))
    cases.append(gating_case(torch, "T1_E32_k8", grid(randn(1, 32)), 8, False))
    cases.append(gating_case(torch, "T7_E5_k5", grid(randn(7, 5)), 5, False))
    cases.append(gating_case(torch, "T513_E100_k3", grid(randn(513, 100)), 3, False))
    cases.append(gating_case(torch, "T33_E512_k32", grid(randn(33, 512)), 32, False))
    ties = torch.zeros((4, 48), device="cuda")
    ties[1, [3, 35, 40]] = 2.0
    ties[2] = torch.arange(24, device="cuda").repeat_interleave(2).float()
    ties[3, 47] = 1.0
    cases.append(gating_case(torch, "tie_rows", ties, 4, False))
    _, tie_idx = topk_gating(ties, k=4)
    check(tie_idx[0].tolist() == [0, 1, 2, 3] and tie_idx[1].tolist() == [3, 35, 40, 0]
          and tie_idx[2].tolist() == [46, 47, 44, 45], "tie rows: ties must go to the lower index")

    cases.append(histogram_case(torch, "N100001_E512", randint(0, 512, 100001), 512, False))
    cases.append(histogram_case(torch, "N1_E32", randint(0, 32, 1), 32, False))
    cases.append(histogram_case(torch, "N999_E7_out_of_range", randint(-3, 11, 999), 7, False))
    # Off the main path, one cluster counts 20 MB of ids: timed for the record.
    cases.append(histogram_case(torch, "N5000011_E384", randint(0, 384, 5000011), 384, True))
    cases.append(histogram_case(torch, "all_one_bin", torch.full((70001,), 5, device="cuda", dtype=torch.int32), 16, False))
    cases.append(histogram_case(torch, "N0_E32", randint(0, 32, 0), 32, False))
    cases.append(histogram_case(torch, "N1_E12288", randint(0, 12288, 1), 12288, False))
    # Either side of the one-block threshold, and ids off the 16-byte grid.
    for n in (SINGLE_BLOCK_MAX - 1, SINGLE_BLOCK_MAX, SINGLE_BLOCK_MAX + 1):
        cases.append(histogram_case(torch, f"N{n}_E32", randint(-1, 33, n), 32, False))
    cases.append(histogram_case(torch, "N70000_E12288_off_grid", randint(0, 12288, 70003)[3:], 12288, False))

    def mask(n, p):
        return torch.rand((n,), generator=gen, device="cuda") < p

    cases.append(dispatch_case(torch, "T77_D1000_S1001_bf16", randn(77, 1000).bfloat16(), randint(0, 77, 1001), mask(1001, 0.7), False))
    cases.append(dispatch_case(torch, "T77_D1001_S1001_f32_bytes", randn(77, 1001), randint(0, 77, 1001), mask(1001, 0.7), False))
    cases.append(dispatch_case(torch, "T9_D7_S13_bf16_bytes", randn(9, 7).bfloat16(), randint(0, 9, 13), mask(13, 0.5), False))
    cases.append(dispatch_case(torch, "all_invalid", randn(16, 128), torch.zeros(37, device="cuda", dtype=torch.int32), torch.zeros(37, device="cuda", dtype=torch.bool), False))
    cases.append(dispatch_case(torch, "int_valid", randn(16, 128), randint(0, 16, 40), mask(40, 0.5).to(torch.int32), False))
    offset = randn(64 * 128 + 1)[1:].view(64, 128)   # base pointer off the 16-byte grid
    cases.append(dispatch_case(torch, "misaligned_base", offset, randint(0, 64, 200), mask(200, 0.6), False))
    cases.append(dispatch_case(torch, "S1", randn(4, 8), randint(0, 4, 1), mask(1, 1.1), False))
    cases.append(dispatch_case(torch, "all_valid", randn(512, 1024).bfloat16(), randint(0, 512, 20000), mask(20000, 1.1), False))
    cases.append(dispatch_case(torch, "one_row", randn(512, 1024).bfloat16(), torch.full((20000,), 7, device="cuda", dtype=torch.int32), mask(20000, 0.5), False))
    # More slots than the persistent grid has warps, and no multiple of it;
    # a row of 250 vectors ends in a partial piece.
    grid_warps = launch_blocks(1 << 30, torch.cuda.get_device_properties(0).multi_processor_count) * WARPS_PER_BLOCK
    cases.append(dispatch_case(torch, "S_ragged_grid_f32", randn(300, 1000), randint(0, 300, 3 * grid_warps + 17), mask(3 * grid_warps + 17, 0.6), False))
    cases.append(dispatch_case(torch, "S_ragged_grid_f32_D1024", randn(300, 1024), randint(0, 300, 2 * grid_warps + 5), mask(2 * grid_warps + 5, 0.6), False))

    # ---- ssd_state_scan: the served shape, timed, then awkward shapes.
    states, decay = served_scan_inputs(torch, gen)
    cases.append(ssd_case(torch, "prefill_f32", states, decay, timed=True))
    # A rank of the expert_parallel phase scans its 16 of mamba2's 64 heads
    # (8 prompts x 16 heads).
    n = states.shape[1] // EP_MODEL
    cases.append(ssd_case(torch, f"prefill_f32_shard{EP_MODEL}", states[:, :n].contiguous(),
                          decay[:, :n].contiguous(), timed=True))
    cases.append(ssd_case(torch, "prefill_bf16_states", states.bfloat16(), decay, False))
    # Its backward at the training shape, which is the same (8 x 1024 tokens
    # of mamba2-1.3b in chunks of 128): timed, and with bfloat16 states.
    g, out = ssd_bwd_inputs(torch, gen, states, decay)
    cases.append(ssd_bwd_case(torch, "train_f32", g, out, decay, torch.float32, timed=True))
    cases.append(ssd_bwd_case(torch, "train_bf16_states", g, out, decay, torch.bfloat16, False))
    del states, decay, g, out
    torch.cuda.empty_cache()

    def unit(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    cases.append(ssd_case(torch, "C1_zeros", randn(1, 64, 64, 128), unit(1, 64), False))
    cases.append(ssd_case(torch, "C33", randn(33, 16, 64, 128), unit(33, 16), False))
    cases.append(ssd_case(torch, "C300_decay_tiles", randn(300, 3, 8, 16), unit(300, 3), False))
    cases.append(ssd_case(torch, "H1", randn(9, 1, 64, 128), unit(9, 1), False))
    cases.append(ssd_case(torch, "P5_N7_scalar", randn(9, 7, 5, 7), unit(9, 7), False))
    cases.append(ssd_case(torch, "P5_N7_scalar_bf16", randn(9, 7, 5, 7).bfloat16(), unit(9, 7), False))
    cases.append(ssd_case(torch, "P4_N3_rows_share_a_vector", randn(9, 4, 4, 3), unit(9, 4), False))
    cases.append(ssd_case(torch, "plane_2304_ragged_block", randn(5, 3, 64, 36), unit(5, 3), False))
    shifted = randn(9 * 8 * 16 * 16 + 1)[1:].view(9, 8, 16, 16)   # base 4 bytes off the grid
    cases.append(ssd_case(torch, "misaligned_base_f32", shifted, unit(9, 8), False))
    shifted = randn(9 * 8 * 16 * 16 + 2).bfloat16()[2:].view(9, 8, 16, 16)
    cases.append(ssd_case(torch, "misaligned_base_bf16", shifted, unit(9, 8), False))
    exact = (torch.arange(9 * 6, device="cuda").view(9, 6) % 2).float()   # decays 0 and 1
    cases.append(ssd_case(torch, "decays_0_and_1", randn(9, 6, 16, 16), exact, False))
    # The backward at awkward shapes: one chunk (nothing reaches an output),
    # two (no live d_decay), more chunks than a decay tile, a ragged plane
    # and its bfloat16 gradient, a plane whose last block is part-filled,
    # one head, gradients off the 16-byte grid, decays 0 and 1.
    for name, shape, dtype in (("bwd_C1", (1, 64, 64, 128), torch.float32),
                               ("bwd_C2", (2, 64, 64, 128), torch.float32),
                               ("bwd_C300_decay_tiles", (300, 3, 8, 16), torch.float32),
                               ("bwd_P5_N7_scalar", (9, 7, 5, 7), torch.float32),
                               ("bwd_P5_N7_scalar_bf16", (9, 7, 5, 7), torch.bfloat16),
                               ("bwd_plane_2304_ragged_block", (5, 3, 64, 36), torch.float32),
                               ("bwd_H1_bf16", (9, 1, 64, 128), torch.bfloat16)):
        st, dec = randn(*shape).to(dtype), unit(*shape[:2])
        g, out = ssd_bwd_inputs(torch, gen, st, dec)
        cases.append(ssd_bwd_case(torch, name, g, out, dec, dtype, False))
    st, dec = randn(9, 8, 16, 16), unit(9, 8)
    g, out = ssd_bwd_inputs(torch, gen, st, dec)
    shifted = torch.empty(g.numel() + 1, device="cuda")[1:].view(g.shape)   # 4 bytes off the grid
    shifted.copy_(g)
    cases.append(ssd_bwd_case(torch, "bwd_misaligned_g", shifted, out, dec, torch.float32, False))
    st, dec = randn(9, 6, 16, 16), exact
    g, out = ssd_bwd_inputs(torch, gen, st, dec)
    cases.append(ssd_bwd_case(torch, "bwd_decays_0_and_1", g, out, dec, torch.float32, False))
    del st, dec, g, out, shifted
    torch.cuda.empty_cache()

    cases += combine_checks(torch, gen)
    cases += attention_checks(torch, gen)
    torch.cuda.synchronize()
    emit({"phase": "kernel_checks", "cases": cases})
    return cases


# --------------------------------------------------------------------- #
# Phase 4: moe_apply, kernel path against plain path
# --------------------------------------------------------------------- #


class Recorder:
    """Wraps the three dispatch steps and keeps what the last call of each
    was given and gave, to compare the two paths step by step."""

    def __init__(self, ops):
        from repro_torch.models.layers.moe import DispatchOps

        self.last = {}
        self.ops = DispatchOps(
            gating=self._wrap("gating", ops.gating),
            histogram=self._wrap("histogram", ops.histogram),
            dispatch=self._wrap("dispatch", ops.dispatch),
        )

    def _wrap(self, name, fn):
        def call(*args):
            out = fn(*args)
            self.last[name] = (args, out)
            return out
        return call


def compare_dispatch(torch, kern, plain, ema_k, ema_p, metrics_k, metrics_p, where):
    """The two Recorders' last dispatch, step by step, and what it left:
    picks, counts, the plan, the buffer, ``ema_loads`` and the routing
    metrics equal."""
    check(torch.equal(kern.last["gating"][1][1], plain.last["gating"][1][1]), f"{where}: picks")
    check(torch.equal(kern.last["histogram"][1], plain.last["histogram"][1]), f"{where}: counts")
    # The dispatch step's inputs ARE the plan: which slot is fed (valid,
    # hence keep) and by which token (src).
    (_, src_k, valid_k), buf_k = kern.last["dispatch"]
    (_, src_p, valid_p), buf_p = plain.last["dispatch"]
    check(torch.equal(valid_k, valid_p), f"{where}: keep")
    check(torch.equal(src_k[valid_k], src_p[valid_p]), f"{where}: slots")
    check(torch.equal(buf_k, buf_p), f"{where}: buffer")
    check(torch.equal(ema_k, ema_p), f"{where}: ema_loads")
    for key in ("moe_dropped_frac", "moe_distribute_frac", "moe_shard_imbalance"):
        check(float(metrics_k[key]) == float(metrics_p[key]), f"{where}: {key}")


def phase_moe(torch):
    import numpy as np

    from repro_torch.config.base import ArchConfig, MoEConfig
    from repro_torch.models.layers import moe
    from repro_torch.models.param import tree_materialize

    E, k, d, ff, B, S, steps = 32, 8, 128, 64, 4, 256, 10
    ctx = moe.SpmdCtx(num_groups=1, num_ep_shards=EP_SHARDS)
    results = []
    for alpha in (0.0, 0.8, 1.5):
        row = {"alpha": alpha}
        for mode in ("static", "dyskew"):
            cfg = ArchConfig(
                name="bench", family="moe", num_layers=1, d_model=d, num_heads=4,
                num_kv_heads=2, d_ff=ff, vocab_size=256, dtype="float32",
                moe=MoEConfig(num_experts=E, top_k=k, expert_ff=ff,
                              capacity_factor=1.25, adaptive=(mode == "dyskew")),
            )
            gen = torch.Generator(device="cuda").manual_seed(0)
            p = tree_materialize(moe.moe_specs(cfg), gen, dtype_override=torch.float32)
            probs = 1.0 / np.arange(1, E + 1) ** alpha
            probs /= probs.sum()
            bias = torch.tensor(np.log(probs) - np.log(probs).mean(), dtype=torch.float32, device="cuda")
            # Router weights on a grid of 1/1024 and activations on a grid
            # of 1/4 within +-6: every logit is then an exact multiple of
            # 1/4096 in float32 whatever the order of the sum, so two logits
            # are equal (a tie, to the lower index on both paths) or so far
            # apart that no last-bit difference between the kernel's softmax
            # and the plain one can order two picks differently.
            p["router"] = torch.round((p["router"] + bias[None, :] * 0.5) * 1024) / 1024
            kern, plain = Recorder(moe.KERNEL_OPS), Recorder(moe.PLAIN_OPS)
            st_k = moe.moe_state_init(cfg)
            st_p = moe.moe_state_init(cfg)
            dropped, distribute = [], []
            for step in range(steps):
                x = torch.randn((B, S, d), generator=gen, device="cuda")
                x = torch.clamp(torch.round(x * 4) / 4, -6.0, 6.0)
                y_k, st_k, m_k = moe.moe_apply(p, x, cfg=cfg, state=st_k, ctx=ctx, ops=kern.ops)
                y_p, st_p, m_p = moe.moe_apply(p, x, cfg=cfg, state=st_p, ctx=ctx, ops=plain.ops)
                torch.cuda.synchronize()
                where = f"moe alpha={alpha} {mode} step {step}"
                compare_dispatch(torch, kern, plain, st_k["ema_loads"], st_p["ema_loads"], m_k, m_p, where)
                # Same picks, same buffer: y differs only through the
                # renormalised weights' last bits (rtol 1e-5 / atol 1e-6 there).
                check(torch.allclose(y_k, y_p, rtol=1e-4, atol=1e-5), f"{where}: y")
                check(bool(torch.isfinite(y_k).all()), f"{where}: y not finite")
                dropped.append(float(m_k["moe_dropped_frac"]))
                distribute.append(float(m_k["moe_distribute_frac"]))
            row[f"{mode}_dropped"] = float(np.mean(dropped[2:]))
            row[f"{mode}_distribute"] = float(np.mean(distribute))
        results.append(row)
    skewed = results[-1]
    check(skewed["dyskew_dropped"] < skewed["static_dropped"],
          "adaptive dispatch must drop fewer tokens than static under skew")
    emit({"phase": "moe", "steps": steps, "experts": E, "top_k": k, "ep_shards": EP_SHARDS,
          "tokens_per_step": B * S, "results": results})


# --------------------------------------------------------------------- #
# Phase 5: one Mamba-2 layer, kernel scan against plain scan
# --------------------------------------------------------------------- #


def mamba2_decay_init(torch, p, gen) -> None:
    """Draws, in place, a Mamba layer's (or a stack of them) ``dt_bias`` and
    ``A_log`` as Mamba-2's own initialisation draws them (dt log-uniform in
    [0.001, 0.1], A uniform in [1, 16]), so that the chunk decays spread
    over (0, 1); the model's zero init puts them near 0."""
    import math

    shape = p["A_log"].shape
    u = torch.rand(shape, generator=gen, device=p["A_log"].device)
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
    p["dt_bias"].copy_(dt0 + torch.log(-torch.expm1(-dt0)))          # softplus(dt_bias) = dt0
    p["A_log"].copy_(torch.log(1.0 + 15.0 * torch.rand(shape, generator=gen, device=p["A_log"].device)))


def phase_mamba(torch):
    """One Mamba-2 layer of mamba2-1.3b at full width (d_model 2048, 64
    heads of 64, d_state 128) over 8 x 1024 tokens from a carried, non-zero
    decode state, in float32 so that only the scan differs: once with the
    kernel, once with the plain scan."""
    import dataclasses

    from repro_torch import kernels
    from repro_torch.config.base import get_config
    from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_ref
    from repro_torch.models.layers.mamba2 import mamba_apply, mamba_specs, mamba_state_init
    from repro_torch.models.param import tree_materialize

    cfg = dataclasses.replace(get_config(SSM_ARCH), dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(2)
    p = tree_materialize(mamba_specs(cfg), gen, dtype_override=torch.float32)
    mamba2_decay_init(torch, p, gen)
    B, S = PREFILL_BATCH, PREFILL_LEN
    x = torch.randn((B, S, cfg.d_model), generator=gen, device="cuda")
    state = {k: torch.randn(v.shape, generator=gen, device="cuda", dtype=v.dtype)
             for k, v in mamba_state_init(cfg, B, torch.float32).items()}

    kernels.reset_launch_counts()
    y_k, st_k = mamba_apply(p, x, cfg=cfg, state=state)
    torch.cuda.synchronize()
    launched = kernels.launch_counts()["ssd_state_scan"]
    y_p, st_p = mamba_apply(p, x, cfg=cfg, state=state, scan=ssd_state_scan_ref)
    torch.cuda.synchronize()
    check(launched == 1 and kernels.launch_counts()["ssd_state_scan"] == 1,
          "mamba: the kernel path must launch the scan once, the plain path never")
    check(y_k.shape == (B, S, cfg.d_model) and st_k["ssm"].shape == state["ssm"].shape, "mamba: shapes")
    errs = {}
    for name, a, b in [("y", y_k, y_p)] + [(k, st_k[k], st_p[k]) for k in st_k]:
        check(bool(torch.isfinite(a).all()), f"mamba: {name} not finite")
        # The scan is exact (bit for bit against the plain version) and the
        # rest of the layer is the same code on the same inputs: rtol 1e-5
        # / atol 1e-5 leaves room only for a library's order of summation.
        check(torch.allclose(a, b, rtol=1e-5, atol=1e-5), f"mamba: {name} differs")
        errs[name] = float((a - b).abs().max())
    equal = all(torch.equal(a, b) for a, b in [(y_k, y_p)] + [(st_k[k], st_p[k]) for k in st_k])
    decay_in_chunk = torch.exp(-torch.exp(p["A_log"]) * torch.nn.functional.softplus(p["dt_bias"]) * 128)
    del y_k, y_p, st_k, st_p
    layer_ms = time_ms(torch, lambda: mamba_apply(p, x, cfg=cfg, state=state), iters=3, reps=3)
    plain_ms = time_ms(torch, lambda: mamba_apply(p, x, cfg=cfg, state=state, scan=ssd_state_scan_ref),
                       iters=3, reps=3)
    emit({"phase": "mamba", "arch": cfg.name, "d_model": cfg.d_model, "batch": B, "seq": S,
          "dtype": "float32", "max_abs_err": errs, "bitwise_equal": equal,
          "chunk_decay_at_bias": [float(decay_in_chunk.min()), float(decay_in_chunk.max())],
          "layer_ms": layer_ms, "layer_plain_scan_ms": plain_ms})
    del p, x, state
    torch.cuda.empty_cache()


# --------------------------------------------------------------------- #
# Phase 6: the full models, served
# --------------------------------------------------------------------- #


def served_model(torch, arch, layers=None, prompt=PREFILL_LEN, ctx=None):
    """The model with random weights from a seed (``layers`` of its depth
    where given), the inputs of its prompt and its two serving steps: 8
    prompts of ``prompt`` tokens, with the encoder-decoder's frames and the
    VLM's patch embeddings drawn from the same generator.  ``ctx`` (default
    one group, EP_SHARDS link instances) may name a model group: each
    expert leaf is then this rank's slice of the same draw."""
    import dataclasses

    from repro_torch.config.base import get_config
    from repro_torch.models.layers.moe import SpmdCtx
    from repro_torch.models.model_api import build
    from repro_torch.train.step import make_decode_step, make_prefill_step

    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build(cfg)
    ctx = SpmdCtx(num_groups=1, num_ep_shards=EP_SHARDS) if ctx is None else ctx
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen, ctx=ctx)
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, prompt), generator=gen,
                                      device="cuda", dtype=torch.int32)}
    if cfg.family == "encdec":
        inputs["frames"] = torch.randn((PREFILL_BATCH, cfg.encoder_len, cfg.d_model), generator=gen,
                                       device="cuda")
    if cfg.family == "vlm":
        inputs["patches"] = torch.randn((PREFILL_BATCH, cfg.num_patches, cfg.d_model), generator=gen,
                                        device="cuda")
    torch.cuda.empty_cache()   # the float32 draws' temporaries
    torch.cuda.synchronize()
    return model, ctx, params, inputs, make_prefill_step(model, ctx), make_decode_step(model, ctx)


def attention_launches(cfg) -> int:
    """Launches of the attention kernel in one prefill: one an attention
    call where the kernel takes the config (bf16 or fp16, head width 64 or
    128): every attention layer of a decoder, the encoder's layers and the
    decoder's self- and cross-attention of an encoder-decoder; none for the
    cached layers of an int8 cache.  Decode steps make none."""
    from repro_torch.kernels.attention.kernel import DTYPES, HEAD_DIMS
    from repro_torch.models import transformer

    if transformer.model_dtype(cfg) not in DTYPES or cfg.head_dim_ not in HEAD_DIMS:
        return 0
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    if cfg.kv_cache_dtype == "int8":
        return 0
    return len(transformer.attn_layer_positions(cfg)) * transformer.num_blocks(cfg)


def expected_launches(cfg, steps=DECODE_STEPS):
    """Launches of each kernel in one prefill and ``steps`` decode steps:
    the MoE kernels (the combine among them) once per MoE layer and step,
    the scan once per Mamba layer and prefill (decode is the recurrent
    update, with no scan), the attention kernel as ``attention_launches``;
    no backward."""
    from repro_torch.models import transformer

    nb = transformer.num_blocks(cfg)
    n_moe = len(transformer.moe_layer_positions(cfg)) * nb
    n_mamba = len(transformer.mamba_layer_positions(cfg)) * nb
    moe = n_moe * (1 + steps)
    return {"topk_gating": moe, "load_histogram": moe, "dispatch_gather": moe,
            "ssd_state_scan": n_mamba, "ssd_state_scan_bwd": 0, "moe_combine": moe, "moe_combine_bwd": 0,
            "attention": attention_launches(cfg)}


def host_steps(before):
    """The decode steps the host ran since ``before``, a copy of
    ``decode_graph.counts``: eager steps and captures.  A graph's replay
    calls no kernel wrapper, so the wrappers count these steps' launches
    alone."""
    from repro_torch.train import decode_graph

    return sum(decode_graph.counts[k] - before[k] for k in ("decode_eager_steps", "decode_graph_captures"))


def serve_pass(torch, served, forced=None):
    """One prefill and DECODE_STEPS decode steps, greedy or fed ``forced``
    tokens: (state, logits per step, tokens fed, prefill s, decode s)."""
    model, ctx, params, inputs, prefill, decode = served
    B, prompt = inputs["tokens"].shape
    state = model.decode_state_init(B, prompt + DECODE_STEPS, ctx=ctx)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, state = prefill(params, state, inputs)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    all_logits, toks = [logits], []
    t0 = time.perf_counter()
    for i in range(DECODE_STEPS):
        tok = torch.argmax(logits, dim=-1).to(torch.int32) if forced is None else forced[i]
        toks.append(tok)
        logits, state = decode(params, state, tok)
        all_logits.append(logits)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    return state, all_logits, toks, prefill_s, decode_s


def phase_serve(torch, served):
    """An uncounted, a timed and a traced serve pass; returns (the kernels
    the traced pass ran, by their device records, the row to emit, the
    timed pass).  The timed pass's kernel wrappers count the host's calls:
    the prefill's and those of the decode steps the host ran, a graph's
    eager step and its capture; a replay runs its kernels with no call, so
    what ran is read from the trace."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.models import transformer
    from repro_torch.models.layers.moe import capacities
    from repro_torch.train import decode_graph

    model, ctx, params, inputs, _, _ = served
    cfg = model.cfg
    B, prompt = inputs["tokens"].shape

    # A first, uncounted pass pays the one-off costs (library handles, the
    # allocator's first blocks, the decode graph's capture), so that the
    # timed pass is a steady one.
    serve_pass(torch, served)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    before = dict(decode_graph.counts)
    run = serve_pass(torch, served)
    calls = kernels.launch_counts()
    ran_on_host = host_steps(before)
    peak = torch.cuda.max_memory_allocated()
    state, all_logits, toks, prefill_s, decode_s = run
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        serve_pass(torch, served)
    counts = kernels.launches_in_trace(prof)
    del prof

    want, on_host = expected_launches(cfg), expected_launches(cfg, ran_on_host)
    check(set(counts) == set(want), f"serve: kernels {sorted(counts)}")
    for name, n in counts.items():
        check(n == want[name], f"serve {cfg.name}: {name} ran {n} times, expected {want[name]}")
        check(calls[name] == on_host[name], f"serve {cfg.name}: {name} called {calls[name]} times with "
              f"{ran_on_host} decode steps on the host, expected {on_host[name]}")
    check(int(state["pos"]) == prompt + DECODE_STEPS, "serve: pos")
    stacked = torch.cat(all_logits, dim=1).float()
    check(stacked.shape == (B, 1 + DECODE_STEPS, cfg.padded_vocab), "serve: logits shape")
    check(bool(torch.isfinite(stacked).all()), "serve: logits not finite")
    check(bool((stacked[..., cfg.vocab_size:] == torch.finfo(transformer.model_dtype(cfg)).min).all()),
          "serve: pad-vocab logits not masked")
    check(all(int(t.max()) < cfg.vocab_size and int(t.min()) >= 0 for t in toks), "serve: token out of vocab")
    distinct = len({tuple(t.flatten().tolist()) for t in toks})
    check(distinct > 1, "serve: decode repeats one token")
    del stacked

    row = {
        "phase": "serve", "arch": cfg.name, "family": cfg.family, "layers": cfg.num_layers,
        "d_model": cfg.d_model, "vocab": cfg.vocab_size, "dtype": cfg.dtype,
        "params": model.num_params(), "batch": B, "prompt": prompt,
        "prefill_tokens": B * prompt, "prefill_s": prefill_s,
        "prefill_tokens_per_s": B * prompt / prefill_s,
        "decode_steps": DECODE_STEPS, "decode_s": decode_s,
        "decode_tokens_per_s": B * DECODE_STEPS / decode_s,
        "decode_ms_per_step": decode_s / DECODE_STEPS * 1e3,
        "peak_memory_bytes": peak, "launches": counts, "wrapper_calls": calls,
        "host_decode_steps": ran_on_host, "distinct_decode_steps": distinct,
    }
    if cfg.moe is not None:
        # Routing telemetry: Model.prefill drops the metrics, so one more
        # forward with carried state reads them (after the counts were
        # taken).
        _, aux = transformer.forward(params, inputs["tokens"], cfg=cfg, ctx=ctx, dyskew=model.dyskew_init(ctx))
        metrics = {k: float(v) for k, v in aux["metrics"].items()}
        check(all(v == v for v in metrics.values()), "serve: a metric is NaN")
        row.update(experts=cfg.moe.num_experts, top_k=cfg.moe.top_k, ep_shards=ctx.num_ep_shards,
                   prefill_c_buf=capacities(cfg, B * prompt)[1], decode_c_buf=capacities(cfg, B)[1],
                   moe_dropped_frac=metrics["moe_dropped_frac"],
                   moe_distribute_frac=metrics["moe_distribute_frac"],
                   moe_shard_imbalance=metrics["moe_shard_imbalance"])
        del aux
    if cfg.mamba is not None:
        row.update(ssm_heads=cfg.mamba.num_heads(cfg.d_model), d_state=cfg.mamba.d_state,
                   chunk=cfg.mamba.chunk,
                   ssm_state_bytes=sum(v["ssm"].numel() * 4 for k, v in state.items()
                                       if k.startswith("ssm_l")))
    return counts, row, run


def profiled(torch, arch, what, steps, window):
    """Trace ``window()`` with torch.profiler and emit where its device time
    went, by kernel name and by the PyTorch operator that launched the
    kernel, and how much of the wall time the card was busy at all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        window()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, by_op = [], []
    for evt in prof.key_averages():
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0.0)
        if dev_us <= 0:
            continue
        # The busy time sums the device's own events only; a host
        # operator's row repeats the time of the kernels it launched
        # itself, and names the operation behind a generic kernel name.
        (rows if evt.device_type == DeviceType.CUDA else by_op).append(
            (evt.key, dev_us / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    by_op.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    check(busy_ms > 0.0, f"profile {what}: the trace shows no device time")
    emit({
        "phase": "profile", "arch": arch, "what": what, "steps": steps,
        "wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
        "device_launches": sum(r[2] for r in rows),
        "top": [{"name": n[:80], "ms": ms, "calls": c} for n, ms, c in rows[:14]],
        "top_ops": [{"op": n, "ms": ms, "calls": c} for n, ms, c in by_op[:14]],
        "ours": [{"name": n[:80], "ms": ms, "calls": c} for n, ms, c in rows
                 if any(k in n for k in PORT_KERNEL_NAMES)],
        "memsets": sum(c for n, _, c in rows if "memset" in n.lower()),
    })


def phase_profile(torch, served, decode_steps: int = 4):
    """Optional: one prefill and a few decode steps, traced."""
    model, _, params, inputs, prefill, decode = served
    B, prompt = inputs["tokens"].shape

    state = model.decode_state_init(B, prompt + decode_steps)
    logits, state = prefill(params, state, inputs)

    def prefill_window():
        fresh = model.decode_state_init(B, prompt + decode_steps)
        prefill(params, fresh, inputs)

    def decode_window():
        nonlocal logits, state
        for _ in range(decode_steps):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            logits, state = decode(params, state, tok)

    profiled(torch, model.cfg.name, "prefill", 1, prefill_window)
    profiled(torch, model.cfg.name, "decode", decode_steps, decode_window)


# --------------------------------------------------------------------- #
# Phase 6b: the other model families at full width
# --------------------------------------------------------------------- #

#: (arch, layers kept or None for all, prompt tokens, the cut and its reason)
FAMILIES = (
    ("whisper-base", None, 224,
     "whole; 224 + 32 tokens lie within Whisper's 448-token decoder context"),
    ("pixtral-12b", None, PREFILL_LEN, "whole: 12.25 B parameters, 24.5 GB in bf16"),
    ("qwen1.5-32b", 32, PREFILL_LEN,
     "32 of 64 layers: all 64 hold 70.4 GB of bf16 weights, which leaves under 10 GB of the "
     "80 GB card for the cache, the activations and the 2.5 GB of prefill logits"),
    (KIMI_ARCH, 1, PREFILL_LEN,
     "1 of 61 layers: one layer's experts are 34 GB in bf16 and drawing one expert leaf takes a "
     "22.5 GB float32 temporary, so two layers do not fit"),
)
#: The registry's seven configs besides granite-moe-1b-a400m, mamba2-1.3b and
#: jamba-1.5-large-398b, run reduced on card and host.
REDUCED_IDS = ("whisper-base", "granite-20b", "chatglm3-6b", "starcoder2-3b", "qwen1.5-32b",
           "pixtral-12b", KIMI_ARCH)
#: tests/test_arch_smoke.py's bands: a cached path against the uncached
#: forward, and the same for an int8 cache (card against host here too).
SMOKE_RTOL, SMOKE_ATOL = 2e-2, 2e-3
INT8_RTOL, INT8_ATOL = 0.5, 0.25
#: An int8 cache's float32 scales, card against host: amax / 127 of keys
#: and values that two float32 orders of summation computed.
SCALE_RTOL = 1e-4
CHECK_STEPS = 3
REDUCED_BATCH, REDUCED_SEQ, REDUCED_PROMPT = 2, 32, 16


#: The held comparisons' weights.  ``repro``'s init takes a leaf's first
#: axis as its fan-in, and for a stacked block leaf that is the layer
#: count: at full width every block matrix is drawn 9 to 30 times too large,
#: the softmaxes saturate and the random model amplifies last bits.  These
#: leaves are rescaled to the fan-in of their inputs, the axes after the
#: stack's (one, two for ``wo``'s heads and head_dim).
INPUT_AXES = {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w_gate": 1, "w_up": 1, "w_down": 1,
              "w_z": 1, "w_x": 1, "w_B": 1, "w_C": 1, "w_dt": 1, "w_out": 1}
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")


def at_input_fan_in(params, specs=None) -> None:
    """Rescales, in place, every stacked block matrix of ``params`` from the
    layer count's fan-in to that of its inputs (INPUT_AXES).  ``specs``:
    the model's spec tree, for a rank that holds slices of its leaves (the
    scale is the whole leaf's, as one process applies it)."""
    import math

    for key, leaf in params.items():
        whole = None if specs is None else specs[key]
        if isinstance(leaf, dict):
            at_input_fan_in(leaf, whole)
        elif key in INPUT_AXES:
            shape = list(leaf.shape if whole is None else whole.shape)
            fan_in = math.prod(shape[1:1 + INPUT_AXES[key]])
            leaf.mul_(math.sqrt(shape[0] / fan_in))


def band_ratio(got, want, rtol, atol) -> float:
    """The largest |got - want| / (atol + rtol |want|): 1 or less inside
    the band.  One leading row at a time, so that a prefill's logits are
    never copied whole into float32."""
    return max(float(((g.float() - w.float()).abs() / (atol + rtol * w.float().abs())).max())
               for g, w in zip(got, want))


def max_gap(got, want) -> float:
    return max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))


def whisper_check(torch, prompt):
    """whisper-base whole on the card: the float32 cached prefill of a
    prompt shorter than the encoder, and CHECK_STEPS decode steps, against
    the port's own float32 uncached forward over the same tokens, at
    test_arch_smoke's band (rtol 2e-2, atol 2e-3).  A reading is
    ``band_ratio``: 1 or less inside the band.

    Held at 1, with the weights at the fan-in of their inputs
    (``at_input_fan_in``).  Two controls of the same weights must read over
    1, so that the band is seen to reject a fault and a lesser precision:
    the reference's cached prefill (the prompt's cross attention over its
    first ``prompt`` frames, computed as the uncached forward over them) and
    the same cached path in bfloat16.  At ``repro``'s own init the random
    model is chaotic and two float32 orders of summation part; that run is
    reported, not held."""
    import dataclasses

    from repro_torch.config.base import get_config
    from repro_torch.models import encdec
    from repro_torch.models.model_api import build
    from repro_torch.models.param import tree_map

    cfg = dataclasses.replace(get_config("whisper-base"), dtype="float32")
    check(prompt < cfg.encoder_len, "whisper: the check is of a prompt shorter than the encoder")
    model = build(cfg)
    V, end = cfg.vocab_size, prompt + CHECK_STEPS
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    tokens = torch.randint(0, V, (PREFILL_BATCH, end), generator=gen, device="cuda", dtype=torch.int32)
    frames = torch.randn((PREFILL_BATCH, cfg.encoder_len, cfg.d_model), generator=gen, device="cuda")

    def cached(dtype, p):
        m = build(dataclasses.replace(cfg, dtype=dtype))
        state = m.decode_state_init(PREFILL_BATCH, end)
        logits, state = m.prefill(p, {"tokens": tokens[:, :prompt], "frames": frames}, state)
        out = [logits[..., :V]]
        for t in range(prompt, end):
            logits, state = m.decode_step(p, state, tokens[:, t:t + 1])
            out.append(logits[..., :V])
        return out

    def uncached(p, frames_seen):
        """The uncached forward; the prefill's cross attention sees the first
        ``frames_seen`` frames of the encoder's output."""
        enc_out = encdec.encode(p, frames, cfg)[:, :frames_seen]
        full, _ = encdec.forward(p, tokens, cfg=cfg, enc_out=enc_out)
        return [full[:, :prompt, :V]] + [full[:, t:t + 1, :V] for t in range(prompt, end)]

    def reading(got, want):
        return {"band_ratio": [band_ratio(g, w, SMOKE_RTOL, SMOKE_ATOL) for g, w in zip(got, want)],
                "max_abs_err": [max_gap(g, w) for g, w in zip(got, want)],
                "logit_scale": max(float(w.abs().max()) for w in want)}

    out = {"dtype": "float32", "prompt": prompt, "encoder_len": cfg.encoder_len, "decode_steps": CHECK_STEPS,
           "rtol": SMOKE_RTOL, "atol": SMOKE_ATOL}
    out["reference_init"] = reading(cached("float32", params), uncached(params, cfg.encoder_len))
    at_input_fan_in(params)
    want = uncached(params, cfg.encoder_len)
    held = out["at_input_fan_in"] = reading(cached("float32", params), want)
    check(max(held["band_ratio"]) <= 1.0, f"whisper float32: the cached path leaves the uncached forward: {held}")
    # The controls: the prefill over the first frames (its decode steps
    # would carry the same fault on), and the whole cached path in bf16.
    first = reading(uncached(params, prompt)[:1], want[:1])
    bf16 = reading(cached("bfloat16", tree_map(lambda t: t.to(torch.bfloat16), params)), want)
    out["controls"] = {"first_frames": first, "bfloat16": bf16}
    for name, ctl in out["controls"].items():
        check(max(ctl["band_ratio"]) > 1.0, f"whisper control {name} passes the band: {ctl}")
    del params, want
    torch.cuda.empty_cache()
    return out


def kv_bytes(state):
    return sum(t.numel() * t.element_size() for key, entry in state.items()
               if key.startswith("kv") for t in entry.values())


def int8_cache_check(torch, served, run):
    """The int8 run's prompts and greedy tokens again through a cache of the
    model dtype: the two caches' bytes, the largest logit gap, its
    ``band_ratio`` at test_arch_smoke's int8 band and the share of greedy
    tokens the two agree on.  At ``repro``'s init (``run``, reported: the
    random model is chaotic there), then, held at the band, with the served
    weights rescaled in place to the fan-in of their inputs; and a control
    with a fault of the int8 arm, which the band must reject."""
    import dataclasses

    from repro_torch.models.model_api import build
    from repro_torch.train.step import make_decode_step, make_prefill_step

    model, ctx, params, inputs, _, _ = served
    model_m = build(dataclasses.replace(model.cfg, kv_cache_dtype="model"))
    served_m = (model_m, ctx, params, inputs, make_prefill_step(model_m, ctx), make_decode_step(model_m, ctx))

    def pair(run8):
        _, logits8, toks, _, _ = run8
        state_m, logits_m, _, prefill_s, decode_s = serve_pass(torch, served_m, forced=toks)
        agree = torch.cat([(a.argmax(-1) == b.argmax(-1)).flatten() for a, b in zip(logits8, logits_m)])
        row = {"max_logit_gap_by_step": [max_gap(a, b) for a, b in zip(logits8, logits_m)],
               "band_ratio_by_step": [band_ratio(a, b, INT8_RTOL, INT8_ATOL) for a, b in zip(logits8, logits_m)],
               "logit_scale": max(float(b.abs().max()) for b in logits_m),
               "greedy_agree_share": float(agree.float().mean())}
        row.update(max_logit_gap=max(row["max_logit_gap_by_step"]), band_ratio=max(row["band_ratio_by_step"]))
        return row, state_m, prefill_s, decode_s

    reference, state_m, prefill_s, decode_s = pair(run)
    ratio = kv_bytes(run[0]) / kv_bytes(state_m)
    # int8 values and a float32 scale per head vector against values of the
    # model dtype: (128 + 4) / 256 for qwen's bf16 heads of 128.
    hd, elem = model.cfg.head_dim_, next(iter(state_m["kv_l0"].values())).element_size()
    check(abs(ratio - (hd + 4) / (hd * elem)) < 1e-9, f"int8 cache: {ratio} of the model-dtype cache's bytes")
    out = {"cache_bytes_int8": kv_bytes(run[0]), "cache_bytes_model": kv_bytes(state_m), "bytes_ratio": ratio,
           "model_cache_prefill_s": prefill_s, "model_cache_decode_ms_per_step": decode_s / DECODE_STEPS * 1e3,
           "rtol": INT8_RTOL, "atol": INT8_ATOL, "reference_init": reference}
    del state_m
    torch.cuda.empty_cache()
    at_input_fan_in(params)
    run8 = serve_pass(torch, served)
    held, state_m, _, _ = pair(run8)
    out["at_input_fan_in"] = held
    check(held["band_ratio"] <= 1.0, f"int8 cache: logits leave the model-dtype cache's: {held}")
    del state_m
    torch.cuda.empty_cache()
    # The control: a fault of the int8 arm, which the band must reject.  The
    # prompt's scales are rolled by half the prompt, so that each position's
    # int8 values are read with the scales of the other query chunk's
    # position, and the decode steps are run again on that cache.
    _, _, toks, _, _ = run8
    model_i, _, _, _, prefill, decode = served
    B, prompt = inputs["tokens"].shape
    state = model_i.decode_state_init(B, prompt + DECODE_STEPS)
    _, state = prefill(params, state, inputs)
    for key, entry in state.items():
        if key.startswith("kv"):
            for name in ("k_scale", "v_scale"):
                entry[name][:, :, :prompt] = torch.roll(entry[name][:, :, :prompt], prompt // 2, dims=2)
    rolled = []
    for tok in toks:
        logits, state = decode(params, state, tok)
        rolled.append(logits)
    good = run8[1][1:]
    out["control_rolled_scales"] = {"band_ratio": band_ratio(rolled, good, INT8_RTOL, INT8_ATOL),
                                    "max_logit_gap": max_gap(rolled, good)}
    check(out["control_rolled_scales"]["band_ratio"] > 1.0,
          f"int8 cache: the rolled-scales control passes the band: {out['control_rolled_scales']}")
    del state, rolled, good, run8, served_m
    torch.cuda.empty_cache()
    return out


def moe_path_check(torch, served):
    """One forward of the prompt through the kernels and through the plain
    versions, with the same carried ``ema_loads``, as the moe phase does for
    granite: router logits, picks, counts, plan, buffer, ``ema_loads`` and
    metrics equal, gate weights at the gating check's band.  Then the MoE
    layer on the hidden state it was given, through the kernels and through
    the plain versions with the combine's contract (``combine/ref.py``, the
    kernel's arithmetic in plain PyTorch): the outputs differ only where a
    gate weight's float32 last bits move the rounded sum, so they are held
    to two bfloat16 steps (2^-7) of the largest |y|.  The plain loop's
    combine (``PLAIN_OPS``), which rounds every product and sum to
    bfloat16, is printed beside it against the same band."""
    import dataclasses

    from repro_torch.kernels.combine.ref import moe_combine_contract
    from repro_torch.models import transformer
    from repro_torch.models.layers import moe
    from repro_torch.models.param import tree_map

    model, ctx, params, inputs, _, _ = served
    cfg = model.cfg
    tokens = inputs["tokens"]
    dk = model.dyskew_init(ctx)
    kern, plain = Recorder(moe.KERNEL_OPS), Recorder(moe.PLAIN_OPS)
    logits_k, aux_k = transformer.forward(params, tokens, cfg=cfg, ctx=ctx, dyskew=dk, ops=kern.ops)
    logits_p, aux_p = transformer.forward(params, tokens, cfg=cfg, ctx=ctx, dyskew=dk, ops=plain.ops)
    torch.cuda.synchronize()
    where = f"{cfg.name} kernel path"
    (router_k, _), (w_k, _) = kern.last["gating"]
    (router_p, _), (w_p, _) = plain.last["gating"]
    check(torch.equal(router_k, router_p), f"{where}: router logits")
    check(torch.allclose(w_k, w_p, rtol=1e-5, atol=1e-6), f"{where}: gate weights")
    compare_dispatch(torch, kern, plain, aux_k["dyskew"]["l0"]["ema_loads"], aux_p["dyskew"]["l0"]["ema_loads"],
                     aux_k["metrics"], aux_p["metrics"], where)
    (x_k, _, valid_k), _ = kern.last["dispatch"]
    logit_gap = float((logits_k.float() - logits_p.float()).abs().max())
    agree = float((logits_k.argmax(-1) == logits_p.argmax(-1)).float().mean())
    slots, valid_frac = int(valid_k.numel()), float(valid_k.float().mean())
    del logits_k, logits_p, aux_k, aux_p, kern, plain

    B, S = tokens.shape
    p_moe = tree_map(lambda a: a[0], params["blocks"]["l0"]["moe"])
    st = tree_map(lambda a: a[0], dk["l0"])
    h = x_k.reshape(B, S, cfg.d_model)
    y_k, _, _ = moe.moe_apply(p_moe, h, cfg=cfg, state=st, ctx=ctx)
    y_p, _, _ = moe.moe_apply(p_moe, h, cfg=cfg, state=st, ctx=ctx,
                              ops=dataclasses.replace(moe.PLAIN_OPS, combine=moe_combine_contract))
    y_err = float((y_k.float() - y_p.float()).abs().max())
    y_scale = float(y_p.float().abs().max())
    check(bool(torch.isfinite(y_k).all()), f"{where}: y not finite")
    check(y_err <= 2.0 ** -7 * y_scale, f"{where}: y {y_err} off the plain path (scale {y_scale})")
    del y_p
    y_l, _, _ = moe.moe_apply(p_moe, h, cfg=cfg, state=st, ctx=ctx, ops=moe.PLAIN_OPS)
    loop_err = float((y_k.float() - y_l.float()).abs().max())
    del y_l
    out = {"tokens": B * S, "slots": slots, "valid_frac": valid_frac, "plan_equal": True,
           "buffer_equal": True, "gate_weight_max_abs_err": float((w_k - w_p).abs().max()),
           "y_max_abs_err": y_err, "y_scale": y_scale, "y_band": 2.0 ** -7,
           "y_loop_combine_max_abs_err": loop_err,
           "logit_max_abs_gap": logit_gap, "greedy_agree_share": agree}
    del y_k, h, x_k
    torch.cuda.empty_cache()
    return out


def reduced_card_host(torch, arch):
    """The reduced config in float32: prefill REDUCED_PROMPT tokens and
    CHECK_STEPS decode steps on the card and on the host from the same
    weights and inputs, logits within test_arch_smoke's bands (the int8 band
    where the cache is int8).  Those are its bands for a cached path against
    the uncached forward, far wider than card against host needs, so an
    int8 cache is held itself: its values one by one (a card-side
    ``x / scale`` may round to the other side of a half, so those that
    differ are counted, and none may differ by more than one) and its
    float32 scales within SCALE_RTOL."""
    import dataclasses

    from repro_torch.config.base import get_config
    from repro_torch.models.model_api import build
    from repro_torch.models.param import tree_map

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
    model = build(cfg)
    gen = torch.Generator().manual_seed(0)
    params = model.init(gen, device=HOST)
    shape = (REDUCED_BATCH, REDUCED_SEQ)
    inputs = {"tokens": torch.randint(0, cfg.vocab_size, shape, generator=gen, dtype=torch.int32)}
    if cfg.family == "encdec":
        inputs["frames"] = torch.randn((REDUCED_BATCH, cfg.encoder_len, cfg.d_model), generator=gen)
    if cfg.family == "vlm":
        inputs["patches"] = torch.randn((REDUCED_BATCH, cfg.num_patches, cfg.d_model), generator=gen)
    runs = {}
    for dev in ("cuda", HOST):
        p = tree_map(lambda t: t.to(dev), params)
        inp = {k: v.to(dev) for k, v in inputs.items()}
        state = model.decode_state_init(REDUCED_BATCH, REDUCED_SEQ, device=dev)
        logits, state = model.prefill(p, dict(inp, tokens=inp["tokens"][:, :REDUCED_PROMPT]), state)
        out = [logits.cpu()]
        for t in range(REDUCED_PROMPT, REDUCED_PROMPT + CHECK_STEPS):
            logits, state = model.decode_step(p, state, inp["tokens"][:, t:t + 1])
            out.append(logits.cpu())
        runs[dev] = (out, tree_map(lambda t: t.cpu(), state))
    int8 = cfg.kv_cache_dtype == "int8"
    rtol, atol = (INT8_RTOL, INT8_ATOL) if int8 else (SMOKE_RTOL, SMOKE_ATOL)
    errs = []
    for step, (a, b) in enumerate(zip(runs["cuda"][0], runs[HOST][0])):
        check(torch.allclose(a, b, rtol=rtol, atol=atol), f"{arch} reduced: step {step} card against host")
        errs.append(float((a - b).abs().max()))
    row = {"arch": arch, "family": cfg.family, "kv_cache_dtype": cfg.kv_cache_dtype, "rtol": rtol,
           "atol": atol, "max_abs_err": errs}
    if int8:
        cache = {}
        for key, entry in runs["cuda"][1].items():
            if not key.startswith("kv"):
                continue
            for name in ("k", "v"):
                diff = (entry[name].to(torch.int32) - runs[HOST][1][key][name].to(torch.int32)).abs()
                check(int(diff.max()) <= 1, f"{arch} reduced: {key}/{name} int8 values more than a step apart")
                sc_a, sc_b = entry[f"{name}_scale"], runs[HOST][1][key][f"{name}_scale"]
                rel = float(((sc_a - sc_b).abs() / sc_b.abs().clamp(min=1e-30)).max())
                check(rel <= SCALE_RTOL, f"{arch} reduced: {key}/{name} scales {rel} apart")
                cache[f"{key}/{name}"] = {"values": diff.numel(), "differ": int((diff > 0).sum()),
                                          "scale_max_rel_diff": rel, "scale_rtol": SCALE_RTOL}
        row["int8_cache"] = cache
    return row


def phase_families(torch, profile=False):
    """The four served configs of the other families at full width, then the
    seven configs of REDUCED_IDS reduced, card against host.  Returns kimi-k2's
    launch counts."""
    from repro_torch.config.base import get_config

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    counts = {}
    for arch, layers, prompt, cut in FAMILIES:
        t0 = time.perf_counter()
        served = served_model(torch, arch, layers, prompt)
        build_s = time.perf_counter() - t0
        got, row, run = phase_serve(torch, served)
        if profile:
            phase_profile(torch, served)
        cfg = served[0].cfg
        row.update(phase="families", card=smi, published_layers=get_config(arch).num_layers, cut=cut,
                   build_s=build_s, kv_cache_dtype=cfg.kv_cache_dtype, cache_bytes=kv_bytes(run[0]))
        if cfg.family == "encdec":
            row["cached_against_uncached"] = whisper_check(torch, prompt)
        if cfg.kv_cache_dtype == "int8":
            row["int8_cache"] = int8_cache_check(torch, served, run)
        if cfg.moe is not None:
            for name in ("topk_gating", "load_histogram", "dispatch_gather", "moe_combine"):
                check(got[name] == 1 + DECODE_STEPS, f"{arch}: {name} launched {got[name]} times")
            counts = got
            row["kernel_path"] = moe_path_check(torch, served)
        del run
        row["seconds"] = time.perf_counter() - t0
        emit(row)
        del served
        torch.cuda.empty_cache()
    reduced = [reduced_card_host(torch, arch) for arch in REDUCED_IDS]
    emit({"phase": "families_reduced", "card": smi, "dtype": "float32", "batch": REDUCED_BATCH,
          "prompt": REDUCED_PROMPT, "decode_steps": CHECK_STEPS, "configs": reduced,
          "seconds": time.perf_counter() - t_start})
    return counts


# --------------------------------------------------------------------- #
# Phase 7: the adaptive link and its planners, card against host
# --------------------------------------------------------------------- #

# (instances, items): the paper's 4-node cluster of 8 interpreters, and
# 128 such nodes.
LINK_SIZES = ((32, 4096), (64, 4096), (128, 4096), (1024, 1 << 20))
LINK_TICKS = 6
LPT_ITEMS = 4096
HOST = "cpu"


def sync(torch, device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def link_inputs(n: int, items: int, seed: int):
    """LINK_TICKS ticks of items: Zipf-skewed ownership (a quarter of the
    items on producer 0), log-normal costs in seconds, sizes in bytes,
    2 % padding."""
    import numpy as np

    rng = np.random.default_rng(seed)
    ticks = []
    for _ in range(LINK_TICKS):
        producer = np.minimum(rng.zipf(1.3, items) - 1, n - 1).astype(np.int32)
        costs = rng.lognormal(-7.0, 1.5, items).astype(np.float32)
        sizes = rng.integers(64, 4096, items).astype(np.float32)
        valid = rng.random(items) < 0.98
        ticks.append((costs, sizes, producer, valid))
    return ticks


def run_link(torch, policy, n, ticks, device):
    """AdaptiveLink.step over the ticks on ``device``: the plans and the
    state after each step (on the host), and each step's host time with
    the device drained before and after."""
    from repro_torch.core.adaptive_link import AdaptiveLink, AdaptiveLinkConfig
    from repro_torch.core.types import DySkewConfig

    link = AdaptiveLink(AdaptiveLinkConfig(dyskew=DySkewConfig(policy=policy), num_instances=n),
                        device=device)
    state = link.init_state()
    steps, ms = [], []
    for arrays in ticks:
        tensors = [torch.from_numpy(a).to(device) for a in arrays]
        sync(torch, device)
        t0 = time.perf_counter()
        state, plan = link.step(state, *tensors)
        sync(torch, device)
        ms.append((time.perf_counter() - t0) * 1e3)
        host_state = {k: (v.cpu() if not isinstance(v, dict) else {m: x.cpu() for m, x in v.items()})
                      for k, v in state.items()}
        steps.append((plan.dest.cpu(), plan.distribute.cpu(), float(plan.est_bytes_moved),
                      float(plan.est_time_saved), host_state))
    return steps, ms


def same_link_run(torch, a, b, where, exact_estimates):
    """``exact_estimates`` names the estimates that must be equal; the rest
    agree to rtol 1e-6."""
    for t, (sa, sb) in enumerate(zip(a, b)):
        at = f"{where} tick {t}"
        check(torch.equal(sa[0], sb[0]), f"{at}: dest")
        check(torch.equal(sa[1], sb[1]), f"{at}: distribute")
        for i, name in ((2, "est_bytes_moved"), (3, "est_time_saved")):
            ok = sa[i] == sb[i] if name in exact_estimates else abs(sa[i] - sb[i]) <= 1e-6 * abs(sb[i])
            check(ok, f"{at}: {name} {sa[i]!r} against {sb[i]!r}")
        for key, v in sa[4].items():
            if isinstance(v, dict):
                for m, x in v.items():
                    check(torch.equal(x, sb[4][key][m]), f"{at}: link metric {m}")
            else:
                check(torch.equal(v, sb[4][key]), f"{at}: link {key}")


def planner_runs(torch, n, items, card, seed):
    """Every planner at (n, items), with and without ``eligible`` and
    ``base_loads``: twice on the card, once on the host, all equal."""
    import numpy as np

    from repro_torch.core import redistribution as rd

    rng = np.random.default_rng(seed)
    costs = rng.lognormal(-7.0, 1.5, items).astype(np.float32)
    costs[rng.random(items) < 0.2] = 0.0          # ties, as non-moving items have
    base = np.round(rng.uniform(0.0, 4.0, n), 2).astype(np.float32)
    eligible = rng.random(n) < 0.75
    cases, lpt_ms = 0, None
    for use_base in (False, True):
        for use_elig in (False, True):
            def args(device):
                kw = {}
                if use_base:
                    kw["base_loads"] = torch.from_numpy(base).to(device)
                if use_elig:
                    kw["eligible"] = torch.from_numpy(eligible).to(device)
                return torch.from_numpy(costs).to(device), kw
            planners = ["zigzag"] + (["lpt_greedy"] if items <= LPT_ITEMS else [])
            for name in planners:
                outs = []
                for device in (card, card, HOST):
                    c, kw = args(device)
                    sync(torch, device)
                    t0 = time.perf_counter()
                    dest, loads = getattr(rd, name)(c, n, **kw)
                    span = rd.makespan(dest, c, n)
                    sync(torch, device)
                    if name == "lpt_greedy" and device == card and not use_base and not use_elig:
                        lpt_ms = (time.perf_counter() - t0) * 1e3
                    outs.append((dest.cpu(), loads.cpu(), span.cpu()))
                for o in outs[1:]:
                    for x, y in zip(outs[0], o):
                        check(torch.equal(x, y), f"{name} n={n} items={items} base={use_base} "
                                                 f"eligible={use_elig}: card runs or card and host differ")
                cases += 1
            rr = [rd.round_robin(items, n, 3, args(d)[1].get("eligible"), device=d).cpu()
                  for d in (card, card, HOST)]
            check(torch.equal(rr[0], rr[1]) and torch.equal(rr[0], rr[2]), f"round_robin n={n}")
            cases += 1
    return cases, lpt_ms


def order_controls(torch, card):
    """Why the link sums through ``ordered_sums``: how many results of
    PyTorch's own sums and divisions on ``card`` differ from the host's
    float32 in index order, beside the port's, which must differ in none."""
    import numpy as np

    from repro_torch.core import ordered_sums as osum

    rng = np.random.default_rng(0)
    n, items = LINK_SIZES[-1]
    index = np.minimum(rng.zipf(1.3, items) - 1, n - 1)
    values = (rng.standard_normal(items) * 10 ** rng.uniform(-3, 3, items)).astype(np.float32)
    in_order = np.zeros(n, np.float32)
    np.add.at(in_order, index, values)            # unbuffered: one item at a time, in order
    idx, val = torch.from_numpy(index).to(card), torch.from_numpy(values).to(card)
    zeros = torch.zeros(n, dtype=torch.float32, device=card)
    x = rng.integers(0, 1000, 100_000).astype(np.float32)
    rows = rng.standard_normal((4096, 8)).astype(np.float32)
    rows_in_order = rows[:, 0].copy()
    for i in range(1, rows.shape[1]):
        rows_in_order += rows[:, i]
    xt, rt = torch.from_numpy(x).to(card), torch.from_numpy(rows).to(card)

    def differ(t, want):
        return int((t.cpu().numpy() != want).sum())

    out = {
        "slots": n, "items": items, "quotients": x.size, "rows_of_8": rows.shape[0],
        "scatter_add_differs": differ(osum.scatter_add(zeros, idx, val), in_order),
        "index_put_accumulate_differs": differ(zeros.clone().index_put_((idx,), val, accumulate=True), in_order),
        "index_add_differs": differ(zeros.clone().index_add_(0, idx, val), in_order),
        "div_differs": differ(osum.div(xt, 31), x / np.float32(31)),
        "div_by_python_number_differs": differ(xt / 31, x / np.float32(31)),
        "sum_last_differs": differ(osum.sum_last(rt), rows_in_order),
        "sum_dim_differs": differ(rt.sum(dim=-1), rows_in_order),
    }
    for key in ("scatter_add_differs", "div_differs", "sum_last_differs"):
        check(out[key] == 0, f"ordered sums on {card}: {key} = {out[key]}")
    return out


def phase_link(torch, card="cuda"):
    import statistics as st

    from repro_torch.core.types import Policy

    t_start = time.perf_counter()
    sizes = []
    for n, items in LINK_SIZES:
        ticks = link_inputs(n, items, seed=n)
        row = {"instances": n, "items": items, "ticks": LINK_TICKS}
        for policy in (Policy.EAGER_SNOWPARK, Policy.LATE):
            first, ms_card = run_link(torch, policy, n, ticks, card)
            again, _ = run_link(torch, policy, n, ticks, card)
            host, ms_host = run_link(torch, policy, n, ticks, HOST)
            same_link_run(torch, first, again, f"link {policy.name} n={n}: two card runs",
                          ("est_bytes_moved", "est_time_saved"))
            # bytes_moved is one long sum in XLA's host order on both.
            same_link_run(torch, first, host, f"link {policy.name} n={n}: card against host",
                          ("est_bytes_moved",))
            row[policy.name] = {
                "host_ms_card": st.median(ms_card), "host_ms_card_first": ms_card[0],
                "host_ms_cpu": st.median(ms_host),
                "distributing_ticks": sum(bool(s[1].any()) for s in first),
                "items_moved": [int((s[0] != torch.from_numpy(t[2])).sum()) for s, t in zip(first, ticks)],
            }
        row["planner_cases"], row["lpt_greedy_ms"] = planner_runs(torch, n, items, card, seed=n + 1)
        sizes.append(row)
    check(sizes[0]["EAGER_SNOWPARK"]["distributing_ticks"] == LINK_TICKS, "link: an eager link must distribute")
    check(sizes[0]["LATE"]["distributing_ticks"] > 0, "link: a late link must fire on this skew")
    emit({"phase": "link", "device": card, "sizes": sizes, "controls": order_controls(torch, card),
          "card_runs_identical": True, "card_equals_host": True,
          "seconds": time.perf_counter() - t_start})


# --------------------------------------------------------------------- #
# Phase 8: the Snowpark UDF simulator, card against host
# --------------------------------------------------------------------- #

SIM_RTOL = 1e-9


class TickLog:
    """Wraps the simulators' two tick drivers while in use: keeps every
    distribute mask and the host time of each call (which ends when the
    mask is back on the host)."""

    def __init__(self):
        from repro_torch.sim import batched_link, engine

        self.classes = (engine.AdaptiveLinkSim, batched_link.BatchedLinkSim)

    def __enter__(self):
        self.masks = {c.__name__: [] for c in self.classes}
        self.seconds = {c.__name__: 0.0 for c in self.classes}
        self.saved = [c.tick for c in self.classes]
        for cls, orig in zip(self.classes, self.saved):
            def tick(obj, *args, _orig=orig, _name=cls.__name__, **kw):
                t0 = time.perf_counter()
                out = _orig(obj, *args, **kw)
                self.seconds[_name] += time.perf_counter() - t0
                self.masks[_name].append(out.copy())
                return out
            cls.tick = tick
        return self

    def __exit__(self, *exc):
        for cls, orig in zip(self.classes, self.saved):
            cls.tick = orig
        return False

    def ms_per_tick(self, name=None):
        names = [name] if name else list(self.masks)
        count = sum(len(self.masks[k]) for k in names)
        return sum(self.seconds[k] for k in names) / count * 1e3 if count else None


def same_masks(a: TickLog, b: TickLog, where: str) -> int:
    import numpy as np

    total = 0
    for name, ma in a.masks.items():
        mb = b.masks[name]
        check(len(ma) == len(mb), f"{where}: {len(ma)} against {len(mb)} {name} ticks")
        for i, (x, y) in enumerate(zip(ma, mb)):
            check(np.array_equal(x, y), f"{where}: distribute mask of {name} tick {i}")
        total += len(ma)
    return total


def same_results(a, b, where: str) -> None:
    import numpy as np

    check(len(a) == len(b), f"{where}: result count")
    for i, (x, y) in enumerate(zip(a, b)):
        for f in ("latency", "utilization", "bytes_moved_remote", "decision_overhead"):
            check(bool(np.isclose(getattr(x, f), getattr(y, f), rtol=SIM_RTOL, atol=0.0)),
                  f"{where} {i}: {f} {getattr(x, f)!r} against {getattr(y, f)!r}")
        check(bool(np.allclose(x.per_worker_busy, y.per_worker_busy, rtol=SIM_RTOL, atol=0.0)),
              f"{where} {i}: per_worker_busy")
        for f in ("num_ticks", "rows_redistributed", "redistribution_applied", "preempted_rows"):
            check(getattr(x, f) == getattr(y, f), f"{where} {i}: {f}")


def on_both(torch, card, run, where):
    """``run(device)`` on the card, then on the host; masks and results
    held equal.  Returns the card's output, both logs and both walls."""
    outs, logs, walls = [], [], []
    for device in (card, HOST):
        with TickLog() as log:
            sync(torch, device)
            t0 = time.perf_counter()
            out = run(device)
            walls.append(time.perf_counter() - t0)
        outs.append(out)
        logs.append(log)
    ticks = same_masks(logs[0], logs[1], where)
    return outs, logs, walls, ticks


def fig4_run(device):
    from repro_torch.sim.engine import ClusterConfig, Simulator
    from repro_torch.sim.replay import dyskew_strategy, legacy_strategy
    from repro_torch.sim.workload import generate_query, tpcxbb_suite

    cluster = ClusterConfig(num_nodes=4)
    out = []
    for i, prof in enumerate(tpcxbb_suite()):
        batches = generate_query(prof, cluster.num_workers, seed=100 + i)
        legacy = Simulator(cluster, legacy_strategy(prof), seed=i, device=device).run_query(batches)
        dyskew = Simulator(cluster, dyskew_strategy(prof), seed=i, device=device).run_query(batches)
        out.append((prof.name, legacy, dyskew))
    return out


MANY_TENANTS = 256
MANY_TICK_S = 8e-3


def many_tenants_run(device):
    from repro_torch.core.types import DySkewConfig, Policy, SkewModelKind
    from repro_torch.sim.engine import ClusterConfig, MultiQuerySimulator, StrategyConfig
    from repro_torch.sim.replay import open_loop_rate, open_loop_tenants
    from repro_torch.sim.workload import ArrivalProcess, many_tenants_suite

    cluster = ClusterConfig(num_nodes=4)
    specs = many_tenants_suite(MANY_TENANTS, seed=71)
    strategy = StrategyConfig(
        kind="dyskew",
        dyskew=DySkewConfig(policy=Policy.LATE, skew_model=SkewModelKind.IDLE_TIME, n_strikes=2),
        tick_interval=MANY_TICK_S,
    )
    proc = ArrivalProcess(kind="poisson", rate=open_loop_rate([p for p, _ in specs], cluster, load=0.7))
    tenants = open_loop_tenants(specs, cluster, lambda prof: strategy, proc, MANY_TENANTS, seed=0,
                                grid_align=MANY_TICK_S)
    sim = MultiQuerySimulator(cluster, device=device)
    return sim.run(tenants), dict(sim.last_event_counts)


def fault_run(device):
    from repro_torch.core.admission import FairShareConfig
    from repro_torch.runtime.fault_tolerance import FaultConfig
    from repro_torch.sim.engine import ClusterConfig, MultiQuerySimulator, TenantQuery
    from repro_torch.sim.faults import CRASH, FaultEvent, FaultSchedule
    from repro_torch.sim.replay import dyskew_strategy, scan_arrival_gap
    from repro_torch.sim.workload import QueryProfile, generate_query

    cluster = ClusterConfig(num_nodes=2)
    prof = QueryProfile(name="t", n_rows=800, mean_row_cost=1.2e-3, cost_sigma=0.8,
                        partition_alpha=0.6, hot_fraction=0.1)
    gap = scan_arrival_gap(prof, cluster)
    tenants = [TenantQuery(f"t{i}", generate_query(prof, cluster.num_workers, seed=3 + i),
                           dyskew_strategy(prof), 0.02 * i, gap) for i in range(3)]
    sim = MultiQuerySimulator(
        cluster, fair_share=FairShareConfig(quantum_rows=64.0, heavy_row_bytes=1e6),
        faults=FaultSchedule(events=(FaultEvent(time=0.05, kind=CRASH, worker=1),)),
        fault_cfg=FaultConfig(heartbeat_interval=0.02, missed_beats_dead=2, n_strikes=3,
                              slope_window=8, min_hosts=2),
        device=device,
    )
    return sim.run(tenants), dict(sim.last_fault_stats)


def pipeline_run(device):
    from repro_torch.sim.engine import ClusterConfig
    from repro_torch.sim.replay import run_pipeline_ab
    from repro_torch.sim.workload import pipeline_suite

    name, stages, inputs = pipeline_suite(quick=True)[0]
    return name, run_pipeline_ab(stages, inputs, ClusterConfig(num_nodes=4), seed=13, device=device)


CLAIM_QUERIES = ("q05", "q10", "q19", "q22")


def claims_run(device):
    """The paper's claims as ``tests/test_paper_claims.py`` and
    ``tests/test_slo_layer.py`` run them: Fig. 4's four quick queries at
    seeds 100 + i on 4 nodes, the §III.B heavy-row case (``none``, the
    unguarded arm, the guarded arm), the Never and Eager policy runs, and
    the overloaded SLO mix under weight-only and deadline-aware admission."""
    from repro_torch.core.admission import DeadlineConfig, FairShareConfig
    from repro_torch.core.types import DySkewConfig, Policy
    from repro_torch.sim.engine import ClusterConfig, Simulator, StrategyConfig
    from repro_torch.sim.replay import (dyskew_strategy, improvement, legacy_strategy,
                                        open_loop_rate, run_open_loop)
    from repro_torch.sim.workload import (ArrivalProcess, QueryProfile, generate_query,
                                          heavy_rows_case, slo_suite, tpcxbb_suite)

    out = {"fig4": {}}
    cluster = ClusterConfig(num_nodes=4)
    suite = {p.name: p for p in tpcxbb_suite()}
    for i, name in enumerate(CLAIM_QUERIES):
        prof = suite[name]
        batches = generate_query(prof, cluster.num_workers, seed=100 + i)
        legacy = Simulator(cluster, legacy_strategy(prof), i, device=device).run_query(batches)
        dyskew = Simulator(cluster, dyskew_strategy(prof), i, device=device).run_query(batches)
        out["fig4"][name] = (improvement(legacy.latency, dyskew.latency), legacy, dyskew)

    batches = generate_query(heavy_rows_case(row_gb=1.0, n_rows=48), cluster.num_workers, seed=0)
    unguarded = StrategyConfig(
        kind="dyskew",
        dyskew=DySkewConfig(policy=Policy.EAGER_SNOWPARK, cost_gate=0.0, min_batch_density_frac=0.0),
        enable_density_guard=False, enable_cost_gate=False,
    )
    out["heavy_rows"] = [Simulator(cluster, st, 0, device=device).run_query(batches)
                         for st in (StrategyConfig(kind="none"), unguarded, StrategyConfig(kind="dyskew"))]

    cluster = ClusterConfig(num_nodes=2)
    for key, prof in (
        ("never", QueryProfile(name="nv", n_rows=4000, mean_row_cost=1e-3, partition_alpha=1.0,
                               hot_fraction=0.3, policy=Policy.NEVER)),
        ("eager", QueryProfile(name="ea", n_rows=4000, mean_row_cost=1e-3, policy=Policy.EAGER_SNOWPARK)),
    ):
        batches = generate_query(prof, cluster.num_workers, seed=0)
        out[key] = Simulator(cluster, dyskew_strategy(prof), 0, device=device).run_query(batches)

    specs = slo_suite()
    proc = ArrivalProcess(kind="poisson", rate=open_loop_rate([p for p, _, _ in specs], cluster, load=2.5))
    kw = dict(fair_share=FairShareConfig(quantum_rows=64.0, heavy_row_bytes=1e6), seed=0, device=device)
    deadline = DeadlineConfig(urgency_horizon=1.0, boost_quanta=4.0)
    out["slo"] = [
        {k: v for k, v in run_open_loop(specs, cluster, proc, 14, **arm, **kw).items() if k != "tenants"}
        for arm in ({}, dict(deadline_aware=True, deadline_cfg=deadline))
    ]
    return out


def claims_checks(out) -> dict:
    """The bands of the reference's claim tests on one side's numbers;
    returns the virtual-time readings."""
    imp = {q: out["fig4"][q][0] for q in CLAIM_QUERIES}
    check(0.30 <= imp["q10"] <= 0.60, f"claims: Fig. 4 q10 improvement {imp['q10']} outside 0.30-0.60")
    check(0.20 <= imp["q19"] <= 0.50, f"claims: Fig. 4 q19 improvement {imp['q19']} outside 0.20-0.50")
    for q in ("q05", "q22"):
        check(abs(imp[q]) < 0.08, f"claims: Fig. 4 {q} improvement {imp[q]} not within 0.08")
    none, ung, grd = out["heavy_rows"]
    check(ung.latency > 10.0 * none.latency, f"claims: unguarded heavy rows {ung.latency} not > 10x {none.latency}")
    check(grd.latency < 1.1 * none.latency, f"claims: guarded heavy rows {grd.latency} not < 1.1x {none.latency}")
    never, eager = out["never"], out["eager"]
    check(never.rows_redistributed == 0 and not never.redistribution_applied, "claims: Policy.NEVER moved rows")
    check(eager.redistribution_applied, "claims: Policy.EAGER_SNOWPARK did not redistribute")
    base, dl = out["slo"]
    g_base, g_dl = base["per_class"]["gold"], dl["per_class"]["gold"]
    check(dl["slo_attainment"] >= base["slo_attainment"], "claims: deadline-aware lost on SLO attainment")
    check(g_dl["slo_attainment"] >= g_base["slo_attainment"], "claims: deadline-aware lost gold's attainment")
    check(g_dl["p99_tardiness"] <= g_base["p99_tardiness"] + 1e-9, "claims: deadline-aware lost gold's p99 tardiness")
    return {
        "fig4_improvement": imp,
        "fig4_latency_virtual_s": {q: [out["fig4"][q][1].latency, out["fig4"][q][2].latency]
                                   for q in CLAIM_QUERIES},
        "heavy_rows_latency_virtual_s": {"none": none.latency, "unguarded": ung.latency, "guarded": grd.latency},
        "heavy_rows_unguarded_over_none": ung.latency / none.latency,
        "heavy_rows_guarded_over_none": grd.latency / none.latency,
        "heavy_rows_redistributed": [r.rows_redistributed for r in out["heavy_rows"]],
        "never_rows_redistributed": never.rows_redistributed,
        "eager_rows_redistributed": eager.rows_redistributed,
        "slo_attainment": [base["slo_attainment"], dl["slo_attainment"]],
        "gold_slo_attainment": [g_base["slo_attainment"], g_dl["slo_attainment"]],
        "gold_p99_tardiness_virtual_s": [g_base["p99_tardiness"], g_dl["p99_tardiness"]],
    }


def device_work_of(torch, fn):
    """Kernels and copies one call of ``fn`` puts on the card, from
    torch.profiler (None where the trace shows no device events), and the
    synchronising calls PyTorch reports for it."""
    import warnings

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = copies = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            if e.name.startswith(("Memcpy", "Memset")):
                copies += 1
            else:
                kernels += 1
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    if kernels == 0:
        return {"kernels": None, "copies": None, "syncs": syncs}
    return {"kernels": kernels, "copies": copies, "syncs": syncs}


def tick_launches(torch):
    """Device work of one tick of each driver, and of one link step, at the
    sizes the simulator and the link phase use."""
    import numpy as np

    from repro_torch.core.adaptive_link import AdaptiveLink, AdaptiveLinkConfig
    from repro_torch.core.types import DySkewConfig, Policy, SkewModelKind
    from repro_torch.sim.batched_link import BatchedLinkSim
    from repro_torch.sim.engine import AdaptiveLinkSim

    rng = np.random.default_rng(5)
    cfg = DySkewConfig(policy=Policy.LATE, skew_model=SkewModelKind.IDLE_TIME, n_strikes=2)
    n, T = 32, MANY_TENANTS

    def inputs(shape):
        rows = rng.poisson(3.0, shape).astype(np.float64)
        return rows, rows * 1e-3, rows, np.full(shape, 2048.0), rng.random(shape) < 0.3

    solo = AdaptiveLinkSim(cfg, n, "cuda")
    one = inputs((n,))
    batched = BatchedLinkSim(cfg, n, T, "cuda")
    many = inputs((T, n))
    active = np.ones(T, bool)
    link = AdaptiveLink(AdaptiveLinkConfig(dyskew=DySkewConfig(policy=Policy.EAGER_SNOWPARK),
                                           num_instances=n), device="cuda")
    state = link.init_state()
    costs, sizes, producer, valid = (torch.from_numpy(a).cuda() for a in link_inputs(n, LINK_SIZES[0][1], 9)[0])
    return {
        "tick_n32": device_work_of(torch, lambda: solo.tick(*one)),
        "batched_tick_256x32": device_work_of(torch, lambda: batched.tick(*many, active)),
        "link_step_32x4096": device_work_of(torch, lambda: link.step(state, costs, sizes, producer, valid)),
    }


def phase_sim(torch, card="cuda"):
    from repro_torch.sim.replay import improvement

    t_start = time.perf_counter()
    row = {"phase": "sim", "device": card}

    # 1. Fig. 4: the TPCx-BB suite, legacy and DySkew arms, 4 nodes.
    outs, logs, walls, ticks = on_both(torch, card, fig4_run, "fig4")
    for (qa, la, da), (qb, lb, db) in zip(*outs):
        check(qa == qb, "fig4: query order")
        same_results([la, da], [lb, db], f"fig4 {qa}")
    row["fig4"] = {
        "queries": len(outs[0]), "link_ticks": ticks,
        "improvement_virtual": {q: improvement(lg.latency, dk.latency) for q, lg, dk in outs[0]},
        "dyskew_latency_virtual_s": {q: dk.latency for q, _, dk in outs[0] if q in ("q10", "q19")},
        "legacy_latency_virtual_s": {q: lg.latency for q, lg, _ in outs[0] if q in ("q10", "q19")},
        "dyskew_ticks": {q: dk.num_ticks for q, _, dk in outs[0] if q in ("q10", "q19")},
        "wall_s_card": walls[0], "wall_s_cpu": walls[1],
        # A lone tenant rides a one-row batched group: every tick is (1, 32).
        "ms_per_tick_card": logs[0].ms_per_tick(),
        "ms_per_tick_cpu": logs[1].ms_per_tick(),
    }

    # 2. 256 open-loop tenants on one warehouse, grid-aligned: batched ticks.
    outs, logs, walls, ticks = on_both(torch, card, many_tenants_run, "tenants")
    same_results(outs[0][0], outs[1][0], "tenants")
    check(outs[0][1] == outs[1][1], "tenants: event counts")
    gticks = outs[0][1]["gtick"]
    check(gticks == len(logs[0].masks["BatchedLinkSim"]) > 0, "tenants: batched ticks")
    check(all(m.shape == (MANY_TENANTS, 32) for m in logs[0].masks["BatchedLinkSim"]), "tenants: tick shape")
    row["tenants"] = {
        "tenants": MANY_TENANTS, "batched_ticks": gticks, "per_tenant_ticks": outs[0][1]["tick"],
        "ms_per_batched_tick_card": logs[0].ms_per_tick("BatchedLinkSim"),
        "ms_per_batched_tick_cpu": logs[1].ms_per_tick("BatchedLinkSim"),
        "wall_s_card": walls[0], "wall_s_cpu": walls[1],
        "mean_latency_virtual_s": sum(r.latency for r in outs[0][0]) / len(outs[0][0]),
    }

    # 3. A worker crash mid-query, and one pipeline scenario.
    outs, logs, walls, ticks = on_both(torch, card, fault_run, "faults")
    same_results(outs[0][0], outs[1][0], "faults")
    check(repr(outs[0][1]) == repr(outs[1][1]), "faults: fault statistics")
    stats = outs[0][1]
    check(stats["detections"] >= 1 and stats["unrecovered_rows"] == 0, "faults: crash not recovered")
    row["faults"] = {"link_ticks": ticks, "detections": stats["detections"],
                     "recovered_rows": sum(stats["recovered_rows"]),
                     "wall_s_card": walls[0], "wall_s_cpu": walls[1]}
    outs, logs, walls, ticks = on_both(torch, card, pipeline_run, "pipeline")
    (name, ab_card), (_, ab_host) = outs
    check(repr(ab_card) == repr(ab_host), "pipeline: summaries")
    row["pipeline"] = {"scenario": name, "arms": sorted(ab_card), "link_ticks": ticks,
                       "makespan_virtual_s": {k: v["makespan"] for k, v in ab_card.items()},
                       "wall_s_card": walls[0], "wall_s_cpu": walls[1]}

    # 4. The paper's claims (the reference's claim tests' runs): the same
    # bits on card and host, the bands checked on the card's numbers.
    outs, logs, walls, ticks = on_both(torch, card, claims_run, "claims")
    same_value(outs[0], outs[1], "claims")
    row["claims"] = dict(claims_checks(outs[0]), link_ticks=ticks, wall_s_card=walls[0], wall_s_cpu=walls[1])

    if torch.device(card).type == "cuda":
        row["device_work"] = tick_launches(torch)
    row["seconds"] = time.perf_counter() - t_start
    emit(row)


# --------------------------------------------------------------------- #
# Phase 9: the DySkew data pipeline, card against host
# --------------------------------------------------------------------- #

TRAIN_BATCH, TRAIN_SEQ, TRAIN_SHARDS, TRAIN_STEPS = 8, 1024, 8, 4
PIPELINE_BATCHES = 64
# A shape at which the link does move sequences (eight a shard).
MOVING_BATCH, MOVING_SEQ = 64, 128


def train_data_config(vocab: int, seq: int = TRAIN_SEQ, batch: int = TRAIN_BATCH):
    from repro_torch.data.pipeline import DataConfig

    return DataConfig(vocab_size=vocab, seq_len=seq, global_batch=batch, num_shards=TRAIN_SHARDS)


def data_pipeline_run(torch, data_cfg, device, count):
    """``count`` batches from a fresh pipeline, each link plan's ``dest``
    and the wall seconds (one thread, no prefetch: every batch's assembly
    and link step is on the clock)."""
    from repro_torch.data.pipeline import DataPipeline

    pipe = DataPipeline(data_cfg, device=device)
    dests, step = [], pipe.link.step

    def recorded(*args, **kw):
        state, plan = step(*args, **kw)
        dests.append(plan.dest.cpu())
        return state, plan
    pipe.link.step = recorded
    t0 = time.perf_counter()
    batches = [next(pipe) for _ in range(count)]
    return batches, dests, time.perf_counter() - t0, pipe


def data_pipeline_card_host(torch, data_cfg, card, count):
    """``count`` batches on the card and on the host: the same tokens,
    targets, plans and link state.  Returns the card's batches, the wall
    seconds on each device, the card's pipeline and how many batches the
    link moved a sequence off its producer's shard in."""
    import numpy as np

    (b_card, d_card, s_card, p_card), (b_host, d_host, s_host, p_host) = (
        data_pipeline_run(torch, data_cfg, dev, count) for dev in (card, HOST))
    shape = f"{data_cfg.global_batch}x{data_cfg.seq_len}"
    for i, (a, b) in enumerate(zip(b_card, b_host)):
        for key in ("tokens", "targets"):
            check(np.array_equal(a[key], b[key]), f"data_pipeline {shape} batch {i}: {key}")
    check(len(d_card) == len(d_host) == count, f"data_pipeline {shape}: one link step a batch")
    check(all(torch.equal(a, b) for a, b in zip(d_card, d_host)), f"data_pipeline {shape}: dest")
    for key in ("state", "strikes", "transitions", "tick"):
        check(torch.equal(p_card.link_state[key].cpu(), p_host.link_state[key]),
              f"data_pipeline {shape}: link {key}")
    for key, v in p_card.link_state["metrics"].items():
        check(torch.equal(v.cpu(), p_host.link_state["metrics"][key]),
              f"data_pipeline {shape}: link metric {key}")
    batch = data_cfg.global_batch
    producer = torch.arange(batch) * data_cfg.num_shards // batch
    moves = sum(bool((d != producer).any()) for d in d_card)
    return b_card, s_card, s_host, p_card, moves


def phase_data_pipeline(torch, card="cuda"):
    """At the training shape (one sequence a shard, so the cost gate keeps
    every sequence home) and at 64 x 128 on 8 shards, where the link moves
    sequences: the card's plans must equal the host's at both."""
    import numpy as np

    data_cfg = train_data_config(49155)
    b_card, s_card, s_host, p_card, moves = data_pipeline_card_host(torch, data_cfg, card, PIPELINE_BATCHES)
    moving_cfg = train_data_config(49155, seq=MOVING_SEQ, batch=MOVING_BATCH)
    _, m_card, m_host, _, m_moves = data_pipeline_card_host(torch, moving_cfg, card, PIPELINE_BATCHES)
    check(m_moves > 0, f"data_pipeline {MOVING_BATCH}x{MOVING_SEQ}: the link moved no sequence")
    # The prefetch thread on the card, on its own stream: the same batches.
    threaded = p_card.__class__(data_cfg, device=card).start()
    thread = threaded._thread
    try:
        for i in range(min(8, len(b_card))):
            check(np.array_equal(next(threaded)["tokens"], b_card[i]["tokens"]), f"data_pipeline thread batch {i}")
    finally:
        threaded.stop()
    check(not thread.is_alive(), "data_pipeline: stop joins the thread")
    emit({"phase": "data_pipeline", "device": card, "batches": PIPELINE_BATCHES,
          "shape": [TRAIN_BATCH, TRAIN_SEQ], "shards": TRAIN_SHARDS,
          "ms_per_batch_card": s_card / PIPELINE_BATCHES * 1e3, "ms_per_batch_cpu": s_host / PIPELINE_BATCHES * 1e3,
          "batches_with_moves": moves,
          "nonpad_token_share": float(np.mean([(b["tokens"] != 0).mean() for b in b_card])),
          "moving": {"shape": [MOVING_BATCH, MOVING_SEQ], "shards": TRAIN_SHARDS,
                     "batches_with_moves": m_moves,
                     "ms_per_batch_card": m_card / PIPELINE_BATCHES * 1e3,
                     "ms_per_batch_cpu": m_host / PIPELINE_BATCHES * 1e3},
          "card_equals_host": True})


# --------------------------------------------------------------------- #
# Phase 10: the serving engine's scheduler, card against host
# --------------------------------------------------------------------- #


def serving_configs():
    """(name, ServeConfig keywords, requests): ``launch/serve.py``'s
    defaults under two schedulers, and the fair-share, deadline-aware,
    preempting configuration of ``tests/test_slo_layer.py``."""
    from repro_torch.launch.serve import requests
    from repro_torch.serving.engine import Request

    def gold_and_bulk():
        return [Request(rid=i, prompt_len=128, max_new_tokens=60 if i % 4 == 0 else 400,
                        arrival=i * 0.01, tenant=0 if i % 4 == 0 else 1) for i in range(40)]
    return (
        ("dyskew", dict(scheduler="dyskew"), lambda: requests(64)),
        ("round_robin", dict(scheduler="round_robin"), lambda: requests(64)),
        ("fair_share_deadline", dict(num_replicas=2, max_batch=4, decode_rate=2_000.0,
                                     tenant_weights=(1.0, 1.0), slo_targets=(0.5, None),
                                     deadline_aware=True, preemption=True), gold_and_bulk),
    )


def same_value(a, b, where):
    """Card against host bit for bit: results field by field, summaries
    key by key, floats and arrays equal (NaN equal to NaN)."""
    import dataclasses
    import math

    import numpy as np

    check(type(a) is type(b), f"{where}: {type(a).__name__} against {type(b).__name__}")
    if dataclasses.is_dataclass(a):
        for f in dataclasses.fields(a):
            same_value(getattr(a, f.name), getattr(b, f.name), f"{where}.{f.name}")
    elif isinstance(a, dict):
        check(list(a) == list(b), f"{where}: keys")
        for k in a:
            same_value(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        check(len(a) == len(b), f"{where}: length")
        for i, (x, y) in enumerate(zip(a, b)):
            same_value(x, y, f"{where}[{i}]")
    elif isinstance(a, np.ndarray):
        check(a.shape == b.shape and bool(np.array_equal(a, b, equal_nan=a.dtype.kind == "f")),
              f"{where}: arrays differ")
    elif isinstance(a, float):
        check(a == b or (math.isnan(a) and math.isnan(b)), f"{where}: {a!r} against {b!r}")
    else:
        check(a == b, f"{where}: {a!r} against {b!r}")


def phase_serving_engine(torch, card="cuda"):
    from repro_torch.serving.engine import ServeConfig, ServingEngine

    row = {"phase": "serving_engine", "device": card}
    for name, kw, make_requests in serving_configs():
        out = []
        for dev in ("cuda", HOST):
            eng = ServingEngine(ServeConfig(**kw), seed=0, device=dev)
            inner, calls = eng.sched.rebalance, []

            def rebalance(queued, load_tokens, _inner=inner, _calls=calls):
                t0 = time.perf_counter()
                moves = _inner(queued, load_tokens)
                _calls.append((time.perf_counter() - t0, dict(moves), len(queued)))
                return moves
            eng.sched.rebalance = rebalance
            t0 = time.perf_counter()
            res = eng.run(make_requests())
            # A pass runs the link when its policy uses one and requests wait.
            linked = [c for c in calls if c[2] > 0] if eng.sched.policy.uses_link else []
            out.append((res, calls, time.perf_counter() - t0, linked))
        (res, calls, wall, linked), (res_h, calls_h, wall_h, linked_h) = out
        same_value(res, res_h, f"serving_engine {name}")
        check([c[1] for c in calls] == [c[1] for c in calls_h], f"serving_engine {name}: rebalance moves")
        row[name] = {
            "wall_s_card": wall, "wall_s_cpu": wall_h, "rebalance_calls": len(calls),
            "rebalance_link_steps": len(linked),
            "ms_per_rebalance_card": sum(c[0] for c in linked) / len(linked) * 1e3 if linked else None,
            "ms_per_rebalance_cpu": sum(c[0] for c in linked_h) / len(linked_h) * 1e3 if linked_h else None,
            "moves": sum(len(c[1]) for c in calls),
            "completed": res["completed"], "mean_latency_virtual_s": res["mean_latency"],
            "p99_latency_virtual_s": res["p99_latency"], "migrations": res["migrations"],
        }
        check(res["completed"] > 0, f"serving_engine {name}: nothing completed")
    row["card_equals_host"] = True
    emit(row)


# --------------------------------------------------------------------- #
# Phase 11: training, step 1 kernel against plain, then 4 full steps
# --------------------------------------------------------------------- #

#: Step 1, kernel path against plain path, at full width and depth in
#: float32 (TF32 off).  The plain path differentiates through the plain
#: versions of all three dispatch steps; its gating replays the kernel
#: path's picks and takes the kernel's weights as its forward value
#: (``PickLog``), so both forwards are the same bits and the comparison is of
#: the backwards: the loss, and each leaf's max |difference| over its max
#: |gradient|.  Left to its own forward, the plain path differs from the
#: kernel path in the weights' last bits, which the random model (stacked
#: leaves drawn at fan-in = the number of blocks) amplifies from layer to
#: layer: that run is reported and held only to ``TRAIN_OWN_LOSS_RTOL``.
#: In bf16, the training dtype, the gradients are held to the looser
#: ``TRAIN_GRAD_TOL_BF16``: at random init the attention's softmax backward
#: cancels (P · (dP - Σ P dP) with P near uniform), so a bf16 rounding of an
#: upstream gradient moves the q/k gradients by a large share of their own
#: size (4.92e-2 of the largest element on an H100), while a gradient that
#: is dropped or zeroed reads 1.0.
TRAIN_LOSS_RTOL = 1e-6
TRAIN_GRAD_TOL = 1e-3
TRAIN_GRAD_TOL_BF16 = 0.2
TRAIN_OWN_LOSS_RTOL = 1e-3


class PickLog:
    """The kernel path's gating, keeping each call's weights and picks in
    call order (forward, then the recompute of each block), and a plain
    gating that replays them: softmax, gather and renormalise by autograd,
    with the kernel's weights as the forward value and the plain graph's
    gradient.  ``flips`` counts the rows where the plain version's own
    picks would differ."""

    def __init__(self):
        self.calls, self.replayed, self.flips = [], 0, 0
        #: The largest |kernel weight - plain weight| over the replays.
        self.w_gap = 0.0

    def record(self, logits, k):
        from repro_torch.models.layers.moe import KERNEL_OPS

        w, idx = KERNEL_OPS.gating(logits, k)
        self.calls.append((w.detach(), idx))
        return w, idx

    def replay(self, logits, k):
        from repro_torch.kernels.topk_gating.ref import gate_probs, renormalise, topk_gating_ref

        w_kernel, idx = self.calls[self.replayed]
        self.replayed += 1
        self.flips += int((topk_gating_ref(logits.detach(), k)[1] != idx).any(dim=-1).sum())
        w = renormalise(gate_probs(logits), idx)
        self.w_gap = max(self.w_gap, float((w.detach() - w_kernel).abs().max()))
        # The kernel's bits forward (w - w.detach() is exactly 0), the plain
        # graph's gradient backward.
        return w_kernel + (w - w.detach()), idx


def tree_pairs(a, b):
    from repro_torch.checkpoint.manager import flatten_with_paths

    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    check([k for k, _ in fa] == [k for k, _ in fb], "trees differ in their keys")
    return [(k, x, y) for (k, x), (_, y) in zip(fa, fb)]


def step_one_checks(torch, model, data_cfg, card, ctx=None, prepare=None):
    """Step 1's loss and gradients from one set of params and one batch:
    through the kernels twice, through the plain versions on the kernel
    path's forward values (the combine's contract, ``combine/ref.py``, in
    place of the plain loop, which rounds every product and sum to the
    model's type where the kernel sums in float32), and through the plain
    versions on their own.
    ``ctx`` sets the token groups (default one); ``prepare`` is applied to
    the drawn params first."""
    import dataclasses

    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels.combine.ref import moe_combine_contract
    from repro_torch.models import transformer
    from repro_torch.models.layers.moe import KERNEL_OPS, PLAIN_OPS, SpmdCtx
    from repro_torch.train.step import batch_to, make_grad_fn

    ctx = SpmdCtx() if ctx is None else ctx
    params = model.init(torch.Generator().manual_seed(0), device=card)
    if prepare is not None:
        prepare(params)
    batch = batch_to(next(DataPipeline(data_cfg, device=card)), torch.device(card))
    dyskew = model.dyskew_init(ctx, device=card)
    picks = PickLog()
    runs = []
    for ops in (dataclasses.replace(KERNEL_OPS, gating=picks.record), KERNEL_OPS):
        runs.append(make_grad_fn(model, ctx, ops=ops)(params, batch, dyskew))
    (loss_k, aux_k, grads_k), (_, _, grads_k2) = runs
    del runs
    n_moe = len(transformer.moe_layer_positions(model.cfg)) * transformer.num_blocks(model.cfg)
    # Every leaf bit-equal over two kernel runs: the gating, dispatch and
    # combine backwards are deterministic, and so is all that follows them.
    for key, a, b in tree_pairs(grads_k, grads_k2):
        check(torch.equal(a, b), f"train step 1: two kernel runs give other {key} gradients")
    del grads_k2

    loss_p, aux_p, grads_p = make_grad_fn(model, ctx, ops=dataclasses.replace(
        PLAIN_OPS, gating=picks.replay, combine=moe_combine_contract))(params, batch, dyskew)
    check(picks.replayed == len(picks.calls) == 2 * n_moe, "train step 1: the plain path's gating calls")
    grad_tol = TRAIN_GRAD_TOL if model.cfg.dtype == "float32" else TRAIN_GRAD_TOL_BF16
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(loss_rel <= TRAIN_LOSS_RTOL, f"train step 1 {model.cfg.dtype}: loss {float(loss_k)} against plain {float(loss_p)}")
    errs = {}
    for key, a, b in tree_pairs(grads_k, grads_p):
        check(bool(torch.isfinite(a).all()), f"train step 1: {key} gradient not finite")
        scale = float(b.float().abs().max())
        errs[key] = float((a.float() - b.float()).abs().max()) / max(scale, 1e-30)
        check(scale > 0, f"train step 1: {key} gradient is zero")
        check(errs[key] <= grad_tol, f"train step 1 {model.cfg.dtype}: {key} gradient {errs[key]} off plain")
    for key in ("moe_dropped_frac", "moe_distribute_frac"):
        check(float(aux_k["metrics"][key]) == float(aux_p["metrics"][key]), f"train step 1: {key}")
    del grads_p, grads_k
    loss_own, _, _ = make_grad_fn(model, ctx, ops=PLAIN_OPS)(params, batch, dyskew)
    own_rel = abs(float(loss_k) - float(loss_own)) / abs(float(loss_own))
    check(own_rel <= TRAIN_OWN_LOSS_RTOL, f"train step 1 {model.cfg.dtype}: loss {float(loss_k)} against "
          f"the plain path's own {float(loss_own)}")
    out = {"dtype": model.cfg.dtype, "loss_kernel": float(loss_k), "loss_plain": float(loss_p),
           "loss_rel_diff": loss_rel, "loss_tol": TRAIN_LOSS_RTOL, "grad_tol": grad_tol,
           "grad_err_max": max(errs.values()), "grad_err_by_leaf": errs,
           "loss_plain_own_forward": float(loss_own), "loss_rel_diff_own_forward": own_rel,
           "plain_pick_flips_own_forward": picks.flips,
           "all_grads_bitwise_equal": True,
           "moe_layers": n_moe, "gating_calls": len(picks.calls)}
    del params, batch, picks
    torch.cuda.empty_cache()
    return out


def phase_train(torch, card="cuda", profile=False):
    import dataclasses
    import shutil
    import tempfile

    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.config.base import get_config
    from repro_torch.models import transformer
    from repro_torch.models.model_api import build
    from repro_torch.optim.optimizers import OptimizerConfig

    t_start = time.perf_counter()
    cfg = get_config(MOE_ARCH)
    model = build(cfg)
    data_cfg = train_data_config(cfg.vocab_size)
    opt_cfg = OptimizerConfig(name=cfg.optimizer, warmup_steps=1, total_steps=TRAIN_STEPS)
    row = {"phase": "train", "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k, "dtype": cfg.dtype, "remat": cfg.remat,
           "optimizer": opt_cfg.name, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "shards": TRAIN_SHARDS,
           "steps": TRAIN_STEPS, "params": model.num_params()}
    row["step_one"] = [step_one_checks(torch, build(dataclasses.replace(cfg, dtype=dtype)), data_cfg, card)
                       for dtype in ("float32", cfg.dtype)]

    # ---- 4 steps through the loop: the counted main path ------------- #
    n_moe = len(transformer.moe_layer_positions(cfg)) * transformer.num_blocks(cfg)
    want = {"topk_gating": 2 * n_moe * TRAIN_STEPS, "load_histogram": 2 * n_moe * TRAIN_STEPS,
            "dispatch_gather": 2 * n_moe * TRAIN_STEPS, "ssd_state_scan": 0, "ssd_state_scan_bwd": 0,
            "moe_combine": 2 * n_moe * TRAIN_STEPS, "moe_combine_bwd": n_moe * TRAIN_STEPS, "attention": 0}
    out, counts, loop_row = counted_loop(torch, cfg, data_cfg, opt_cfg, card, want)
    hist = out["history"]
    row.update(loop_row, moe_dropped_frac=[h["moe_dropped_frac"] for h in hist],
               moe_distribute_frac=[h["moe_distribute_frac"] for h in hist])
    state = out["state"]
    check(int(state["step"]) == TRAIN_STEPS, "train: step counter")
    # The EMA of the loads moved off its uniform start in every block, and
    # still sums to one (each step adds 0.1 x shares that sum to one).
    E = cfg.moe.num_experts
    for key, ema in state["dyskew"].items():
        check(sorted(ema) == ["ema_loads"], f"train: dyskew {key} carries {sorted(ema)}")
        moved = (ema["ema_loads"] - 1.0 / E).abs().amax(dim=-1)
        check(bool((moved > 0).all()), f"train: dyskew {key} ema_loads still uniform in a block: {moved.tolist()}")
        sums = ema["ema_loads"].sum(dim=-1)
        check(bool(((sums - 1.0).abs() <= 1e-5).all()), f"train: dyskew {key} ema_loads sum to {sums.tolist()}")
        row.setdefault("ema_loads_max_move", {})[key] = float(moved.max())

    # ---- checkpoint round trip on the card ---------------------------- #
    # The whole train state: parameters (bf16, stored as raw bits), the
    # float32 AdamW moments, ``ema_loads`` and the step counter.
    where = tempfile.mkdtemp(dir=ROOT, prefix=".chip_smoke_ckpt_")
    try:
        mgr = CheckpointManager(where)
        disk_free = shutil.disk_usage(where).free
        t0 = time.perf_counter()
        mgr.save(TRAIN_STEPS, state, blocking=True)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = mgr.restore(state)
        restore_s = time.perf_counter() - t0
        pairs = tree_pairs(state, back)
        check(all(b.device == a.device and b.dtype == a.dtype and torch.equal(a, b) for _, a, b in pairs),
              "train: checkpoint round trip")
        row["checkpoint"] = {"leaves": len(pairs), "bytes": sum(a.numel() * a.element_size() for _, a, _ in pairs),
                             "save_s": save_s, "restore_s": restore_s, "disk_free_bytes": disk_free,
                             "equal": True}
    finally:
        shutil.rmtree(where, ignore_errors=True)
    del back, pairs

    if profile:
        from repro_torch.data.pipeline import DataPipeline
        from repro_torch.train.step import make_train_step

        step = make_train_step(model, opt_cfg)
        batch = next(DataPipeline(data_cfg, device=card))
        state, _ = step(state, batch)
        holder = [state]

        def one_step():
            holder[0], _ = step(holder[0], batch)
        profiled(torch, cfg.name, "train_step", 1, one_step)
        del holder
    del out, state
    torch.cuda.empty_cache()

    # ---- the reduced config: the same 4 steps on the card and the host -- #
    row["reduced"] = reduced_loop_card_host(torch, cfg, card)
    row["seconds"] = time.perf_counter() - t_start
    emit(row)
    return counts


# --------------------------------------------------------------------- #
# Phase 12: training the Mamba-2 families through the scan's backward
# --------------------------------------------------------------------- #

#: Step 1 of mamba2-1.3b in float32, the kernel scan against the plain one.
#: The plain path differentiates ``ssd_state_scan_ref`` by autograd, a
#: backward independent of the hand-written one.  Both forwards are the same
#: bits (the scan kernel equals the plain scan bit for bit, and the rest is
#: the same code), so is d_states (the backward kernel rounds as autograd
#: does), and the gradients differ by d_decay's order of summation, carried
#: through 48 layers.  A leaf's reading is ``band_ratio`` with rtol 0 and
#: atol MAMBA_GRAD_TOL of the plain gradient's largest element (granite's
#: step-1 band, ``TRAIN_GRAD_TOL``): 1 at the band's edge.  The control, a
#: backward that drops d_decay (the scan's decay detached), must read more
#: than 1: the decay's gradient is the only path from the scan to A_log,
#: dt_bias and w_dt.
MAMBA_GRAD_TOL = TRAIN_GRAD_TOL
#: The leaves the control must move outside the band.
DECAY_LEAVES = ("A_log", "dt_bias", "w_dt")


def grad_readings(torch, got, want):
    """``band_ratio`` of every leaf of ``got`` against ``want`` at rtol 0,
    atol MAMBA_GRAD_TOL of the leaf's largest |want|."""
    out = {}
    for key, a, b in tree_pairs(got, want):
        scale = float(b.float().abs().max())
        check(scale > 0, f"train_mamba step 1: {key} gradient is zero")
        out[key] = band_ratio(a, b, 0.0, MAMBA_GRAD_TOL * scale)
    return out


def mamba_step_one(torch, cfg, data_cfg, card):
    """Step 1 of ``cfg`` in float32 at full width and depth: the gradients
    through the scan kernels twice (bit-equal), through the plain scan, and
    through a control that drops the decay's gradient.  The weights are
    rescaled to the fan-in of their inputs (``at_input_fan_in``) and the
    decays drawn as Mamba-2 draws them (``mamba2_decay_init``), so that the
    chunk decays spread over (0, 1) and the scan carries state."""
    import dataclasses

    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.kernels.ssd_scan import ops as ssd_ops
    from repro_torch.models import transformer
    from repro_torch.models.layers.moe import KERNEL_OPS, PLAIN_OPS
    from repro_torch.models.model_api import build
    from repro_torch.train.step import batch_to, make_grad_fn

    model = build(dataclasses.replace(cfg, dtype="float32"))
    gen = torch.Generator(device=card).manual_seed(0)
    params = model.init(gen, device=card)
    at_input_fan_in(params)
    for j in transformer.mamba_layer_positions(cfg):
        mamba2_decay_init(torch, params["blocks"][f"l{j}"]["mamba"], gen)
    batch = batch_to(next(DataPipeline(data_cfg, device=card)), torch.device(card))

    runs = [make_grad_fn(model)(params, batch, None) for _ in range(2)]
    (loss_k, _, grads_k), (loss_k2, _, grads_k2) = runs
    del runs
    check(torch.equal(loss_k, loss_k2), "train_mamba step 1: two kernel runs give other losses")
    for key, a, b in tree_pairs(grads_k, grads_k2):
        check(torch.equal(a, b), f"train_mamba step 1: two kernel runs give other {key} gradients")
    del grads_k2
    loss_p, _, grads_p = make_grad_fn(model, ops=PLAIN_OPS)(params, batch, None)
    loss_rel = abs(float(loss_k) - float(loss_p)) / abs(float(loss_p))
    check(loss_rel <= TRAIN_LOSS_RTOL, f"train_mamba step 1: loss {float(loss_k)} against plain {float(loss_p)}")
    for key, a, _ in tree_pairs(grads_k, grads_p):
        check(bool(torch.isfinite(a).all()), f"train_mamba step 1: {key} gradient not finite")
    held = grad_readings(torch, grads_k, grads_p)
    check(max(held.values()) <= 1.0, f"train_mamba step 1: gradients outside the band: {held}")
    del grads_k

    def no_decay_grad(states, decay):
        return ssd_ops.state_scan(states, decay.detach())
    _, _, grads_c = make_grad_fn(model, ops=dataclasses.replace(KERNEL_OPS, scan=no_decay_grad))(
        params, batch, None)
    control = grad_readings(torch, grads_c, grads_p)
    moved = {k: v for k, v in control.items() if k.rsplit("/", 1)[-1] in DECAY_LEAVES}
    check(min(moved.values()) > 1.0, f"train_mamba step 1: the control stays inside the band: {moved}")
    decay = torch.exp(-torch.exp(params["blocks"]["l0"]["mamba"]["A_log"])
                      * torch.nn.functional.softplus(params["blocks"]["l0"]["mamba"]["dt_bias"]) * cfg.mamba.chunk)
    out = {"dtype": "float32", "weights": "at_input_fan_in, Mamba-2 decay init",
           "loss_kernel": float(loss_k), "loss_plain": float(loss_p), "loss_rel_diff": loss_rel,
           "loss_tol": TRAIN_LOSS_RTOL, "grad_tol": MAMBA_GRAD_TOL,
           "band_ratio_max": max(held.values()),
           "band_ratio_decay_leaves": {k: v for k, v in held.items() if k.rsplit("/", 1)[-1] in DECAY_LEAVES},
           "band_ratio_by_leaf": held,
           "control_drop_d_decay": {"band_ratio_decay_leaves": moved, "band_ratio_max": max(control.values())},
           "all_grads_bitwise_equal": True,
           "chunk_decay_at_bias": [float(decay.min()), float(decay.max())]}
    del params, batch, grads_p, grads_c
    torch.cuda.empty_cache()
    return out


def phase_train_mamba(torch, card="cuda", profile=False):
    """mamba2-1.3b at full width and depth: step 1 in float32 through the
    kernels against the plain scan, then TRAIN_STEPS bf16 steps through the
    loop (AdamW, remat), counted; then reduced mamba2-1.3b and reduced
    jamba-1.5-large-398b (Adafactor), card against host.  Returns the
    loop's launch counts."""
    from repro_torch.config.base import get_config
    from repro_torch.models import transformer
    from repro_torch.models.model_api import build
    from repro_torch.optim.optimizers import OptimizerConfig

    t_start = time.perf_counter()
    cfg = get_config(SSM_ARCH)
    model = build(cfg)
    data_cfg = train_data_config(cfg.vocab_size)
    opt_cfg = OptimizerConfig(name=cfg.optimizer, warmup_steps=1, total_steps=TRAIN_STEPS)
    n_mamba = len(transformer.mamba_layer_positions(cfg)) * transformer.num_blocks(cfg)
    row = {"phase": "train_mamba", "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "ssm_heads": cfg.mamba.num_heads(cfg.d_model), "d_state": cfg.mamba.d_state, "chunk": cfg.mamba.chunk,
           "dtype": cfg.dtype, "remat": cfg.remat, "optimizer": opt_cfg.name, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "steps": TRAIN_STEPS, "params": model.num_params()}
    t0 = time.perf_counter()
    row["step_one"] = mamba_step_one(torch, cfg, data_cfg, card)
    row["step_one"]["seconds"] = time.perf_counter() - t0

    # ---- 4 bf16 steps through the loop: the counted main path -------- #
    want = {"topk_gating": 0, "load_histogram": 0, "dispatch_gather": 0,
            "ssd_state_scan": 2 * n_mamba * TRAIN_STEPS, "ssd_state_scan_bwd": n_mamba * TRAIN_STEPS,
            "moe_combine": 0, "moe_combine_bwd": 0, "attention": 0}
    out, counts, loop_row = counted_loop(torch, cfg, data_cfg, opt_cfg, card, want)
    row.update(loop_row)
    state = out["state"]
    check(int(state["step"]) == TRAIN_STEPS, "train_mamba: step counter")
    if profile:
        from repro_torch.data.pipeline import DataPipeline
        from repro_torch.train.step import make_train_step

        step = make_train_step(model, opt_cfg)
        batch = next(DataPipeline(data_cfg, device=card))
        holder = [state]

        def one_step():
            holder[0], _ = step(holder[0], batch)
        one_step()
        profiled(torch, cfg.name, "train_step", 1, one_step)
        del holder
    del out, state
    torch.cuda.empty_cache()

    # ---- reduced mamba2 and jamba: 4 steps on the card and the host -- #
    row["reduced"] = [reduced_loop_card_host(torch, get_config(arch), card) for arch in (SSM_ARCH, HYBRID_ARCH)]
    row["seconds"] = time.perf_counter() - t_start
    emit(row)
    return counts


def counted_loop(torch, cfg, data_cfg, opt_cfg, card, want):
    """TRAIN_STEPS steps of ``cfg`` through ``train/loop.py::train`` with
    every launch counter at 0 before and read after, each kernel held to its
    count in ``want``.  Returns (the loop's output, the counts, the row's
    rates, memory and history)."""
    import math

    from repro_torch import kernels
    from repro_torch.train.loop import LoopConfig, train

    stamps = []

    def on_metrics(step, m):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = train(cfg, data_cfg, opt_cfg, LoopConfig(steps=TRAIN_STEPS, log_every=1), on_metrics=on_metrics,
                device=card)
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    check(set(counts) == set(want), f"train {cfg.name}: kernels {sorted(counts)}")
    for name, n in counts.items():
        check(n == want[name], f"train {cfg.name}: {name} launched {n} times, expected {want[name]}")
    check(len(hist) == TRAIN_STEPS and all(math.isfinite(h["loss"]) for h in hist),
          f"train {cfg.name}: a loss is not finite")
    steps_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    steady_ms = sum(steps_ms) / len(steps_ms)
    return out, counts, {
        "wall_s": wall, "ms_per_step": steady_ms, "ms_steps_2_to_4": steps_ms,
        "tokens_per_s": data_cfg.global_batch * data_cfg.seq_len / (steady_ms / 1e3), "peak_memory_bytes": peak,
        "loss": [h["loss"] for h in hist], "grad_norm": [h["grad_norm"] for h in hist],
        "lr": [h["lr"] for h in hist], "data_wait_ms": [h["data_wait_s"] * 1e3 for h in hist],
        "launches": counts, "launches_per_step": {k: v // TRAIN_STEPS for k, v in counts.items()},
    }


#: Reduced configs, 4 float32 steps on the card against the same on the
#: host: each step's loss within rtol 1e-5, the band of the CPU tests'
#: train steps against ``repro`` (two libraries' float32 products and sums
#: in another order; a dropped or wrong gradient moves step 2's loss of
#: these models by 1e-4 or more).
REDUCED_LOSS_RTOL = 1e-5


def reduced_loop_card_host(torch, cfg, card):
    """TRAIN_STEPS float32 steps of ``cfg`` reduced (its own optimizer) on
    the card and on the host, 8 x 128 tokens a step: the losses within
    REDUCED_LOSS_RTOL and, with MoE layers, the routing shares and the
    carried ``ema_loads`` equal."""
    import dataclasses

    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.loop import LoopConfig, train

    small = dataclasses.replace(cfg.reduced(), dtype="float32")
    small_data = train_data_config(small.vocab_size, seq=128)
    opt_cfg = OptimizerConfig(name=small.optimizer, warmup_steps=1, total_steps=TRAIN_STEPS)
    runs = {dev: train(small, small_data, opt_cfg, LoopConfig(steps=TRAIN_STEPS, log_every=1), device=dev)
            for dev in (card, HOST)}
    l_card, l_host = ([h["loss"] for h in runs[dev]["history"]] for dev in (card, HOST))
    rel = [abs(a - b) / abs(b) for a, b in zip(l_card, l_host)]
    check(max(rel) <= REDUCED_LOSS_RTOL, f"train {small.name} reduced: losses {l_card} against {l_host}")
    row = {
        "arch": small.name, "layers": small.num_layers, "d_model": small.d_model, "dtype": small.dtype,
        "optimizer": opt_cfg.name, "batch": TRAIN_BATCH, "seq": 128, "steps": TRAIN_STEPS,
        "loss_card": l_card, "loss_cpu": l_host, "loss_max_rel_diff": max(rel), "loss_rtol": REDUCED_LOSS_RTOL,
    }
    if small.moe is not None:
        h_card, h_host = ([h["moe_distribute_frac"] for h in runs[dev]["history"]] for dev in (card, HOST))
        s_card, s_host = runs[card]["state"]["dyskew"], runs[HOST]["state"]["dyskew"]
        check(h_card == h_host, f"train {small.name} reduced: moe_distribute_frac {h_card} against {h_host}")
        # The loads are whole numbers, the same picks on both sides, and the
        # EMA one elementwise float32 op at a time: the same bits.
        pairs = [(key, a.cpu(), b) for key, a, b in tree_pairs(s_card, s_host) if key.endswith("ema_loads")]
        check(len(pairs) > 0, f"train {small.name} reduced: no ema_loads carried")
        for key, a, b in pairs:
            check(torch.equal(a, b), f"train {small.name} reduced: dyskew {key}")
        row.update(experts=small.moe.num_experts, moe_distribute_frac=h_card, ema_loads_equal=True,
                   ema_loads_max_abs_diff=max(float((a - b).abs().max()) for _, a, b in pairs))
    return row


# --------------------------------------------------------------------- #
# Phase 13: token groups and data-parallel ranks
# --------------------------------------------------------------------- #

#: Token groups of the one-card checks (a): 8 × 1024 tokens, a group a
#: prompt.
RANKS_GROUPS = 8
#: Ranks sharing the one card over gloo (c), each with 2 × 1024 tokens of
#: every step's 8 × 1024, and the steps of each run.
RANKS_WORLD, RANKS_ROWS, RANKS_STEPS = 4, 2, 2
#: Depth of (c): granite at full width with 6 of its 24 layers, about 0.43 B
#: parameters in float32, so about 7 GB of parameters, AdamW moments and
#: gradients and 11 GB with activations a rank, 45 GB for four; all 24
#: layers would be about 88 GB.
RANKS_LAYERS = 6
#: Zipf exponent of the router skew (as the moe phase skews its layer).
RANKS_SKEW_ALPHA = 1.5
#: Seconds each wait on a rank of (c) may take: a process start, the kernel
#: build, two models' steps through gloo.
RANKS_TIMEOUT_S = 420
#: (c) against the one-process run at num_groups 4, in float32 on the card,
#: both with the block matrices rescaled to the fan-in of their inputs
#: (``at_input_fan_in``: at ``repro``'s init the backward of six full-width
#: layers grows the blocks' gradients three orders of magnitude above the
#: head's, and the two runs' gradient norms part by more than 10 % on
#: rounding alone, with the plain path and without remat too).  The
#: ranks' forwards multiply 2 × 1024 rows where the one process multiplies
#: 8 × 1024, so cuBLAS rounds the router's logits otherwise and a near-tied
#: pick may flip, moving one token's output; each rank's gradient is its
#: share, summed over the ranks in float32.  Losses and ``grad_norm`` within
#: rtol 1e-3 (summing nothing, or to the wrong scale, moves ``grad_norm`` by
#: a factor of 2 to 4); ``ema_loads`` within EMA_RTOL; a parameter after
#: the AdamW step within 1e-5 of its leaf's largest |p|, except where
#: AdamW's normalised step m / sqrt(v) follows a gradient at rounding or
#: moved by a flipped pick (then by at most one step of each sign, 2 · lr):
#: such elements at most 1 % of a leaf.  Against each other the ranks are
#: held EQUAL (their all_reduce gives every rank the same bits), and one
#: NCCL rank to no group EQUAL in (b).
RANKS_LOSS_RTOL = 1e-3
RANKS_PARAM_TOL = 1e-5
RANKS_NOISE_SHARE = 0.01
#: ``ema_loads`` of ranks against one process.  A step moves the EMA by 0.1
#: times the change of each expert's share of the picks, so n steps leave it
#: within (1 - 0.9 ** n) times the largest share of the picks a step moved.
#: Where the ranks keep one process's picks (data-parallel (c), the
#: experts-only layout) the EMA is held at the CPU tests' EMA_RTOL of its
#: largest element; where near-tied picks flip (the reference layout, FSDP)
#: at EMA_PICK_SHARE of the picks moved a step.  The reference layout read
#: 4.8e-5 of the largest element (PERF.md §6); an EMA that missed a step,
#: or a rank's own loads in place of the summed ones, lies further off.
EMA_RTOL = 1e-6
EMA_PICK_SHARE = 1e-3
#: A rank's allocator, set before its first allocation: ranks share the
#: card, and segments that grow in place leave less of it reserved and
#: unused (without it, the whole script ran out of memory in (c) on an
#: NVIDIA H100 80GB HBM3 with 1.26 GiB of a rank's reserved but unallocated).
EXPANDABLE = "expandable_segments:True"


def ranks_config(layers=None):
    import dataclasses

    from repro_torch.config.base import get_config

    cfg = get_config(MOE_ARCH)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers, dtype="float32")
    return cfg


def skew_router(torch, params, alpha=RANKS_SKEW_ALPHA):
    """Every MoE layer's router biased by a Zipf(``alpha``) profile over the
    experts, as the moe phase biases its one layer, in place."""
    import numpy as np

    router = params["blocks"]["l0"]["moe"]["router"]           # (blocks, d, E)
    E = router.shape[-1]
    probs = 1.0 / np.arange(1, E + 1) ** alpha
    bias = np.log(probs / probs.sum())
    router.add_(torch.tensor((bias - bias.mean()) * 0.5, dtype=router.dtype, device=router.device))


def counted(torch, fn):
    """``fn()`` with every launch counter at 0 before; (its result, the
    counts after)."""
    from repro_torch import kernels

    kernels.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, kernels.launch_counts()


def moe_counts_are(counts, n, where):
    for name in ("topk_gating", "load_histogram", "dispatch_gather"):
        check(counts[name] == n, f"{where}: {name} launched {counts[name]} times, expected {n}")


def step_collectives(cfg, groups, params, tokens, data=1, model=None):
    """(kind, group size, bytes) of each collective one plain train step
    issues, in order, on a rank with ``data`` data ranks and a model group
    of ``model`` ranks (None: no model group), ``params`` its own leaves,
    ``tokens`` its tokens: per MoE layer the counts' and mean
    probabilities' all_reduce over the data group, and with a model group
    the all-gather of the expert outputs; the loss's sum and count; each
    layer's again in the recompute, with a model group followed by
    ``to_shard``'s all_reduce of the tokens' gradient; one float32 sum a
    parameter leaf; with a model group of more than one rank the global
    norm's all_reduce of the expert leaves' sums of squares (the
    experts-only layout: ``param.expert_rules``)."""
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models.layers.moe import capacities

    E, d = cfg.moe.num_experts, cfg.d_model
    item = 2 if cfg.dtype == "bfloat16" else 4
    Gl = groups // data
    counts = ("all-reduce", data, 4 * (groups * E + E))
    fwd = [counts]
    if model is not None:
        fwd.append(("all-gather", model, Gl * E * capacities(cfg, tokens // Gl)[1] * d * item))
    bwd = (fwd if cfg.remat else []) + ([("all-reduce", model, tokens * d * item)] if model is not None else [])
    n = n_moe_layers(cfg)
    leaves = flatten_with_paths(params)
    out = fwd * n + [("all-reduce", data, 8)] + bwd * n + [("all-reduce", data, 4 * p.numel()) for _, p in leaves]
    if model is not None and model > 1:
        out.append(("all-reduce", model, 4 * sum(1 for k, _ in leaves if k.rsplit("/", 1)[-1] in EXPERT_LEAVES)))
    return out


def records_of(counter_result):
    return [(c["kind"], c["group"], c["bytes"]) for c in counter_result["collectives"]]


def ranks_batches(torch, cfg):
    """RANKS_STEPS global batches of RANKS_WORLD · RANKS_ROWS × TRAIN_SEQ
    tokens on the host, from a seed."""
    gen = torch.Generator().manual_seed(1)
    shape = (RANKS_WORLD * RANKS_ROWS, TRAIN_SEQ)
    return [{key: torch.randint(0, cfg.vocab_size, shape, generator=gen, dtype=torch.int32)
             for key in ("tokens", "targets")} for _ in range(RANKS_STEPS)]


def ranks_rank(rank, world, init_method, reference, backend):
    """Rank ``rank`` of (c): the granite cut to RANKS_LAYERS, over gloo on
    the one card or over NCCL on card ``rank``, its rows of each step:
    RANKS_STEPS plain steps (the first under the op counter), then
    RANKS_STEPS with compressed reduction from the same start.  Rank 0 also
    holds its parameters to the one-process run's, read from
    ``reference``."""
    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.models.layers.moe import SpmdCtx
    from repro_torch.models.model_api import build
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.roofline.analysis import analyze, model_flops_estimate
    from repro_torch.roofline.op_cost import OpCounter
    from repro_torch.train.step import StepConfig, make_train_step, train_state_init

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The machine's cores shared among the ranks (gloo's host staging and
    # the launches).
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = EXPANDABLE
    card = torch.device("cuda", rank if backend == "nccl" else 0)
    mesh = init_ranks(rank, world, device=card, init_method=init_method, backend=backend)
    try:
        cfg = ranks_config(RANKS_LAYERS)
        model = build(cfg)
        opt_cfg = OptimizerConfig(name=cfg.optimizer, warmup_steps=1, total_steps=TRAIN_STEPS)
        ctx = SpmdCtx(num_groups=world, group=mesh.group)
        rows = slice(rank * RANKS_ROWS, (rank + 1) * RANKS_ROWS)
        batches = [{k: v[rows] for k, v in b.items()} for b in ranks_batches(torch, cfg)]
        out = {}
        kernels.reset_launch_counts()
        for name, compress in (("plain", False), ("compressed", True)):
            state = train_state_init(model, opt_cfg, torch.Generator(device="cuda").manual_seed(0), ctx, card)
            at_input_fan_in(state["params"])
            step = make_train_step(model, opt_cfg, StepConfig(grad_compression=compress), ctx)
            run = {"loss": [], "grad_norm": [], "ms": []}
            for i, batch in enumerate(batches):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if i == 0 and not compress:
                    with OpCounter() as counter:
                        state, m = step(state, batch)
                else:
                    state, m = step(state, batch)
                torch.cuda.synchronize()
                run["ms"].append((time.perf_counter() - t0) * 1e3)
                run["loss"].append(float(m["loss"]))
                run["grad_norm"].append(float(m["grad_norm"]))
            run["dyskew"] = {k: v.cpu().numpy() for k, v in flatten_with_paths(state["dyskew"])}
            run["param_sums"] = {k: float(p.double().sum()) for k, p in flatten_with_paths(state["params"])}
            if compress:
                run["residual_abs_max"] = max(float(r.abs().max()) for _, r in flatten_with_paths(state["grad_residual"]))
            elif rank == 0:
                run["against_one_process"] = ranks_param_gaps(torch, state["params"], reference, m["lr"])
            out[name] = run
            del state, step
            torch.cuda.empty_cache()
        res = counter.result()
        issued = step_collectives(cfg, world, model.abstract_params(), RANKS_ROWS * TRAIN_SEQ, data=world)
        tokens = RANKS_WORLD * RANKS_ROWS * TRAIN_SEQ
        terms = analyze(dict(res, flops=res["flops"] * world, bytes=res["bytes"] * world), world,
                        model_flops_estimate(cfg.active_param_count(), tokens, "train"))
        out["collectives"] = {"records": len(res["collectives"]), "got": records_of(res), "issued": issued,
                              "t_collective_s": terms.t_collective, "t_compute_s": terms.t_compute,
                              "t_memory_s": terms.t_memory, "collective_bytes_global": terms.collective_bytes_global,
                              "by_kind": terms.by_kind}
        out["launches"] = kernels.launch_counts()
        out["peak_memory_bytes"] = torch.cuda.max_memory_allocated(card)
        return out
    finally:
        dist.destroy_process_group()


def ranks_param_gaps(torch, params, reference, lr):
    """Each leaf against the one-process run's: the largest |Δ| over the
    leaf's largest |p|, and the share of elements off by more than
    RANKS_PARAM_TOL of it (each within 2 · lr, one AdamW step of each
    sign)."""
    from repro_torch.checkpoint.manager import flatten_with_paths

    want = torch.load(reference, map_location="cpu")
    gaps = {}
    # On the host, leaf by leaf: four ranks already fill the card.
    for key, p in flatten_with_paths(params):
        ref = want[key]
        diff = (p.cpu() - ref).abs()
        scale = float(ref.abs().max())
        gaps[key] = {"max_rel": float(diff.max()) / scale, "max_over_lr": float(diff.max()) / float(lr),
                     "share_off": float((diff > RANKS_PARAM_TOL * scale).float().mean())}
    return gaps


def ranks_groups_on_the_card(torch, card):
    """(a): the full granite prefill (8 × 1024) and one train step at
    RANKS_GROUPS token groups on a skewed router, each MoE kernel once a
    layer as at one group, the kernel path against PLAIN_OPS, and G 1
    against G 8 apart.  Returns (row, the main path's counts)."""
    import dataclasses

    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.models import transformer
    from repro_torch.models.layers.moe import SpmdCtx
    from repro_torch.models.model_api import build
    from repro_torch.train.step import batch_to, make_decode_step, make_grad_fn, make_prefill_step

    served = served_model(torch, MOE_ARCH)
    model, ctx1, params, inputs, prefill1, _ = served
    cfg = model.cfg
    skew_router(torch, params)
    ctx8 = SpmdCtx(num_groups=RANKS_GROUPS, num_ep_shards=EP_SHARDS)
    served8 = (model, ctx8, params, inputs, make_prefill_step(model, ctx8), make_decode_step(model, ctx8))
    n_moe = n_moe_layers(cfg)
    B, prompt = inputs["tokens"].shape
    row = {"groups": RANKS_GROUPS, "tokens": B * prompt, "moe_layers": n_moe, "skew_alpha": RANKS_SKEW_ALPHA}
    main = {}
    for name, ctx, prefill in (("g1", ctx1, prefill1), ("g8", ctx8, served8[4])):
        state = model.decode_state_init(B, prompt)
        _, got = counted(torch, lambda: prefill(params, state, inputs))
        moe_counts_are(got, n_moe, f"ranks (a) prefill {name}")
        row[f"prefill_launches_{name}"] = got
        if name == "g8":
            main = dict(got)
        del state
    # G 1 and G 8 must route differently on this router.
    dk = model.dyskew_init(ctx1)
    fwd = {name: transformer.forward(params, inputs["tokens"], cfg=cfg, ctx=ctx, dyskew=dk)
           for name, ctx in (("g1", ctx1), ("g8", ctx8))}
    gap = float((fwd["g1"][0].float() - fwd["g8"][0].float()).abs().max())
    row["dropped_frac"] = {n: float(f[1]["metrics"]["moe_dropped_frac"]) for n, f in fwd.items()}
    row["logit_gap_g1_g8"] = gap
    check(gap > 0 and row["dropped_frac"]["g1"] != row["dropped_frac"]["g8"],
          f"ranks (a): G 1 and G 8 route alike on the skewed router ({row['dropped_frac']}, gap {gap})")
    del fwd
    row["kernel_path"] = groups_path_check(torch, served8)

    # One train step at G 8 (bf16, remat): twice the layers' launches.
    data_cfg = train_data_config(cfg.vocab_size)
    batch = batch_to(next(DataPipeline(data_cfg, device=card)), torch.device(card))
    for name, ctx in (("g1", ctx1), ("g8", ctx8)):
        dyskew = model.dyskew_init(ctx, device=card)
        with torch.enable_grad():
            _, got = counted(torch, lambda: make_grad_fn(model, ctx)(params, batch, dyskew))
        moe_counts_are(got, 2 * n_moe, f"ranks (a) train step {name}")
        row[f"train_launches_{name}"] = got
        if name == "g8":
            main = {k: main[k] + got[k] for k in main}
    del served, served8, params, batch
    torch.cuda.empty_cache()
    with torch.enable_grad():
        row["train_step_one"] = step_one_checks(torch, build(dataclasses.replace(cfg, dtype="float32")), data_cfg,
                                                card, ctx=ctx8, prepare=lambda p: skew_router(torch, p))
    return row, main


def groups_path_check(torch, served):
    """The prompt's forward through the kernels and through the plain
    versions from the same carried ``ema_loads``, the plain gating replaying
    the kernel's picks and weights (``PickLog``), so that both forwards are
    the same bits through all the layers: logits, every layer's ``ema_loads``
    and the metrics equal, the last layer's picks, counts, plan and buffer
    equal; the kernel's gate weights against the plain ones from the same
    logits at the gating check's band (rtol 1e-5, atol 1e-6 of weights at
    most 1), and the rows where the plain version would pick otherwise
    counted."""
    import dataclasses

    from repro_torch.models import transformer
    from repro_torch.models.layers import moe

    model, ctx, params, inputs, _, _ = served
    cfg = model.cfg
    dk = model.dyskew_init(ctx)
    picks = PickLog()
    kern = Recorder(dataclasses.replace(moe.KERNEL_OPS, gating=picks.record))
    plain = Recorder(dataclasses.replace(moe.PLAIN_OPS, gating=picks.replay))
    logits_k, aux_k = transformer.forward(params, inputs["tokens"], cfg=cfg, ctx=ctx, dyskew=dk, ops=kern.ops)
    logits_p, aux_p = transformer.forward(params, inputs["tokens"], cfg=cfg, ctx=ctx, dyskew=dk, ops=plain.ops)
    torch.cuda.synchronize()
    where = f"{cfg.name} at G {ctx.num_groups}, kernel path"
    check(torch.equal(logits_k, logits_p), f"{where}: logits")
    for key, a, b in tree_pairs(aux_k["dyskew"], aux_p["dyskew"]):
        check(torch.equal(a, b), f"{where}: {key}")
    compare_dispatch(torch, kern, plain, aux_k["dyskew"]["l0"]["ema_loads"], aux_p["dyskew"]["l0"]["ema_loads"],
                     aux_k["metrics"], aux_p["metrics"], where)
    check(picks.replayed == len(picks.calls), f"{where}: gating calls")
    check(picks.w_gap <= 1e-5 + 1e-6, f"{where}: gate weights {picks.w_gap} off the plain ones")
    (_, _, valid), _ = kern.last["dispatch"]
    return {"layers": picks.replayed, "slots": int(valid.numel()), "valid_frac": float(valid.float().mean()),
            "logits_equal": True, "ema_loads_equal": True, "plan_equal": True, "buffer_equal": True,
            "gate_weight_max_abs_err": picks.w_gap, "plain_pick_flips": picks.flips}


def ranks_nccl_one_rank(torch, card):
    """(b): RANKS_STEPS full granite steps through ``launch/train.py``'s
    path on a real NCCL group of one rank, under the op counter, against the
    same steps with no group: losses and parameters the same bits.  Returns
    (row, the main path's counts)."""
    import tempfile

    from repro_torch.launch.train import train_ranks
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.roofline.op_cost import OpCounter
    from repro_torch.train.loop import LoopConfig, train

    cfg = ranks_config()
    data_cfg = train_data_config(cfg.vocab_size)
    opt_cfg = OptimizerConfig(name=cfg.optimizer, warmup_steps=1, total_steps=TRAIN_STEPS)
    loop_cfg = LoopConfig(steps=RANKS_STEPS, log_every=1)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as tmp:
        t0 = time.perf_counter()
        with OpCounter() as counter:
            grouped, got = counted(torch, lambda: train_ranks(0, 1, cfg, data_cfg, opt_cfg, loop_cfg,
                                                              init_method="file://" + os.path.join(tmp, "store"),
                                                              device=card))
        group_s = time.perf_counter() - t0
    moe_counts_are(got, 2 * RANKS_STEPS * n_moe_layers(cfg), "ranks (b) NCCL")
    records = counter.result()["collectives"]
    del counter
    t0 = time.perf_counter()
    alone = train(cfg, data_cfg, opt_cfg, loop_cfg, device=card)
    alone_s = time.perf_counter() - t0
    pairs = tree_pairs(grouped["state"], alone["state"])
    losses = [[h["loss"] for h in r["history"]] for r in (grouped, alone)]
    check(losses[0] == losses[1], f"ranks (b): losses {losses[0]} with one NCCL rank, {losses[1]} alone")
    differ = [k for k, a, b in pairs if not torch.equal(a, b)]
    check(not differ, f"ranks (b): one NCCL rank and no group differ in {differ[:5]}")
    # The loop's mesh has a model group of one rank: its records are the
    # model group's beside the data group's.
    issued = step_collectives(cfg, 1, grouped["state"]["params"], TRAIN_BATCH * TRAIN_SEQ, model=1) * RANKS_STEPS
    seen = [(c["kind"], c["group"], c["bytes"]) for c in records]
    check(seen == issued, f"ranks (b): {len(seen)} collective records against {len(issued)} issued")
    row = {"backend": "nccl", "world": 1, "steps": RANKS_STEPS, "loss": losses[0], "state_leaves": len(pairs),
           "equal_to_no_group": True, "collective_records": len(records), "kinds": sorted({g[:2] for g in seen}),
           "collective_bytes": sum(b for _, _, b in seen),
           "records_equal_issued": True, "seconds_with_group": group_s, "seconds_alone": alone_s}
    del grouped, alone, pairs
    torch.cuda.empty_cache()
    return row, got


def n_moe_layers(cfg):
    from repro_torch.models import transformer

    return len(transformer.moe_layer_positions(cfg)) * transformer.num_blocks(cfg)


def ranks_one_process(torch, card, path):
    """(c)'s yardstick: the same steps in one process at num_groups
    RANKS_WORLD on the global batch; its parameters saved to ``path``."""
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models.layers.moe import SpmdCtx
    from repro_torch.models.model_api import build
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.train.step import make_train_step, train_state_init

    cfg = ranks_config(RANKS_LAYERS)
    model = build(cfg)
    opt_cfg = OptimizerConfig(name=cfg.optimizer, warmup_steps=1, total_steps=TRAIN_STEPS)
    ctx = SpmdCtx(num_groups=RANKS_WORLD)
    state = train_state_init(model, opt_cfg, torch.Generator(device="cuda").manual_seed(0), ctx, card)
    at_input_fan_in(state["params"])
    step = make_train_step(model, opt_cfg, ctx=ctx)
    out = {"loss": [], "grad_norm": [], "ms": []}
    for batch in ranks_batches(torch, cfg):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
    out["dyskew"] = {k: v.cpu().numpy() for k, v in flatten_with_paths(state["dyskew"])}
    out["params"] = model.num_params()
    torch.save({k: v.cpu() for k, v in flatten_with_paths(state["params"])}, path)
    del state, step
    torch.cuda.empty_cache()
    return out


def ranks_spawn(reference, where, backend):
    """RANKS_WORLD processes of ``ranks_rank`` over ``backend`` (a FileStore
    in ``where``); their results in rank order and the seconds from the
    first start to the last exit."""
    from repro_torch.launch.mesh import run_ranks

    t0 = time.perf_counter()
    rows = run_ranks(ranks_rank, RANKS_WORLD, reference, backend, timeout=RANKS_TIMEOUT_S, store_dir=where)
    return rows, time.perf_counter() - t0


def ema_gap_check(one, got, steps, picks_kept, where):
    """The largest gap of ``got``'s ``ema_loads`` leaves (numpy, by key) to
    ``one``'s, over the largest |EMA|, checked against EMA_RTOL where the
    ranks keep one process's picks and against the pick-share bound where
    they do not; returns the gap."""
    import numpy as np

    check(sorted(got) == sorted(one) and all(k.endswith("ema_loads") for k in one),
          f"{where}: dyskew leaves {sorted(got)} against one process's {sorted(one)}")
    gap, abs_gap = 0.0, 0.0
    for key, a in one.items():
        d = float(np.abs(a - got[key]).max())
        gap, abs_gap = max(gap, d / max(float(np.abs(a).max()), 1e-30)), max(abs_gap, d)
    if picks_kept:
        check(gap <= EMA_RTOL, f"{where}: ema_loads {gap} of the largest off one process's")
    else:
        limit = (1.0 - 0.9 ** steps) * EMA_PICK_SHARE
        check(abs_gap <= limit, f"{where}: ema_loads {abs_gap} off one process's, beyond {limit}")
    return gap


def ranks_check(torch, one, rows, backend):
    """(c)'s checks of one run of the ranks against each other and against
    the one-process run; returns (row, roofline row, the ranks' summed
    counts)."""
    import numpy as np

    cfg = ranks_config(RANKS_LAYERS)
    n_moe = n_moe_layers(cfg)
    where = f"ranks (c) {backend}"
    for name in ("plain", "compressed"):
        for key, a in rows[0][name]["dyskew"].items():
            check(all(np.array_equal(r[name]["dyskew"][key], a) for r in rows[1:]),
                  f"{where} {name}: {key} differs between ranks")
        check(all(r[name]["param_sums"] == rows[0][name]["param_sums"] for r in rows[1:]),
              f"{where} {name}: the ranks' parameters differ")
        check(all(r[name]["loss"] == rows[0][name]["loss"] for r in rows[1:]), f"{where} {name}: losses differ")
        check(all(np.isfinite(rows[0][name]["loss"])), f"{where} {name}: a loss is not finite")
    plain = rows[0]["plain"]
    for key in ("loss", "grad_norm"):
        rel = max(abs(a - b) / abs(b) for a, b in zip(plain[key], one[key]))
        check(rel <= RANKS_LOSS_RTOL, f"{where}: {key} {plain[key]} against one process {one[key]}")
    ema_gap = ema_gap_check(one["dyskew"], plain["dyskew"], len(plain["loss"]), True, where)
    gaps = plain["against_one_process"]
    for key, g in gaps.items():
        check(g["max_rel"] <= RANKS_PARAM_TOL or (g["max_over_lr"] <= 2.0 and g["share_off"] <= RANKS_NOISE_SHARE),
              f"{where}: parameter {key} against one process: {g}")
    check(rows[0]["compressed"]["loss"][0] == plain["loss"][0], f"{where}: compressed step 1 loss")
    check(all(r["compressed"]["residual_abs_max"] > 0 for r in rows), f"{where}: no error-feedback residual")
    coll = rows[0]["collectives"]
    check(coll["got"] == coll["issued"], f"{where}: {coll['records']} collective records against "
          f"{len(coll['issued'])} issued")
    check(coll["t_collective_s"] > 0, f"{where}: t_collective is 0")
    for r in rows:
        moe_counts_are(r["launches"], 2 * 2 * RANKS_STEPS * n_moe, f"{where}: a rank")
    row = {
        "backend": backend, "world": RANKS_WORLD,
        "cards": "one card, shared by the ranks" if backend == "gloo" else "one card a rank",
        "rank_ms_per_step": {name: [r[name]["ms"] for r in rows] for name in ("plain", "compressed")},
        "loss": {name: rows[0][name]["loss"] for name in ("plain", "compressed")},
        "grad_norm": {name: rows[0][name]["grad_norm"] for name in ("plain", "compressed")},
        "ema_loads_equal_across_ranks": True, "ema_loads_gap_to_one_process": ema_gap,
        "param_max_rel_gap": max(g["max_rel"] for g in gaps.values()),
        "param_max_gap_over_lr": max(g["max_over_lr"] for g in gaps.values()),
        "param_share_off_max": max(g["share_off"] for g in gaps.values()),
        "peak_memory_bytes": [r["peak_memory_bytes"] for r in rows],
    }
    if backend == "gloo":
        row["timed_note"] = "gloo stages every all_reduce through the host: these are not NCCL's times"
    roofline = {"phase": "roofline_step", "step": f"{MOE_ARCH} {RANKS_LAYERS} layers, data-parallel train step, "
                f"rank 0 of {RANKS_WORLD} ({backend})", "collective_records": coll["records"],
                "collective_bytes_per_rank": sum(b for _, _, b in coll["got"]),
                "collective_bytes_global": coll["collective_bytes_global"], "collective_by_kind": coll["by_kind"],
                "t_collective_s": coll["t_collective_s"], "t_compute_s": coll["t_compute_s"],
                "t_memory_s": coll["t_memory_s"], "records_equal_issued": True}
    summed = {k: sum(r["launches"][k] for r in rows) for k in rows[0]["launches"]}
    return row, roofline, summed


def ranks_on_cards(torch, card):
    """(c): RANKS_WORLD ranks of the cut granite sharing the card over gloo,
    and over NCCL with a card a rank where the machine has RANKS_WORLD
    cards, each held to the one-process run at num_groups RANKS_WORLD.
    Returns (row, roofline rows, the ranks' summed counts)."""
    import shutil
    import tempfile

    where = tempfile.mkdtemp(dir=ROOT, prefix=".chip_smoke_ranks_")
    try:
        reference = os.path.join(where, "one_process.pt")
        t0 = time.perf_counter()
        one = ranks_one_process(torch, card, reference)
        row = {"layers": RANKS_LAYERS, "layers_of": ranks_config().num_layers, "params": one["params"],
               "dtype": ranks_config(RANKS_LAYERS).dtype, "tokens_per_step": RANKS_WORLD * RANKS_ROWS * TRAIN_SEQ,
               "steps": RANKS_STEPS, "one_process": {k: one[k] for k in ("loss", "grad_norm", "ms")},
               "one_process_seconds": time.perf_counter() - t0}
        backends = ["gloo"]
        if torch.cuda.device_count() >= RANKS_WORLD:
            backends.append("nccl")
        else:
            row["nccl"] = f"not run: {torch.cuda.device_count()} card(s), NCCL takes one a rank"
        rooflines, summed = [], {}
        for backend in backends:
            rows, seconds = ranks_spawn(reference, where, backend)
            row[backend], roofline, got = ranks_check(torch, one, rows, backend)
            row[backend]["seconds"] = seconds
            rooflines.append(roofline)
            summed = {k: summed.get(k, 0) + got[k] for k in got}
    finally:
        shutil.rmtree(where, ignore_errors=True)
    return row, rooflines, summed


def phase_ranks(torch, card="cuda"):
    """Token groups on the card (a), a one-rank NCCL group through the
    launcher (b), four gloo ranks sharing the card (c), and their
    collectives counted (d).  Returns the main path's launch counts and
    (b)'s row."""
    t_start = time.perf_counter()
    row = {"phase": "ranks"}
    with torch.no_grad():
        row["groups"], counts = ranks_groups_on_the_card(torch, card)
    row["nccl_one_rank"], got = ranks_nccl_one_rank(torch, card)
    counts = {k: counts.get(k, 0) + got[k] for k in got}
    # The four ranks need the card to themselves, less this process.  The
    # cuBLAS workspaces (32 MiB a handle, in the caching allocator) sit in
    # blocks split from the earlier phases' large segments and would keep
    # most of them reserved, too much for four ranks beside this process:
    # freed first, they let ``empty_cache`` give the segments back.
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    row["main_process_bytes"] = {"allocated": torch.cuda.memory_allocated(), "reserved": torch.cuda.memory_reserved(),
                                 "card_free": free, "card_total": total}
    emit({"phase": "ranks_spawn_memory", **row["main_process_bytes"]})
    row["data_parallel"], rooflines, got = ranks_on_cards(torch, card)
    counts = {k: counts[k] + got[k] for k in counts}
    for roofline in rooflines:
        emit(roofline)
    row["launches"] = counts
    row["seconds"] = time.perf_counter() - t_start
    emit(row)
    return counts, row["nccl_one_rank"]


# --------------------------------------------------------------------- #
# Phase 13b: the model axis
# --------------------------------------------------------------------- #

#: (b): the ranks of a (data 1, model EP_MODEL) mesh, sharing the one card
#: over gloo.  Under the reference's layout less FSDP (``param.model_rules``) a rank
#: holds a quarter of granite's experts, attention heads and vocabulary, of
#: starcoder2-3b's query heads (its 2 kv heads stay whole: a rank uses the
#: one its query heads read) and ffn, of mamba2-1.3b's heads.
EP_MODEL = 4
#: Seconds each wait on a rank of (b) may take: a process start, the kernel
#: build, three served models, two trained ones, all through gloo's host
#: staging.
EP_TIMEOUT_S = 900
#: (b)'s train depth is reckoned from these before the run.  A rank's
#: peak is the larger of two: at the update a float32 parameter costs 32 B
#: (itself, its gradient, the clipped gradient, AdamW's two moments, and
#: the new parameter and moments while the old are alive); in the
#: backward 14 B a parameter beside EP_ACTIVATION_BYTES, the activations
#: of all 8 × 1024 tokens (every rank of a model group holds its rows).
#: The backward's two constants fit a rank's peaks at 7 and 12 layers of
#: the experts-only layout, 11,013,041,664 and 12,125,836,800 B on an NVIDIA H100
#: 80GB HBM3 (PERF.md §6).  The depth is the most layers whose EP_MODEL
#: ranks fit in EP_CARD_SHARE of the free card (the rest: the allocator's
#: slack, five CUDA contexts, this process), and at least EP_MIN_LAYERS.
EP_UPDATE_BYTES_PER_PARAM = 32
EP_BACKWARD_BYTES_PER_PARAM = 14
EP_ACTIVATION_BYTES = 8 * 10 ** 9
EP_CARD_SHARE = 0.85
EP_MIN_LAYERS = 6
#: The most layers (b) trains: 24 fit, but a float32 step at 24 layers took
#: 45.5-57.6 s a rank through gloo (PERF.md §6), and with the fsdp
#: phase the script would near its time limit, so the depth is cut.
EP_MAX_LAYERS = 8
#: The experts-only layout (``param.expert_rules``), kept as an
#: earlier path at this depth, to keep the script's time: served with the
#: default combine (held to one process bit for bit) and trained.
EP_EXPERT_LAYERS = 2
#: The served models of (b) besides granite, at full width and depth: the
#: ``mlp`` rule with the kv-head fallback, and ``ssm_heads``; their decode
#: steps (fewer than granite's 32, to keep the script's time: a step is
#: about a hundred small gloo collectives on the ranks).
EP_DENSE_ARCHS = ("starcoder2-3b", SSM_ARCH)
EP_DENSE_DECODE_STEPS = 8
#: The served comparisons (bf16), ranks against one process fed the same
#: tokens.  A row-sharded product adds four bf16 partial sums where one
#: process adds one, and cuBLAS picks its kernel by the shapes, so a layer's
#: output may move by bf16's rounding; on the random granite a flipped
#: top-8 pick moves a token's whole MoE output, and both cascade through
#: the later layers (granite's full-depth logits lay 47 times the
#: EP_SERVE_* band off one process's, with 35 of 264 greedy flips away from
#: a near tie, and mamba2's 3.6 times, on an NVIDIA H100 80GB HBM3:
#: PERF.md §6).  So each layer is held with no cascade: fed one
#: process's output of the layer before (``layer_outputs``, on LAYER_PROMPTS
#: of the prompts, the MoE layers through H9), its output within
#: LAYER_TOL of |x| and of the largest |x| (four bf16 roundings, 2^-6:
#: a row-sharded product adds four partial sums, each rounded once; at two,
#: 2^-7, granite's layers read 1.17 of the band: PERF.md §6), a MoE
#: layer's rows where the rank's router picks other
#: experts than one process's excepted, each such row a near tie of one
#: process's router logits (its k-th and (k+1)-th within twice that band);
#: the embedding's output EQUAL.  The full-depth logits against one
#: process's (``EP_SERVE_ATOL · max|logits|`` + ``EP_SERVE_RTOL · |logit|``,
#: greedy flips at near ties) are a reading.  Between the ranks, and
#: between two H9 prefills, EQUAL; under the experts-only layout the default combine
#: bit for bit.
LAYER_TOL = 2.0 ** -6
LAYER_PROMPTS = 2
#: The float32 train steps under the reference's layout, a rank against one
#: process: losses and ``grad_norm`` within RANKS_LOSS_RTOL, ``ema_loads``
#: within EMA_PICK_SHARE's bound, and each parameter within 2 · lr (one AdamW step of each sign).
#: Every gradient there comes from products of other shapes than one
#: process's (a rank's heads, ffn columns and vocabulary rows), whose
#: float32 sums cuBLAS orders otherwise, and a near-tied pick that flips in
#: one of the 24 layers moves a token's path through the backward:
#: ``wk``'s AdamW first moment lay 1.26 % of its largest element off one
#: process's, and the experts-only layout's rule for the parameters (within
#: RANKS_PARAM_TOL of the largest |p| but for 1 % of a leaf) read 20.7 % of
#: ``wk`` beyond it, all within 1.29 · lr (PERF.md §6).  So the parameters'
#: share beyond RANKS_PARAM_TOL is a reading here; the experts-only layout
#: keeps that rule.
EP_SERVE_RTOL = 2e-2
EP_SERVE_ATOL = 2e-2


def ep_rank_params(cfg, rules, model=EP_MODEL, mesh=None):
    """The parameters a rank of a model axis of ``model`` (or of ``mesh``)
    holds under ``rules``, reckoned from the specs."""
    import math

    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models.model_api import build
    from repro_torch.models.param import local_shape

    mesh = {"model": model} if mesh is None else mesh
    return sum(math.prod(local_shape(p, mesh, rules)) for _, p in flatten_with_paths(build(cfg).specs()))


def ep_train_layers(torch, free):
    """(b)'s train depth under the reference's layout, reckoned from the
    parameters a rank holds at each depth (see EP_UPDATE_BYTES_PER_PARAM);
    (layers, the reckoning)."""
    import dataclasses

    from repro_torch.models.param import model_rules

    cfg = ranks_config()
    budget = EP_CARD_SHARE * free / EP_MODEL
    table = {}
    for layers in range(1, cfg.num_layers + 1):
        held = ep_rank_params(dataclasses.replace(cfg, num_layers=layers), model_rules())
        table[layers] = {"params_a_rank": held, "bytes_a_rank": max(
            EP_UPDATE_BYTES_PER_PARAM * held, EP_BACKWARD_BYTES_PER_PARAM * held + EP_ACTIVATION_BYTES)}
    fits = [n for n, t in table.items() if t["bytes_a_rank"] <= budget]
    layers = min(max(fits + [EP_MIN_LAYERS]), EP_MAX_LAYERS)
    return layers, {"layers": layers, "budget_a_rank": budget, "card_free": free,
                    "at_depth": table[layers], "all_layers": table[cfg.num_layers],
                    "fit": max(fits + [EP_MIN_LAYERS]), "cut_to": EP_MAX_LAYERS,
                    "update_bytes_per_param": EP_UPDATE_BYTES_PER_PARAM,
                    "backward_bytes_per_param": EP_BACKWARD_BYTES_PER_PARAM,
                    "activation_bytes": EP_ACTIVATION_BYTES}


def ep_served_passes(torch, served, forced=None, combines=(False, True), steps=DECODE_STEPS):
    """Per combine (False: default, True: H9) a prefill under the op
    counter, then one serve pass of ``steps`` decode steps, greedy or fed
    ``forced[combine]``, its launches counted: {combine: (logits of the
    real vocabulary, tokens, prefill s, decode s, launches, the counted
    prefill's collective records)}."""
    from repro_torch import kernels
    from repro_torch.models.perf_flags import PerfFlags, use_flags
    from repro_torch.roofline.op_cost import OpCounter

    model, ctx, params, inputs, prefill, decode = served
    B, prompt = inputs["tokens"].shape
    out = {}
    for scatter in combines:
        with use_flags(PerfFlags(moe_scatter_combine=scatter)):
            # The counted prefill also pays the one-off costs (gloo's
            # first buffers, library handles) before the timed pass.
            with OpCounter() as counter:
                prefill(params, model.decode_state_init(B, prompt, ctx=ctx), inputs)
            state = model.decode_state_init(B, prompt + steps, ctx=ctx)
            kernels.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, state = prefill(params, state, inputs)
            torch.cuda.synchronize()
            prefill_s = time.perf_counter() - t0
            all_logits, toks = [logits], []
            t0 = time.perf_counter()
            for i in range(steps):
                tok = torch.argmax(logits, dim=-1).to(torch.int32) if forced is None else forced[scatter][i].cuda()
                toks.append(tok)
                logits, state = decode(params, state, tok)
                all_logits.append(logits)
            torch.cuda.synchronize()
            decode_s = time.perf_counter() - t0
            out[scatter] = (torch.cat(all_logits, dim=1)[..., :model.cfg.vocab_size].cpu(), torch.stack(toks).cpu(),
                            prefill_s, decode_s, kernels.launch_counts(), records_of(counter.result()))
            del state, all_logits
        torch.cuda.empty_cache()
    return out


def layer_outputs(torch, served, teacher=None, prompts=LAYER_PROMPTS):
    """Every layer of ``served`` on its prompts, as ``transformer.forward``
    runs a prefill under the served context: the embedding's output, each
    layer's output (the residual stream after its mixer and ffn) and a MoE
    layer's router logits (T, E), on the host.  With ``teacher`` (one
    process's ``layer_outputs``) each layer takes the teacher's output of
    the layer before as its input, so that a layer is compared with no
    cascade from the ones before it.  A MoE layer runs at a capacity that
    drops nothing (``capacity_factor`` E/k: at the served one a near-tied
    pick that flips moves which other tokens an expert keeps) and through
    H9 (an all_reduce of the tokens' width, where the default combine
    all-gathers the whole buffer).  The first ``prompts`` prompts, each
    block's leaves gathered whole over the data axes first (FSDP)."""
    import dataclasses

    from repro_torch.models import fsdp, transformer
    from repro_torch.models.layers import basic
    from repro_torch.models.layers.attention import attention_apply, mlp_apply
    from repro_torch.models.layers.mamba2 import mamba_apply
    from repro_torch.models.layers.moe import moe_apply
    from repro_torch.models.perf_flags import PerfFlags, use_flags

    model, ctx, params, inputs, _, _ = served
    cfg = model.cfg
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cfg.moe.num_experts
                                                               / cfg.moe.top_k))
    tokens = inputs["tokens"][:prompts]
    positions = torch.arange(tokens.shape[1], dtype=torch.int32, device=tokens.device)
    plan = fsdp.plan(transformer.model_specs(cfg), ctx)
    block_plan = fsdp.unstacked(plan["blocks"])
    x = basic.embed_apply(fsdp.gather(params["embed"], plan["embed"], ctx), tokens, transformer.model_dtype(cfg),
                          transformer.vocab_group(params, cfg, ctx))
    out = {"embed": x.cpu(), "layers": [], "router": []}
    with use_flags(PerfFlags(moe_scatter_combine=True)):
        for b in range(transformer.num_blocks(cfg)):
            bp = fsdp.gather(transformer._take_block(params["blocks"], b), block_plan, ctx)
            for j in range(transformer.block_period(cfg)):
                i = len(out["layers"])
                if teacher is not None:
                    x = (teacher["embed"] if i == 0 else teacher["layers"][i - 1]).to(tokens.device)
                lp = bp[f"l{j}"]
                h = basic.norm_apply(lp["norm1"], x, cfg.norm)
                if "attn" in lp:
                    mix, _ = attention_apply(lp["attn"], h, cfg=cfg, positions=positions, group=ctx.ep_group)
                else:
                    mix, _ = mamba_apply(lp["mamba"], h, cfg=cfg, group=ctx.ep_group)
                x = x + mix
                if "moe" in lp:
                    h = basic.norm_apply(lp["norm2"], x, cfg.norm)
                    out["router"].append((h.reshape(-1, cfg.d_model) @ lp["moe"]["router"].to(h.dtype)).cpu())
                    x = x + moe_apply(lp["moe"], h, cfg=cfg, ctx=ctx)[0]
                elif "ffn" in lp:
                    x = x + mlp_apply(lp["ffn"], basic.norm_apply(lp["norm2"], x, cfg.norm), cfg, ctx.ep_group)
                out["layers"].append(x.cpu())
    return out


def layers_check(torch, got, want, top_k=None):
    """``got`` (a rank's ``layer_outputs`` taught by ``want``, one
    process's) against ``want``: the embedding's output EQUAL; each layer's
    output within LAYER_TOL of |x| and of the largest |x|, a MoE
    layer's rows where the rank's router picks other experts than one
    process's (the gating kernel on each side's router logits) excepted,
    each such row a near tie of one process's logits (its k-th and
    (k+1)-th within twice that band).  Returns the readings."""
    from repro_torch.kernels.topk_gating import ops as gating_ops

    def ratio(a, b, rows=None):
        a, b = a.float().reshape(-1, a.shape[-1]), b.float().reshape(-1, b.shape[-1])
        if rows is not None:
            a, b = a[rows], b[rows]
        if not a.numel():
            return 0.0
        band = LAYER_TOL * (b.abs().max() + b.abs())
        return float(((a - b).abs() / band).max())

    out = {"embed_equal": bool(torch.equal(got["embed"], want["embed"])), "layers": len(got["layers"]),
           "band_ratio": [], "rows_other_picks": 0, "other_picks_outside_near_ties": 0}
    for i, (a, b) in enumerate(zip(got["layers"], want["layers"])):
        rows = None
        if top_k is not None:
            mine = gating_ops.gating(got["router"][i].cuda(), top_k)[1].sort(dim=-1).values
            ref = want["router"][i].float()
            theirs = gating_ops.gating(want["router"][i].cuda(), top_k)[1].sort(dim=-1).values
            rows = (mine == theirs).all(dim=-1).cpu()
            top = ref.topk(top_k + 1, dim=-1).values
            tie_band = 2 * LAYER_TOL * (ref.abs().max() + top[:, top_k - 1].abs())
            out["rows_other_picks"] += int((~rows).sum())
            out["other_picks_outside_near_ties"] += int((~rows & (top[:, top_k - 1] - top[:, top_k] > tie_band)).sum())
        out["band_ratio"].append(ratio(a, b, rows))
    out["max_band_ratio"] = max(out["band_ratio"])
    return out


def served_against(torch, logits, toks, ref):
    """A rank's served logits against one process's ``ref`` (the band of
    EP_SERVE_*, greedy flips only at near ties), bit-equality and a
    checksum."""
    scale = float(ref.float().abs().max())
    gap = (logits.float() - ref.float()).abs()
    band = EP_SERVE_ATOL * scale + EP_SERVE_RTOL * ref.float().abs()
    top2 = ref.float().topk(2, dim=-1).values
    near_tie = (top2[..., 0] - top2[..., 1]) <= 2 * (EP_SERVE_ATOL * scale + EP_SERVE_RTOL * top2[..., 0].abs())
    flips = logits.argmax(dim=-1) != ref.argmax(dim=-1)
    return {"band_ratio": float((gap / band).max()), "max_abs_gap": float(gap.max()), "scale": scale,
            "bitwise_equal": bool(torch.equal(logits, ref)), "flips": int(flips.sum()),
            "flips_outside_near_ties": int((flips & ~near_tie).sum()), "positions": int(flips.numel()),
            "checksum": float(logits.double().sum()), "tokens_checksum": int(toks.long().sum())}


def ep_train(torch, card, layers, ctx, batches, specs=None, start_step=0):
    """An AdamW step of granite cut to ``layers`` in float32 at ``ctx`` on
    each of ``batches``, the first under the op counter: (state, losses,
    grad norms, ms, records, launches).  ``specs``: the whole leaves'
    specs, for a rank's slices (``at_input_fan_in``); ``start_step``: the
    schedule's step of the first (at 0 the warm-up's lr is 0)."""
    from repro_torch import kernels
    from repro_torch.models.model_api import build
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.roofline.op_cost import OpCounter
    from repro_torch.train.step import make_train_step, train_state_init

    cfg = ranks_config(layers)
    model = build(cfg)
    opt_cfg = OptimizerConfig(name=cfg.optimizer, warmup_steps=1, total_steps=TRAIN_STEPS)
    state = train_state_init(model, opt_cfg, torch.Generator(device="cuda").manual_seed(0), ctx, card)
    state["step"].fill_(start_step)
    at_input_fan_in(state["params"], specs)
    step = make_train_step(model, opt_cfg, ctx=ctx)
    run = {"loss": [], "grad_norm": [], "ms": []}
    kernels.reset_launch_counts()
    for i, batch in enumerate(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            with OpCounter() as counter:
                state, m = step(state, batch)
        else:
            state, m = step(state, batch)
        torch.cuda.synchronize()
        run["ms"].append((time.perf_counter() - t0) * 1e3)
        run["loss"].append(float(m["loss"]))
        run["grad_norm"].append(float(m["grad_norm"]))
    run["lr"] = float(m["lr"])
    run["launches"] = kernels.launch_counts()
    run["records"] = records_of(counter.result())
    run["cost"] = {k: counter.result()[k] for k in ("flops", "bytes")}
    return state, run


def ep_rank_train(torch, card, layers, ctx, where, name, mesh):
    """A rank's train steps at ``layers`` under ``ctx``, held to the one
    process's parameters (``where``/``name``): the run's readings."""
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models.model_api import build
    from repro_torch.models.param import expert_rules, shard_axes, slice_shards

    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    ref_params = torch.load(os.path.join(where, name), mmap=True)
    specs = build(ranks_config(layers)).specs()
    batches = [{k: v.to(card) for k, v in b.items()} for b in ranks_batches(torch, ranks_config(layers))]
    torch.cuda.reset_peak_memory_stats(card)
    state, run = ep_train(torch, card, layers, ctx, batches, specs)
    run["peak_memory_bytes"] = torch.cuda.max_memory_allocated(card)
    run["dyskew"] = {k: v.cpu().numpy() for k, v in flatten_with_paths(state["dyskew"])}
    axes = shard_axes(specs, ctx.mesh, ctx.rules)
    want_p = slice_shards(ref_params, axes, ctx.mesh, ctx.coords)
    gaps = {}
    for key, p in flatten_with_paths(state["params"]):
        diff = (p.cpu() - want_p[key]).abs()
        scale = float(want_p[key].abs().max())
        gaps[key] = {"max_rel": float(diff.max()) / scale, "max_over_lr": float(diff.max()) / run["lr"],
                     "share_off": float((diff > RANKS_PARAM_TOL * scale).float().mean())}
    run["against_one_process"] = gaps
    run["sliced_leaves"] = {k: list(p.shape) for k, p in flatten_with_paths(state["params"]) if k in axes}
    run["params_a_rank"] = sum(p.numel() for _, p in flatten_with_paths(state["params"]))
    if ctx.rules == expert_rules():
        run["issued"] = step_collectives(ranks_config(layers), 1, state["params"], TRAIN_BATCH * TRAIN_SEQ,
                                         model=EP_MODEL)
    else:
        run["issued"] = tp_train_collectives(ranks_config(layers), (TRAIN_BATCH, TRAIN_SEQ), state["params"],
                                             False)
    del state, want_p, ref_params
    torch.cuda.empty_cache()
    return run


def ep_rank(rank, world, init_method, where, layers):
    """Rank ``rank`` of (b).  Under the reference's layout: granite at full
    width and depth served, fed the one process's greedy tokens, both
    combines and H9's prefill a second time, every layer held beside
    (``layer_outputs``); starcoder2-3b
    and mamba2-1.3b served the same way; granite trained at ``layers`` in
    float32.  Under the experts-only layout: granite served with the default combine
    and trained, at EP_EXPERT_LAYERS.  Each held to the one process's files
    in ``where``."""
    import dataclasses

    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks
    from repro_torch.models.layers.moe import SpmdCtx
    from repro_torch.models.param import expert_rules
    from repro_torch.models.perf_flags import PerfFlags, use_flags

    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = EXPANDABLE
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    card = torch.device("cuda", 0)
    mesh = init_ranks(rank, world, device=card, init_method=init_method, backend="gloo", model=world)
    try:
        full = SpmdCtx(num_groups=1, num_ep_shards=world, group=mesh.group, ep_group=mesh.ep_group)
        experts = dataclasses.replace(full, rules=expert_rules())
        out = {"serve": {}, "layers": {}, "dense": {}, "seconds": {}}
        t0 = time.perf_counter()
        with torch.no_grad():
            served = served_model(torch, MOE_ARCH, ctx=full)
            at_input_fan_in(served[2], served[0].specs())
            out["held"] = {"experts": tuple(served[2]["blocks"]["l0"]["moe"]["w_gate"].shape),
                           "wq": tuple(served[2]["blocks"]["l0"]["attn"]["wq"].shape),
                           "table": tuple(served[2]["embed"]["table"].shape)}
            want = torch.load(os.path.join(where, "served.pt"))
            out["layers"][MOE_ARCH] = layers_check(torch, layer_outputs(torch, served, want["layers"]),
                                                   want["layers"], served[0].cfg.moe.top_k)
            runs = ep_served_passes(torch, served, forced=want["tokens"])
            for scatter, (logits, toks, prefill_s, decode_s, launches, records) in runs.items():
                out["serve"][scatter] = dict(served_against(torch, logits, toks, want["logits"][scatter]),
                                             prefill_s=prefill_s, decode_s=decode_s, launches=launches,
                                             records=records)
            # H9 a second time: the prefill's logits the same bits.
            model, _, params, inputs, prefill, _ = served
            with use_flags(PerfFlags(moe_scatter_combine=True)):
                again, _ = prefill(params, model.decode_state_init(*inputs["tokens"].shape, ctx=full), inputs)
            out["serve"][True]["second_prefill_equal"] = bool(torch.equal(
                again[..., :model.cfg.vocab_size].cpu(), runs[True][0][:, :1]))
            del served, runs, again, params
            torch.cuda.empty_cache()
            out["seconds"][MOE_ARCH] = time.perf_counter() - t0
            for arch in EP_DENSE_ARCHS:
                t0 = time.perf_counter()
                served = served_model(torch, arch, ctx=full)
                at_input_fan_in(served[2], served[0].specs())
                want = torch.load(os.path.join(where, f"{arch}.pt"))
                out["layers"][arch] = layers_check(torch, layer_outputs(torch, served, want["layers"]), want["layers"])
                logits, toks, prefill_s, decode_s, launches, records = ep_served_passes(
                    torch, served, forced={False: want["tokens"]}, combines=(False,), steps=EP_DENSE_DECODE_STEPS)[False]
                ssm = served[0].decode_state_init(1, 1, ctx=full).get("ssm_l0")
                out["dense"][arch] = dict(served_against(torch, logits, toks, want["logits"]), prefill_s=prefill_s,
                                          decode_s=decode_s, launches=launches, records=records,
                                          ssm_heads_hd_n=list(ssm["ssm"].shape[2:]) if ssm else None)
                del served
                torch.cuda.empty_cache()
                out["seconds"][arch] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["train"] = ep_rank_train(torch, card, layers, full, where, "params.pt", mesh)
        out["seconds"]["train"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.no_grad():
            served = served_model(torch, MOE_ARCH, layers=EP_EXPERT_LAYERS, ctx=experts)
            at_input_fan_in(served[2], served[0].specs())
            want = torch.load(os.path.join(where, "served_experts.pt"))
            logits, toks, prefill_s, decode_s, launches, records = ep_served_passes(
                torch, served, forced=want["tokens"], combines=(False,))[False]
            out["experts_only"] = {"serve": dict(served_against(torch, logits, toks, want["logits"][False]),
                                                 prefill_s=prefill_s, decode_s=decode_s, launches=launches,
                                                 records=records)}
            del served
            torch.cuda.empty_cache()
        out["experts_only"]["train"] = ep_rank_train(torch, card, EP_EXPERT_LAYERS, experts, where,
                                                     "params_experts.pt", mesh)
        out["seconds"]["experts_only"] = time.perf_counter() - t0
        return out
    finally:
        dist.destroy_process_group()


def ep_one_process(torch, card, where, layers):
    """(b)'s yardstick in this process, every leaf whole: granite at
    num_ep_shards EP_MODEL served (greedy, both combines, H9 a second time
    fed its first pass's tokens: the same bits), starcoder2-3b and
    mamba2-1.3b served greedy, each with its ``layer_outputs``, and granite at
    EP_EXPERT_LAYERS served greedy with the default combine, saved for the
    ranks; granite trained at ``layers`` and at EP_EXPERT_LAYERS, the
    parameters saved."""
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models.layers.moe import SpmdCtx

    ctx = SpmdCtx(num_groups=1, num_ep_shards=EP_MODEL)
    served = served_model(torch, MOE_ARCH, ctx=ctx)
    at_input_fan_in(served[2])
    runs = ep_served_passes(torch, served)
    again = ep_served_passes(torch, served, forced={True: runs[True][1]}, combines=(True,))[True][0]
    check(torch.equal(again, runs[True][0]), "expert_parallel (b) one process: two H9 passes differ")
    torch.save({"logits": {c: r[0] for c, r in runs.items()}, "tokens": {c: r[1] for c, r in runs.items()},
                "layers": layer_outputs(torch, served)}, os.path.join(where, "served.pt"))
    out = {"serve": {c: {"prefill_s": r[2], "decode_s": r[3], "records": r[5],
                         "distinct_tokens": len({tuple(t.flatten().tolist()) for t in r[1]})}
                     for c, r in runs.items()}, "h9_second_pass_equal": True, "dense": {}}
    for c, r in runs.items():
        check(bool(torch.isfinite(r[0].float()).all()), "expert_parallel (b) one process: logits not finite")
        check(out["serve"][c]["distinct_tokens"] > 1, "expert_parallel (b) one process: decode repeats one token")
    del served, runs, again
    torch.cuda.empty_cache()
    served = served_model(torch, MOE_ARCH, layers=EP_EXPERT_LAYERS, ctx=ctx)
    at_input_fan_in(served[2])
    run = ep_served_passes(torch, served, combines=(False,))[False]
    torch.save({"logits": {False: run[0]}, "tokens": {False: run[1]}}, os.path.join(where, "served_experts.pt"))
    del served, run
    torch.cuda.empty_cache()
    for arch in EP_DENSE_ARCHS:
        served = served_model(torch, arch, ctx=SpmdCtx())
        at_input_fan_in(served[2])
        logits, toks, prefill_s, decode_s, _, _ = ep_served_passes(torch, served, combines=(False,),
                                                                   steps=EP_DENSE_DECODE_STEPS)[False]
        check(bool(torch.isfinite(logits.float()).all()), f"expert_parallel (b) one process: {arch} logits")
        torch.save({"logits": logits, "tokens": toks, "layers": layer_outputs(torch, served)},
                   os.path.join(where, f"{arch}.pt"))
        out["dense"][arch] = {"prefill_s": prefill_s, "decode_s": decode_s,
                              "distinct_tokens": len({tuple(t.flatten().tolist()) for t in toks})}
        del served
        torch.cuda.empty_cache()
    for depth, name in ((layers, "params.pt"), (EP_EXPERT_LAYERS, "params_experts.pt")):
        batches = [{k: v.to(card) for k, v in b.items()} for b in ranks_batches(torch, ranks_config(depth))]
        torch.cuda.reset_peak_memory_stats()
        state, run = ep_train(torch, card, depth, ctx, batches)
        run["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        run["dyskew"] = {k: v.cpu().numpy() for k, v in flatten_with_paths(state["dyskew"])}
        torch.save({k: v.cpu() for k, v in flatten_with_paths(state["params"])}, os.path.join(where, name))
        out["train" if name == "params.pt" else "train_experts"] = run
        del state, batches
        torch.cuda.empty_cache()
    return out


def ep_one_rank(torch, card, nccl_train):
    """(a): granite at full width and depth served (8 × 1024 prefill, 32
    greedy decode steps, each combine) on a one-rank NCCL mesh (data 1,
    model 1), through the model group's collectives, against no group:
    the logits of every step, the tokens, and the ``ema_loads`` of a carried
    forward the same bits, H9 too (its sum by token is deterministic).  Its
    two train steps are ``ranks`` (b)'s (``nccl_train``), whose loop now
    runs on the same mesh.  Returns (row, the main path's counts)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.launch.mesh import init_ranks
    from repro_torch.models import transformer
    from repro_torch.models.layers.moe import SpmdCtx
    from repro_torch.models.perf_flags import PerfFlags, use_flags
    from repro_torch.train import decode_graph
    from repro_torch.train.step import make_decode_step, make_prefill_step

    counts = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as tmp:
        mesh = init_ranks(0, 1, device=torch.device("cuda", 0), init_method="file://" + os.path.join(tmp, "store"))
        try:
            grouped = SpmdCtx(group=mesh.group, ep_group=mesh.ep_group)
            model, _, params, inputs, _, _ = served = served_model(torch, MOE_ARCH, ctx=grouped)
            alone = SpmdCtx()
            runs = {"group": served, "alone": (model, alone, params, inputs, make_prefill_step(model, alone),
                                               make_decode_step(model, alone))}
            row = {"backend": "nccl", "mesh": mesh.shape, "layers": model.cfg.num_layers}
            where = "expert_parallel (a)"
            for scatter in (False, True):
                name = "h9" if scatter else "default"
                got = {}
                with use_flags(PerfFlags(moe_scatter_combine=scatter)):
                    for kind, s in runs.items():
                        kernels.reset_launch_counts()
                        before = dict(decode_graph.counts)
                        _, logits, toks, prefill_s, decode_s = serve_pass(torch, s)
                        launches, ran_on_host = kernels.launch_counts(), host_steps(before)
                        # A grouped step runs eagerly; the one alone is a
                        # graph, its replays checked by its logits.
                        check(kind == "alone" or ran_on_host == DECODE_STEPS, f"{where} {name}: a grouped step replayed")
                        moe_counts_are(launches, n_moe_layers(model.cfg) * (1 + ran_on_host),
                                       f"{where} {name} {kind}")
                        if kind == "group":
                            counts = {k: counts.get(k, 0) + v for k, v in launches.items()}
                        _, aux = transformer.forward(params, inputs["tokens"], cfg=model.cfg, ctx=s[1],
                                                     dyskew=model.dyskew_init(s[1]))
                        got[kind] = (logits, toks, aux["dyskew"], prefill_s, decode_s)
                (la, ta, da, *_), (lb, tb, db, *_) = got["group"], got["alone"]
                check(all(torch.equal(a, b) for a, b in zip(la, lb)), f"{where} {name}: logits differ from no group")
                check(all(torch.equal(a, b) for a, b in zip(ta, tb)), f"{where} {name}: tokens differ from no group")
                pairs = tree_pairs(da, db)
                check(all(torch.equal(a, b) for _, a, b in pairs), f"{where} {name}: ema_loads differ from no group")
                row[name] = {
                    "logits_equal": True, "tokens_equal": True, "ema_leaves_equal": len(pairs),
                    "prefill_s_group": got["group"][3], "prefill_s_alone": got["alone"][3],
                    "decode_s_group": got["group"][4], "decode_s_alone": got["alone"][4]}
                del got
            del served, runs, params
            torch.cuda.empty_cache()
        finally:
            dist.destroy_process_group()
    check(nccl_train["equal_to_no_group"] and ["all-gather", 1] in [list(k) for k in nccl_train["kinds"]],
          "expert_parallel (a): ranks (b)'s train steps did not run through the model group")
    row["train"] = {"by": "ranks (b): the same loop on the same one-rank mesh", "loss": nccl_train["loss"],
                    "equal_to_no_group": True, "collective_records": nccl_train["collective_records"]}
    return row, counts


def prefill_collectives(cfg, tokens, scatter):
    """(kind, group size, bytes) of each collective a rank of (b) issues in
    a prefill of ``tokens`` under the experts-only layout: a MoE layer's counts over
    its data group of one, then the expert outputs' all-gather over the
    model group (default combine) or the partial output's all_reduce
    (H9)."""
    from repro_torch.models.layers.moe import capacities

    E, d = cfg.moe.num_experts, cfg.d_model
    item = 2 if cfg.dtype == "bfloat16" else 4
    combine = (("all-reduce", EP_MODEL, tokens * d * item) if scatter
               else ("all-gather", EP_MODEL, E * capacities(cfg, tokens)[1] * d * item))
    return [("all-reduce", 1, 4 * 2 * E), combine] * n_moe_layers(cfg)


def tp_prefill_collectives(cfg, tokens, scatter, model=EP_MODEL):
    """(kind, group size, bytes) of each collective a rank of (data 1,
    model ``model``) issues, in order, in a prefill of ``tokens`` = (B, S)
    under the reference's layout: the embedding's sum of the ranks' rows;
    per layer the attention's or the Mamba mixer's sum of its partial
    output (the gated norm's sum of squares before it), then the ffn's sum
    or a MoE layer's counts over the data group of one and its combine; the
    last position's logits gathered over the vocabulary."""
    from repro_torch.models import transformer
    from repro_torch.models.layers.moe import capacities

    B, S = tokens
    d = cfg.d_model
    item = 2 if cfg.dtype == "bfloat16" else 4
    act = ("all-reduce", model, B * S * d * item)
    block = []
    for j in range(transformer.block_period(cfg)):
        if cfg.is_attention_layer(j) and cfg.num_heads > 0:
            block.append(act)
        else:
            block += [("all-reduce", model, B * S * 4), act]
        if cfg.is_moe_layer(j):
            E = cfg.moe.num_experts
            block.append(("all-reduce", 1, 4 * 2 * E))
            block.append(act if scatter else ("all-gather", model, E * capacities(cfg, B * S)[1] * d * item))
        elif cfg.d_ff > 0:
            block.append(act)
    return [act] + block * transformer.num_blocks(cfg) + [("all-gather", model, cfg.padded_vocab * B * item)]


def tp_train_collectives(cfg, tokens, params, scatter, model=EP_MODEL):
    """The (kind, group size, bytes) a train step issues on a rank of (data
    1, model ``model``) under the reference's layout, sorted (the
    backward's order is autograd's): the forward's (the prefill's but the
    gather), each block's again in its recompute (but a closing sum that
    no saved tensor follows: non-reentrant checkpointing stops at a block's
    last saved tensor), the loss's max and sums; in the backward
    ``to_shard``'s sum of each gradient of a replicated input (a layer's
    input, a MoE layer's tokens, the logits' input) and of whole kv leaves
    a rank uses for its share; one float32 sum a leaf over the data group
    of one and the global norm's sum over the model group."""
    import collections
    import math

    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models import transformer
    from repro_torch.models.param import model_rules, shard_axes

    B, S = tokens
    d = cfg.d_model
    item = 2 if cfg.dtype == "bfloat16" else 4
    fwd = tp_prefill_collectives(cfg, tokens, scatter, model)[:-1]
    nb = transformer.num_blocks(cfg)
    act = ("all-reduce", model, B * S * d * item)
    out = collections.Counter(fwd)
    recompute = collections.Counter(fwd[1:])
    last = transformer.block_period(cfg) - 1
    if not cfg.is_moe_layer(last) and (cfg.d_ff > 0 or not cfg.is_attention_layer(last)):
        recompute.subtract({act: nb})
    out += recompute
    out.update([("all-reduce", model, B * S * 4), ("all-reduce", model, 2 * B * S * 4), ("all-reduce", 1, 8), act])
    att = transformer.attention_specs(cfg) if cfg.num_heads else {}
    for j in range(transformer.block_period(cfg)):
        grads = [act]
        if cfg.is_attention_layer(j) and cfg.num_heads > 0 and cfg.num_kv_heads % model:
            grads += [("all-reduce", model, 4 * math.prod(att[n].shape)) for n in ("wk", "wv", "bk", "bv") if n in att]
        if cfg.is_moe_layer(j):
            grads.append(act)
            if scatter:
                grads.append(("all-reduce", model, B * S * cfg.moe.top_k * 4))
        elif cfg.d_ff > 0:
            grads.append(act)
        out.update(grads * nb)
    out.update(("all-reduce", 1, 4 * p.numel()) for _, p in flatten_with_paths(params))
    out.update([("all-reduce", model, 4 * len(shard_axes(transformer.model_specs(cfg), {"model": model}, model_rules())))])
    return sorted(out.elements())


def ep_check(torch, one, rows, layers):
    """(b)'s checks of the ranks against each other and against the one
    process; returns (row, the ranks' summed counts)."""
    import dataclasses

    import numpy as np

    from repro_torch.config.base import get_config
    from repro_torch.models.param import model_rules
    from repro_torch.roofline.analysis import analyze

    cfg = ranks_config(layers)
    E = cfg.moe.num_experts
    where = "expert_parallel (b)"
    full_cfg = ranks_config()
    for r in rows:
        check(r["held"]["experts"][1] == E // EP_MODEL and r["held"]["wq"][2] == full_cfg.num_heads // EP_MODEL
              and r["held"]["table"][0] == full_cfg.padded_vocab // EP_MODEL, f"{where}: a rank holds {r['held']}")
    layer_rows = {}
    for arch in (MOE_ARCH,) + EP_DENSE_ARCHS:
        got = [r["layers"][arch] for r in rows]
        for g in got:
            check(g["embed_equal"], f"{where} {arch}: the embedding's output differs from one process")
            check(g["max_band_ratio"] <= 1.0, f"{where} {arch}: a layer's output {g['max_band_ratio']} of the "
                  f"band off one process's from the same input: {g['band_ratio']}")
            check(g["other_picks_outside_near_ties"] == 0,
                  f"{where} {arch}: a rank's router picks other experts off a near tie: {g}")
        layer_rows[arch] = {"layers": got[0]["layers"], "max_band_ratio": max(g["max_band_ratio"] for g in got),
                            "rows_other_picks": max(g["rows_other_picks"] for g in got),
                            "band_ratio_by_layer": got[0]["band_ratio"]}

    def wire(records):
        kinds = {}
        for kind, group, nbytes in records:
            kinds.setdefault(f"{kind} x{group}", []).append(nbytes)
        terms = analyze({"flops": 0, "bytes": 0, "collectives": [
            {"kind": k, "bytes": b, "group": g} for k, g, b in records]}, EP_MODEL, 0.0)
        return {"records": {k: {"count": len(v), "bytes": sum(v)} for k, v in kinds.items()},
                "wire_bytes_a_rank": terms.collective_bytes_global / EP_MODEL, "t_collective_s": terms.t_collective}

    def served_row(got, issued, launches_each, name):
        """The ranks' served readings: the same bits on every rank, their
        launches and prefill records; the full-depth logits against one
        process's (the EP_SERVE_* band, greedy flips at near ties) are a
        reading (see LAYER_TOL)."""
        check(all(g["checksum"] == got[0]["checksum"] and g["tokens_checksum"] == got[0]["tokens_checksum"]
                  for g in got), f"{where} {name}: the ranks' logits or tokens differ")
        for g in got:
            for k, n in launches_each.items():
                check(g["launches"][k] == n, f"{where} {name}: {k} launched {g['launches'][k]}, expected {n}")
            check(g["records"] == issued, f"{where} {name}: a rank's prefill records against the "
                  "collectives it issued")
        out = {key: got[0][key] for key in ("band_ratio", "max_abs_gap", "scale", "bitwise_equal", "flips",
                                            "flips_outside_near_ties", "positions")}
        out.update(prefill_s=[g["prefill_s"] for g in got], decode_s=[g["decode_s"] for g in got])
        out["prefill"] = wire(got[0]["records"])
        return out

    def moe_launches(cfg):
        return {k: n_moe_layers(cfg) * (1 + DECODE_STEPS) for k in ("topk_gating", "load_histogram", "dispatch_gather")}

    moe_each = moe_launches(full_cfg)
    serve = {}
    for scatter in (False, True):
        name = "h9" if scatter else "default"
        got = [r["serve"][scatter] for r in rows]
        serve[name] = served_row(got, tp_prefill_collectives(full_cfg, (PREFILL_BATCH, PREFILL_LEN), scatter),
                                 moe_each, name)
        serve[name].update(one_process_prefill_s=one["serve"][scatter]["prefill_s"],
                           one_process_decode_s=one["serve"][scatter]["decode_s"])
        if scatter:
            check(all(g["second_prefill_equal"] for g in got), f"{where} h9: a rank's two H9 prefills differ")
            serve[name]["second_prefill_equal"] = True
    for arch in EP_DENSE_ARCHS:
        acfg = get_config(arch)
        got = [r["dense"][arch] for r in rows]
        scans = {"ssd_state_scan": n_mamba_layers(acfg)} if acfg.mamba is not None else {}
        serve[arch] = served_row(got, tp_prefill_collectives(acfg, (PREFILL_BATCH, PREFILL_LEN), False), scans,
                                 arch)
        serve[arch].update(one_process_prefill_s=one["dense"][arch]["prefill_s"],
                           one_process_decode_s=one["dense"][arch]["decode_s"],
                           ssm_heads_hd_n_a_rank=got[0]["ssm_heads_hd_n"])
        if scans:
            from repro_torch.models.layers.mamba2 import _dims

            _, _, nh, hd, _, n = _dims(acfg)
            check(got[0]["ssm_heads_hd_n"] == [nh // EP_MODEL, hd, n],
                  f"{where} {arch}: a rank's ssm state holds {got[0]['ssm_heads_hd_n']}")

    def train_row(train, base, name, per_element):
        for key, a in train[0]["dyskew"].items():
            check(all(np.array_equal(t["dyskew"][key], a) for t in train[1:]), f"{where} {name}: {key} "
                  "differs between ranks")
        check(all(t["loss"] == train[0]["loss"] and t["grad_norm"] == train[0]["grad_norm"] for t in train[1:]),
              f"{where} {name}: the ranks' losses or grad norms differ")
        for key in ("loss", "grad_norm"):
            rel = max(abs(a - b) / abs(b) for a, b in zip(train[0][key], base[key]))
            check(rel <= RANKS_LOSS_RTOL, f"{where} {name}: {key} {train[0][key]} against one process {base[key]}")
        ema_gap = ema_gap_check(base["dyskew"], train[0]["dyskew"], len(train[0]["loss"]), per_element,
                                f"{where} {name}")
        worst = {"max_rel": 0.0, "max_over_lr": 0.0, "share_off": 0.0}
        worst_leaf = ("", 0.0)
        for t in train:
            for key, g in t["against_one_process"].items():
                ok = g["max_over_lr"] <= 2.0
                if per_element:
                    ok = g["max_rel"] <= RANKS_PARAM_TOL or (ok and g["share_off"] <= RANKS_NOISE_SHARE)
                check(ok, f"{where} {name}: parameter {key} against one process: {g}")
                worst = {k: max(worst[k], g[k]) for k in worst}
                worst_leaf = max(worst_leaf, (key, g["share_off"]), key=lambda kv: kv[1])
            moe_counts_are(t["launches"], 2 * RANKS_STEPS * n_moe_layers(ranks_config(t["layers"])),
                           f"{where} {name}: a rank's train steps")
            check(sorted(t["records"]) == sorted(t["issued"]), f"{where} {name}: a rank's train records against "
                  "the collectives it issued")
        terms = wire(train[0]["records"])
        return {"layers": train[0]["layers"], "layers_of": full_cfg.num_layers, "dtype": cfg.dtype,
                "tokens_per_step": TRAIN_BATCH * TRAIN_SEQ, "steps": RANKS_STEPS,
                "params_a_rank": train[0]["params_a_rank"], "sliced_leaves": len(train[0]["sliced_leaves"]),
                "loss": train[0]["loss"], "grad_norm": train[0]["grad_norm"],
                "one_process": {k: base[k] for k in ("loss", "grad_norm", "ms", "peak_memory_bytes")},
                "rank_ms_per_step": [t["ms"] for t in train],
                "peak_memory_bytes": [t["peak_memory_bytes"] for t in train],
                "ema_loads_equal_across_ranks": True, "ema_loads_gap_to_one_process": ema_gap,
                "param_gap_worst": worst, "param_share_off_worst_leaf": worst_leaf, **terms}

    for r in rows:
        r["train"]["layers"] = layers
        r["experts_only"]["train"]["layers"] = EP_EXPERT_LAYERS
    check(rows[0]["train"]["params_a_rank"] == ep_rank_params(cfg, model_rules()),
          f"{where}: a rank holds {rows[0]['train']['params_a_rank']} parameters")
    train = train_row([r["train"] for r in rows], one["train"], "reference layout", False)
    got = [r["experts_only"]["serve"] for r in rows]
    for g in got:
        check(g["bitwise_equal"], f"{where} experts only: the default combine's logits differ from one process")
    served_cfg = dataclasses.replace(full_cfg, num_layers=EP_EXPERT_LAYERS)
    experts = {"serve": served_row(got, prefill_collectives(served_cfg, PREFILL_BATCH * PREFILL_LEN, False),
                                   moe_launches(served_cfg), "experts only"),
               "train": train_row([r["experts_only"]["train"] for r in rows], one["train_experts"], "experts only",
                                  True)}
    row = {"layers_from_one_process": layer_rows, "serve": serve, "train": train, "experts_only": experts,
           "timed_note": "gloo stages every collective through the host: these are not NCCL's times"}
    summed = {}
    for r in rows:
        for got in ([r["serve"][False]["launches"], r["serve"][True]["launches"], r["train"]["launches"],
                     r["experts_only"]["serve"]["launches"], r["experts_only"]["train"]["launches"]]
                    + [r["dense"][arch]["launches"] for arch in EP_DENSE_ARCHS]):
            summed = {k: summed.get(k, 0) + got[k] for k in got}
    return row, summed


def n_mamba_layers(cfg):
    from repro_torch.models import transformer

    return len(transformer.mamba_layer_positions(cfg)) * transformer.num_blocks(cfg)


def phase_expert_parallel(torch, nccl_train, card="cuda"):
    """The model axis: one NCCL rank with a model group of one against no
    group (a); EP_MODEL gloo ranks sharing the card under the reference's
    layout and under the experts-only one, held to one process (b); the model group's
    collectives of a prefill and a train step (c).  Returns the main path's
    launch counts."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import run_ranks

    t_start = time.perf_counter()
    row = {"phase": "expert_parallel", "mesh_b": {"data": 1, "model": EP_MODEL}}
    with torch.no_grad():
        row["one_rank"], counts = ep_one_rank(torch, card, nccl_train)
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info()
    row["main_process_bytes"] = {"allocated": torch.cuda.memory_allocated(), "reserved": torch.cuda.memory_reserved(),
                                 "card_free": free}
    layers, row["train_depth"] = ep_train_layers(torch, free)
    emit({"phase": "expert_parallel_depth", **row["train_depth"], "main_process_bytes": row["main_process_bytes"]})
    where = tempfile.mkdtemp(dir=ROOT, prefix=".chip_smoke_ep_")
    try:
        t0 = time.perf_counter()
        with torch.no_grad():
            one = ep_one_process(torch, card, where, layers)
        row["one_process_seconds"] = time.perf_counter() - t0
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rows = run_ranks(ep_rank, EP_MODEL, where, layers, timeout=EP_TIMEOUT_S, store_dir=where)
        row["ranks_seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(where, ignore_errors=True)
    emit({"phase": "expert_parallel_readings", "rank_seconds": [r["seconds"] for r in rows],
          "layers": [{a: {k: v for k, v in r["layers"][a].items() if k != "band_ratio"} for a in r["layers"]}
                     for r in rows],
          "served": {str(c): {k: rows[0]["serve"][c][k] for k in ("band_ratio", "max_abs_gap", "flips",
                                                                  "flips_outside_near_ties", "prefill_s", "decode_s")}
                     for c in (False, True)},
          "dense": {a: {k: rows[0]["dense"][a][k] for k in ("band_ratio", "max_abs_gap", "flips",
                                                            "flips_outside_near_ties", "prefill_s", "decode_s")}
                    for a in EP_DENSE_ARCHS},
          "train": {k: rows[0]["train"][k] for k in ("loss", "grad_norm", "ms", "peak_memory_bytes")},
          "one_process": {"train": {k: one["train"][k] for k in ("loss", "grad_norm", "ms")}}})
    row["ranks"], got = ep_check(torch, one, rows, layers)
    counts = {k: counts.get(k, 0) + got[k] for k in got}
    row["launches"] = counts
    row["seconds"] = time.perf_counter() - t_start
    emit(row)
    return counts


# --------------------------------------------------------------------- #
# Phase 14: FSDP of embed over the data group
# --------------------------------------------------------------------- #

#: The meshes of (b) and (c): four gloo ranks sharing the card.
FSDP_B, FSDP_C = {"data": 4, "model": 1}, {"data": 2, "model": 2}
FSDP_WORLD = 4
#: Seconds each wait on a rank may take: a process start, the kernel
#: build, two served models and three train steps through gloo.
FSDP_TIMEOUT_S = 900
#: The train depth of (a)-(d): granite at full width, float32, one AdamW
#: step of the 8 × 1024 tokens.  A rank holds a quarter of every leaf at
#: (4, 1) (346,342,400 parameters at 24 layers), and gathers one block at a
#: time; the time is gloo's host staging of every block's leaves three
#: times a step (forward, recompute, reduce-scatter): at 24 layers a rank's
#: step took 32-42 s and the phase about 370 s (PERF.md §6), over
#: the script's time, so the depth is cut to half.
FSDP_LAYERS = 12
#: Decode steps of the served passes of (b) and (c), and the depth they
#: serve: half of each model (granite 12 of 24 layers, mamba2-1.3b 24 of
#: 48), cut for the script's time (a decode step gathers the whole model
#: through gloo's host staging: 4.7-6.7 s a step at full depth, and the
#: script took 941 s with both served whole; PERF.md §6).
FSDP_DECODE_STEPS = 8
FSDP_SERVE_LAYERS = {MOE_ARCH: 12, SSM_ARCH: 24}


def fsdp_issued(cfg, mesh, kind, rows, h2=False):
    """The multiset of (kind, group size, bytes) of the all-gathers and
    reduce-scatters a rank of ``mesh`` issues over a group of more than one
    rank in a ``kind`` ("prefill" or "train") step of ``rows`` × 1024
    tokens under ``default_rules``: FSDP's all-gather over the data group
    of each leaf the data axes slice (whole over them, the model axis's
    slice: bf16 served, float32 trained or bf16 under H2) where it is used, twice a block leaf in a
    train step (the forward and remat's recompute), and in the backward
    one reduce-scatter a leaf of its rank's slice; over the model group a
    MoE layer's default combine (twice in a train step) and a prefill's
    last logits over the vocabulary."""
    import collections
    import math

    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models import transformer
    from repro_torch.models.layers.moe import capacities
    from repro_torch.models.model_api import build
    from repro_torch.models.param import default_rules, dp_part, layer_shape, leaf_slices

    data, model = mesh["data"], mesh["model"]
    train = kind == "train"
    act = 4 if train else 2
    item = 2 if (not train or h2) else 4
    nb = transformer.num_blocks(cfg)
    out = collections.Counter()
    for key, p in flatten_with_paths(build(cfg).specs()):
        if data == 1 or not any(dp_part(ax) for _, ax in leaf_slices(p, mesh, default_rules())):
            continue
        block = key.startswith("blocks/")
        # Whole over the data axes, the model axis's slice of it.
        shape = layer_shape(p, mesh, default_rules())
        whole = math.prod(shape[1:] if block else shape) * item
        uses = nb if block else 1
        out[("all-gather", data, whole)] += uses * (2 if train and block and cfg.remat else 1)
        if train:
            out[("reduce-scatter", data, whole // data)] += uses
    if model > 1:
        tokens = rows * PREFILL_LEN
        if cfg.moe is not None:
            E = cfg.moe.num_experts
            out[("all-gather", model, E * capacities(cfg, tokens)[1] * cfg.d_model * act)] += \
                n_moe_layers(cfg) * (2 if train else 1)
        if not train:
            out[("all-gather", model, cfg.padded_vocab * rows * act)] += 1
    return out


def fsdp_records(records):
    """The all-gathers and reduce-scatters among a step's records, over a
    group of more than one rank."""
    import collections

    return collections.Counter((k, g, b) for k, g, b in records if g > 1 and k in ("all-gather", "reduce-scatter"))


def wire_row(records, chips):
    """Records by kind and group size, with the wire bytes a rank sends
    and ``t_collective`` at the H100's NVLink rate."""
    from repro_torch.roofline.analysis import analyze

    kinds = {}
    for kind, group, nbytes in records:
        row = kinds.setdefault(f"{kind} x{group}", {"count": 0, "bytes": 0})
        row["count"] += 1
        row["bytes"] += nbytes
    terms = analyze({"flops": 0, "bytes": 0, "collectives": [
        {"kind": k, "bytes": b, "group": g} for k, g, b in records]}, chips, 0.0)
    return {"records": dict(sorted(kinds.items())), "wire_bytes_a_rank": terms.collective_bytes_global / chips,
            "t_collective_s": terms.t_collective}


def fsdp_rows(batch, mesh, data_rank):
    """This rank's rows of a global batch."""
    n = next(iter(batch.values())).shape[0] // mesh["data"]
    return {k: v[data_rank * n:(data_rank + 1) * n] for k, v in batch.items()}


def fsdp_one_process(torch, card, where):
    """The yardsticks, in this process with every leaf whole: granite
    served at num_groups 4 at FSDP_SERVE_LAYERS (8 × 1024 prefill,
    FSDP_DECODE_STEPS greedy decode steps, every layer's output from
    ``layer_outputs`` over all 8 prompts) and mamba2-1.3b served the same
    way; granite at FSDP_LAYERS trained one float32 step at num_groups 4
    (b), at (num_groups 2, num_ep_shards 2) (c) and so with H2 (d); the
    parameters saved."""
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models.layers.moe import SpmdCtx
    from repro_torch.models.perf_flags import PerfFlags, use_flags

    out = {}
    with torch.no_grad():
        for arch, ctx in ((MOE_ARCH, SpmdCtx(num_groups=FSDP_WORLD)), (SSM_ARCH, SpmdCtx())):
            served = served_model(torch, arch, layers=FSDP_SERVE_LAYERS[arch], ctx=ctx)
            at_input_fan_in(served[2])
            logits, toks, prefill_s, decode_s, _, _ = ep_served_passes(
                torch, served, combines=(False,), steps=FSDP_DECODE_STEPS)[False]
            check(bool(torch.isfinite(logits.float()).all()), f"fsdp one process: {arch} logits not finite")
            torch.save({"logits": logits, "tokens": toks, "layers": layer_outputs(torch, served, prompts=PREFILL_BATCH)},
                       os.path.join(where, f"{arch}.pt"))
            out[arch] = {"prefill_s": prefill_s, "decode_s": decode_s}
            del served
            torch.cuda.empty_cache()
    batches = [{k: v.to(card) for k, v in ranks_batches(torch, ranks_config(FSDP_LAYERS))[0].items()}]
    for part, ctx, h2 in (("b", SpmdCtx(num_groups=FSDP_WORLD), False), ("c", SpmdCtx(num_groups=2, num_ep_shards=2), False),
                          ("d", SpmdCtx(num_groups=2, num_ep_shards=2), True)):
        torch.cuda.reset_peak_memory_stats()
        with use_flags(PerfFlags(cast_before_gather=h2)):
            state, run = ep_train(torch, card, FSDP_LAYERS, ctx, batches, start_step=1)
        run["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
        run["dyskew"] = {k: v.cpu().numpy() for k, v in flatten_with_paths(state["dyskew"])}
        torch.save({k: v.cpu() for k, v in flatten_with_paths(state["params"])}, os.path.join(where, f"params_{part}.pt"))
        out[part] = run
        del state
        torch.cuda.empty_cache()
    return out


def fsdp_rank_train(torch, card, ctx, mesh, where, part, h2=False):
    """A rank's one train step of granite at FSDP_LAYERS on its rows, held
    to one process's parameters (``params_<part>.pt``): the readings."""
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.models.model_api import build
    from repro_torch.models.param import shard_axes, slice_shards
    from repro_torch.models.perf_flags import PerfFlags, use_flags

    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    cfg = ranks_config(FSDP_LAYERS)
    specs = build(cfg).specs()
    batch = fsdp_rows(ranks_batches(torch, cfg)[0], ctx.mesh, mesh.data_rank)
    torch.cuda.reset_peak_memory_stats(card)
    t0 = time.perf_counter()
    with use_flags(PerfFlags(cast_before_gather=h2)):
        state, run = ep_train(torch, card, FSDP_LAYERS, ctx, [{k: v.to(card) for k, v in batch.items()}], specs,
                              start_step=1)
    run["seconds"] = time.perf_counter() - t0
    run["peak_memory_bytes"] = torch.cuda.max_memory_allocated(card)
    run["dyskew"] = {k: v.cpu().numpy() for k, v in flatten_with_paths(state["dyskew"])}
    ref = torch.load(os.path.join(where, f"params_{part}.pt"), mmap=True)
    want = slice_shards(ref, shard_axes(specs, ctx.mesh, ctx.rules), ctx.mesh, ctx.coords)
    gaps = {}
    for key, p in flatten_with_paths(state["params"]):
        diff = (p.cpu() - want[key]).abs()
        gaps[key] = {"max_rel": float(diff.max()) / float(want[key].abs().max()),
                     "max_over_lr": float(diff.max()) / run["lr"]}
    run["against_one_process"] = gaps
    run["params_a_rank"] = sum(p.numel() for _, p in flatten_with_paths(state["params"]))
    del state, ref, want
    torch.cuda.empty_cache()
    return run


def fsdp_rank_serve(torch, arch, ctx, where, data_rank):
    """A rank's prefill of its prompts and FSDP_DECODE_STEPS decode steps
    fed one process's tokens, and each layer's output fed one process's
    input, against one process's (``<arch>.pt``)."""
    served = served_model(torch, arch, layers=FSDP_SERVE_LAYERS[arch], ctx=ctx)
    at_input_fan_in(served[2], served[0].specs())
    model, _, params, inputs, prefill, decode = served
    n = PREFILL_BATCH // ctx.mesh["data"]
    rows = slice(data_rank * n, (data_rank + 1) * n)
    served = (model, ctx, params, {k: v[rows] for k, v in inputs.items()}, prefill, decode)
    want = torch.load(os.path.join(where, f"{arch}.pt"))
    teacher = {"embed": want["layers"]["embed"][rows], "layers": [x[rows] for x in want["layers"]["layers"]],
               "router": [x.reshape(PREFILL_BATCH, PREFILL_LEN, -1)[rows].reshape(-1, x.shape[-1])
                          for x in want["layers"]["router"]]}
    out = {"layers": layers_check(torch, layer_outputs(torch, served, teacher, prompts=n), teacher,
                                  model.cfg.moe.top_k if model.cfg.moe is not None else None)}
    logits, toks, prefill_s, decode_s, launches, records = ep_served_passes(
        torch, served, forced={False: want["tokens"][:, rows]}, combines=(False,), steps=FSDP_DECODE_STEPS)[False]
    out.update(served_against(torch, logits, toks, want["logits"][rows]), prefill_s=prefill_s, decode_s=decode_s,
               launches=launches, records=records)
    del served, params
    torch.cuda.empty_cache()
    return out


def fsdp_rank(rank, world, init_method, where):
    """Rank ``rank`` of (b), then of (c) and (d) on a second process group
    of the same ranks: granite served and trained at (data 4, model 1);
    granite trained, with H2 too, and mamba2-1.3b served at (data 2, model
    2); under ``default_rules``, each held to one process's files in
    ``where``."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_ranks, mesh_ctx

    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = EXPANDABLE
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    card = torch.device("cuda", 0)
    out = {"seconds": {}}
    for part, model in (("b", 1), ("c", 2)):
        store = init_method if part == "b" else init_method + "_c"
        mesh = init_ranks(rank, world, device=card, init_method=store, backend="gloo", model=model)
        try:
            ctx = mesh_ctx(mesh)
            t0 = time.perf_counter()
            with torch.no_grad():
                out[part] = {"serve": fsdp_rank_serve(torch, MOE_ARCH if part == "b" else SSM_ARCH, ctx, where,
                                                      mesh.data_rank)}
            out["seconds"][part + "_serve"] = time.perf_counter() - t0
            out[part]["train"] = fsdp_rank_train(torch, card, ctx, mesh, where, part)
            if part == "c":
                out["d"] = {"train": fsdp_rank_train(torch, card, ctx, mesh, where, "d", h2=True)}
        finally:
            dist.destroy_process_group()
    return out


def fsdp_one_rank(torch, card):
    """(a): one NCCL rank, data and model groups of one, under
    ``default_rules``: granite at full width and depth served (8 × 1024
    prefill, 32 greedy decode steps) and one float32 train step at
    FSDP_LAYERS, against no group: the same bits.  Returns (row, the path's
    launches)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.launch.mesh import init_ranks, mesh_ctx
    from repro_torch.models.layers.moe import SpmdCtx
    from repro_torch.train import decode_graph
    from repro_torch.train.step import make_decode_step, make_prefill_step

    where = "fsdp (a)"
    counts = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as tmp:
        mesh = init_ranks(0, 1, device=torch.device("cuda", 0), init_method="file://" + os.path.join(tmp, "store"))
        try:
            grouped = mesh_ctx(mesh, num_groups=1)
            row = {"backend": "nccl", "mesh": mesh.shape, "rules": "default_rules", "layers": ranks_config().num_layers}
            with torch.no_grad():
                model, _, params, inputs, _, _ = served = served_model(torch, MOE_ARCH, ctx=grouped)
                alone = SpmdCtx()
                got = {}
                for kind, s in (("group", served), ("alone", (model, alone, params, inputs, make_prefill_step(model, alone),
                                                              make_decode_step(model, alone)))):
                    kernels.reset_launch_counts()
                    before = dict(decode_graph.counts)
                    _, logits, toks, prefill_s, decode_s = serve_pass(torch, s)
                    launches, ran_on_host = kernels.launch_counts(), host_steps(before)
                    # As in ``ep_one_rank``: the grouped step eager, the
                    # one alone a graph.
                    check(kind == "alone" or ran_on_host == DECODE_STEPS, f"{where}: a grouped step replayed")
                    moe_counts_are(launches, n_moe_layers(model.cfg) * (1 + ran_on_host), f"{where} {kind}")
                    if kind == "group":
                        counts = dict(launches)
                    got[kind] = (logits, toks, prefill_s, decode_s)
                check(all(torch.equal(a, b) for a, b in zip(got["group"][0], got["alone"][0])),
                      f"{where}: logits differ from no group")
                check(all(torch.equal(a, b) for a, b in zip(got["group"][1], got["alone"][1])),
                      f"{where}: tokens differ from no group")
                row["serve"] = {"logits_equal": True, "tokens_equal": True,
                                "prefill_s": {k: v[2] for k, v in got.items()},
                                "decode_s": {k: v[3] for k, v in got.items()}}
                del served, params, got
                torch.cuda.empty_cache()
            batches = [{k: v.to(card) for k, v in ranks_batches(torch, ranks_config(FSDP_LAYERS))[0].items()}]
            runs = {}
            for kind, ctx in (("group", grouped), ("alone", SpmdCtx(num_groups=1))):
                state, run = ep_train(torch, card, FSDP_LAYERS, ctx, batches, start_step=1)
                runs[kind] = (run, {k: v.cpu() for k, v in flatten_with_paths(state["params"])})
                if kind == "group":
                    counts = {k: counts.get(k, 0) + v for k, v in run["launches"].items()}
                del state
                torch.cuda.empty_cache()
            (a, pa), (b, pb) = runs["group"], runs["alone"]
            check(a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"], f"{where}: loss or grad_norm differ")
            check(all(torch.equal(pa[k], pb[k]) for k in pa), f"{where}: parameters differ from no group")
            row["train"] = {"layers": FSDP_LAYERS, "loss": a["loss"], "grad_norm": a["grad_norm"], "equal_to_no_group": True,
                            "ms": {"group": a["ms"], "alone": b["ms"]}, **wire_row(a["records"], 1)}
        finally:
            dist.destroy_process_group()
    return row, counts


def fsdp_check(torch, one, rows):
    """(b), (c), (d): the ranks against one process and against what they
    issue; returns (row, the ranks' summed launches)."""
    import dataclasses

    import numpy as np

    from repro_torch.config.base import get_config

    cfg = ranks_config(FSDP_LAYERS)
    out, summed = {}, {}
    for part, mesh in (("b", FSDP_B), ("c", FSDP_C), ("d", FSDP_C)):
        where = f"fsdp ({part})"
        train = [r[part]["train"] for r in rows]
        base = one[part]
        ema_gaps = []
        for t in train:
            for key in ("loss", "grad_norm"):
                rel = abs(t[key][0] - base[key][0]) / abs(base[key][0])
                check(rel <= RANKS_LOSS_RTOL, f"{where}: {key} {t[key]} against one process {base[key]}")
            for key, g in t["against_one_process"].items():
                check(g["max_over_lr"] <= 2.0, f"{where}: parameter {key} against one process: {g}")
            ema_gaps.append(ema_gap_check(base["dyskew"], t["dyskew"], len(base["loss"]), False, where))
            issued = fsdp_issued(cfg, mesh, "train", TRAIN_BATCH // mesh["data"], h2=part == "d")
            check(fsdp_records(t["records"]) == issued, f"{where}: a rank's gathers and reduce-scatters against "
                  "what it issues")
            moe_counts_are(t["launches"], 2 * n_moe_layers(cfg), f"{where}: a rank's train step")
            summed = {k: summed.get(k, 0) + v for k, v in t["launches"].items()}
        check(all(t["loss"] == train[0]["loss"] and t["grad_norm"] == train[0]["grad_norm"] for t in train),
              f"{where}: the ranks' losses or grad norms differ")
        out[part] = {"mesh": mesh, "layers": FSDP_LAYERS, "loss": train[0]["loss"], "grad_norm": train[0]["grad_norm"],
                     "one_process": {k: base[k] for k in ("loss", "grad_norm", "ms", "peak_memory_bytes")},
                     "params_a_rank": train[0]["params_a_rank"], "rank_seconds": [t["seconds"] for t in train],
                     "peak_memory_bytes": [t["peak_memory_bytes"] for t in train],
                     "param_max_over_lr": max(g["max_over_lr"] for t in train for g in t["against_one_process"].values()),
                     "ema_loads_gap_to_one_process": max(ema_gaps),
                     **wire_row(train[0]["records"], FSDP_WORLD)}
    # FSDP's all-gathers alone (the data axes' part of what (c) and (d)
    # issue, held above): H2's move half the bytes.
    gathers = {p: sum(n * b for (k, _, b), n in fsdp_issued(cfg, {"data": 2, "model": 1}, "train", 4, h2).items()
                      if k == "all-gather") for p, h2 in (("c", False), ("d", True))}
    check(2 * gathers["d"] == gathers["c"], f"fsdp (d): H2's gathers move {gathers}")
    out["d"]["fsdp_gather_bytes"] = gathers
    for part, arch, mesh in (("b", MOE_ARCH, FSDP_B), ("c", SSM_ARCH, FSDP_C)):
        where = f"fsdp ({part}) {arch}"
        got = [r[part]["serve"] for r in rows]
        acfg = dataclasses.replace(get_config(arch), num_layers=FSDP_SERVE_LAYERS[arch])
        for g in got:
            check(g["layers"]["embed_equal"], f"{where}: the embedding's output differs from one process")
            check(g["layers"]["max_band_ratio"] <= 1.0, f"{where}: a layer {g['layers']['max_band_ratio']} of the band "
                  f"off one process's from the same input: {g['layers']['band_ratio']}")
            check(g["layers"]["other_picks_outside_near_ties"] == 0, f"{where}: other picks off a near tie")
            issued = fsdp_issued(acfg, mesh, "prefill", PREFILL_BATCH // mesh["data"])
            check(fsdp_records(g["records"]) == issued, f"{where}: a rank's prefill gathers against what it issues")
            summed = {k: summed.get(k, 0) + v for k, v in g["launches"].items()}
        if acfg.mamba is not None:
            check(all(g["launches"]["ssd_state_scan"] == n_mamba_layers(acfg) for g in got), f"{where}: scan launches")
        else:
            moe_counts_are(got[0]["launches"], n_moe_layers(acfg) * (1 + FSDP_DECODE_STEPS), where)
        out[part]["serve"] = {"arch": arch, "layers": acfg.num_layers,
                              "max_layer_band_ratio": max(g["layers"]["max_band_ratio"] for g in got),
                              "logits_band_ratio": max(g["band_ratio"] for g in got),
                              "flips": sum(g["flips"] for g in got), "positions": sum(g["positions"] for g in got),
                              "prefill_s": [g["prefill_s"] for g in got], "decode_s": [g["decode_s"] for g in got],
                              "one_process": one[arch], **wire_row(got[0]["records"], FSDP_WORLD)}
    out["timed_note"] = "gloo stages every collective through the host: these are not NCCL's times"
    return out, summed


def phase_fsdp(torch, card="cuda"):
    """FSDP of embed over the data group: one NCCL rank with groups of one
    against no group (a); four gloo ranks sharing the card at (data 4,
    model 1) (b) and (data 2, model 2) (c), with H2 (d), held to one
    process.  Returns the main path's launch counts."""
    import shutil
    import tempfile

    from repro_torch.launch.mesh import run_ranks
    from repro_torch.models.param import default_rules

    t_start = time.perf_counter()
    row = {"phase": "fsdp", "meshes": {"b": FSDP_B, "c": FSDP_C}, "train_layers": FSDP_LAYERS}
    row["one_rank"], counts = fsdp_one_rank(torch, card)
    gc.collect()
    torch._C._cuda_clearCublasWorkspaces()
    torch.cuda.empty_cache()
    emit({"phase": "fsdp_depth", "layers": FSDP_LAYERS, "of": ranks_config().num_layers,
          "params_a_rank": {p: ep_rank_params(ranks_config(FSDP_LAYERS), default_rules(), mesh=m) for p, m in
                            (("b", FSDP_B), ("c", FSDP_C))}})
    where = tempfile.mkdtemp(dir=ROOT, prefix=".chip_smoke_fsdp_")
    try:
        t0 = time.perf_counter()
        one = fsdp_one_process(torch, card, where)
        row["one_process_seconds"] = time.perf_counter() - t0
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rows = run_ranks(fsdp_rank, FSDP_WORLD, where, timeout=FSDP_TIMEOUT_S, store_dir=where)
        row["ranks_seconds"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(where, ignore_errors=True)
    emit({"phase": "fsdp_readings", "rank_seconds": [r["seconds"] for r in rows],
          "train": {p: {k: rows[0][p]["train"][k] for k in ("loss", "grad_norm", "ms", "peak_memory_bytes")}
                    for p in ("b", "c", "d")},
          "one_process": {p: {k: one[p][k] for k in ("loss", "grad_norm", "ms")} for p in ("b", "c", "d")},
          "layers": {p: rows[0][p]["serve"]["layers"]["max_band_ratio"] for p in ("b", "c")}})
    row["ranks"], got = fsdp_check(torch, one, rows)
    counts = {k: counts.get(k, 0) + got.get(k, 0) for k in set(counts) | set(got)}
    row["launches"] = counts
    row["seconds"] = time.perf_counter() - t_start
    emit(row)
    return counts


# --------------------------------------------------------------------- #
# Phase 15: the dry-run and the roofline of whole steps
# --------------------------------------------------------------------- #

#: The configs whose dry-run cells this phase counts: the six the script
#: serves or trains.  All 40 cells take about four minutes on one CPU core
#: (PERF.md §6), over the 90 s the phase may give them.
ROOFLINE_ARCHS = (MOE_ARCH, SSM_ARCH, "whisper-base", "pixtral-12b", "qwen1.5-32b", KIMI_ARCH)
#: The counted peak live bytes of a step (its ``meta`` run) over the card's
#: peak for the same step, stated before the first run: the plain versions
#: that stand for the kernels on ``meta`` keep more temporaries, the
#: allocator rounds each block up.
PEAK_BAND = (0.9, 1.2)
#: Timed calls of each step (the median is its time), decode steps timed.
ROOFLINE_TIMED, ROOFLINE_DECODES = 3, 8
KERNEL_NAMES = ("topk_gating", "load_histogram", "dispatch_gather", "ssd_state_scan", "ssd_state_scan_bwd",
                "moe_combine", "moe_combine_bwd", "attention")


def as_meta(torch, tree):
    """Every tensor of ``tree`` as a ``meta`` tensor of its shape, strides
    and dtype."""
    if isinstance(tree, dict):
        return {k: as_meta(torch, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(as_meta(torch, v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return torch.empty_strided(tree.shape, tree.stride(), dtype=tree.dtype, device="meta")
    return tree


def timed_s(torch, fn, reps=ROOFLINE_TIMED):
    """Median wall seconds of ``reps`` calls, each ended by a synchronise."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def count_step(torch, name, fn, args, model_flops, seconds):
    """``fn(*args)`` once on the card under the op counter (untimed), every
    launch counter at 0 before and read after, and once on ``meta`` tensors
    of the same shapes: FLOPs, product FLOPs, bytes and kernel records must
    be equal, and the records must equal the launches.  Returns the row:
    the counts, ``mfu`` (MODEL_FLOPS over ``seconds`` at the bf16 peak), the
    counted roofline terms, and the counted peak beside the card's."""
    from repro_torch import kernels
    from repro_torch.roofline import hw
    from repro_torch.roofline.analysis import analyze
    from repro_torch.roofline.op_cost import OpCounter

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    kernels.reset_launch_counts()
    with OpCounter() as card:
        card.track(args)
        arg_bytes = card.peak_bytes
        out = fn(*args)
        torch.cuda.synchronize()
    launches = kernels.launch_counts()
    card_peak = torch.cuda.max_memory_allocated() - before + arg_bytes
    del out
    meta_args = as_meta(torch, args)
    with OpCounter() as meta:
        meta.track(meta_args)
        fn(*meta_args)
    c, m = card.result(), meta.result()
    differ = [key for key in ("flops", "dot_flops", "bytes", "kernels") if c[key] != m[key]]
    if differ:
        emit({"phase": "roofline_mismatch", "step": name, "keys": differ,
              "card": {k: c[k] for k in differ}, "meta": {k: m[k] for k in differ},
              "by_op": {str(op): {"card": card.by_op.get(op), "meta": meta.by_op.get(op)}
                        for op in sorted(set(card.by_op) | set(meta.by_op), key=str)
                        if card.by_op.get(op) != meta.by_op.get(op)}})
    records = {k: m["kernels"].get(k, {}).get("calls", 0) for k in KERNEL_NAMES}
    terms = analyze(m, hw.CHIPS_SINGLE, model_flops)
    ratio = m["peak_bytes"] / card_peak
    return {
        "phase": "roofline_step", "step": name, "model_flops": model_flops, "flops": m["flops"],
        "dot_flops": m["dot_flops"], "bytes": m["bytes"], "kernels": m["kernels"],
        "launches": {k: v for k, v in launches.items() if v}, "card_equals_meta": not differ,
        "records_equal_launches": records == launches,
        "seconds": seconds, "mfu": model_flops / (seconds * hw.PEAK_FLOPS_BF16),
        "t_compute_s": terms.t_compute, "t_memory_s": terms.t_memory,
        "useful_flops_ratio": terms.useful_flops_ratio,
        "peak_bytes_counted": m["peak_bytes"], "peak_bytes_card": card_peak, "peak_ratio": ratio,
        "peak_band": list(PEAK_BAND), "peak_in_band": PEAK_BAND[0] <= ratio <= PEAK_BAND[1],
    }


def roofline_serve(torch, arch):
    """Prefill 8 x 1024 and one decode step of ``arch`` at full width, each
    timed and then counted on the card and on ``meta``.  The decode step is
    timed as served, a CUDA graph's replay, and counted through the eager
    step it replays: a replay runs no op that the counter sees."""
    from repro_torch.roofline.analysis import model_flops_estimate

    served = served_model(torch, arch)
    model, ctx, params, inputs, prefill, decode = served
    cfg = model.cfg
    B, prompt = inputs["tokens"].shape
    n = cfg.active_param_count()
    fresh = model.decode_state_init(B, prompt + ROOFLINE_DECODES + 2)
    prefill(params, fresh, inputs)                      # warm-up
    prefill_s = timed_s(torch, lambda: prefill(params, fresh, inputs))
    rows = [count_step(torch, f"{arch} prefill {B}x{prompt}", prefill, (params, fresh, inputs),
                       model_flops_estimate(n, B * prompt, "prefill"), prefill_s)]
    logits, state = prefill(params, fresh, inputs)
    times = []
    for _ in range(ROOFLINE_DECODES):
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = decode(params, state, tok)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    rows.append(count_step(torch, f"{arch} decode step", lambda p, s, t: model.decode_step(p, s, t, ctx=ctx),
                           (params, state, tok), model_flops_estimate(n, B, "decode"), statistics.median(times)))
    del served, params, fresh, state, logits
    torch.cuda.empty_cache()
    return rows


def roofline_train(torch, arch):
    """One train step of ``arch`` at full width, 8 x 1024 tokens (bf16,
    AdamW, remat, as the train phases run it), timed over steps 2-4 and then
    counted on the card and on ``meta``."""
    from repro_torch.config.base import get_config
    from repro_torch.models.model_api import build
    from repro_torch.optim.optimizers import OptimizerConfig
    from repro_torch.roofline.analysis import model_flops_estimate
    from repro_torch.train.step import make_train_step, train_state_init

    cfg = get_config(arch)
    model = build(cfg)
    opt_cfg = OptimizerConfig(name=cfg.optimizer, warmup_steps=1, total_steps=TRAIN_STEPS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    holder = [train_state_init(model, opt_cfg, gen, device="cuda")]
    batch = {key: torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=gen, device="cuda",
                                dtype=torch.int32) for key in ("tokens", "targets")}
    step = make_train_step(model, opt_cfg)

    def one():
        holder[0], _ = step(holder[0], batch)
    one()                                               # warm-up
    seconds = timed_s(torch, one)
    row = count_step(torch, f"{arch} train step {TRAIN_BATCH}x{TRAIN_SEQ}", step, (holder[0], batch),
                     model_flops_estimate(cfg.active_param_count(), TRAIN_BATCH * TRAIN_SEQ, "train"), seconds)
    del holder, batch
    torch.cuda.empty_cache()
    return row


#: The dry-run of a pod's rank (``--mesh single`` / ``multi``): granite and
#: mamba2 served and trained on a rank of (data 16, model 16), granite
#: trained on a rank of (pod 2, data 16, model 16).
POD_CELLS = tuple((arch, shape, "single") for arch in (MOE_ARCH, SSM_ARCH)
                  for shape in ("train_4k", "prefill_32k", "decode_32k")) + ((MOE_ARCH, "train_4k", "multi"),)
#: Seconds the roofline phase may wait for the dry-run's process once the
#: card's phases are done.
DRYRUN_TIMEOUT_S = 600


def dryrun_cells(results) -> None:
    """The dry-run's records, in a process of their own: every cell of
    ROOFLINE_ARCHS on one card, then POD_CELLS (each pod rank's fake
    process group meets no live one), with each part's seconds, put on
    ``results``.  A failure is put there too."""
    try:
        import torch

        from repro_torch.config.base import SHAPES
        from repro_torch.launch.dryrun import run_cell

        torch.set_num_threads(1)
        t0 = time.perf_counter()
        card = [run_cell(arch, shape, "card", verbose=False) for arch in ROOFLINE_ARCHS for shape in SHAPES]
        t1 = time.perf_counter()
        pods = [run_cell(arch, shape, mesh, verbose=False) for arch, shape, mesh in POD_CELLS]
        results.put((card, pods, t1 - t0, time.perf_counter() - t1, None))
    except BaseException:
        import traceback

        results.put((None, None, 0.0, 0.0, traceback.format_exc()))


def start_dryrun():
    """Starts ``dryrun_cells`` in a spawned process (it runs on the host's
    cores beside the card's phases): (process, its results queue)."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    proc = ctx.Process(target=dryrun_cells, args=(results,), daemon=True)
    proc.start()
    return proc, results


def phase_roofline(torch, pending):
    """The dry-run of every cell of ROOFLINE_ARCHS on one card (one line a
    cell; a FAIL fails the run) and of POD_CELLS on a pod's rank, from the
    process ``start_dryrun`` started (``pending``), then the six steps
    counted on the card against ``meta`` with their ``mfu``."""
    t_start = time.perf_counter()
    proc, results = pending
    card, pods, dryrun_s, pod_s, error = results.get(timeout=DRYRUN_TIMEOUT_S)
    proc.join(DRYRUN_TIMEOUT_S)
    check(error is None, f"roofline: the dry-run's process failed:\n{error}")
    waited_s = time.perf_counter() - t_start
    ok = skipped = 0
    for rec in card:
        status = rec["status"]
        check(not status.startswith("FAIL"), f"roofline: dry-run {rec['arch']} x {rec['shape']}: {status}\n"
              + rec.get("traceback", ""))
        line = {"phase": "roofline_cell", "arch": rec["arch"], "shape": rec["shape"], "status": status}
        if status == "OK":
            ok += 1
            t = rec["roofline"]
            line.update(model_flops=rec["model_flops"], flops=rec["cost"]["flops"],
                        bytes=rec["cost"]["bytes"], t_compute_s=t["t_compute_s"],
                        t_memory_s=t["t_memory_s"], peak_gb=rec["memory"]["per_device_total_gb"],
                        fits_hbm=rec["memory"]["fits_hbm"], trace_s=rec["trace_s"])
        else:
            skipped += 1
        emit(line)
    for rec in pods:
        check(rec["status"] == "OK", f"roofline: pod rank {rec['arch']} x {rec['shape']} x {rec['mesh']}: "
              f"{rec['status']}\n" + rec.get("traceback", ""))
        t = rec["roofline"]
        emit({"phase": "roofline_pod_cell", "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
              "mesh_shape": rec["mesh_shape"], "chips": rec["chips"], "params_a_rank": rec["params_a_rank"],
              "rows_a_rank": rec["rows_a_rank"], "peak_gb": rec["memory"]["per_device_total_gb"],
              "fits_hbm": rec["memory"]["fits_hbm"], "t_compute_s": t["t_compute_s"],
              "t_memory_s": t["t_memory_s"], "t_collective_s": t["t_collective_s"], "bottleneck": t["bottleneck"],
              "collectives": rec["collectives"], "trace_s": rec["trace_s"]})
    rows = roofline_serve(torch, MOE_ARCH) + roofline_serve(torch, SSM_ARCH)
    rows += [roofline_train(torch, MOE_ARCH), roofline_train(torch, SSM_ARCH)]
    for row in rows:
        emit(row)
    # Checked once every step has been counted and printed.
    for row in rows:
        check(row["card_equals_meta"], f"roofline {row['step']}: the card's count differs from meta's")
        check(row["records_equal_launches"], f"roofline {row['step']}: records {row['kernels']} "
              f"against launches {row['launches']}")
    emit({"phase": "roofline", "archs": list(ROOFLINE_ARCHS), "cells_ok": ok, "cells_skipped": skipped,
          "dryrun_s": dryrun_s, "pod_cells": len(POD_CELLS), "pod_s": pod_s, "waited_for_dryrun_s": waited_s,
          "steps": len(rows), "seconds": time.perf_counter() - t_start})


# --------------------------------------------------------------------- #


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true",
                    help="print the registers and shared memory ptxas reports for each kernel")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one prefill and four decode steps of each model, and one "
                         "training step, with torch.profiler")
    args = ap.parse_args()
    t_script = time.perf_counter()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device and found none", file=sys.stderr)
        return 1

    # Before anything is printed: without the package beside this script
    # there is nothing to run, and the import error is the whole output.
    from repro_torch.kernels import _loader

    from repro_torch.roofline import hw

    smi = nvidia_smi_line()
    name, _, limit = smi.partition(",")
    emit({"phase": "device", "name": name.strip(), "power_limit": limit.strip(),
          "kind": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "total_memory": torch.cuda.get_device_properties(0).total_memory, "hw_hbm_bytes": hw.HBM_BYTES})

    _loader.lib(verbose=args.ptxas)
    emit({"phase": "build", "seconds": _loader.last_build_seconds,
          "sources": [os.path.relpath(s, ROOT) for s in _loader.sources()],
          "flags": list(_loader.NVCC_FLAGS)})
    # The dry-run needs no card: it runs beside the card's phases.
    pending = start_dryrun()
    try:
        return run_phases(torch, args, smi, pending, t_script)
    finally:
        if pending[0].is_alive():
            pending[0].terminate()
        pending[0].join()


def run_phases(torch, args, smi, pending, t_script) -> int:
    """Every phase after the build, then the ``kernels`` line and the last
    lines."""
    # float32 products in full float32 on both sides of every comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    counts = {"serve": {}}
    with torch.no_grad():
        cases = phase_kernel_checks(torch)
        phase_moe(torch)
        phase_mamba(torch)
        # Each model's counts are read from its own serve run: the MoE
        # kernels from granite's, the scan from mamba2's.
        for arch, kernels_of_path in ((MOE_ARCH, ("topk_gating", "load_histogram", "dispatch_gather",
                                                  "moe_combine", "attention")),
                                      (SSM_ARCH, ("ssd_state_scan",))):
            served = served_model(torch, arch)
            got, row, run = phase_serve(torch, served)
            emit(row)
            counts["serve"].update({k: got[k] for k in kernels_of_path})
            if args.profile:
                phase_profile(torch, served)
            del served, got, run
            torch.cuda.empty_cache()
        # kimi-k2's counts: the MoE kernels at 384 experts.
        counts["families"] = phase_families(torch, profile=args.profile)
        phase_link(torch)
        phase_sim(torch)
        phase_data_pipeline(torch)
        phase_serving_engine(torch)
    # Training needs autograd: outside the no_grad block.  Its counts are
    # of the 4 steps through the loop (forward and recompute, and the
    # scan's backward).
    counts["train"] = phase_train(torch, profile=args.profile)
    counts["train_mamba"] = phase_train_mamba(torch, profile=args.profile)
    counts["ranks"], nccl_train = phase_ranks(torch)
    counts["expert_parallel"] = phase_expert_parallel(torch, nccl_train)
    counts["fsdp"] = phase_fsdp(torch)
    # Its launches are held to its own counter records, not to the paths'.
    phase_roofline(torch, pending)

    rows = []
    prefill_case = {"topk_gating": "prefill_bf16", "load_histogram": "prefill",
                    "dispatch_gather": "prefill_bf16", "ssd_state_scan": "prefill_f32",
                    "ssd_state_scan_bwd": "train_f32", "moe_combine": "train_bf16",
                    "moe_combine_bwd": "train_bf16", "attention": "granite_prefill"}
    for kname, case_name in prefill_case.items():
        mine = [c for c in cases if c["kernel"] == kname]
        c = next(c for c in mine if c["case"] == case_name)
        by_path = {path: got[kname] for path, got in counts.items() if got.get(kname)}
        check(sum(by_path.values()) > 0, f"{kname} was never launched on the main path")
        rows.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(m["max_abs_err"] for m in mine),
            "ms": c["kernel_ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "library_timed": c.get("library_timed", "graph"),
            "host_ms": c["host_ms"], "shape": c["shape"], "bytes": c["bytes"],
        })
        if kname == "topk_gating":
            rows[-1].update(general_ms=c["general_ms"], node_ms=c["node_ms"])
        if kname == "dispatch_gather":
            # The op counter's shape-only record (every slot filled) beside
            # the plan-aware bytes of ``bound_ms``.
            rows[-1].update(shape_bytes=c["shape_bytes"], shape_bound_ms=c["shape_bound_ms"])
        if kname == "attention":
            # The tensor cores' bound, the path it replaced, and head width 128.
            rows[-1].update(flops=c["flops"], chunked_ms=c["chunked_ms"],
                            hd128={k: mine_c[k] for mine_c in mine if mine_c["case"] == "hd128_G4" for k in (
                                "shape", "kernel_ms", "plain_ms", "chunked_ms", "bound_ms", "bound_by",
                                "library_ms", "host_ms", "bytes", "flops")})
        if kname == "ssd_state_scan_bwd":
            # max_abs_err is d_decay's; d_states equals the plain version.
            rows[-1].update(d_states_equal=all(m["d_states_equal"] for m in mine),
                            d_decay_max_rel_err=max(m["d_decay_max_rel_err"] for m in mine),
                            d_decay_rtol=BWD_DECAY_RTOL)
        for other, key in (("kimi_" + case_name, "kimi"), (f"{case_name}_shard{EP_MODEL}", "shard")):
            c = next((c for c in mine if c["case"] == other), None)
            if c is not None:
                rows[-1][key] = {k: c[k] for k in (
                    "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "host_ms", "bytes")}
    emit({"phase": "script", "seconds": time.perf_counter() - t_script})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
