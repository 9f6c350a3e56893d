#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for sm_90a).

    python3 chip_smoke.py

builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` with ``nvcc``,
holds each against its plain PyTorch version on the card, runs the DySkew
MoE dispatch and one full-width Mamba-2 layer through the kernels and
through the plain versions side by side, and then serves two models at full
width and depth (random weights from a seed), each with one prefill of 8
prompts of 1024 tokens and 32 greedy decode steps through
``make_prefill_step`` / ``make_decode_step``: ``granite-moe-1b-a400m``,
whose 24 MoE layers run the three dispatch kernels, and ``mamba2-1.3b``,
whose 48 Mamba-2 layers run the state-scan kernel in every prefill.

Standard output is one JSON object per line:

    {"phase": "device", ...}     card, power limit, torch and CUDA versions
    {"phase": "build", ...}      seconds to build the kernel library
    {"phase": "gating_sweep"}    the gating kernel over E, k, T and dtype
    {"phase": "kernel_checks"}   every kernel against its plain version
    {"phase": "moe", ...}        moe_apply, kernel path against plain path
    {"phase": "mamba", ...}      one Mamba-2 layer, kernel scan against plain
    {"phase": "serve", ...}      per model: rates, memory, launches
    {"phase": "profile", ...}    only with --profile: device time by kernel
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
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_OPS_PER_S = 67e12         # H100 SXM data sheet, outside the tensor cores

MOE_ARCH = "granite-moe-1b-a400m"
SSM_ARCH = "mamba2-1.3b"
PREFILL_BATCH, PREFILL_LEN, DECODE_STEPS = 8, 1024, 32
EP_SHARDS = 8

REPLACES = {
    "topk_gating": "src/repro/kernels/topk_gating/kernel.py:51",
    "load_histogram": "src/repro/kernels/histogram/kernel.py:38",
    "dispatch_gather": "src/repro/kernels/dispatch/kernel.py:49",
    "ssd_state_scan": "src/repro/kernels/ssd_scan/kernel.py:43",
}
SOURCES = {
    "topk_gating": "src/repro_torch/kernels/csrc/topk_gating.cu",
    "load_histogram": "src/repro_torch/kernels/csrc/histogram.cu",
    "dispatch_gather": "src/repro_torch/kernels/csrc/dispatch.cu",
    "ssd_state_scan": "src/repro_torch/kernels/csrc/ssd_state_scan.cu",
}

# The device kernels of csrc/, as the profiler names them.
PORT_KERNEL_NAMES = (
    "topk_gating_group_kernel", "topk_gating_warp_kernel", "histogram_block_kernel",
    "histogram_cluster_kernel", "dispatch_gather_kernel", "dispatch_bytes_kernel",
    "ssd_scan_vec_kernel", "ssd_scan_scalar_kernel",
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
    by_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    by_ops = operations / FP32_OPS_PER_S * 1e3
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
        nbytes = T * E * logits.element_size() + T * k * 8
        # exp, subtract, divide and the sum per element, k compare rounds.
        b_ms, by = bound(nbytes, T * E * (4 + k))
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
        in_range = ids[(ids >= 0) & (ids < E)]
        nbytes = ids.numel() * 4 + E * 4
        b_ms, by = bound(nbytes, ids.numel())
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
        row = D * x.element_size()
        live = valid != 0
        rows_read = int(torch.unique(src[live]).numel())
        nbytes = rows_read * row + src.numel() * row + src.numel() * 5
        b_ms, by = bound(nbytes, 0)
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
        plane = H * P * N
        live = C - 1
        nbytes = live * plane * states.element_size() + live * H * 4 + C * plane * 4
        b_ms, by = bound(nbytes, 2 * live * plane)
        out.update(
            kernel_ms=time_ms(torch, lambda: ssd_state_scan(states, decay)),
            host_ms=host_ms(torch, lambda: ssd_state_scan(states, decay)),
            plain_ms=time_ms(torch, lambda: ssd_state_scan_ref(states, decay)),
            library_ms=None,   # no single PyTorch call computes this prefix
            bytes=nbytes, bound_ms=b_ms, bound_by=by,
        )
    del out_k, out_r
    return out


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


def main_path_plan(torch, gen, tokens: int, d: int, E: int, k: int, dtype):
    """Inputs of the three kernels as one MoE layer of the served model
    makes them: router logits of random activations, the picks' expert ids,
    and the routing plan at the uniform capacity."""
    from repro_torch.config.base import get_config
    from repro_torch.kernels.histogram.ref import load_histogram_ref
    from repro_torch.kernels.topk_gating.ref import topk_gating_ref
    from repro_torch.models.layers.moe import capacities, dispatch_plan

    cfg = get_config(MOE_ARCH)
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
    E, k, d = 32, 8, 1024
    for label, tokens in (("prefill", PREFILL_BATCH * PREFILL_LEN), ("decode", PREFILL_BATCH)):
        x, logits, flat_e, src, valid = main_path_plan(torch, gen, tokens, d, E, k, torch.bfloat16)
        cases.append(gating_case(torch, f"{label}_bf16", logits, k, timed=True))
        check(cases[-1]["path"] == "group", f"gating {label}: the served shape must take the group path")
        cases.append(gating_case(torch, f"{label}_bf16_warp", logits, k, False, general=True))
        cases.append(histogram_case(torch, label, flat_e, E, timed=True))
        served = label == "prefill"
        cases.append(dispatch_case(torch, f"{label}_bf16", x, src, valid, timed=True, controls=served))
        cases.append(dispatch_case(torch, f"{label}_f32", x.float(), src, valid, timed=True, controls=served))
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
    cases.append(ssd_case(torch, "prefill_bf16_states", states.bfloat16(), decay, False))
    del states, decay
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
            st_k = moe.moe_state_init(cfg, ctx)
            st_p = moe.moe_state_init(cfg, ctx)
            dropped, distribute = [], []
            for step in range(steps):
                x = torch.randn((B, S, d), generator=gen, device="cuda")
                x = torch.clamp(torch.round(x * 4) / 4, -6.0, 6.0)
                y_k, st_k, m_k = moe.moe_apply(p, x, cfg=cfg, state=st_k, ctx=ctx, ops=kern.ops)
                y_p, st_p, m_p = moe.moe_apply(p, x, cfg=cfg, state=st_p, ctx=ctx, ops=plain.ops)
                torch.cuda.synchronize()
                where = f"moe alpha={alpha} {mode} step {step}"
                check(torch.equal(kern.last["gating"][1][1], plain.last["gating"][1][1]), f"{where}: picks")
                check(torch.equal(kern.last["histogram"][1], plain.last["histogram"][1]), f"{where}: counts")
                # The dispatch step's inputs ARE the plan: which slot is fed
                # (valid, hence keep) and by which token (src).
                (_, src_k, valid_k), _ = kern.last["dispatch"]
                (_, src_p, valid_p), _ = plain.last["dispatch"]
                check(torch.equal(valid_k, valid_p), f"{where}: keep")
                check(torch.equal(src_k[valid_k], src_p[valid_p]), f"{where}: slots")
                check(torch.equal(kern.last["dispatch"][1], plain.last["dispatch"][1]), f"{where}: buffer")
                for key in ("state", "strikes", "transitions", "tick"):
                    check(torch.equal(st_k["link"][key], st_p["link"][key]), f"{where}: link {key}")
                for key, v in st_k["link"]["metrics"].items():
                    check(torch.equal(v, st_p["link"]["metrics"][key]), f"{where}: link metric {key}")
                check(torch.equal(st_k["ema_loads"], st_p["ema_loads"]), f"{where}: ema_loads")
                for key in ("moe_dropped_frac", "moe_distribute_frac"):
                    check(float(m_k[key]) == float(m_p[key]), f"{where}: {key}")
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


def phase_mamba(torch):
    """One Mamba-2 layer of mamba2-1.3b at full width (d_model 2048, 64
    heads of 64, d_state 128) over 8 x 1024 tokens from a carried, non-zero
    decode state, in float32 so that only the scan differs: once with the
    kernel, once with the plain scan."""
    import dataclasses
    import math

    from repro_torch import kernels
    from repro_torch.config.base import get_config
    from repro_torch.kernels.ssd_scan.ref import ssd_state_scan_ref
    from repro_torch.models.layers.mamba2 import mamba_apply, mamba_specs, mamba_state_init
    from repro_torch.models.param import tree_materialize

    cfg = dataclasses.replace(get_config(SSM_ARCH), dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(2)
    p = tree_materialize(mamba_specs(cfg), gen, dtype_override=torch.float32)
    # dt_bias and A_log drawn as Mamba-2's own initialisation draws them (dt
    # log-uniform in [0.001, 0.1], A uniform in [1, 16]), so that the chunk
    # decays spread over (0, 1); the model's zero init puts them near 0.
    nh = p["A_log"].shape[0]
    u = torch.rand(nh, generator=gen, device="cuda")
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(0.1) - math.log(1e-3)))
    p["dt_bias"] = dt0 + torch.log(-torch.expm1(-dt0))          # softplus(dt_bias) = dt0
    p["A_log"] = torch.log(1.0 + 15.0 * torch.rand(nh, generator=gen, device="cuda"))
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


def served_model(torch, arch):
    """The full model with random weights from a seed, its prompt and its
    two serving steps."""
    from repro_torch.config.base import get_config
    from repro_torch.models.layers.moe import SpmdCtx
    from repro_torch.models.model_api import build
    from repro_torch.train.step import make_decode_step, make_prefill_step

    cfg = get_config(arch)
    model = build(cfg)
    ctx = SpmdCtx(num_groups=1, num_ep_shards=EP_SHARDS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    return model, ctx, params, tokens, make_prefill_step(model, ctx), make_decode_step(model, ctx)


def expected_launches(cfg):
    """Launches of each kernel in one prefill and DECODE_STEPS decode steps:
    the MoE kernels once per MoE layer and step, the scan once per Mamba
    layer and prefill (decode is the recurrent update, with no scan)."""
    from repro_torch.models import transformer

    nb = transformer.num_blocks(cfg)
    n_moe = len(transformer.moe_layer_positions(cfg)) * nb
    n_mamba = len(transformer.mamba_layer_positions(cfg)) * nb
    moe = n_moe * (1 + DECODE_STEPS)
    return {"topk_gating": moe, "load_histogram": moe, "dispatch_gather": moe,
            "ssd_state_scan": n_mamba}


def phase_serve(torch, served):
    from repro_torch import kernels
    from repro_torch.models import transformer

    model, ctx, params, tokens, prefill, decode = served
    cfg = model.cfg

    def serve_once():
        state = model.decode_state_init(PREFILL_BATCH, PREFILL_LEN + DECODE_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, state = prefill(params, state, {"tokens": tokens})
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        all_logits, toks = [logits], []
        t0 = time.perf_counter()
        for _ in range(DECODE_STEPS):
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            toks.append(tok)
            logits, state = decode(params, state, tok)
            all_logits.append(logits)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        return state, all_logits, toks, prefill_s, decode_s

    # A first, uncounted pass pays the one-off costs (library handles, the
    # allocator's first blocks), so that the counted pass is a steady one.
    serve_once()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    state, all_logits, toks, prefill_s, decode_s = serve_once()
    counts = kernels.launch_counts()
    peak = torch.cuda.max_memory_allocated()

    want = expected_launches(cfg)
    check(set(counts) == set(want), f"serve: kernels {sorted(counts)}")
    for name, n in counts.items():
        check(n == want[name], f"serve {cfg.name}: {name} launched {n} times, expected {want[name]}")
    check(int(state["pos"]) == PREFILL_LEN + DECODE_STEPS, "serve: pos")
    stacked = torch.cat(all_logits, dim=1).float()
    check(stacked.shape == (PREFILL_BATCH, 1 + DECODE_STEPS, cfg.padded_vocab), "serve: logits shape")
    check(bool(torch.isfinite(stacked).all()), "serve: logits not finite")
    check(bool((stacked[..., cfg.vocab_size:] == torch.finfo(transformer.model_dtype(cfg)).min).all()),
          "serve: pad-vocab logits not masked")
    check(all(int(t.max()) < cfg.vocab_size and int(t.min()) >= 0 for t in toks), "serve: token out of vocab")
    distinct = len({tuple(t.flatten().tolist()) for t in toks})
    check(distinct > 1, "serve: decode repeats one token")

    row = {
        "phase": "serve", "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "vocab": cfg.vocab_size, "dtype": cfg.dtype, "params": model.num_params(),
        "prefill_tokens": PREFILL_BATCH * PREFILL_LEN, "prefill_s": prefill_s,
        "prefill_tokens_per_s": PREFILL_BATCH * PREFILL_LEN / prefill_s,
        "decode_steps": DECODE_STEPS, "decode_s": decode_s,
        "decode_tokens_per_s": PREFILL_BATCH * DECODE_STEPS / decode_s,
        "decode_ms_per_step": decode_s / DECODE_STEPS * 1e3,
        "peak_memory_bytes": peak, "launches": counts, "distinct_decode_steps": distinct,
    }
    if cfg.moe is not None:
        # Link telemetry: Model.prefill drops the new link states, so one
        # more forward with carried state reads them (after the counts were
        # taken).
        _, aux = transformer.forward(params, tokens, cfg=cfg, ctx=ctx, dyskew=model.dyskew_init(ctx))
        metrics = {k: float(v) for k, v in aux["metrics"].items()}
        check(all(v == v for v in metrics.values()), "serve: a metric is NaN")
        link = aux["dyskew"]["l0"]["link"]
        check(link["tick"].tolist() == [1] * transformer.num_blocks(cfg), "serve: link tick")
        row.update(experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                   moe_dropped_frac=metrics["moe_dropped_frac"],
                   moe_distribute_frac=metrics["moe_distribute_frac"],
                   moe_shard_imbalance=metrics["moe_shard_imbalance"])
    if cfg.mamba is not None:
        row.update(ssm_heads=cfg.mamba.num_heads(cfg.d_model), d_state=cfg.mamba.d_state,
                   chunk=cfg.mamba.chunk,
                   ssm_state_bytes=sum(v["ssm"].numel() * 4 for k, v in state.items()
                                       if k.startswith("ssm_l")))
    emit(row)
    return counts


def phase_profile(torch, served, decode_steps: int = 4):
    """Optional: where the device time of one prefill and of a few decode
    steps goes, by kernel name and by the PyTorch operator that launched
    the kernel, and how much of the wall time the card was busy at all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model, _, params, tokens, prefill, decode = served

    def run(what):
        state = model.decode_state_init(PREFILL_BATCH, PREFILL_LEN + decode_steps)
        logits, state = prefill(params, state, {"tokens": tokens})
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            if what == "prefill":
                fresh = model.decode_state_init(PREFILL_BATCH, PREFILL_LEN + decode_steps)
                prefill(params, fresh, {"tokens": tokens})
            else:
                for _ in range(decode_steps):
                    tok = torch.argmax(logits, dim=-1).to(torch.int32)
                    logits, state = decode(params, state, tok)
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
            "phase": "profile", "arch": model.cfg.name, "what": what, "steps": 1 if what == "prefill" else decode_steps,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_launches": sum(r[2] for r in rows),
            "top": [{"name": n[:80], "ms": ms, "calls": c} for n, ms, c in rows[:14]],
            "top_ops": [{"op": n, "ms": ms, "calls": c} for n, ms, c in by_op[:14]],
            "ours": [{"name": n[:80], "ms": ms, "calls": c} for n, ms, c in rows
                     if any(k in n for k in PORT_KERNEL_NAMES)],
            "memsets": sum(c for n, _, c in rows if "memset" in n.lower()),
        })

    run("prefill")
    run("decode")


# --------------------------------------------------------------------- #


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true",
                    help="print the registers and shared memory ptxas reports for each kernel")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one prefill and four decode steps of each model with torch.profiler")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device and found none", file=sys.stderr)
        return 1

    # Before anything is printed: without the package beside this script
    # there is nothing to run, and the import error is the whole output.
    from repro_torch.kernels import _loader

    smi = nvidia_smi_line()
    name, _, limit = smi.partition(",")
    emit({"phase": "device", "name": name.strip(), "power_limit": limit.strip(),
          "kind": torch.cuda.get_device_name(0), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    _loader.lib(verbose=args.ptxas)
    emit({"phase": "build", "seconds": _loader.last_build_seconds,
          "sources": [os.path.relpath(s, ROOT) for s in _loader.sources()],
          "flags": list(_loader.NVCC_FLAGS)})

    # float32 products in full float32 on both sides of every comparison.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    counts = {}
    with torch.no_grad():
        cases = phase_kernel_checks(torch)
        phase_moe(torch)
        phase_mamba(torch)
        # Each model's counts are read from its own serve run: the MoE
        # kernels from granite's, the scan from mamba2's.
        for arch, kernels_of_path in ((MOE_ARCH, ("topk_gating", "load_histogram", "dispatch_gather")),
                                      (SSM_ARCH, ("ssd_state_scan",))):
            served = served_model(torch, arch)
            got = phase_serve(torch, served)
            counts.update({k: got[k] for k in kernels_of_path})
            if args.profile:
                phase_profile(torch, served)
            del served, got
            torch.cuda.empty_cache()

    rows = []
    prefill_case = {"topk_gating": "prefill_bf16", "load_histogram": "prefill",
                    "dispatch_gather": "prefill_bf16", "ssd_state_scan": "prefill_f32"}
    for kname, case_name in prefill_case.items():
        mine = [c for c in cases if c["kernel"] == kname]
        c = next(c for c in mine if c["case"] == case_name)
        check(counts[kname] > 0, f"{kname} was never launched on the main path")
        rows.append({
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": counts[kname],
            "max_abs_err": max(m["max_abs_err"] for m in mine),
            "ms": c["kernel_ms"], "plain_ms": c["plain_ms"], "bound_ms": c["bound_ms"],
            "bound_by": c["bound_by"], "library_ms": c["library_ms"],
            "library_timed": c.get("library_timed", "graph"),
            "host_ms": c["host_ms"], "shape": c["shape"], "bytes": c["bytes"],
        })
        if kname == "topk_gating":
            rows[-1].update(general_ms=c["general_ms"], node_ms=c["node_ms"])
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
