#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for sm_90a).

    python3 chip_smoke.py

builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` with ``nvcc``,
holds each against its plain PyTorch version on the card, runs the DySkew
MoE dispatch through the kernels and through the plain versions side by
side, and then serves ``granite-moe-1b-a400m`` at full width and depth
(random weights from a seed): one prefill of 8 prompts of 1024 tokens and 32
greedy decode steps through ``make_prefill_step`` / ``make_decode_step``.

Standard output is one JSON object per line:

    {"phase": "device", ...}     card, power limit, torch and CUDA versions
    {"phase": "build", ...}      seconds to build the kernel library
    {"phase": "kernel_checks"}   every kernel against its plain version
    {"phase": "moe", ...}        moe_apply, kernel path against plain path
    {"phase": "serve", ...}      the full model: rates, memory, launches
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

ARCH = "granite-moe-1b-a400m"
PREFILL_BATCH, PREFILL_LEN, DECODE_STEPS = 8, 1024, 32
EP_SHARDS = 8

REPLACES = {
    "topk_gating": "src/repro/kernels/topk_gating/kernel.py:51",
    "load_histogram": "src/repro/kernels/histogram/kernel.py:38",
    "dispatch_gather": "src/repro/kernels/dispatch/kernel.py:49",
}
SOURCES = {
    "topk_gating": "src/repro_torch/kernels/csrc/topk_gating.cu",
    "load_histogram": "src/repro_torch/kernels/csrc/histogram.cu",
    "dispatch_gather": "src/repro_torch/kernels/csrc/dispatch.cu",
}


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


def gating_case(torch, name, logits, k, timed):
    from repro_torch.kernels.topk_gating.kernel import topk_gating
    from repro_torch.kernels.topk_gating.ref import topk_gating_ref

    w, idx = topk_gating(logits, k=k)
    torch.cuda.synchronize()
    wr, idxr = topk_gating_ref(logits, k)
    check(w.dtype == torch.float32 and idx.dtype == torch.int32, f"{name}: types")
    check(torch.equal(idx, idxr), f"{name}: top-k indices differ from the plain version")
    # rtol 1e-5 / atol 1e-6: float32 softmax sums taken in another order.
    check(torch.allclose(w, wr, rtol=1e-5, atol=1e-6), f"{name}: weights differ")
    T, E = logits.shape
    out = {
        "kernel": "topk_gating", "case": name, "shape": [T, E, k],
        "dtype": str(logits.dtype).replace("torch.", ""),
        "max_abs_err": float((w - wr).abs().max()) if T else 0.0,
    }
    if timed:
        nbytes = T * E * logits.element_size() + T * k * 8
        # exp, subtract, divide and the sum per element, k compare rounds.
        b_ms, by = bound(nbytes, T * E * (4 + k))
        out.update(
            kernel_ms=time_ms(torch, lambda: topk_gating(logits, k=k)),
            host_ms=host_ms(torch, lambda: topk_gating(logits, k=k)),
            plain_ms=time_ms(torch, lambda: topk_gating_ref(logits, k)),
            library_ms=None,   # no single call: softmax, topk and a division
            library_note="softmax+topk+renormalise (3 calls, no tie order): %.6f ms" % time_ms(
                torch, lambda: _softmax_topk(torch, logits, k)),
            bytes=nbytes, bound_ms=b_ms, bound_by=by,
        )
    return out


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


def dispatch_case(torch, name, x, src, valid, timed):
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
    del out_k, out_r
    return out


def main_path_plan(torch, gen, tokens: int, d: int, E: int, k: int, dtype):
    """Inputs of the three kernels as one MoE layer of the served model
    makes them: router logits of random activations, the picks' expert ids,
    and the routing plan at the uniform capacity."""
    from repro_torch.config.base import get_config
    from repro_torch.kernels.histogram.ref import load_histogram_ref
    from repro_torch.kernels.topk_gating.ref import topk_gating_ref
    from repro_torch.models.layers.moe import capacities, dispatch_plan

    cfg = get_config(ARCH)
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
        cases.append(histogram_case(torch, label, flat_e, E, timed=True))
        cases.append(dispatch_case(torch, f"{label}_bf16", x, src, valid, timed=True))
        cases.append(dispatch_case(torch, f"{label}_f32", x.float(), src, valid, timed=True))
        del x, logits, flat_e, src, valid
    torch.cuda.empty_cache()

    # ---- awkward shapes.  float32 logits sit on a grid of 1/64, so that two
    # logits are equal (a tie, which must go to the lower index) or far
    # enough apart that no rounding of the softmax can reorder them.
    def grid(t):
        return torch.round(t * 64) / 64

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
    cases.append(histogram_case(torch, "N5000011_E384", randint(0, 384, 5000011), 384, False))
    cases.append(histogram_case(torch, "all_one_bin", torch.full((70001,), 5, device="cuda", dtype=torch.int32), 16, False))

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
# Phase 5: the full model, served
# --------------------------------------------------------------------- #


def served_model(torch):
    """The full model with random weights from a seed, its prompt and its
    two serving steps."""
    from repro_torch.config.base import get_config
    from repro_torch.models.layers.moe import SpmdCtx
    from repro_torch.models.model_api import build
    from repro_torch.train.step import make_decode_step, make_prefill_step

    cfg = get_config(ARCH)
    model = build(cfg)
    ctx = SpmdCtx(num_groups=1, num_ep_shards=EP_SHARDS)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = model.init(gen)
    tokens = torch.randint(0, cfg.vocab_size, (PREFILL_BATCH, PREFILL_LEN), generator=gen,
                           device="cuda", dtype=torch.int32)
    torch.cuda.synchronize()
    return model, ctx, params, tokens, make_prefill_step(model, ctx), make_decode_step(model, ctx)


def phase_serve(torch, served):
    from repro_torch import kernels
    from repro_torch.models import transformer

    model, ctx, params, tokens, prefill, decode = served
    cfg = model.cfg
    n_moe = len(transformer.moe_layer_positions(cfg)) * transformer.num_blocks(cfg)

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

    want = n_moe * (1 + DECODE_STEPS)
    for name, n in counts.items():
        check(n == want, f"serve: {name} launched {n} times, expected {want}")
    check(int(state["pos"]) == PREFILL_LEN + DECODE_STEPS, "serve: pos")
    stacked = torch.cat(all_logits, dim=1).float()
    check(stacked.shape == (PREFILL_BATCH, 1 + DECODE_STEPS, cfg.padded_vocab), "serve: logits shape")
    check(bool(torch.isfinite(stacked).all()), "serve: logits not finite")
    check(bool((stacked[..., cfg.vocab_size:] == torch.finfo(transformer.model_dtype(cfg)).min).all()),
          "serve: pad-vocab logits not masked")
    check(all(int(t.max()) < cfg.vocab_size and int(t.min()) >= 0 for t in toks), "serve: token out of vocab")
    check(len({tuple(t.flatten().tolist()) for t in toks}) > 1, "serve: decode repeats one token")

    # Link telemetry: Model.prefill drops the new link states, so one more
    # forward with carried state reads them (after the counts were taken).
    _, aux = transformer.forward(params, tokens, cfg=cfg, ctx=ctx, dyskew=model.dyskew_init(ctx))
    metrics = {k: float(v) for k, v in aux["metrics"].items()}
    check(all(v == v for v in metrics.values()), "serve: a metric is NaN")
    link = aux["dyskew"]["l0"]["link"]
    check(link["tick"].tolist() == [1] * transformer.num_blocks(cfg), "serve: link tick")

    emit({
        "phase": "serve", "arch": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
        "experts": cfg.moe.num_experts, "top_k": cfg.moe.top_k, "vocab": cfg.vocab_size,
        "dtype": cfg.dtype, "params": model.num_params(),
        "prefill_tokens": PREFILL_BATCH * PREFILL_LEN, "prefill_s": prefill_s,
        "prefill_tokens_per_s": PREFILL_BATCH * PREFILL_LEN / prefill_s,
        "decode_steps": DECODE_STEPS, "decode_s": decode_s,
        "decode_tokens_per_s": PREFILL_BATCH * DECODE_STEPS / decode_s,
        "decode_ms_per_step": decode_s / DECODE_STEPS * 1e3,
        "peak_memory_bytes": peak, "launches": counts,
        "moe_dropped_frac": metrics["moe_dropped_frac"],
        "moe_distribute_frac": metrics["moe_distribute_frac"],
        "moe_shard_imbalance": metrics["moe_shard_imbalance"],
    })
    return counts


def phase_profile(torch, served, decode_steps: int = 4):
    """Optional: where the device time of one prefill and of a few decode
    steps goes, by kernel name, and how much of the wall time the card was
    busy at all."""
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
        rows = []
        for evt in prof.key_averages():
            # Rows of the device's own events only: a host operator's row
            # repeats the time of the kernels it launched.
            if evt.device_type != DeviceType.CUDA:
                continue
            dev_us = getattr(evt, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(evt, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((evt.key, dev_us / 1e3, evt.count))
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        check(busy_ms > 0.0, f"profile {what}: the trace shows no device time")
        emit({
            "phase": "profile", "what": what, "steps": 1 if what == "prefill" else decode_steps,
            "wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_idle_share": 1.0 - busy_ms / wall_ms,
            "device_launches": sum(r[2] for r in rows),
            "top": [{"name": n[:80], "ms": ms, "calls": c} for n, ms, c in rows[:14]],
            "ours": [{"name": n[:80], "ms": ms, "calls": c} for n, ms, c in rows
                     if "dyskew" in n or "topk_gating_kernel" in n or "histogram_kernel" in n
                     or "counts_to_float" in n or "dispatch_vec_kernel" in n or "dispatch_bytes_kernel" in n],
        })

    run("prefill")
    run("decode")


# --------------------------------------------------------------------- #


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ptxas", action="store_true",
                    help="print the registers and shared memory ptxas reports for each kernel")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one prefill and four decode steps with torch.profiler")
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

    with torch.no_grad():
        cases = phase_kernel_checks(torch)
        phase_moe(torch)
        served = served_model(torch)
        counts = phase_serve(torch, served)
        if args.profile:
            phase_profile(torch, served)

    rows = []
    prefill_case = {"topk_gating": "prefill_bf16", "load_histogram": "prefill",
                    "dispatch_gather": "prefill_bf16"}
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
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
