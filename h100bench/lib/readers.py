"""Arithmetic the per-layer metric readers share: each reader under
``metrics/`` is one call of these on the run.  A reader returns None when
the run gives it nothing to read (no trace, no such kernel)."""

from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

from h100bench.lib import roofline
from h100bench.lib.weights import DTYPES, dims

PCT = 100.0


def _elem(run) -> int:
    return DTYPES[run.doc["model"].get("dtype", "bfloat16")].itemsize


def _span_range(run, name: str) -> Optional[Tuple[int, int]]:
    t = run.traced
    if t is None:
        return None
    spans = t.spans(name)
    if not spans:
        return None
    return spans[0][0], spans[-1][1]


def _records(run, families: Dict[str, tuple], t0=None, t1=None) -> Dict[str, List[Tuple[int, int, str]]]:
    out: Dict[str, List] = {}
    for rec in run.traced.kernels(t0, t1):
        fam = roofline.kernel_of(rec[2], families)
        if fam:
            out.setdefault(fam, []).append(rec)
    return out


def _moe_bounds(run, tokens: int) -> Dict[str, float]:
    """Each MoE kernel's least time a launch at ``tokens`` tokens a call."""
    from h100bench.reference.link import capacities

    z = dims(run.doc["model"])
    moe = run.doc["model"]["moe"]
    E, k, d = z["E"], z["k"], z["d"]
    _, c_buf = capacities(moe.get("capacity_factor", 1.25), tokens, k, E, moe.get("adaptive", True))
    costs = {
        "topk_gating": roofline.topk_gating(tokens, E, k, _elem(run)),
        "load_histogram": roofline.load_histogram(tokens * k, E),
        "dispatch_gather": roofline.dispatch_gather(E * c_buf, tokens, d * _elem(run)),
    }
    return {f: roofline.bound_s(c["flops"], c["bytes"]) for f, c in costs.items()}


def _scan_bounds(run, batch: int, seq: int) -> Dict[str, float]:
    z = dims(run.doc["model"])
    C = seq // min(z["chunk"], seq) + 1
    costs = {
        "ssd_state_scan": roofline.ssd_state_scan(C, batch * z["nh"], z["P"], z["N"], 4),
        "ssd_state_scan_bwd": roofline.ssd_state_scan_bwd(C, batch * z["nh"], z["P"], z["N"], 4),
    }
    return {f: roofline.bound_s(c["flops"], c["bytes"], roofline.PEAK_FLOPS_FP32) for f, c in costs.items()}


def _share(parts: List[Tuple[Dict[str, List], Dict[str, float]]], launch_names: Dict[str, str]) -> Optional[float]:
    """Summed least times over summed device times of the kernels in
    ``parts`` ([(records by family, least time a launch by family)]).  A
    family's launches are its records named ``launch_names[family]``
    (one more kernel of the same call only adds its time)."""
    bound = busy = 0.0
    for recs, bounds in parts:
        for fam, rs in recs.items():
            busy += sum(e - s for s, e, _ in rs) / 1e9
            first = launch_names.get(fam)
            launches = sum(1 for r in rs if first is None or first in r[2])
            bound += launches * bounds[fam]
    if busy <= 0.0:
        return None
    return PCT * bound / busy


_LAUNCH = {"ssd_state_scan_bwd": "ssd_scan_bwd_kernel"}


def moe_roofline_train(run) -> Optional[float]:
    if run.traced is None or not run.doc["model"].get("moe"):
        return None
    info = run.traced_info
    return _share([(_records(run, roofline.MOE_KERNELS), _moe_bounds(run, info["batch"] * info["seq_len"]))], _LAUNCH)


def moe_roofline_serve(run) -> Optional[float]:
    if run.traced is None or not run.doc["model"].get("moe"):
        return None
    info = run.traced_info
    pf, dec = _span_range(run, "prefill"), _span_range(run, "decode")
    if pf is None or dec is None:
        return None
    return _share([(_records(run, roofline.MOE_KERNELS, *pf), _moe_bounds(run, info["prompts"] * info["prompt_len"])),
                   (_records(run, roofline.MOE_KERNELS, *dec), _moe_bounds(run, info["prompts"]))], _LAUNCH)


def scan_roofline_train(run) -> Optional[float]:
    if run.traced is None or not run.doc["model"].get("mamba"):
        return None
    info = run.traced_info
    return _share([(_records(run, roofline.SCAN_KERNELS), _scan_bounds(run, info["batch"], info["seq_len"]))], _LAUNCH)


def scan_roofline_serve(run) -> Optional[float]:
    if run.traced is None or not run.doc["model"].get("mamba"):
        return None
    info = run.traced_info
    pf = _span_range(run, "prefill")
    if pf is None:
        return None
    return _share([(_records(run, roofline.SCAN_KERNELS, *pf), _scan_bounds(run, info["prompts"], info["prompt_len"]))],
                  _LAUNCH)


def idle_pct(run, span: str) -> Optional[float]:
    rng = _span_range(run, span)
    if rng is None or not run.traced.kernels(*rng):
        return None
    return PCT * (1.0 - run.traced.busy_ns(*rng) / (rng[1] - rng[0]))


def launches_per_step(run, span: str, steps_key: str) -> Optional[float]:
    rng = _span_range(run, span)
    if rng is None:
        return None
    n = len(run.traced.kernels(*rng))
    return n / run.traced_info[steps_key] if n else None


def mfu(run, kind: str, tokens: float) -> Optional[float]:
    if run.device.type != "cuda" or not run.window_s or not tokens:
        return None
    n = roofline.n_active_params(run.doc["model"])
    return PCT * roofline.model_flops(n, int(tokens), kind) / run.window_s / roofline.PEAK_FLOPS_BF16


def mean_ms(run, span: str) -> Optional[float]:
    xs = run.spans.get(span)
    return 1e3 * statistics.fmean(xs) if xs else None


def median_ms(run, span: str) -> Optional[float]:
    xs = run.spans.get(span)
    return 1e3 * statistics.median(xs) if xs else None
