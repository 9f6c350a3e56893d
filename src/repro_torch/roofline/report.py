"""Render the dry-run record directory into the roofline table (and pick
hillclimb candidates).  The port's copy of ``repro.roofline.report``: the
same records render the same text.

    PYTHONPATH=src python -m repro_torch.roofline.report /tmp/dryrun
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List


def load_records(dirname: str) -> List[Dict]:
    out = []
    for f in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(f) as fh:
            out.append(json.load(fh))
    order = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}
    out.sort(key=lambda r: (r["arch"], order.get(r["shape"], 9), r["mesh"]))
    return out


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-4:
        return f"{x*1e6:.1f}µs"
    if x < 0.1:
        return f"{x*1e3:.2f}ms"
    return f"{x:.3f}s"


def fmt_bytes(x: float) -> str:
    for unit, div in (("TB", 1e12), ("GB", 1e9), ("MB", 1e6), ("KB", 1e3)):
        if x >= div:
            return f"{x/div:.1f}{unit}"
    return f"{x:.0f}B"


def roofline_table(records: List[Dict], mesh: str = "single") -> str:
    rows = [
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck "
        "| MODEL/HLO flops | coll bytes (global) | mem/dev | fits |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in records:
        if r["mesh"] != mesh:
            continue
        if r.get("status") != "OK":
            rows.append(
                f"| {r['arch']} | {r['shape']} | — | — | — | — | — | — | — | "
                f"{r['status'].split(':')[0]} |"
            )
            continue
        t = r["roofline"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {fmt_s(t['t_compute_s'])} "
            f"| {fmt_s(t['t_memory_s'])} | {fmt_s(t['t_collective_s'])} "
            f"| **{t['bottleneck']}** | {t['useful_flops_ratio']:.3f} "
            f"| {fmt_bytes(t['collective_bytes_global'])} "
            f"| {r['memory']['per_device_total_gb']:.2f}GB "
            f"| {'✓' if r['memory']['fits_hbm'] else 'OVER'} |"
        )
    return "\n".join(rows)


def pick_hillclimb_candidates(records: List[Dict]) -> Dict[str, Dict]:
    """Worst roofline fraction, most collective-bound, most
    technique-representative (MoE train cell with the largest expert count)."""
    ok = [r for r in records if r.get("status") == "OK" and r["mesh"] == "single"]

    def frac(r):
        t = r["roofline"]
        tot = t["t_compute_s"] + t["t_memory_s"] + t["t_collective_s"]
        return t["t_compute_s"] / tot if tot else 0.0

    worst = min(ok, key=lambda r: (frac(r) if r["roofline"]["t_compute_s"] > 0
                                   else 1.0))
    coll = max(ok, key=lambda r: r["roofline"]["t_collective_s"])
    moe_train = [
        r for r in ok
        if r["shape"] == "train_4k" and "moe" in r["arch"] or
        r["arch"].startswith("kimi")
    ]
    rep = max(moe_train, key=lambda r: r["roofline"]["t_collective_s"]) \
        if moe_train else coll
    return {"worst_fraction": worst, "most_collective": coll,
            "technique_representative": rep}


if __name__ == "__main__":
    import sys

    recs = load_records(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun_torch")
    print("## Single mesh (one H100)\n")
    print(roofline_table(recs, "single"))
    picks = pick_hillclimb_candidates(recs)
    print("\nHillclimb candidates:")
    for k, r in picks.items():
        print(f"  {k}: {r['arch']} × {r['shape']}")
