"""Run one cell of the benchmark of ``repro_torch`` on the GPUs of this machine.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``; its configuration, traffic mix,
driver and per-layer metric readers are files found by their names.  A run
draws the weights and the traffic from ``--seed``, warms up the cell's
shapes (set-up), measures for ``--seconds``, with ``--trace 1`` profiles a
short stretch after that, frees the program's state and holds what the
timed path produced to the plain reference.  Earlier lines of standard
output say what the run saw; its last line is one JSON object with
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics), ``device``,
``breakdown`` (traced runs) and ``checks`` (each compared number and its
limit), which also end standard error.

It exits non-zero and prints no result without enough CUDA devices, when
any module of ``jax``, ``jaxlib``, ``flax`` or ``repro`` is loaded by the
time the window has closed, or when the program is not beside it.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``, whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> dict:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return {"nvidia_smi": out.stdout.strip()}
    except (OSError, subprocess.SubprocessError) as e:
        return {"nvidia_smi": f"unavailable: {e}"}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device=None, root: Path = ROOT,
             started: float = STARTED):
    """Run the cell; returns (the result object, the earlier lines).  With
    ``device`` given (a CPU in the tests) the look for enough GPUs is
    skipped."""
    import torch

    from h100bench.lib import cell as cellmod
    from h100bench.lib import checks as checksmod
    from h100bench.lib import roofline

    cell = cellmod.load(workload, root)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{workload} needs {cell.chips} CUDA device(s); this machine has "
                             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    run = cellmod.Run(cell=cell, seed=seed, seconds=seconds, trace=trace, device=device, started=started)
    drv = cellmod.driver(cell.mix["driver"]).Driver(run)

    drv.setup()
    t_window = time.perf_counter()
    run.end_to_end["setup_s"] = t_window - started
    drv.window(t_window)
    if trace:
        drv.traced()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        run.peak_bytes = int(torch.cuda.max_memory_allocated(device))
    run.end_to_end["peak_mem_gb"] = run.peak_bytes / 1e9
    drv.release()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = drv.check()

    lines = [{"line": "device", "platform": device.type, "torch": torch.__version__,
              "cuda": torch.version.cuda, "peaks": {"bf16_flops": roofline.PEAK_FLOPS_BF16,
                                                   "hbm_bytes_per_s": roofline.HBM_BW},
              **(card_line() if device.type == "cuda" else {})},
             {"line": "run", "workload": workload, "seed": seed, "seconds": seconds, "trace": int(trace),
              **run.readings},
             {"line": "numbers", **run.numbers}]
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = cellmod.reader(m["name"], root)(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": run.end_to_end[m["name"]], "unit": m["unit"]} for m in cell.end_to_end}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else device.type,
           "count": cell.chips, "memory_peak_bytes": run.peak_bytes}
    result = {"correct": checksmod.passes(checks) and run.failed == 0, "attempted": run.attempted,
              "failed": run.failed, "metrics": metrics, "device": dev}
    if trace and run.traced is not None:
        dev["busy_s"] = run.traced.busy_ns() / 1e9
        dev["window_s"] = (run.traced.t1 - run.traced.t0) / 1e9
        result["breakdown"] = run.traced.breakdown()
    result["checks"] = checks
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    # After the window and the check, in the process that prints the result.
    found = forbidden_modules()
    if found:
        raise SystemExit(f"modules of {found} are loaded: nothing the benchmark runs may import them")
    for line in lines:
        print(json.dumps(line), flush=True)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
