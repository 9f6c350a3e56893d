"""Runs some of ``chip_smoke.py``'s phases alone on one GPU, for a first
check of their code on the card before the whole script:

    python3 tools/chip_phase.py                # the fsdp and roofline phases
    python3 tools/chip_phase.py sim            # the simulator and the paper's claims
    python3 tools/chip_phase.py link sim fsdp  # several, in this order

The checks are the script's own; without the other phases the ``kernels``
line and the last lines are not printed.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402

# Phases that need nothing from an earlier one; those of the first group
# run under no_grad, as in the script.
NO_GRAD = {
    "kernel_checks": C.phase_kernel_checks, "moe": C.phase_moe, "mamba": C.phase_mamba,
    "families": C.phase_families, "link": C.phase_link, "sim": C.phase_sim,
    "data_pipeline": C.phase_data_pipeline, "serving_engine": C.phase_serving_engine,
}
WITH_GRAD = {"train": C.phase_train, "train_mamba": C.phase_train_mamba, "ranks": C.phase_ranks,
             "fsdp": C.phase_fsdp}
PHASES = list(NO_GRAD) + list(WITH_GRAD) + ["roofline"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("phases", nargs="*", metavar="PHASE",
                    help=f"phases to run, in order (default: fsdp roofline); any of {', '.join(PHASES)}")
    args = ap.parse_args()
    args.phases = args.phases or ["fsdp", "roofline"]
    unknown = [p for p in args.phases if p not in PHASES]
    if unknown:
        ap.error(f"unknown phase {', '.join(unknown)}")

    import torch
    from repro_torch.kernels import _loader

    _loader.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(C.nvidia_smi_line(), flush=True)
    pending = C.start_dryrun() if "roofline" in args.phases else None
    try:
        for name in args.phases:
            t = time.perf_counter()
            if name == "roofline":
                C.phase_roofline(torch, pending)
                out = None
            elif name in NO_GRAD:
                with torch.no_grad():
                    out = NO_GRAD[name](torch)
            else:
                out = WITH_GRAD[name](torch)
            row = {"phase": f"runner_{name}", "seconds": time.perf_counter() - t}
            if isinstance(out, dict):
                row["counts"] = out
            C.emit(row)
    finally:
        if pending is not None:
            if pending[0].is_alive():
                pending[0].terminate()
            pending[0].join()


if __name__ == "__main__":
    main()
