"""Runs ``chip_smoke.py``'s ``fsdp`` and ``roofline`` phases alone on one
GPU, for a first check of their code on the card before the whole script:

    python3 tools/chip_phase.py

The checks are the script's own; without the other phases the ``kernels``
line and the last lines are not printed.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as C  # noqa: E402


def main() -> None:
    import torch
    from repro_torch.kernels import _loader

    _loader.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(C.nvidia_smi_line(), flush=True)
    t = time.perf_counter()
    counts = C.phase_fsdp(torch)
    C.emit({"phase": "runner_fsdp", "counts": counts, "seconds": time.perf_counter() - t})
    t = time.perf_counter()
    C.phase_roofline(torch, C.start_dryrun())
    C.emit({"phase": "runner_roofline", "seconds": time.perf_counter() - t})


if __name__ == "__main__":
    main()
