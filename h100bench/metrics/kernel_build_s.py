"""Seconds the program's build of its CUDA kernels took in this process
(``repro_torch.tracing.counters()``); None where it built nothing, or
where the program has no such counter."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.counters()["kernel_build_s"]
