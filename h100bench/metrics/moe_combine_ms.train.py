"""Summed device time of the MoE combine's kernels (the port's
``moe_combine_fwd_kernel`` and ``moe_combine_bwd_kernel``: forward, remat's
recompute and backward) over the traced training steps, ms a step; 0 for a
model without an MoE layer.  None where the trace holds no device record
(the CPU), and where the program's own launch counts name no combine kernel
(a program without it); a trace given without those counts is read as it
is."""

KERNELS = ("moe_combine_fwd_kernel", "moe_combine_bwd_kernel")


def read(run):
    if run.traced is None or not run.traced.kernels():
        return None
    if "moe_combine" not in run.readings.get("traced_launches", {"moe_combine": None}):
        return None
    ns = sum(e - s for s, e, name in run.traced.kernels() if any(k in name for k in KERNELS))
    return ns / 1e6 / run.traced_info["steps"]
