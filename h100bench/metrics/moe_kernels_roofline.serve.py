"""The three MoE kernels over the traced prefill and decode steps (each at its
own tokens a call): summed least times over summed device time, in %."""

from h100bench.lib import readers


def read(run):
    return readers.moe_roofline_serve(run)
