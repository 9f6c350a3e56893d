"""The three MoE kernels (gating, histogram, gather) over the traced training
steps: their summed least times (``lib.roofline``) over their summed device
time, in %."""

from h100bench.lib import readers


def read(run):
    return readers.moe_roofline_train(run)
