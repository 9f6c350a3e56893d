"""Summed device time of the work launched inside the program's MoE layer
ranges (``dyskew.moe``) in the traced prefill, ms."""

from h100bench.lib import phases


def read(run):
    return phases.device_ms(run, "moe", "prefill")
