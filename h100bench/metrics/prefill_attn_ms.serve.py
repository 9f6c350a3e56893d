"""Summed device time of the work launched inside the program's attention
ranges (``dyskew.attn``) in the traced prefill, ms."""

from h100bench.lib import phases


def read(run):
    return phases.device_ms(run, "attn", "prefill")
