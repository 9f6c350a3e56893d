"""Summed device time of the work launched inside the program's head range
(``dyskew.head``: the final norm and the logits of every position) in the
traced prefill, ms."""

from h100bench.lib import phases


def read(run):
    return phases.device_ms(run, "head", "prefill")
