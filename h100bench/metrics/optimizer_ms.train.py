"""Summed device time of the work launched inside the program's optimizer
range (``dyskew.step.optimizer``: the clip and AdamW), ms a traced
training step.  Approximate: the join pairs records with launch calls by
order, and the data pipeline's records on their own stream shift the
pairing near them (``lib/phases.py``)."""

from h100bench.lib import phases


def read(run):
    return phases.device_ms(run, "step.optimizer", None, "steps")
