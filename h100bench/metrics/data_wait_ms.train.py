"""The time a training step waited for its batch: the benchmark's span around
``next(pipeline)``, mean ms a step over the untraced window."""

from h100bench.lib import readers


def read(run):
    return readers.mean_ms(run, "data_wait")
