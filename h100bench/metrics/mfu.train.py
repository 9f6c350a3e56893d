"""MODEL_FLOPS (6 x active parameters x tokens) of the untraced window's
steps over its seconds, as a share of the bf16 peak, in %."""

from h100bench.lib import readers


def read(run):
    return readers.mfu(run, "train", run.readings.get("tokens"))
