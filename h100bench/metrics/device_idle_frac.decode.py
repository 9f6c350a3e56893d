"""Share of the traced decode steps with no device record running, in %."""

from h100bench.lib import readers


def read(run):
    return readers.idle_pct(run, "decode")
