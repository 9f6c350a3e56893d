"""Device kernel records over the traced decode steps, per step."""

from h100bench.lib import readers


def read(run):
    return readers.launches_per_step(run, "decode", "decode_steps")
