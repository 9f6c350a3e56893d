"""The state scan and its backward over the traced training steps: summed
least times over summed device time, in %."""

from h100bench.lib import readers


def read(run):
    return readers.scan_roofline_train(run)
