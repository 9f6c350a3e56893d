"""The state scan over the traced prefill: least time over device time, in %."""

from h100bench.lib import readers


def read(run):
    return readers.scan_roofline_serve(run)
