"""A round's prefill on the host clock, from the decode state's allocation to
the first tokens on the host: median ms over the window's rounds."""

from h100bench.lib import readers


def read(run):
    return readers.median_ms(run, "prefill")
