"""Share of the traced training steps' forward (the program's
``dyskew.step.forward`` ranges) with no device record running, in %."""

from h100bench.lib import phases


def read(run):
    return phases.idle_pct(run, "step.forward")
