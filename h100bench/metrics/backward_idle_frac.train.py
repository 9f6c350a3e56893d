"""Share of the traced training steps' backward (the program's
``dyskew.step.backward`` ranges) with no device record running, in %."""

from h100bench.lib import phases


def read(run):
    return phases.idle_pct(run, "step.backward")
