"""Device work launched inside the program's DySkew link ranges
(``dyskew.moe.link``: a served call's fresh link state and the tick) over
the traced decode steps, a step."""

from h100bench.lib import phases


def read(run):
    return phases.launches_per_step(run, "moe.link", "decode", "decode_steps")
