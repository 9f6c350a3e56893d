"""Performance-tuning flags.

Defaults are the straightforward baseline implementation; each flag is one
hypothesis→change pair.  Flags live in a contextvar so a caller can A/B a
path without touching model code.  ``repro.models.perf_flags`` also
carries H3, H5 and H11, GSPMD layout hints that the port's explicit
collectives express by where they sit; H6 and H10 are rule tables
(``launch/dryrun.py::make_rules``).
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses


@dataclasses.dataclass(frozen=True)
class PerfFlags:
    # H1: skip fully-masked kv positions in causal attention (each query
    # chunk attends only the kv prefix up to its last position) — targets
    # the ~2× causal flop waste of attending the whole cache.
    causal_skip: bool = False
    # H2: cast float32 master parameters to bf16 on a rank's FSDP slice,
    # before the all-gather — the gathers (and the backward's
    # reduce-scatters) move half the bytes.
    cast_before_gather: bool = False
    # H8: constrain gradients to the parameter sharding.  The port's FSDP
    # gradients always come back reduce-scattered, so it changes nothing.
    constrain_grads: bool = False
    # H9: MoE combine via scatter-add of weighted expert outputs by token,
    # instead of k gathers from the (E, C, d) expert output buffer.
    moe_scatter_combine: bool = False


_FLAGS: contextvars.ContextVar[PerfFlags] = contextvars.ContextVar(
    "perf_flags", default=PerfFlags()
)


def get_flags() -> PerfFlags:
    return _FLAGS.get()


@contextlib.contextmanager
def use_flags(flags: PerfFlags):
    token = _FLAGS.set(flags)
    try:
        yield
    finally:
        _FLAGS.reset(token)
