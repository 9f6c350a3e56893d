"""Performance-tuning flags.

Defaults are the straightforward baseline implementation; each flag is one
hypothesis→change pair.  Flags live in a contextvar so a caller can A/B a
path without touching model code.  Only the flags that a single-device path
reads are kept: ``repro.models.perf_flags`` also carries flags that steer
cross-device sharding, which have no counterpart on one card.
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
