"""The port's own spans and counters, on while a ``torch.profiler`` records.

There is no switch: tracing is on exactly while a profiler is recording in
this process (``torch._C._autograd._profiler_enabled()``), and off it costs
one such check a call.

``span(name)`` is a ``record_function`` range named ``dyskew.<name>`` on the
profiler's clock, beside the device records the range's work launches, on
whichever thread runs it.  Off, it is one shared null context: nothing is
allocated, recorded or launched.  The ranges:

- ``dyskew.step.forward``, ``dyskew.step.backward``, ``dyskew.step.optimizer``
  (``train/step.py``): ``Model.loss``; ``torch.autograd.grad``, remat's
  recompute inside it; ``opt_update``, the clip included.
- ``dyskew.attn`` (``transformer._apply_layer``): ``attention_apply``.
- ``dyskew.moe`` (same): the MoE layer, ``norm2`` through ``moe_apply``.
- ``dyskew.moe.link`` (``moe_apply``): the DySkew link, one range a layer:
  the loads' EMA (from a fresh one for a stateless caller) and the
  effective capacities.
- ``dyskew.head`` (``transformer.forward``): the final norm and the logits.

While a profiler records, ``calling_thread()`` keeps a backward on the
thread that called it, where autograd would otherwise run a device's
backward on a worker thread of its own: the step's records then lie on one
thread, the backward's launches inside ``dyskew.step.backward``, for a
reader of the profile that keeps one thread's records.  It changes the
profiled step, whose backward then runs on another thread than it would
unprofiled; a reader that keeps every thread's records has no need of it.

``counters()`` reads the seconds this process's kernel build took (the
kernel wrappers' launches stay with ``kernels.launch_counts()``) and the
decode steps of ``make_decode_step`` by how they ran: captured into a CUDA
graph, replayed, or eager (``train/decode_graph.py``).
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import torch
from torch.autograd.profiler import record_function

PREFIX = "dyskew."

_enabled = torch._C._autograd._profiler_enabled
_NULL = contextlib.nullcontext()


def span(name: str):
    """A ``dyskew.<name>`` range while a profiler records, else a shared
    null context."""
    return record_function(PREFIX + name) if _enabled() else _NULL


def calling_thread():
    """While a profiler records, a backward inside runs on the calling
    thread (``torch.autograd.set_multithreading_enabled(False)``, which is
    thread-local); else a shared null context."""
    return torch.autograd.set_multithreading_enabled(False) if _enabled() else _NULL


def counters() -> Dict[str, Any]:
    """``kernel_build_s``: the seconds this process's kernel build took,
    None where it built nothing; ``decode_graph_captures``,
    ``decode_graph_replays``, ``decode_eager_steps``: this process's decode
    steps by how they ran."""
    from repro_torch.kernels import _loader
    from repro_torch.train import decode_graph

    return {"kernel_build_s": _loader.last_build_seconds or None, **decode_graph.counts}
