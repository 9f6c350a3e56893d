"""The serve decode step as one CUDA graph replay.

A decode step is one forward of a fixed shape, called once a generated
token.  Run eagerly on the card it is bound by the host: each of its few
thousand small kernels is a Python call and a launch, and the device sits
idle most of the step.  ``graphed`` wraps the eager step so that on a CUDA
device it is captured once into a ``torch.cuda.CUDAGraph`` and replayed.

Which calls are captured: those whose token and decode-state counter lie on
a CUDA device, under an ``SpmdCtx`` with no process group.  A collective
inside a graph would have to be captured alike on every rank, and gloo's
cannot be; so multi-rank callers, like CPU and ``meta`` ones, run the eager
step.  There is no switch.

The key.  A graph reads and writes the addresses it was captured with, and
runs the ops its capture's Python chose.  So a graph is keyed on the
token's and the counter's shapes, dtypes and device; on every tensor leaf
of the parameters and of the decode state but the counter (its place in
the tree, address, shape, strides and dtype); and on the port's
``PerfFlags``, which choose ops while the step is captured.  A key's first
call runs eagerly (the warm-up, and its result is the step's); its second
captures and replays; later calls replay.  ``GraphCache`` holds at most
``KEEP`` keys, the most recently used, and the oldest goes with its graph
and its memory pool.  A serving loop that allocates a fresh state every
round gets the same blocks back from the allocator, or two sets in turn.

A replay copies the token and the counter into the graph's static inputs,
replays, and returns a copy of the logits and of the advanced counter, so
that no tensor it returned is overwritten by a later call; the state it
returns holds the caller's caches, which the step writes in place.  The
capture checks that: a step that returns any other state tensor than the
one it was given (the counter aside) raises, since its graph would serve
a stale state.  A capture that fails raises.

Counts.  ``kernels.launch_counts()`` counts the wrappers' calls, so a
graphed step counts its kernels at its eager call and at its capture, and a
replay, which calls no wrapper, counts none: the kernels a replay runs are
seen in its device records (``torch.profiler``).  ``counts`` holds the
steps of every graphed callable in this process by how they ran
(``tracing.counters()`` reads them).
"""

from __future__ import annotations

import collections
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.models.perf_flags import get_flags

#: Captured keys held per decode callable.
KEEP = 2

#: Decode steps of this process by how they ran.
counts: Dict[str, int] = {"decode_graph_captures": 0, "decode_graph_replays": 0, "decode_eager_steps": 0}

Step = Callable[[Any, Dict, torch.Tensor], Tuple[torch.Tensor, Dict]]


def _where(t: torch.Tensor) -> Tuple:
    return t.data_ptr(), tuple(t.shape), t.stride(), t.dtype


def graph_key(params: Any, state: Dict, token: torch.Tensor) -> Tuple:
    """What a captured step depends on besides the token's and the
    counter's values (see the module's docstring)."""
    pos = state["pos"]
    return ((tuple(token.shape), token.dtype, token.device, tuple(pos.shape), pos.dtype),
            get_flags(),
            tuple((path, _where(t)) for path, t in flatten_with_paths(params)),
            tuple((path, _where(t)) for path, t in flatten_with_paths(state) if path != "pos"))


def check_in_place(state: Dict, out: Dict) -> None:
    """Raise unless the state a step returned holds the tensors it was
    given, the counter aside: a replay returns the given ones."""
    given, got = dict(flatten_with_paths(state)), dict(flatten_with_paths(out))
    moved = [path for path in sorted(set(given) | set(got)) if path != "pos" and got.get(path) is not given.get(path)]
    if moved:
        raise ValueError(f"a captured decode step returned new state tensors at {moved}: its graph would "
                         "serve a stale state, so the step must write them in place")


class GraphCache:
    """The graphs of one decode callable, by key, at most ``KEEP`` of them:
    the least recently used beyond that are dropped with what they held."""

    def __init__(self):
        self._held: "collections.OrderedDict[Any, Optional[Captured]]" = collections.OrderedDict()

    def get_or_capture(self, key: Any, capture: Callable[[], "Captured"]) -> Optional["Captured"]:
        """None at ``key``'s first call (the caller runs the step eagerly);
        at its second the graph ``capture()`` makes, held from then on; at
        later calls that graph.  The key becomes the most recent."""
        if key not in self._held:
            self._held[key] = None
            while len(self._held) > KEEP:
                self._held.popitem(last=False)
            return None
        self._held.move_to_end(key)
        if self._held[key] is None:
            self._held[key] = capture()
        return self._held[key]


class Captured:
    """One decode step captured with its static token and counter, and the
    logits and advanced counter it writes.  Its first call is counted as
    the capture, later ones as replays."""

    def __init__(self, step: Step, params: Any, state: Dict, token: torch.Tensor):
        self.token = token.clone()
        self.pos = state["pos"].clone()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits, out = step(params, dict(state, pos=self.pos), self.token)
        check_in_place(state, out)
        self.next_pos = out["pos"]
        self.replayed = False

    def __call__(self, state: Dict, token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        counts["decode_graph_replays" if self.replayed else "decode_graph_captures"] += 1
        self.replayed = True
        self.token.copy_(token)
        self.pos.copy_(state["pos"])
        self.graph.replay()
        return self.logits.clone(), dict(state, pos=self.next_pos.clone())


def graphed(step: Step, ctx) -> Step:
    """``step(params, state, token)`` captured and replayed where the
    token and the counter lie on a CUDA device and ``ctx`` has no process
    group; elsewhere ``step`` itself."""
    grouped = any(g is not None for g in (ctx.group, ctx.ep_group, ctx.fsdp_group, ctx.world_group))
    cache = GraphCache()

    def decode_step(params, state, token):
        graph = None
        if not grouped and token.is_cuda and state["pos"].is_cuda:
            graph = cache.get_or_capture(graph_key(params, state, token),
                                         lambda: Captured(step, params, state, token))
        if graph is None:
            counts["decode_eager_steps"] += 1
            return step(params, state, token)
        return graph(state, token)

    return decode_step
