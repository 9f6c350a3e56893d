"""A FLOP/byte counter over torch ops: the port's counterpart of
``repro.roofline.jaxpr_cost``.

``OpCounter`` is a ``TorchDispatchMode``: it sees every aten op a function
runs below autograd, forward and backward, on whatever device the tensors
lie, ``meta`` included (where nothing is allocated and no kernel runs).

  flops      products counted exactly, as ``jaxpr_cost._dot_flops`` does:
             2·batch·M·N·K for ``mm``, ``bmm``, ``addmm``, ``baddbmm`` and
             the matrix-vector forms, which is what ``einsum``, ``matmul``
             and ``linear`` decompose into (the ``addmm`` / ``baddbmm``
             add is one more FLOP an output element); every other op one
             FLOP an output element.
  dot_flops  the products' part of ``flops``.
  bytes      the sum of each op's input and output bytes: an UNFUSED
             upper-bound proxy for HBM traffic, the same proxy the
             reference documents.  Elementwise chains that a fused kernel
             keeps in registers are counted once an op, so the byte count
             can exceed what the card moves; ratios between configurations
             are what it is for.
  peak_bytes the most bytes of storage alive at once: the arguments'
             storages at entry, each new storage from its op on, dropped
             when it is freed.  The counterpart of XLA's
             ``peak_memory_in_bytes``, which includes live arguments.
  kernels    {name: {"calls", "flops", "bytes"}} of the hand-written
             kernels, which report themselves (``kernel``).
  collectives  one record a ``torch.distributed`` collective (the
             dispatcher's ``c10d`` ops): {"op", "kind", "bytes", "group"},
             the op's name, its kind in the reference's HLO words
             (``all-reduce`` ...), the bytes of the tensors it writes (its
             first argument: the operand of an all-reduce or broadcast, the
             result of a gather, scatter or all-to-all) and the group's
             size.  A collective adds nothing to ``flops`` or ``bytes``:
             ``roofline/analysis.py`` turns the records into wire bytes.

An op whose outputs only alias its inputs' storage without writing them
(a view, ``detach``, ``_unsafe_view``), an allocation that writes nothing
(``empty``), a layout copy (``clone``), a Python number made a tensor
(``scalar_tensor``) and an op with no tensor output (a host read) are not
counted (``_NO_WORK`` says why), so the count depends on the shapes and
the ops, not on strides or on where a tensor lies.

Loops: the reference multiplies a ``scan`` body by its length; the port's
layer stack, chunk loops and remat recompute (``torch.utils.checkpoint``)
are Python that runs every iteration, so each is counted as it runs.

The kernels are launched through ``ctypes``, below the dispatcher, so the
counter cannot see them; on ``meta`` or the host their plain versions run
in their place, and counting those ops would make the yardstick depend on
the path.  Each wrapper therefore opens ``kernel(name, formula, *args)``
around whichever version it runs: the active counter takes the record of
``repro_torch.roofline.kernel_cost`` (shapes and dtypes only) and counts
none of the ops inside.  A kernel and its plain version give the same
count.
"""

from __future__ import annotations

import contextlib
import math
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack

from repro_torch.roofline.kernel_cost import KernelCost

aten = torch.ops.aten

#: Ops counted as no work: allocations that write nothing; ``clone``, the
#: copy that only changes a layout (``contiguous``, ``reshape``); and
#: ``scalar_tensor``, a Python number made a tensor.  Whether a layout copy
#: is needed depends on strides, and the strides ``meta`` functions give
#: can differ from the eager kernels' (``softplus_backward`` of two inputs
#: in different layouts is contiguous on ``meta`` and follows the first
#: input on the host and the card); XLA picks layouts itself in the
#: reference.  A number assigned into a host or CUDA tensor is wrapped on
#: the host without a dispatch, into a ``meta`` one by ``scalar_tensor``.
#: Counting either would tie the count to the path.
_NO_WORK = {aten.empty, aten.empty_strided, aten.empty_like, aten.new_empty, aten.new_empty_strided,
            aten.clone, aten.scalar_tensor}


#: ``c10d`` ops by the kind of collective they are.  A broadcast passes the
#: payload on once a rank in a ring, which is the collective-permute's
#: model in ``analysis.collective_wire_bytes``.
COLLECTIVE_OPS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast_": "collective-permute",
}


def _group_size(args) -> int:
    """The size of the ProcessGroup among a ``c10d`` op's arguments."""
    import torch.distributed as dist

    for a in args:
        if isinstance(a, torch.ScriptObject):
            try:
                return dist.ProcessGroup.unbox(a).size()
            except RuntimeError:
                continue                # a ReduceOp, not the group
    raise ValueError("a c10d op without a process group")


#: Products that also add a tensor: one more FLOP an output element.
_ADD_PRODUCTS = {aten.addmm, aten.baddbmm, aten.addmv}


def _dot_flops(func, args) -> int:
    """2·batch·M·N·K of a product op, 0 for anything else."""
    packet = func.overloadpacket
    if packet in (aten.mm, aten.addmm):
        a, b = (args[0], args[1]) if packet is aten.mm else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * b.shape[1]
    if packet in (aten.bmm, aten.baddbmm):
        a, b = (args[0], args[1]) if packet is aten.bmm else (args[1], args[2])
        return 2 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    if packet in (aten.mv, aten.addmv):
        a = args[0] if packet is aten.mv else args[1]
        return 2 * a.shape[0] * a.shape[1]
    if packet in (aten.dot, aten.vdot):
        return 2 * args[0].shape[0]
    return 0


def _tensors(x: Any, out: List[torch.Tensor]) -> List[torch.Tensor]:
    """The tensors in an op's arguments or results (nested lists, tuples,
    dicts), in order."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpCounter(TorchDispatchMode):
    """Counts the ops run inside ``with OpCounter() as c:``; ``c.result()``
    gives the totals.  ``track(*trees)`` adds storages that are alive on
    entry (the arguments) to the live-bytes count."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.dot_flops = 0
        self.bytes = 0
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.collectives: List[Dict[str, Any]] = []
        #: {op: [calls, flops, bytes]}, to tell two counts apart op by op.
        self.by_op: Dict[Any, List[int]] = {}
        self._kernel_depth = 0
        self._live: Dict[int, Any] = {}
        self._live_bytes = 0
        self.peak_bytes = 0

    # ---- live storage ------------------------------------------------ #

    def _drop(self, key: int, nbytes: int) -> None:
        if self._live.pop(key, None) is not None:
            self._live_bytes -= nbytes

    def track(self, *trees: Any) -> None:
        for t in _tensors(trees, []):
            st = t.untyped_storage()
            key = id(st)
            if key in self._live:
                continue
            nbytes = st.nbytes()
            self._live[key] = weakref.ref(st, lambda _, k=key, n=nbytes: self._drop(k, n))
            self._live_bytes += nbytes
        self.peak_bytes = max(self.peak_bytes, self._live_bytes)

    # ---- kernels ----------------------------------------------------- #

    def add_kernel(self, cost: KernelCost) -> None:
        rec = self.kernels.setdefault(cost.name, {"calls": 0, "flops": 0, "bytes": 0})
        rec["calls"] += 1
        rec["flops"] += cost.flops
        rec["bytes"] += cost.bytes
        self.flops += cost.flops
        self.bytes += cost.bytes

    # ---- ops ---------------------------------------------------------- #

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            return self._collective(func, args, kwargs)
        out = func(*args, **kwargs)
        outs = _tensors(out, [])
        self.track(outs)
        if self._kernel_depth or not outs or func.overloadpacket in _NO_WORK:
            return out
        ins = _tensors((args, kwargs), [])
        if not func._schema.is_mutable:
            inputs = {id(t.untyped_storage()) for t in ins}
            if all(id(t.untyped_storage()) in inputs for t in outs):
                return out          # an alias: no data moves
        dot = _dot_flops(func, args)
        elems = sum(t.numel() for t in outs)
        if not dot:
            flops = elems
        elif func.overloadpacket in _ADD_PRODUCTS:
            flops = dot + elems             # the product and its add
        else:
            flops = dot
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in outs)
        self.dot_flops += dot
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op.setdefault(func, [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes
        return out

    def _collective(self, func, args, kwargs):
        name = func.overloadpacket.__name__
        kind = COLLECTIVE_OPS.get(name)
        if kind is not None and not self._kernel_depth:
            self.collectives.append({
                "op": name, "kind": kind, "bytes": sum(_nbytes(t) for t in _tensors(args[0], [])),
                "group": _group_size(args),
            })
        return func(*args, **kwargs)

    def result(self) -> Dict[str, Any]:
        return {
            "flops": self.flops, "dot_flops": self.dot_flops, "bytes": self.bytes,
            "peak_bytes": self.peak_bytes,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
            "collectives": [dict(c) for c in self.collectives],
        }


def active_counter() -> Optional[OpCounter]:
    """The innermost ``OpCounter`` in this thread's dispatch modes, if any
    (the autograd engine carries them into its backward threads)."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, OpCounter):
            return mode
    return None


@contextlib.contextmanager
def kernel(formula: Callable[..., KernelCost], *args: Any) -> Iterator[None]:
    """Around a kernel wrapper's call of either version: an active counter
    takes ``formula(*args)`` and counts none of the ops inside.  Without a
    counter this costs one look at the dispatch-mode stack."""
    counter = active_counter()
    if counter is None:
        yield
        return
    counter.add_kernel(formula(*args))
    counter._kernel_depth += 1
    try:
        yield
    finally:
        counter._kernel_depth -= 1


def trace_cost(fn: Callable[..., Any], *args: Any) -> Dict[str, Any]:
    """Run ``fn(*args)`` under a counter; returns its totals, with
    ``argument_bytes``, the arguments' storage.  Give ``meta`` tensors to
    count without allocating or running anything."""
    with OpCounter() as counter:
        counter.track(args)
        argument_bytes = counter.peak_bytes
        fn(*args)
    return dict(counter.result(), argument_bytes=argument_bytes)
