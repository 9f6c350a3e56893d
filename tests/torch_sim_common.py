"""Helpers shared by the port's simulator tests (``test_torch_sim*.py``,
``test_torch_claims*.py``): the two sides as module namespaces, and the
ways of running one workload on both and holding the port to the
reference.

``build(m)`` runs a workload with the modules of side ``m`` (``REF`` or
``PORT``; ``m.dev`` is the port's ``device="cpu"``, empty for the
reference).  ``run_both`` runs it on both sides and holds the distribute
mask of every link tick equal, recorded by wrapping
``AdaptiveLinkSim.tick`` and ``BatchedLinkSim.tick``; ``RefRuns`` does
the same with the reference's side computed once per module.
"""

import contextlib
import dataclasses
import enum
import math
import types

import numpy as np
import pytest

import repro.core.admission as j_admission
import repro.core.types as j_types
import repro.runtime.fault_tolerance as j_ft
import repro.sim.batched_link as j_batched
import repro.sim.engine as j_engine
import repro.sim.faults as j_faults
import repro.sim.legacy as j_legacy
import repro.sim.pipeline as j_pipeline
import repro.sim.replay as j_replay
import repro.sim.workload as j_workload
import repro_torch.core.admission as t_admission
import repro_torch.core.types as t_types
import repro_torch.runtime.fault_tolerance as t_ft
import repro_torch.sim.batched_link as t_batched
import repro_torch.sim.engine as t_engine
import repro_torch.sim.faults as t_faults
import repro_torch.sim.legacy as t_legacy
import repro_torch.sim.pipeline as t_pipeline
import repro_torch.sim.replay as t_replay
import repro_torch.sim.workload as t_workload

TOL = dict(rtol=1e-9, atol=0.0)

REF = types.SimpleNamespace(
    name="ref", admission=j_admission, types=j_types, ft=j_ft, batched=j_batched,
    engine=j_engine, faults=j_faults, legacy=j_legacy, pipeline=j_pipeline,
    replay=j_replay, workload=j_workload, dev={},
)
PORT = types.SimpleNamespace(
    name="port", admission=t_admission, types=t_types, ft=t_ft, batched=t_batched,
    engine=t_engine, faults=t_faults, legacy=t_legacy, pipeline=t_pipeline,
    replay=t_replay, workload=t_workload, dev={"device": "cpu"},
)


@contextlib.contextmanager
def recorded_masks(m, monkeypatch):
    """Every distribute mask the side ``m`` hands its event loop, in order."""
    log = []
    with monkeypatch.context() as mp:
        for cls in (m.engine.AdaptiveLinkSim, m.batched.BatchedLinkSim):
            def tick(self, *args, _orig=cls.tick, **kw):
                out = _orig(self, *args, **kw)
                log.append(np.array(out, copy=True))
                return out
            mp.setattr(cls, "tick", tick)
        yield log


def assert_same_masks(ref_log, port_log, min_ticks=0):
    assert len(port_log) == len(ref_log) >= min_ticks
    for i, (a, b) in enumerate(zip(ref_log, port_log)):
        assert a.shape == b.shape and a.dtype == b.dtype == bool, i
        np.testing.assert_array_equal(a, b, err_msg=f"distribute mask of tick {i}")


def run_both(monkeypatch, build, min_ticks=0):
    """``build(m)`` runs one workload with the modules of side ``m``; returns
    (reference output, port output) after holding the masks equal."""
    outs, logs = [], []
    for m in (REF, PORT):
        with recorded_masks(m, monkeypatch) as log:
            outs.append(build(m))
        logs.append(log)
    assert_same_masks(*logs, min_ticks=min_ticks)
    return outs[0], outs[1]


class RefRuns:
    """``runs(build, *args)`` is ``run_both`` with the reference's side
    computed once per (build, args) and kept: a module-scoped fixture of
    this lets the tests of one workload share the reference's run while
    each runs the port's."""

    def __init__(self):
        self.done = {}

    def __call__(self, build, *args, min_ticks=0):
        key = (build.__module__, build.__qualname__, args)
        if key not in self.done:
            with pytest.MonkeyPatch.context() as mp, recorded_masks(REF, mp) as log:
                self.done[key] = (build(REF, *args), log)
        ref, ref_log = self.done[key]
        with pytest.MonkeyPatch.context() as mp, recorded_masks(PORT, mp) as port_log:
            port = build(PORT, *args)
        assert_same_masks(ref_log, port_log, min_ticks)
        return ref, port


def assert_results_equal(ref, port):
    """QueryResults (one or a list) field by field at the reference's bar."""
    if not isinstance(ref, (list, tuple)):
        ref, port = [ref], [port]
    assert len(ref) == len(port)
    for i, (a, b) in enumerate(zip(ref, port)):
        for f in ("latency", "utilization", "bytes_moved_remote", "decision_overhead"):
            np.testing.assert_allclose(getattr(b, f), getattr(a, f), err_msg=f"{i}: {f}", **TOL)
        np.testing.assert_allclose(b.per_worker_busy, a.per_worker_busy, err_msg=f"{i}", **TOL)
        for f in ("num_ticks", "rows_redistributed", "redistribution_applied", "preempted_rows"):
            assert getattr(b, f) == getattr(a, f), (i, f)


def same_bits(ref, port, where="out"):
    """The port's output equal to the reference's bit for bit: the same
    structure (dataclasses field by field, whatever module defines them;
    enums by name), floats and arrays equal, NaN equal to NaN."""
    if dataclasses.is_dataclass(ref) and not isinstance(ref, type):
        assert dataclasses.is_dataclass(port), (where, type(port))
        assert type(ref).__name__ == type(port).__name__, where
        for f in dataclasses.fields(ref):
            same_bits(getattr(ref, f.name), getattr(port, f.name), f"{where}.{f.name}")
    elif isinstance(ref, enum.Enum):
        assert isinstance(port, enum.Enum) and ref.name == port.name, (where, ref, port)
    elif isinstance(ref, dict):
        assert list(ref) == list(port), (where, list(ref), list(port))
        for k in ref:
            same_bits(ref[k], port[k], f"{where}[{k!r}]")
    elif isinstance(ref, (list, tuple)):
        assert isinstance(port, (list, tuple)) and len(ref) == len(port), where
        for i, (a, b) in enumerate(zip(ref, port)):
            same_bits(a, b, f"{where}[{i}]")
    elif isinstance(ref, np.ndarray):
        port = np.asarray(port)
        assert ref.shape == port.shape, (where, ref.shape, port.shape)
        np.testing.assert_array_equal(port, ref, err_msg=where)
    elif isinstance(ref, (float, np.floating)):
        assert ref == port or (math.isnan(ref) and math.isnan(port)), (where, ref, port)
    else:
        assert ref == port, (where, ref, port)


def default_strategies(m, kind):
    return m.replay.default_strategies()[kind]
