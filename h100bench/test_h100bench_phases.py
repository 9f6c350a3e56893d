"""The program's ranges joined to the device records they launched
(``lib/phases.py``) and the readers of the new per-layer metrics, on
hand-built traces: the join, work of several ranges and steps, the
records no launch call accounts for, None where a run has nothing to
read, and every reader the benchmark had reading the same numbers with
the program's ranges in the trace as without them."""

from __future__ import annotations

import json

import pytest
import torch

from h100bench.lib import cell as cellmod
from h100bench.lib import phases
from h100bench.lib.trace import Trace

TRAIN, SERVE = "granite-moe.train.skewed", "granite-moe.serve.skewed"
NEW = {TRAIN: ("forward_idle_frac.train", "backward_idle_frac.train", "optimizer_ms.train"),
       SERVE: ("link_launches_per_decode_step", "prefill_moe_ms.serve", "prefill_attn_ms.serve",
               "prefill_head_ms.serve")}
STEP = 10_000
LAG = 50            # a record starts this long after its launch call


def _launch(host, device, t, dur=30, name="elementwise_kernel", call="cudaLaunchKernel"):
    """A launch call at ``t`` and its device record, after the last one."""
    host.append((t, t + 5, call))
    start = max(t + LAG, device[-1][1] if device else 0)
    device.append((start, start + dur, name))


def _train_step(host, device, t0):
    """One step as the port traces it: forward (an attention layer, an MoE
    layer with its link and the head), backward with the link's recompute,
    the optimizer, then one launch of the harness's own."""
    host += [(t0, t0 + 9000, "bench.train_step"), (t0 + 200, t0 + 3000, "dyskew.step.forward"),
             (t0 + 300, t0 + 600, "dyskew.attn"), (t0 + 700, t0 + 2000, "dyskew.moe"),
             (t0 + 1000, t0 + 1400, "dyskew.moe.link"), (t0 + 2100, t0 + 2800, "dyskew.head"),
             (t0 + 3000, t0 + 7000, "dyskew.step.backward"), (t0 + 3500, t0 + 3900, "dyskew.moe.link"),
             (t0 + 7000, t0 + 8500, "dyskew.step.optimizer")]
    _launch(host, device, t0 + 100, name="Memcpy HtoD (Pageable -> Device)", call="cudaMemcpyAsync")
    for t, name in ((400, "elementwise"), (800, "topk_gating_group_kernel"), (1100, "e"), (1200, "e"),
                    (1600, "dispatch_gather_kernel"), (2200, "gemm"), (3600, "e"), (4000, "e"),
                    (5000, "e")):
        _launch(host, device, t0 + t, name=name)
    _launch(host, device, t0 + 6000, name="Memset (Device)", call="cudaMemsetAsync")
    # The optimizer's two records lag behind their calls.
    _launch(host, device, t0 + 7100, dur=700)
    _launch(host, device, t0 + 7200, dur=500)
    _launch(host, device, t0 + 8800)


def train_trace(ranges=True, extra=False, lost=False):
    host, device = [(0, 2 * STEP, "bench.traced")], []
    for i in range(2):
        _train_step(host, device, i * STEP)
    if extra:                     # a record no call here launched
        device.append((1500, 1510, "Memcpy HtoD (Pageable -> Device)"))
    if lost:                      # the profiler lost the first memset's record
        device = [d for d in device if d[0] != 6050]
    if not ranges:
        host = [h for h in host if not h[2].startswith(phases.PREFIX)]
    return Trace(device, host, 0, 2 * STEP)


def serve_trace(ranges=True):
    """A prefill of one layer (an attention range with one kernel; its MoE
    range: a fresh link state, the tick and two kernels; the head's range)
    and two decode steps of the same."""
    host = [(0, 3 * STEP, "bench.traced"), (0, STEP, "bench.prefill"), (STEP, 3 * STEP, "bench.decode")]
    device = []
    for i in range(3):
        t0 = i * STEP
        host += [(t0 + 20, t0 + 90, "dyskew.attn"), (t0 + 100, t0 + 900, "dyskew.moe"),
                 (t0 + 150, t0 + 300, "dyskew.moe.link"), (t0 + 400, t0 + 600, "dyskew.moe.link"),
                 (t0 + 940, t0 + 990, "dyskew.head")]
        dur = 2000 if i == 0 else 10
        for t, name in ((50, "flash_attn"), (120, "topk_gating_group_kernel"), (200, "e"), (450, "e"),
                        (500, "e"), (700, "dispatch_gather_kernel")):
            _launch(host, device, t0 + t, dur=dur, name=name)
        _launch(host, device, t0 + 950, dur=dur)      # the head, outside the layer
        _launch(host, device, t0 + 995, dur=dur)      # the sampling, outside every range
    if not ranges:
        host = [h for h in host if not h[2].startswith(phases.PREFIX)]
    return Trace(device, host, 0, 3 * STEP)


def make_run(root, cell, trace):
    c = cellmod.load(cell, root)
    run = cellmod.Run(cell=c, seed=1, seconds=1.0, trace=True, device=torch.device("cuda", 0), started=0.0,
                      traced=trace, window_s=2.0)
    if cell == TRAIN:
        run.traced_info.update(steps=2, batch=4, seq_len=64)
        run.readings["tokens"] = 4 * 64 * 20
        run.spans["data_wait"] = [0.001, 0.002]
    else:
        run.traced_info.update(decode_steps=2, prompts=8, prompt_len=32, window_tokens=5000)
        run.spans["prefill"] = [0.5, 0.7]
    return run


def read(root, name, run):
    return cellmod.reader(name, root)(run)


def test_as_many_calls_as_records_pair_in_order():
    j = phases.join(train_trace())
    assert j.owner == list(range(len(j.device)))
    assert set(j.ranges) == {"step.forward", "step.backward", "step.optimizer", "attn", "moe", "moe.link", "head"}
    # The link's tick in the forward and in the recompute: one range name.
    assert phases.launches(j, "moe.link") == 2 * 3
    assert phases.launches(j, "moe") == 2 * 4
    # A launch inside the MoE range and the forward counts for both.
    assert phases.launches(j, "step.forward") == 2 * 6
    assert phases.device_ns(j, "step.optimizer") == 2 * (700 + 500)
    table = phases.by_span(j)
    assert table[phases.OUTSIDE]["launches"] == 2 * 2 and table[phases.UNATTRIBUTED]["records"] == 0
    assert table["step.optimizer"]["device_ms"] == pytest.approx(2 * 1200 / 1e6)


@pytest.mark.parametrize("fault", ["extra", "lost"])
def test_a_record_without_a_call_or_a_call_without_a_record_is_passed_over(fault):
    j = phases.join(train_trace(**{fault: True}))
    table = phases.by_span(j)[phases.UNATTRIBUTED]
    if fault == "extra":
        assert j.device[j.owner.index(-1)][0] == 1500
        assert table == {"records": 1, "of_records": 2 * 14 + 1, "device_ms": 10 / 1e6, "calls_without_record": 0}
    else:
        assert table == {"records": 0, "of_records": 2 * 14 - 1, "device_ms": 0.0, "calls_without_record": 1}
    # Every other record kept its own call.
    base = phases.join(train_trace())
    want = {d: base.calls[o] for d, o in zip(base.device, base.owner)}
    assert all(want[d] == j.calls[o] for d, o in zip(j.device, j.owner) if o >= 0)
    assert phases.launches(j, "moe.link") == 6 and phases.device_ns(j, "step.optimizer") == 2400


def test_idle_inside_a_range_is_its_time_without_a_device_record():
    j = phases.join(train_trace())
    idle, whole = phases.idle_ns(j, "step.backward")
    # Each backward holds three 30-ns records of its own and the memset's,
    # the optimizer's first one starting 50 ns after its end.
    assert whole == 2 * 4000 and idle == 2 * (4000 - 4 * 30)


@pytest.mark.parametrize("cell,want", [
    # The forward's 2,800 ns hold six 30-ns records.
    (TRAIN, {"forward_idle_frac.train": 100.0 * (2800 - 6 * 30) / 2800,
             "backward_idle_frac.train": 100.0 * 3880 / 4000, "optimizer_ms.train": 1200 / 1e6}),
    (SERVE, {"link_launches_per_decode_step": 3.0, "prefill_moe_ms.serve": 5 * 2000 / 1e6,
             "prefill_attn_ms.serve": 2000 / 1e6, "prefill_head_ms.serve": 2000 / 1e6}),
])
def test_the_new_readers_divide_by_the_traced_steps(tiny_root, cell, want):
    trace = train_trace() if cell == TRAIN else serve_trace()
    run = make_run(tiny_root, cell, trace)
    got = {name: read(tiny_root, name, run) for name in NEW[cell]}
    assert got == pytest.approx(want)


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_nothing_to_read_gives_none(tiny_root, cell):
    build = train_trace if cell == TRAIN else serve_trace
    untraced = make_run(tiny_root, cell, None)
    no_ranges = make_run(tiny_root, cell, build(ranges=False))      # a program without them
    host_only = build()
    no_device = make_run(tiny_root, cell, Trace([], host_only.host, host_only.t0, host_only.t1))   # the CPU
    for run in (untraced, no_ranges, no_device):
        assert all(read(tiny_root, name, run) is None for name in NEW[cell])


def test_a_model_without_the_layer_reads_zero(tiny_root):
    """The state-space stand-ins: the program's ranges, but no MoE layer
    and no attention."""
    trace = serve_trace()
    host = [h for h in trace.host if not h[2].startswith(("dyskew.moe", "dyskew.attn"))]
    host.append((100, 900, "dyskew.mamba"))
    run = make_run(tiny_root, SERVE, Trace(trace.device, host, trace.t0, trace.t1))
    assert read(tiny_root, "link_launches_per_decode_step", run) == 0.0
    assert read(tiny_root, "prefill_moe_ms.serve", run) == 0.0
    assert read(tiny_root, "prefill_attn_ms.serve", run) == 0.0
    assert read(tiny_root, "prefill_head_ms.serve", run) == 2000 / 1e6


def test_kernel_build_s_reads_the_programs_counter(tiny_root, monkeypatch):
    from repro_torch.kernels import _loader

    run = make_run(tiny_root, TRAIN, None)
    monkeypatch.setattr(_loader, "last_build_seconds", 0.0)
    assert read(tiny_root, "kernel_build_s", run) is None
    monkeypatch.setattr(_loader, "last_build_seconds", 8.5)
    assert read(tiny_root, "kernel_build_s", run) == 8.5


@pytest.mark.parametrize("cell", [TRAIN, SERVE])
def test_the_programs_ranges_move_no_reader_the_benchmark_had(tiny_root, cell):
    from h100bench.conftest import REPO

    build = train_trace if cell == TRAIN else serve_trace
    before, after = make_run(tiny_root, cell, build(ranges=False)), make_run(tiny_root, cell, build())
    new = {n for ns in NEW.values() for n in ns} | {"kernel_build_s"}
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    old = [m["name"] for m in bench["per_layer"]
           if m["name"] not in new and cell in m.get("workloads", [cell])]
    assert len(old) >= 4
    for name in old:
        value = read(tiny_root, name, before)
        assert value is not None and value == read(tiny_root, name, after), name
    assert before.traced.breakdown()["device_ops"] == after.traced.breakdown()["device_ops"]
