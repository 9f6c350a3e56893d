"""On the card: every cell's tiny stand-in, and each state-space stand-in
that BENCHMARK.json has no real cell for, runs through the CUDA kernels,
correct, and its traced run reads every per-layer metric from the device.

    PYTHONPATH=src python -m pytest -q -m h100 h100bench

These skip on a machine without a GPU."""

from __future__ import annotations

import json
import time

import pytest

from h100bench.conftest import REPO, tiny_cells
from h100bench.run import run_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.h100
@pytest.mark.parametrize("cell", tiny_cells(BENCH))
def test_cell_on_the_card(tiny_root, cuda_device, cell):
    result, _ = run_cell(cell, 2**31 + 99, 1.0, True, device=cuda_device, root=tiny_root,
                         started=time.perf_counter())
    assert result["correct"] is True, result["checks"]
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["per_layer"] if cell in m["workloads"]}
    assert set(result["metrics"]) == want
    for name, m in result["metrics"].items():
        if m["unit"] == "%":
            assert 0.0 < m["value"] <= 105.0, (name, m)
    assert 0.0 < result["device"]["busy_s"] <= result["device"]["window_s"]
