"""The harness end to end on a tiny stand-in of every cell, on the CPU; the
generators repeat by seed; a cell given only as data runs; BENCHMARK.json
keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re
import time

import numpy as np
import pytest
import torch

from h100bench.conftest import REPO, tiny_cells
from h100bench.lib import cell as cellmod
from h100bench.lib import traffic, weights
from h100bench.run import run_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = tiny_cells(BENCH)
SEED = 2**31 + 12345
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def run(root, cell, seed=SEED, trace=False):
    # Long enough for a tiny serving round to finish inside the window on a
    # loaded CPU.
    seconds = 5.0 if ".serve." in cell else 0.5
    return run_cell(cell, seed, seconds, trace, device="cpu", root=root, started=time.perf_counter())


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct_on_cpu(tiny_root, cell):
    result, lines = run(tiny_root, cell)
    assert result["correct"] is True, result["checks"]
    assert list(result)[-1] == "checks"
    assert result["attempted"] > 0 and result["failed"] == 0
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    want = {m["name"] for m in bench["end_to_end"] if "workloads" not in m or cell in m["workloads"]}
    assert set(result["metrics"]) == want
    assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
    assert result["device"]["platform"] == "cpu"
    assert [line["line"] for line in lines] == ["device", "run", "numbers"]


def test_traced_run_gives_per_layer_metrics_and_breakdown(tiny_root):
    result, _ = run(tiny_root, "granite-moe.train.skewed", trace=True)
    assert result["correct"] is True
    # On the CPU only the host's spans can be read: no device number.
    assert set(result["metrics"]) == {"data_wait_ms.train"}
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_generators_repeat_by_seed():
    mix = json.loads((REPO / "h100bench/traffic/text.skewed.json").read_text())
    a, b, c = (traffic.documents(s, mix, 1000) for s in (7, 7, 8))
    first_a = [next(a) for _ in range(20)]
    assert all(np.array_equal(x, next(b)) for x in first_a)
    assert not all(np.array_equal(x, next(c)) for x in first_a)
    assert all(1 <= x.min() and x.max() < 1000 and 16 <= len(x) <= 1024 for x in first_a)
    serve = json.loads((REPO / "h100bench/traffic/batch.skewed.json").read_text())
    small = dict(serve, prompts=3, prompt_len=16)
    assert np.array_equal(traffic.prompts(9, small, 500, 2), traffic.prompts(9, small, 500, 2))
    assert not np.array_equal(traffic.prompts(9, small, 500, 2), traffic.prompts(9, small, 500, 3))


def test_weights_repeat_by_seed_and_carry_the_skew():
    from h100bench.conftest import INIT, TINY_CONFIGS

    model = TINY_CONFIGS["granite-moe-1b-a400m"]["model"]
    mix = {"router_skew_alpha": 1.2, "router_skew_scale": 0.05}
    cpu = torch.device("cpu")
    a = dict(weights.flatten(weights.make_params(model, INIT, mix, 3, cpu)))
    b = dict(weights.flatten(weights.make_params(model, INIT, mix, 3, cpu)))
    c = dict(weights.flatten(weights.make_params(model, INIT, mix, 4, cpu)))
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["embed/table"], c["embed/table"])
    one = weights.make_leaf(model, INIT, mix, 3, "blocks/l0/moe/router", cpu, torch.float32)
    assert torch.equal(one, a["blocks/l0/moe/router"])
    flat = dict(weights.flatten(weights.make_params(model, INIT, {}, 3, cpu)))
    skew = torch.from_numpy(weights.router_skew(model, mix, 3)).float()
    assert torch.allclose(a["blocks/l0/moe/router"] - flat["blocks/l0/moe/router"], skew[:, None, :].expand_as(one))


def test_a_cell_given_only_as_data_runs(tiny_root):
    """A uniform-routing control: one traffic file and one BENCHMARK.json
    entry, no code."""
    mix = json.loads((tiny_root / "h100bench/traffic/text.skewed.json").read_text())
    mix["router_skew_alpha"] = 0.0
    (tiny_root / "h100bench/traffic/text.uniform.json").write_text(json.dumps(mix))
    bench = json.loads((tiny_root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "granite-moe.train.uniform", "config": "granite-moe-1b-a400m",
                               "traffic": "text.uniform", "chips": 1, "why": "uniform routing control"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "granite-moe.train.skewed" in m.get("workloads", []):
            m["workloads"].append("granite-moe.train.uniform")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = cellmod.load("granite-moe.train.uniform", tiny_root)
    assert weights.router_skew(cell.config["model"], cell.mix, SEED) is None
    result, _ = run(tiny_root, "granite-moe.train.uniform")
    assert result["correct"] is True
    assert set(result["metrics"]) == {"train_tokens_per_s", "peak_mem_gb", "setup_s"}


def test_benchmark_json_keeps_to_the_contract():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"] and BENCH["command"] == ["python3", "h100bench/run.py"]
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # A full check of 24 cells: 2 + 14 runs a cell, each run_seconds + 60 s,
    # 2 x 90 s a cell to compile and 1,200 s spare, within 43,200 s.
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and set(c) == {"name", "source", "file", "reduced", "why"}
        doc = json.loads((REPO / c["file"]).read_text())
        assert doc["model"] and doc["limits"] and c["file"].startswith("h100bench/")
        assert 1 <= len(c["why"]) <= 200 and 1 <= len(c["source"]) <= 200
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in configs
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        mix = json.loads((REPO / f"h100bench/traffic/{w['traffic']}.json").read_text())
        assert (REPO / f"h100bench/drivers/{mix['driver']}.py").exists()
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0 < m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and NAME.match(m["name"]) and m["better"] in ("lower", "higher")
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert UNIT.match(m["unit"]) and NAME.match(m["name"]) and m["moves"] in e2e
        assert (REPO / f"h100bench/metrics/{m['name']}.py").exists()
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"], (m["name"], w)
    for w in BENCH["workloads"]:
        reported = [m for m in BENCH["end_to_end"] if "workloads" not in m or w["name"] in m["workloads"]]
        assert len(reported) >= 2 and any(w["name"] in m.get("workloads", ()) for m in BENCH["per_layer"])
    assert len(json.dumps(BENCH)) < 64 * 1024
