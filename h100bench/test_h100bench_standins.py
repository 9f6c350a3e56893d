"""The tiny tree's stand-ins go by kind of block, so that a configuration of
a kind the tree knows joins the benchmark as data alone, and a real
state-space cell takes the place of its stand-in.

The proof: the repo's BENCHMARK.json with mamba2-1.3b and its two cells
added as data, as a change that adds the model would add them (the file
holds the published widths of ``test_h100bench_groups.MAMBA2_1_3B``).  On the CPU
the tree holds each cell once, the real-named cells run correct and the
other cells' files are the same bytes; on the card (marked ``h100``,
skipped elsewhere) a traced run of each reads every per-layer metric
listed for it:

    PYTHONPATH=src python -m pytest -q -m h100 h100bench/test_h100bench_standins.py
"""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import pytest

from h100bench.conftest import (INIT, OPTIMIZER, REPO, SSM_CELLS, TINY_CONFIGS, TINY_LIMITS, TINY_SSM,
                                TINY_TRAFFIC, make_tiny_root, one_thread, tiny_cells)
from h100bench.run import run_cell
from h100bench.test_h100bench_groups import MAMBA2_1_3B

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
GRANITE = json.loads((REPO / "h100bench/configs/granite-moe-1b-a400m.json").read_text())
SEED = 2**31 + 3030
REAL = list(SSM_CELLS)
#: The per-layer metrics a traced run on the CPU can read: the host's spans.
HOST_READ = {"data_wait_ms.train", "prefill_ms.serve"}


def with_mamba2(bench: dict, file: Path) -> dict:
    """``bench`` with what it lacks of mamba2-1.3b, added as data: its
    configuration entry (``file`` written here), the cells
    ``mamba2.train.text`` and ``mamba2.serve.batch``, their names on the
    end-to-end metrics and on the per-layer metrics of granite's matching
    cell (the MoE kernels' roofline aside), and the two scan roofline
    metrics.  Written out here, not taken from ``conftest.py``: it is the
    data a change that adds the model would bring."""
    bench = json.loads(json.dumps(bench))
    if "mamba2-1.3b" not in {c["name"] for c in bench["configs"]}:
        file.parent.mkdir(parents=True, exist_ok=True)
        file.write_text(json.dumps({"name": "mamba2-1.3b", "model": MAMBA2_1_3B, "ep_shards": 1,
                                    "limits": GRANITE["limits"]}))
        bench["configs"].append({"name": "mamba2-1.3b", "source": "https://huggingface.co/state-spaces/mamba2-1.3b",
                                 "file": str(file), "reduced": [], "why": "state-space layers, the chunked scan"})
    have = {w["name"] for w in bench["workloads"]}
    metrics = {m["name"] for m in bench["per_layer"]}
    for cell, (traffic, follows, roofline) in SSM_CELLS.items():
        if cell in have:
            continue
        bench["workloads"].append({"name": cell, "config": "mamba2-1.3b", "traffic": traffic, "chips": 1,
                                   "why": "the chunked scan"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if follows in m.get("workloads", ()) and not m["name"].startswith("moe_kernels_roofline"):
                m["workloads"].append(cell)
        if roofline not in metrics:
            moves = "train_tokens_per_s" if ".train." in cell else "gen_tokens_per_s"
            bench["per_layer"].append({"name": roofline, "unit": "%", "better": "higher",
                                       "source": "device_trace", "layer": "kernels", "moves": moves,
                                       "workloads": [cell]})
    return bench


def files(root: Path) -> dict:
    """Every file of a tree and its bytes (bytecode caches aside)."""
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file() and "__pycache__" not in p.parts}


@pytest.fixture
def mamba2_root(tmp_path):
    """The tiny tree of BENCHMARK.json with mamba2-1.3b added, one thread."""
    with one_thread():
        bench = with_mamba2(BENCH, tmp_path / "data" / "mamba2-1.3b.json")
        yield make_tiny_root(tmp_path / "tree", bench=bench)


def listed(root: Path, kind: str, cell: str) -> set:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    return {m["name"] for m in bench[kind] if "workloads" not in m or cell in m["workloads"]}


def test_the_real_cells_take_the_stand_ins_place(tmp_path):
    plain = make_tiny_root(tmp_path / "plain")
    given = with_mamba2(BENCH, tmp_path / "data" / "mamba2-1.3b.json")
    real = make_tiny_root(tmp_path / "real", bench=given)
    bench = json.loads((real / "BENCHMARK.json").read_text())
    cells = [w["name"] for w in bench["workloads"]]
    assert cells == [w["name"] for w in given["workloads"]] == tiny_cells(given)
    assert set(REAL) <= set(cells) and len(cells) == len(set(cells))
    assert [c["name"] for c in bench["configs"]] == [c["name"] for c in given["configs"]]
    assert "tiny-ssm" not in {c["name"] for c in bench["configs"]}
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for cell, (_, _, roofline) in SSM_CELLS.items():
        assert cell in next(m for m in bench["per_layer"] if m["name"] == roofline)["workloads"]
    doc = json.loads((real / "h100bench/configs/mamba2-1.3b.json").read_text())
    assert doc["model"] == TINY_SSM["model"] and doc["ep_shards"] == 1 and doc["limits"] == TINY_LIMITS
    # Every other file the same bytes: the granite cells see no change.
    own = {"BENCHMARK.json", "h100bench/configs/tiny-ssm.json", "h100bench/configs/mamba2-1.3b.json"}
    a, b = files(plain), files(real)
    assert "h100bench/configs/granite-moe-1b-a400m.json" in a
    assert {k: v for k, v in a.items() if k not in own} == {k: v for k, v in b.items() if k not in own}


@pytest.mark.parametrize("cell", REAL)
def test_a_real_named_cell_runs_correct_on_cpu(mamba2_root, cell):
    result, _ = run_cell(cell, SEED, 5.0 if ".serve." in cell else 0.5, False, device="cpu", root=mamba2_root,
                         started=time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == listed(mamba2_root, "end_to_end", cell)


@pytest.mark.parametrize("cell", REAL)
def test_a_real_named_cell_traced_on_cpu_reads_the_hosts_metrics(mamba2_root, cell):
    result, _ = run_cell(cell, SEED + 1, 5.0 if ".serve." in cell else 0.5, True, device="cpu",
                         root=mamba2_root, started=time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == listed(mamba2_root, "per_layer", cell) & HOST_READ


@pytest.mark.h100
@pytest.mark.parametrize("cell", REAL)
def test_a_real_named_cell_on_the_card(mamba2_root, cuda_device, cell):
    result, _ = run_cell(cell, SEED + 2, 1.0, True, device=cuda_device, root=mamba2_root,
                         started=time.perf_counter())
    assert result["correct"] is True, result["checks"]
    assert set(result["metrics"]) == listed(mamba2_root, "per_layer", cell)
    for name, m in result["metrics"].items():
        if m["unit"] == "%":
            assert 0.0 < m["value"] <= 105.0, (name, m)
    assert 0.0 < result["device"]["busy_s"] <= result["device"]["window_s"]


def test_a_kind_without_a_stand_in_is_refused(tmp_path):
    path = tmp_path / "data" / "dense-7b.json"
    path.parent.mkdir()
    path.write_text(json.dumps({"model": {k: v for k, v in MAMBA2_1_3B.items() if k != "mamba"}}))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "dense-7b", "source": "a dense model", "file": str(path), "reduced": [],
                             "why": "neither sparse experts nor a state-space layer"})
    with pytest.raises(ValueError, match="'dense-7b' needs a stand-in"):
        make_tiny_root(tmp_path / "tree", bench=bench)


# ----------------------------------------------------------------------- #
# The parent's tree, frozen
# ----------------------------------------------------------------------- #

def parent_tree(tmp: Path, bench: dict) -> Path:
    """The tiny tree as the parent commit built it: a stand-in looked up by
    the configuration's name, the state-space stand-in cells always added."""
    bench = json.loads(json.dumps(bench))
    bench["configs"].append({"name": "tiny-ssm", "source": "arXiv:2405.21060", "file": "",
                             "reduced": [], "why": "state-space layers"})
    by_kind = {"train_tokens_per_s": "train", "gen_tokens_per_s": "serve"}
    for cell, (traffic, follows, roofline) in SSM_CELLS.items():
        bench["workloads"].append({"name": cell, "config": "tiny-ssm", "traffic": traffic, "chips": 1,
                                   "why": "stand-in"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if follows in m.get("workloads", ()) and not m["name"].startswith("moe_kernels_roofline"):
                m["workloads"].append(cell)
        moves = next(n for n, kind in by_kind.items() if f".{kind}." in cell)
        bench["per_layer"].append({"name": roofline, "unit": "%", "better": "higher", "source": "device_trace",
                                   "layer": "kernels", "moves": moves, "workloads": [cell]})
    (tmp / "h100bench" / "configs").mkdir(parents=True)
    (tmp / "h100bench" / "traffic").mkdir(parents=True)
    shutil.copytree(REPO / "h100bench" / "metrics", tmp / "h100bench" / "metrics")
    for c in bench["configs"]:
        tiny = dict(TINY_CONFIGS[c["name"]], optimizer=OPTIMIZER, init=INIT, limits=TINY_LIMITS)
        tiny["model"] = dict(tiny["model"], dtype="float32")
        c["file"] = f"h100bench/configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(tiny))
    for f in (REPO / "h100bench" / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix.update({k: v for k, v in TINY_TRAFFIC.items() if k in mix})
        (tmp / "h100bench" / "traffic" / f.name).write_text(json.dumps(mix))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def parents_part(bench: dict) -> dict:
    """What of ``bench`` the parent could build: the configurations with a
    stand-in of their own name, their cells, and the metrics of those."""
    bench = json.loads(json.dumps(bench))
    bench["configs"] = [c for c in bench["configs"] if c["name"] in TINY_CONFIGS]
    kept = {c["name"] for c in bench["configs"]}
    bench["workloads"] = [w for w in bench["workloads"] if w["config"] in kept]
    cells = {w["name"] for w in bench["workloads"]}
    for key in ("end_to_end", "per_layer"):
        out = []
        for m in bench[key]:
            if "workloads" in m:
                m["workloads"] = [w for w in m["workloads"] if w in cells]
                if not m["workloads"]:
                    continue
            out.append(m)
        bench[key] = out
    return bench


def test_the_repos_tree_is_the_parents(tmp_path):
    """With BENCHMARK.json as it is, as far as the parent could build it,
    the tree is byte for byte the parent's, the stand-in cells in it."""
    bench = parents_part(BENCH)
    assert files(make_tiny_root(tmp_path / "ours", bench=bench)) == files(parent_tree(tmp_path / "parent", bench))
