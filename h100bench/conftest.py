"""Test support for the benchmark's own tests: the card marker, a fixture
that skips a card test on a machine without a GPU, and a tiny stand-in for
the benchmark's files (the same cells and traffic, configurations cut to a
size the CPU runs in a second).

Stand-ins go by kind of block, not by name: each configuration of
``BENCHMARK.json`` runs on the tiny model of its kind, ``tiny-moe`` where its
file's ``model`` has ``moe`` and ``tiny-ssm`` where it has ``mamba`` and no
``moe``; a configuration of any other kind needs a stand-in of its own, and
the tree refuses it.  So a configuration of a kind the tree knows joins the
benchmark as data alone.

The tiny tree also holds two state-space cells given only as data, the
stand-ins of the Mamba-2 cells: they keep the harness's, the reference's
and the readers' state-space path under test.  Each gives way to a real
cell of its name in ``BENCHMARK.json``, which then runs on ``tiny-ssm``
under its own metric lists.  The stand-in's file has no ``n_groups`` and 8
heads, so it lays out 1 group under the harness's default and the port's
rule alike."""

from __future__ import annotations

import contextlib
import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
REPO = HERE.parent

OPTIMIZER = {"name": "adamw", "lr": 3e-4, "warmup_steps": 100, "total_steps": 10000, "weight_decay": 0.01,
             "b1": 0.9, "b2": 0.95, "eps": 1e-8, "grad_clip": 1.0, "min_lr_frac": 0.1}
INIT = {"embed_scale": 1.0, "head_scale": 0.02, "router_scale": 0.02}
#: Limits for the tiny float32 models, whose program and reference agree to
#: float32 rounding (about 1e-7 on every number).
TINY_LIMITS = {"train": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 1e-3, "grad_diff": 1e-3,
                         "change_diff": 1e-3, "rows_unmatched": 0},
               "serve": {"logit_gap": 1e-4, "mean_gap": 1e-6, "tokens_out_of_vocab": 0}}
TINY_MOE = {
    "name": "tiny-moe", "ep_shards": 4,
    "model": {"name": "tiny-moe", "family": "moe", "num_layers": 2, "d_model": 64, "num_heads": 4,
              "num_kv_heads": 2, "head_dim": 16, "d_ff": 32, "vocab_size": 256, "rope_style": "full",
              "norm": "rmsnorm", "mlp_act": "swiglu", "tie_embeddings": True, "dtype": "float32",
              "remat": True, "moe": {"num_experts": 8, "top_k": 2, "expert_ff": 32, "capacity_factor": 1.25,
                                     "layout": "all", "adaptive": True}}}
TINY_SSM = {
    "name": "tiny-ssm", "ep_shards": 1,
    "model": {"name": "tiny-ssm", "family": "ssm", "num_layers": 2, "d_model": 64, "num_heads": 0,
              "num_kv_heads": 0, "d_ff": 0, "vocab_size": 256, "rope_style": "none", "norm": "rmsnorm",
              "tie_embeddings": True, "dtype": "float32", "remat": True,
              "mamba": {"d_state": 16, "head_dim": 16, "expand": 2, "conv_width": 4, "chunk": 16}}}
#: The stand-ins by the names the tests know them by.
TINY_CONFIGS = {"granite-moe-1b-a400m": TINY_MOE, "tiny-ssm": TINY_SSM}
#: The state-space stand-ins: cell -> (traffic, the cell whose end-to-end
#: and per-layer metrics it shares, its kernels' roofline metric).
SSM_CELLS = {"mamba2.train.text": ("text", "granite-moe.train.skewed", "ssd_scan_roofline.train"),
             "mamba2.serve.batch": ("batch", "granite-moe.serve.skewed", "ssd_scan_roofline.serve")}
TINY_TRAFFIC = {"batch": 4, "seq_len": 64, "num_shards": 4, "doc_len_mean": 20, "doc_len_min": 4,
                "doc_len_max": 64, "prompts": 8, "prompt_len": 32, "decode_steps": 10, "traced_decode_steps": 3,
                "traced_steps": 1}


def pytest_configure(config):
    config.addinivalue_line("markers", "h100: needs an NVIDIA H100 (CUDA); skipped elsewhere")


@pytest.fixture
def cuda_device():
    """The first CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device on this machine: the test runs on the H100")
    return torch.device("cuda", 0)


def stand_in(name: str, model: dict) -> dict:
    """The tiny stand-in of configuration ``name``, by its ``model``'s kind
    of block."""
    if "moe" in model:
        return TINY_MOE
    if "mamba" in model:
        return TINY_SSM
    raise ValueError(f"configuration {name!r} needs a stand-in in h100bench/conftest.py: its model has "
                     "neither 'moe' nor 'mamba'")


def tiny_cells(bench: dict) -> list:
    """The cells of the tiny tree built from ``bench``: its own, then the
    state-space stand-ins it lacks."""
    names = [w["name"] for w in bench["workloads"]]
    return names + [c for c in SSM_CELLS if c not in names]


def make_tiny_root(tmp: Path, dtype: str = "float32", bench: dict | None = None) -> Path:
    """A checkout-shaped directory: the cells, metrics and traffic mixes of
    ``bench`` (the repo's ``BENCHMARK.json`` by default; its configuration
    files are read from the repo, or from where an absolute ``file`` says),
    traffic sizes cut and each configuration swapped for its stand-in."""
    bench = json.loads(json.dumps(bench) if bench is not None else (REPO / "BENCHMARK.json").read_text())
    tiny = {c["name"]: stand_in(c["name"], json.loads((REPO / c["file"]).read_text())["model"])
            for c in bench["configs"]}
    bench = with_ssm_cells(bench)
    (tmp / "h100bench" / "configs").mkdir(parents=True)
    (tmp / "h100bench" / "traffic").mkdir(parents=True)
    shutil.copytree(HERE / "metrics", tmp / "h100bench" / "metrics")
    for c in bench["configs"]:
        # The one configuration without a file is the stand-in cells' own.
        doc = dict(tiny.get(c["name"], TINY_SSM), optimizer=OPTIMIZER, init=INIT, limits=TINY_LIMITS)
        doc["model"] = dict(doc["model"], dtype=dtype)
        c["file"] = f"h100bench/configs/{c['name']}.json"
        (tmp / c["file"]).write_text(json.dumps(doc))
    for f in (HERE / "traffic").glob("*.json"):
        mix = json.loads(f.read_text())
        mix.update({k: v for k, v in TINY_TRAFFIC.items() if k in mix})
        (tmp / "h100bench" / "traffic" / f.name).write_text(json.dumps(mix))
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def with_ssm_cells(bench: dict) -> dict:
    """``bench`` with the state-space stand-ins it lacks added as data: each
    cell, with its name on the metrics the cell it follows reports (the MoE
    kernels' roofline aside), its scan roofline metric where ``bench`` has
    none of that name, and their configuration where a cell was added."""
    have = {w["name"] for w in bench["workloads"]}
    metrics = {m["name"] for m in bench["per_layer"]}
    missing = [cell for cell in SSM_CELLS if cell not in have]
    if missing:
        bench["configs"].append({"name": "tiny-ssm", "source": "arXiv:2405.21060", "file": "",
                                 "reduced": [], "why": "state-space layers"})
    by_kind = {"train_tokens_per_s": "train", "gen_tokens_per_s": "serve"}
    for cell in missing:
        traffic, follows, roofline = SSM_CELLS[cell]
        bench["workloads"].append({"name": cell, "config": "tiny-ssm", "traffic": traffic, "chips": 1,
                                   "why": "stand-in"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if follows in m.get("workloads", ()) and not m["name"].startswith("moe_kernels_roofline"):
                m["workloads"].append(cell)
        if roofline not in metrics:
            moves = next(n for n, kind in by_kind.items() if f".{kind}." in cell)
            bench["per_layer"].append({"name": roofline, "unit": "%", "better": "higher",
                                       "source": "device_trace", "layer": "kernels", "moves": moves,
                                       "workloads": [cell]})
    return bench


@contextlib.contextmanager
def one_thread():
    """One intra-op thread: the tiny cells' ops gain nothing from more, and
    six test workers would share the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture
def tiny_root(tmp_path):
    """The tiny tree of the repo's BENCHMARK.json, run with one thread."""
    with one_thread():
        yield make_tiny_root(tmp_path)
