"""Files by name: a cell of ``BENCHMARK.json``, its configuration file, its
traffic file, its driver and the readers of its per-layer metrics."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

HERE = Path(__file__).resolve().parents[1]          # h100bench/
ROOT = HERE.parent                                  # the checkout


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    chips: int
    config: Dict
    mix: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _reports(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(workload: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    mix = json.loads((root / "h100bench" / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return Cell(workload, w["config"], w["traffic"], int(w["chips"]), config, mix, e2e, per_layer)


def driver(name: str):
    """The driver module ``drivers/<name>.py``."""
    return importlib.import_module(f"h100bench.drivers.{name}")


def reader(metric: str, root: Path = ROOT) -> Callable[[Any], Optional[float]]:
    """``read`` of ``metrics/<metric>.py``."""
    path = root / "h100bench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """One run of a cell: what the driver measured, for the end-to-end
    metrics, the readers and the result line."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float                                   # process start, time.perf_counter()
    end_to_end: Dict[str, float] = dataclasses.field(default_factory=dict)
    readings: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spans: Dict[str, List[float]] = dataclasses.field(default_factory=dict)
    window_s: float = 0.0
    traced: Any = None                               # lib.trace.Trace of the traced stretch
    traced_info: Dict[str, Any] = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    attempted: int = 0
    failed: int = 0
    numbers: Dict[str, float] = dataclasses.field(default_factory=dict)

    @property
    def doc(self) -> Dict:
        return self.cell.config

    @property
    def mix(self) -> Dict:
        return self.cell.mix

    def limits(self, kind: str) -> Dict[str, Optional[float]]:
        return dict(self.doc.get("limits", {}).get(kind, {}))
