"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
reference imports nothing of the program.

Each import's top-level name (before the first dot) is compared whole, so
``repro_torch`` is not ``repro``.  The reference must not import
``repro_torch``, and no file here reads the JAX package's benchmarks
(``benchmarks/``, ``BENCH_*.json``)."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from h100bench.conftest import HERE, REPO
from h100bench.run import FORBIDDEN

SOURCES = sorted(HERE.rglob("*.py"))


def top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_sources_are_found():
    names = {p.relative_to(HERE).as_posix() for p in SOURCES}
    assert {"run.py", "control.py", "reference/decoder.py", "drivers/train.py"} <= names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: p.relative_to(HERE).as_posix())
def test_no_jax_and_no_jax_package(path):
    found = set(top_level_imports(path)) & set(FORBIDDEN)
    assert not found, f"{path} imports {found}"


@pytest.mark.parametrize("path", sorted((HERE / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in set(top_level_imports(path))


@pytest.mark.parametrize("path", [p for p in SOURCES if p.name != Path(__file__).name],
                         ids=lambda p: p.relative_to(HERE).as_posix())
def test_nothing_reads_the_jax_packages_benchmarks(path):
    text = path.read_text()
    assert "benchmarks/" not in text and "BENCH_" not in text


def test_the_run_loads_neither_jax_nor_the_jax_package():
    """Importing every module of the harness, the drivers and the port's
    timed path loads none of them."""
    code = ("import sys; sys.path[:0] = ['src', '.']\n"
            "import h100bench.run, h100bench.control, h100bench.drivers.train, h100bench.drivers.serve\n"
            "import repro_torch.train.step, repro_torch.data.pipeline, repro_torch.models.model_api\n"
            "from h100bench.run import forbidden_modules\n"
            "print(forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
