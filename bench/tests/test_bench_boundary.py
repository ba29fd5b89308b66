"""The benchmark stands apart: nothing under bench/ imports jax, jaxlib or
the JAX package ``repro`` (top-level names compared whole, so that
``repro_torch`` is not taken for ``repro``); the references import nothing
of the port; nothing reads the ``benchmarks`` folder; without a card a run exits
non-zero and prints no result."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH_FILES = sorted((ROOT / "bench").rglob("*.py"))
REFERENCE_FILES = sorted((ROOT / "bench" / "reference").rglob("*.py"))


def top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def rel(p: Path) -> str:
    return str(p.relative_to(ROOT))


@pytest.mark.parametrize("path", BENCH_FILES, ids=rel)
def test_no_jax_or_jax_package(path):
    assert not top_level_imports(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", REFERENCE_FILES, ids=rel)
def test_reference_imports_nothing_of_the_port(path):
    assert top_level_imports(path) <= {"__future__", "math", "torch"}


@pytest.mark.parametrize("path", BENCH_FILES, ids=rel)
def test_nothing_reads_benchmarks(path):
    assert "benchmarks" not in top_level_imports(path)
    assert "benchmarks" + "/" not in path.read_text()


def test_top_level_names_compared_whole():
    from bench.harness import FORBIDDEN
    assert "repro" in FORBIDDEN and "repro_torch".split(".")[0] not in FORBIDDEN


def test_run_without_card_exits_without_result(tmp_path):
    """Run from a directory holding only BENCHMARK.json and bench/: no card
    (and no port) here, so it exits non-zero and prints nothing."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "bench/run.py", "--workload", "qwen3-decode",
                           "--seed", "4294967311", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
