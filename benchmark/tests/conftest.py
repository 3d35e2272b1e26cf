"""Fixtures of the benchmark's own tests (run with ``python -m pytest
benchmark/tests`` from the repository's root; the cases marked ``cuda``
decide inside the test whether there is a card, and skip without one)."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DATA = Path(__file__).resolve().parent / "data"


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card; skips without one")


def copy_benchmark(dest: Path, bench: dict | None = None) -> Path:
    """A copy of the benchmark under ``dest`` with the tests' tiny
    configuration and cells added as files; returns its BENCHMARK.json."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "tests", "__pycache__"))
    for sub in ("configs", "workloads"):
        for f in (DATA / sub).iterdir():
            shutil.copy(f, dest / "benchmark" / sub / f.name)
    path = dest / "BENCHMARK.json"
    path.write_text(json.dumps(bench or json.loads((DATA / "BENCHMARK.json").read_text())))
    return path


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    """The tiny benchmark's BENCHMARK.json in a temporary copy, its caches
    kept there too."""
    from benchmark.harness import scene

    monkeypatch.setattr(scene, "CACHE", tmp_path / "cache")
    return copy_benchmark(tmp_path)
