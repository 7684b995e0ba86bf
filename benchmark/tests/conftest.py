"""Fixtures of the benchmark's own tests: a checkout-like root holding
``BENCHMARK.json`` and ``benchmark/`` (its data cache included), with the
program importable from the repository."""

import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
REPO = BENCH.parent
sys.path.insert(0, str(BENCH))
sys.path.insert(0, str(REPO))


@pytest.fixture(scope="session")
def bench_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("checkout")
    shutil.copy(REPO / "BENCHMARK.json", root / "BENCHMARK.json")
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    return root
