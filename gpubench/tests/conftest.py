"""Tiny copies of the benchmark for the CPU tests: a checkout root in a
temporary directory with the harness's files and a ``BENCHMARK.json`` of small
configurations that reuse the real cells' traffic and limits."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY_DATA = {
    "matching-canonical-25m": {"num_sources": 3000, "num_destinations": 40, "target_sparsity": 0.1,
                               "destination_seed": 42},
    "movielens-20m": {"num_users": 300, "num_movies": 400, "num_ratings": 9000, "min_ratings": 20,
                      "capacity": 2.0},
}
TINY_ITERATIONS = 16


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


def tiny_spec(real: dict) -> dict:
    """The real spec with each configuration cut to a tiny size."""
    spec = json.loads(json.dumps(real))
    for c in spec["configs"]:
        c["file"] = c["file"].replace(".json", "-tiny.json")
    return spec


def make_root(tmp_path: Path) -> Path:
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "gpubench", ignore=shutil.ignore_patterns("tests", "__pycache__"))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in real["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        cfg["data"].update(TINY_DATA[c["name"]])
        (root / c["file"].replace(".json", "-tiny.json")).write_text(json.dumps(cfg))
    for w in real["workloads"]:
        path = root / "gpubench" / "cells" / f"{w['name']}.json"
        cell = json.loads(path.read_text())
        cell["iterations_per_call"] = TINY_ITERATIONS
        path.write_text(json.dumps(cell))
    (root / "BENCHMARK.json").write_text(json.dumps(tiny_spec(real)))
    return root


@pytest.fixture
def tiny_root(tmp_path):
    return make_root(tmp_path)
