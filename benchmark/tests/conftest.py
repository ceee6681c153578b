"""Shared pieces of the benchmark's own tests (run with
`python -m pytest benchmark/tests -q` from the repository root). Tests that
need a CUDA card carry the `card` marker and skip without one; the decision
is taken inside the `card` fixture, never at import."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
# The tiny size every CPU run of a cell takes: the network needs H and W
# divisible by 16.
TINY = {"height": 64, "width": 48, "batch": 2, "pool": 2, "profile_calls": 1}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def copy_benchmark(dst: Path) -> Path:
    """BENCHMARK.json and benchmark/ copied to `dst`: a checkout of the
    benchmark alone."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(REPO / "benchmark", dst / "benchmark", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    """A copy of the benchmark whose mixes run at the TINY size."""
    root = copy_benchmark(tmp_path_factory.mktemp("tiny"))
    for p in (root / "benchmark" / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        mix.update(TINY)
        mix.update({k: 1 for k in ("check_batches",) if k in mix})
        mix.update({k: 2 for k in ("check_steps",) if k in mix})
        p.write_text(json.dumps(mix))
    return root
