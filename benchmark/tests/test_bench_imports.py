"""What the benchmark loads: no JAX, no JAX package (top-level names
compared whole: the port's name begins with the JAX package's), nothing
of the repository's root tools; the reference and the check nothing of
the program. And a run refuses without a card."""
from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import run
from benchmark.tests.conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "dualpixelface_tpu", "tools", "bench", "chip_smoke",
             "__graft_entry__"}


def _loaded(*modules: str, files: str = "") -> set:
    """Top-level names loaded by importing `modules` and the benchmark's
    files under the glob `files` (as the harness loads them, by path)."""
    code = ("import sys, json, glob\n" + "".join(f"import {m}\n" for m in modules)
            + (f"from benchmark import spec\nfor p in sorted(glob.glob({files!r})):\n    spec.module(p)\n"
               if files else "")
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(REPO)}, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_and_no_root_tool():
    loaded = _loaded("benchmark.run", "benchmark.system", "benchmark.calibrate", "benchmark.work.flops",
                     files="benchmark/*/*.py")
    assert "dualpixelface_tpu_torch" in loaded
    assert not loaded & FORBIDDEN


def test_the_reference_and_the_check_load_nothing_of_the_program():
    loaded = _loaded("benchmark.check", "benchmark.generate", "benchmark.trace", files="benchmark/reference/*.py")
    assert not loaded & (FORBIDDEN | {"dualpixelface_tpu_torch"})


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "dualpixelface_tpu_torch_extra", sys)
    assert "dualpixelface_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "flax.core", sys)
    assert run.forbidden_modules() == ["flax"]


def test_a_run_without_a_card_fails_and_prints_nothing(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "stereodpnet_plus.serve.bf16.b4", "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA" in out.err


def test_a_run_from_the_benchmark_alone_fails(tmp_path):
    from benchmark.tests.conftest import copy_benchmark

    root = copy_benchmark(tmp_path)
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "stereodpnet.serve.f32.b4",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=root, capture_output=True,
                          text=True, timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""
