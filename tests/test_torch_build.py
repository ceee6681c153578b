"""The port's kernel build (`ops/kernels/_build.py`), on the CPU: a
library's name hashes its source and every header the source includes, so
an edited header rebuilds each kernel that uses it and no other. Nothing is
compiled here; the edits are made on a copy of `csrc/`."""
import re
import shutil

import pytest

from dualpixelface_tpu_torch.ops.kernels import _build

HEADERS = sorted(p.name for p in _build.CSRC.glob("*.cuh"))


def _quoted_includes(path):
    return re.findall(r'^\s*#\s*include\s+"([^"]+)"', path.read_text(), re.MULTILINE)


def test_every_source_is_a_kernel():
    assert sorted(p.stem for p in _build.CSRC.glob("*.cu")) == sorted(_build.KERNELS)


@pytest.mark.parametrize("name", _build.KERNELS)
def test_every_quoted_include_is_hashed(name):
    """Each `#include "..."` of the source, and of each header it reaches,
    is among the files its library's hash covers."""
    covered = {p.name for p in _build.sources(name)}
    assert f"{name}.cu" in covered
    for f in _build.sources(name):
        assert set(_quoted_includes(f)) <= covered, f.name


@pytest.mark.parametrize("header", HEADERS)
def test_editing_a_header_renames_the_libraries_that_include_it(header, tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    users = {n for n in _build.KERNELS if header in {p.name for p in _build.sources(n)}}
    assert users, f"{header} is included by no kernel"
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.KERNELS}
    with open(csrc / header, "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.KERNELS}
    assert {n for n in _build.KERNELS if after[n] != before[n]} == users


def test_editing_a_source_renames_only_its_library(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {n: _build.library_path(n) for n in _build.KERNELS}
    with open(csrc / "conv3d_dslice.cu", "a") as f:
        f.write("\n// edited\n")
    after = {n: _build.library_path(n) for n in _build.KERNELS}
    assert {n for n in _build.KERNELS if after[n] != before[n]} == {"conv3d_dslice"}
