"""The CUDA build's cache key: ``kernels._build.lib_path`` names each
library by a hash of its source, of every shared header and of the flags,
so that an edit to a header rebuilds every library that may include it.
Runs no ``nvcc``."""
import shutil

import pytest

from repro_torch.kernels import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources that ``_build`` reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def test_sources_and_a_shared_header_exist():
    assert all((_build.CSRC / f"{n}.cu").is_file() for n in _build.SOURCES)
    assert (_build.CSRC / "sm90_gemm.cuh").is_file()


@pytest.mark.parametrize("name", _build.SOURCES)
def test_header_edit_changes_every_library_path(csrc, name):
    before = _build.lib_path(name)
    assert _build.lib_path(name) == before  # the same files, the same name
    header = csrc / "sm90_gemm.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = _build.lib_path(name)
    assert after != before and after.parent == before.parent


@pytest.mark.parametrize("name", _build.SOURCES)
def test_a_new_header_changes_the_path(csrc, name):
    before = _build.lib_path(name)
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert _build.lib_path(name) != before


def test_source_edit_changes_only_its_library(csrc):
    before = {n: _build.lib_path(n) for n in _build.SOURCES}
    src = csrc / "grouped_gemm.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: _build.lib_path(n) for n in _build.SOURCES}
    assert after["grouped_gemm"] != before["grouped_gemm"]
    assert all(after[n] == before[n] for n in _build.SOURCES if n != "grouped_gemm")
