"""The port's kernel build: sources are found, libraries are named by a hash
of the source, and a build that cannot run raises instead of falling back."""

import os

import pytest

from consensus_entropy_tpu_torch.kernels import build


def test_sources_are_the_csrc_cuda_files():
    assert "linear_mc" in build.sources()
    for name in build.sources():
        assert os.path.exists(os.path.join(build.SRC_DIR, name + ".cu"))


def test_library_name_follows_the_source(tmp_path, monkeypatch):
    monkeypatch.setattr(build, "SRC_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = build.library_path("k")
    src.write_text("// two\n")
    second = build.library_path("k")
    assert first != second
    assert os.path.dirname(first) == str(tmp_path / "_build")
    assert os.path.basename(first).startswith("k-")


def test_library_name_follows_a_header(tmp_path, monkeypatch):
    # An edited header must not reuse a library built from the old one.
    monkeypatch.setattr(build, "SRC_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    header = tmp_path / "k.cuh"
    header.write_text("// one\n")
    first = build.library_path("k")
    assert build.library_path("k") == first
    header.write_text("// two\n")
    assert build.library_path("k") != first
    (tmp_path / "other.h").write_text("// three\n")
    assert build.library_path("k") not in (first, build.library_path("other"))


def test_a_build_that_cannot_run_raises(tmp_path, monkeypatch):
    # Without nvcc the build raises; with one, this source fails to compile
    # and the build raises with the compiler's log.  Either way no library.
    monkeypatch.setattr(build, "SRC_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    (tmp_path / "broken.cu").write_text("this is not CUDA C++\n")
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()
    assert not os.path.exists(build.library_path("broken"))
    assert os.listdir(tmp_path / "_build") == []
