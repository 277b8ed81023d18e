"""The kernel build's cache key, on the CPU: a library's path hashes its
``.cu`` source and every ``csrc/`` header it includes, so that an edited
header rebuilds every library that includes it and no other. No nvcc is
needed: only the paths are computed."""

import shutil

import pytest

from encdiff_tpu_torch.nn.kernels import build

#: the sources that include the shared 3xTF32 / cp.async header
INCLUDERS = ("attention_core", "flash_attention", "fused_attention",
             "groupnorm_silu", "mma_probe")


def test_every_kernel_source_includes_the_shared_header():
    for name in build.NAMES:
        names = [p.name for p in build.sources(name)]
        assert names[0] == f"{name}.cu"
        assert ("tf32_mma.cuh" in names) == (name in INCLUDERS)


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    copy = tmp_path / "csrc"
    shutil.copytree(build.CSRC, copy)
    monkeypatch.setattr(build, "CSRC", copy)
    return copy


def test_editing_a_header_changes_the_library_path(csrc_copy):
    before = {name: build.library_path(name) for name in build.NAMES}
    header = csrc_copy / "tf32_mma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: build.library_path(name) for name in build.NAMES}
    for name in build.NAMES:
        assert (after[name] != before[name]) == (name in INCLUDERS), name


def test_a_header_included_through_another_counts(csrc_copy):
    (csrc_copy / "inner.cuh").write_text("#pragma once\n")
    header = csrc_copy / "tf32_mma.cuh"
    header.write_text('#include "inner.cuh"\n' + header.read_text())
    assert "inner.cuh" in [p.name for p in build.sources("flash_attention")]
    before = build.library_path("flash_attention")
    (csrc_copy / "inner.cuh").write_text("#pragma once\n// edited\n")
    assert build.library_path("flash_attention") != before


def test_editing_a_source_changes_only_its_library_path(csrc_copy):
    before = {name: build.library_path(name) for name in build.NAMES}
    src = csrc_copy / "attention_core.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    for name in build.NAMES:
        assert ((build.library_path(name) != before[name])
                == (name == "attention_core")), name
