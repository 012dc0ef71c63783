"""The port's kernel build cache on the CPU: a library is named by a hash
of its source, the shared headers and the flags, so that editing a header
that two kernels include rebuilds both (no stale library is loaded)."""

import shutil

import pytest

from repro_torch.kernels import runtime

KERNELS = ("paged_decode", "paged_verify", "bitstopper_qk", "flash_attention")


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of the kernel sources that the runtime reads instead."""
    copy = tmp_path / "csrc"
    shutil.copytree(runtime.CSRC, copy)
    monkeypatch.setattr(runtime, "CSRC", copy)
    monkeypatch.setattr(runtime, "BUILD_DIR", tmp_path / "build")
    return copy


def test_paged_kernels_include_the_shared_walk():
    for name in ("paged_decode", "paged_verify"):
        text = (runtime.CSRC / f"{name}.cu").read_text()
        assert '#include "paged_walk.cuh"' in text


@pytest.mark.parametrize("name", KERNELS)
def test_library_digest_follows_headers_sources_and_flags(csrc, monkeypatch,
                                                          name):
    before = runtime._library_path(name)
    assert runtime._library_path(name) == before          # deterministic
    assert before.parent == runtime.BUILD_DIR
    header = csrc / "paged_walk.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after_header = runtime._library_path(name)
    assert after_header != before
    source = csrc / f"{name}.cu"
    source.write_text(source.read_text() + "\n// edited\n")
    after_source = runtime._library_path(name)
    assert after_source not in (before, after_header)
    monkeypatch.setattr(runtime, "NVCC_FLAGS", runtime.NVCC_FLAGS + ("-G",))
    assert runtime._library_path(name) != after_source


def test_new_header_changes_the_digest(csrc):
    before = runtime._library_path("paged_verify")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert runtime._library_path("paged_verify") != before


@pytest.mark.parametrize("name", ["paged_decode", "paged_verify"])
def test_bf16_library_builds_from_the_same_source(csrc, name):
    """A paged kernel's bf16-V library is its source built with
    ``-DPAGED_V_BF16``: a library of its own (its own digest), rebuilt when
    that source or a header changes; the source picks its V type by the
    macro."""
    src, extra = runtime._source(f"{name}_bf16")
    assert src == runtime._source(name)[0] == csrc / f"{name}.cu"
    assert extra == ("-DPAGED_V_BF16",) and runtime._source(name)[1] == ()
    assert "#ifdef PAGED_V_BF16" in src.read_text()
    before = runtime._library_path(f"{name}_bf16")
    assert before != runtime._library_path(name)
    assert before.name.startswith(f"lib{name}_bf16_")
    src.write_text(src.read_text() + "\n// edited\n")
    assert runtime._library_path(f"{name}_bf16") != before
