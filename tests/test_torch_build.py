"""The port's kernel build key (ops/build.py): a library is named by a hash
of its source, every header beside it and the flags, so that an edited
header is never served by a stale build. Runs on the CPU: nothing is
compiled."""

import pytest

from maskdit_tpu_torch.ops import build


@pytest.fixture
def csrc(tmp_path):
    (tmp_path / "kernel.cu").write_text('#include "shared.cuh"\nint kernel() { return f(); }\n')
    (tmp_path / "other.cu").write_text("int other() { return 1; }\n")
    (tmp_path / "shared.cuh").write_text("inline int f() { return 1; }\n")
    return tmp_path


def test_library_path_is_stable_and_named_after_the_kernel(csrc):
    path = build.library_path("kernel", csrc)
    assert path == build.library_path("kernel", csrc)
    assert path.parent == build.BUILD_DIR and path.name.startswith("kernel-")
    assert path.suffix == ".so"


@pytest.mark.parametrize("edit", ["shared.cuh", "kernel.cu", "new.cuh"])
def test_library_path_changes_with_the_source_or_any_header(csrc, edit):
    """An edited header, an edited source and a new header each give a new
    library path."""
    before = build.library_path("kernel", csrc)
    target = csrc / edit
    target.write_text((target.read_text() if target.exists() else "") + "// edited\n")
    assert build.library_path("kernel", csrc) != before


def test_library_path_ignores_other_sources(csrc):
    before = build.library_path("kernel", csrc)
    (csrc / "other.cu").write_text("int other() { return 2; }\n")
    assert build.library_path("kernel", csrc) == before


def test_library_path_changes_with_the_flags(csrc, monkeypatch):
    """A kernel's own flags give a new library path; the whole-row, the
    blocked and the flash kernels (each library holds fp32 tensor-core
    kernels) build with nvcc's optimizer on every core."""
    before = build.library_path("kernel", csrc)
    monkeypatch.setitem(build.KERNEL_FLAGS, "kernel", ("-split-compile=0",))
    assert build.library_path("kernel", csrc) != before
    assert build.flags("kernel")[-1] == "-split-compile=0"
    for name in ("packed_attention_fwd", "packed_attention_bwd",
                 "packed_attention_big_fwd", "packed_attention_big_bwd", "flash_fwd",
                 "flash_bwd"):
        assert "-split-compile=0" in build.flags(name)
    assert build.flags("fused_adam_ema") == build.NVCC_FLAGS
