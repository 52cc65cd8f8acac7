"""Build and load the port's hand-written CUDA kernels.

Each ``ops/csrc/<name>.cu`` has a plain C interface. At first use it is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``<repo>/build/kernels/``, named by a hash of its source and flags so that
an edited ``.cu`` rebuilds, and loaded with ``ctypes``. Building takes
seconds; nothing is built when a module is imported.

``launch_range(entry)`` marks a kernel's launch for torch.profiler: while it
records, the launch runs inside a range named ``maskdit::<entry>`` (the C
function's name), so that tools/torch_trace_report.py can tell the port's
kernels apart where two libraries share a kernel's name (#2 and #4 launch
the same tensor-core backward, #3 and #5 the same forward); otherwise it
costs one flag check.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# The whole-row, the blocked and the flash kernels' libraries also hold the
# fp32 tensor-core kernels (csrc/attention_fp32_mma.cuh: one forward or two
# backward kernels x 16 head dims of unrolled mma.sync), minutes of nvcc's
# optimizer on one thread; -split-compile=0 runs it on every core. Their
# bf16 kernels' SASS is the same either way.
KERNEL_FLAGS = {
    name: ("-split-compile=0",)
    for name in ("packed_attention_fwd", "packed_attention_bwd",
                 "packed_attention_big_fwd", "packed_attention_big_bwd", "flash_fwd",
                 "flash_bwd")
}


def flags(name: str) -> tuple:
    """nvcc's flags for ``csrc/<name>.cu``: NVCC_FLAGS, then the kernel's
    own."""
    return (*NVCC_FLAGS, *KERNEL_FLAGS.get(name, ()))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str, csrc: Path = CSRC) -> Path:
    """Where the build of ``<csrc>/<name>.cu`` goes, keyed by the source,
    every header in ``csrc`` (any of them may be included) and the flags."""
    digest = hashlib.sha256()
    for path in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))]:
        digest.update(path.name.encode() + b"\0" + path.read_bytes())
    digest.update(" ".join(flags(name)).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> tuple[Path, float]:
    """Compile ``csrc/<name>.cu`` unless its build exists.

    Returns the library's path and the seconds spent compiling (0.0 when
    the build existed). The compiler's report (``-Xptxas -v``: registers,
    shared memory, spills) is kept beside the library as ``.log``.
    """
    lib = library_path(name)
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    # compile to a private name, then rename: concurrent builders never see
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *flags(name), "-o", tmp, str(CSRC / f"{name}.cu")],
            capture_output=True, text=True,
        )
        lib.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib, time.perf_counter() - t0


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    lib, _ = build(name)
    return ctypes.CDLL(str(lib))


RANGE_PREFIX = "maskdit::"


def launch_range(entry: str):
    """A profiler range ``maskdit::<entry>`` while torch.profiler records,
    else a context that does nothing."""
    import torch

    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(RANGE_PREFIX + entry)
    return contextlib.nullcontext()
