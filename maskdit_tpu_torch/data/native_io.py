"""The native LMDB reader: data/csrc/lmdb_lite.cc, built with g++ at first
use and bound with ctypes.

Counterpart of maskdit_tpu/data/native_io.py, with two differences:

- the library is the port's own copy of the source, compiled into
  ``<repo>/build/native/`` under a name keyed by a hash of the source and
  the flags (as ops/build.py keys the kernels), never into ``native/``;
- there is no silent fallback. ``open_reader(path)`` returns the native
  reader or raises with the compiler's message; the pure-Python reader
  (data/lmdb_lite.py) is used only when the caller asks for it with
  ``native=False``. Each reader names its kind (``reader.kind``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Union

from maskdit_tpu_torch.data import lmdb_lite

SOURCE = Path(__file__).resolve().parent / "csrc" / "lmdb_lite.cc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Wextra")

_libs: dict[Path, ctypes.CDLL] = {}
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libmaskdit_io-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``SOURCE`` unless its build exists; raises RuntimeError
    with the compiler's output."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if cxx is None:
        raise RuntimeError("the native LMDB reader needs a C++ compiler (g++), found none")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent builders never see
    # a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the native LMDB reader from {SOURCE} failed "
                               f"(exit {proc.returncode}):\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    with _lock:
        path = build()
        if path not in _libs:
            lib = ctypes.CDLL(str(path))
            lib.mdbl_open.restype = ctypes.c_void_p
            lib.mdbl_open.argtypes = [ctypes.c_char_p]
            lib.mdbl_close.argtypes = [ctypes.c_void_p]
            lib.mdbl_entries.restype = ctypes.c_int64
            lib.mdbl_entries.argtypes = [ctypes.c_void_p]
            lib.mdbl_get.restype = ctypes.c_int
            lib.mdbl_get.argtypes = [
                ctypes.c_void_p,
                ctypes.c_char_p, ctypes.c_size_t,
                ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_size_t),
            ]
            _libs[path] = lib
        return _libs[path]


class NativeReader:
    """LMDB reader backed by the C++ mmap implementation; ``get`` returns a
    copy of the value (the C side points into its map)."""

    kind = "native"

    def __init__(self, path: str):
        self._lib = load()
        self._h = self._lib.mdbl_open(os.fsencode(path))
        if not self._h:
            raise IOError(f"{path}: not an LMDB data file")
        self.entries = self._lib.mdbl_entries(self._h)

    def get(self, key: Union[bytes, str]) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode("utf-8")
        val = ctypes.c_void_p()
        vlen = ctypes.c_size_t()
        rc = self._lib.mdbl_get(self._h, key, len(key), ctypes.byref(val), ctypes.byref(vlen))
        if rc != 0:
            return None
        return ctypes.string_at(val.value, vlen.value)

    def __len__(self) -> int:
        return int(self.entries)

    def close(self) -> None:
        if self._h:
            self._lib.mdbl_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def open_reader(path: str, native: bool = True):
    """The native reader of ``path`` (built at first use; raises if it
    cannot be), or the pure-Python one when ``native`` is False."""
    return NativeReader(path) if native else lmdb_lite.Reader(path)
