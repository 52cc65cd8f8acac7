"""Datasets of the port.

Counterpart of maskdit_tpu/data/datasets.py, of its synthetic latent
dataset (datasets.py:455-476) and of ``ImageFolderDataset`` (:242-370), the
FID ingestion path. The JAX module imports Pillow at its top; here PNGs go
through the port's own codec (``utils/png.py``) and Pillow is imported only
to decode another format (JPEG, BMP, WebP). The LMDB and WDS latent
datasets come later.
"""

from __future__ import annotations

import io
import os
import zipfile
from typing import Optional

import numpy as np

from maskdit_tpu_torch.utils.png import decode_png

IMAGE_EXTENSIONS = frozenset({".png", ".jpg", ".jpeg", ".bmp", ".webp"})


class SyntheticLatentDataset:
    """Deterministic fake VAE moments with class labels, for tests and
    benchmarks: record i holds ``np.random.RandomState(i)`` normals of shape
    (2C, R, R) (or (C, R, R) without ``moments``) and class ``i %
    label_dim``, returned one-hot, as the JAX dataset does."""

    def __init__(self, length: int = 256, resolution: int = 32, num_channels: int = 4,
                 label_dim: int = 1000, moments: bool = True):
        self.length = int(length)
        self.resolution = resolution
        self.channels = num_channels * 2 if moments else num_channels
        self.label_dim = int(label_dim)

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        if not 0 <= idx < self.length:
            raise IndexError(idx)
        rng = np.random.RandomState(idx % (1 << 31))
        z = rng.randn(self.channels, self.resolution, self.resolution).astype(np.float32)
        label = np.zeros((self.label_dim,), dtype=np.float32)
        if self.label_dim:
            label[idx % self.label_dim] = 1.0
        return z, label


class _DirSource:
    """Recursive directory listing with relative-path access."""

    def __init__(self, path: str):
        self._root = path
        found = []
        for base, _dirs, files in os.walk(path):
            rel_base = os.path.relpath(base, path)
            found += [f if rel_base == "." else os.path.join(rel_base, f) for f in files]
        self.names = sorted(n.replace(os.sep, "/") for n in found)

    def read(self, name: str) -> bytes:
        with open(os.path.join(self._root, name), "rb") as f:
            return f.read()

    def close(self) -> None:
        pass


class _ZipSource:
    """Zip-archive listing with member access (opened at the first read)."""

    def __init__(self, path: str):
        self._path = path
        self._zf: Optional[zipfile.ZipFile] = None
        with zipfile.ZipFile(path) as zf:
            self.names = sorted(i.filename for i in zf.infolist() if not i.is_dir())

    def read(self, name: str) -> bytes:
        if self._zf is None:
            self._zf = zipfile.ZipFile(self._path)
        return self._zf.read(name)

    def close(self) -> None:
        if self._zf is not None:
            self._zf.close()
            self._zf = None


def _decode_image_chw(data: bytes, name: str) -> np.ndarray:
    """Image bytes -> uint8 CHW (gray gets one channel). PNGs are decoded
    here; other formats need Pillow."""
    if name.lower().endswith(".png"):
        arr = decode_png(data, name)
    else:
        try:
            from PIL import Image
        except ImportError as exc:
            raise ImportError(f"decoding {name!r} needs Pillow, which is not installed "
                              "(the port reads PNGs without it)") from exc
        arr = np.asarray(Image.open(io.BytesIO(data)))
    if arr.dtype != np.uint8:
        raise ValueError(f"expected 8-bit image data in {name!r}")
    return arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)


class ImageFolderDataset:
    """The images of a directory tree or a zip archive, as uint8 CHW arrays
    in sorted name order, each with an empty label (the JAX dataset's
    ``label_dim=0``, as FID reads it); ``max_size`` keeps a random subset of
    that many, drawn from ``random_seed`` and kept in name order (the JAX
    ``plan_view``)."""

    def __init__(self, path: str, max_size: Optional[int] = None, random_seed: int = 0):
        if os.path.isdir(path):
            self._source = _DirSource(path)
        elif zipfile.is_zipfile(path):
            self._source = _ZipSource(path)
        else:
            raise IOError(f"image dataset path is neither a directory nor a zip archive: {path!r}")
        self._files = [n for n in self._source.names
                       if os.path.splitext(n)[1].lower() in IMAGE_EXTENSIONS]
        if not self._files:
            raise IOError(f"no decodable image files under {path!r}")
        ids = np.arange(len(self._files), dtype=np.int64)
        if max_size is not None and max_size < len(ids):
            keep = np.random.RandomState(random_seed % (1 << 31)).permutation(len(ids))
            ids = np.sort(ids[keep[:max_size]])
        self._view = ids

    def __len__(self) -> int:
        return len(self._view)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        name = self._files[int(self._view[idx])]
        image = _decode_image_chw(self._source.read(name), name)
        return image, np.zeros((0,), dtype=np.float32)

    def close(self) -> None:
        self._source.close()
