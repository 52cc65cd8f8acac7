"""Datasets of the port.

Counterpart of maskdit_tpu/data/datasets.py, of its synthetic latent
dataset only (datasets.py:455-476): the JAX module imports Pillow at its
top, which the port's training path does not need. The LMDB and WDS latent
datasets come later.
"""

from __future__ import annotations

import numpy as np


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
