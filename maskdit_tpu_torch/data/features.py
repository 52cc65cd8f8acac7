"""Feature LMDBs for external-feature conditioning (``model.ext_feature_dim``).

Counterpart of maskdit_tpu/data/features.py (reference: retrieve_n_features,
sample.py:192-227). A feature LMDB has the latent LMDB's layout: keys
``feat-{i}`` (float32 bytes), ``y-{i}`` (int text) and ``length`` (int text,
twice the rows a sampler draws from, as the reference stores it). Training
joins it record by record (``ImageNetLatentDataset(feat_path=...)``);
sampling draws (feature, label) rows from it in one of three modes:
``rand_full`` (iid rows), ``rand_repeat`` (one row repeated) and ``rand_y``
(one feature, random labels).
"""

from __future__ import annotations

import os
import random
from typing import Optional

import numpy as np

from maskdit_tpu_torch.data import lmdb_lite
from maskdit_tpu_torch.data.native_io import open_reader

SAMPLE_MODES = ("rand_full", "rand_repeat", "rand_y")


def retrieve_n_features(
    batch_size: int,
    feat_path: str,
    feat_dim: int,
    num_classes: int,
    split: str = "train",
    sample_mode: str = "rand_full",
    seed: Optional[int] = None,
    native: bool = True,
) -> tuple[np.ndarray, np.ndarray]:
    """(features (B, feat_dim) float32, one-hot labels (B, K) float32) from
    the feature LMDB at ``feat_path/split``, the rows chosen by
    ``random.Random(seed)`` as the JAX function chooses them."""
    rng = random.Random(seed)
    db = open_reader(os.path.join(feat_path, split), native=native)
    try:
        pool = int(db.get(b"length").decode("utf-8")) // 2
        if sample_mode == "rand_full":
            ids = rng.sample(range(pool), batch_size)
            ids_y = ids
        elif sample_mode == "rand_repeat":
            ids = rng.sample(range(pool), 1) * batch_size
            ids_y = ids
        elif sample_mode == "rand_y":
            ids = rng.sample(range(pool), 1) * batch_size
            ids_y = rng.sample(range(pool), batch_size)
        else:
            raise NotImplementedError(f"sample_mode '{sample_mode}'")
        features = np.stack([
            np.frombuffer(db.get(f"feat-{i}".encode()), dtype=np.float32).reshape([feat_dim])
            for i in ids
        ])
        labels = [int(db.get(f"y-{i}".encode()).decode("utf-8")) for i in ids_y]
    finally:
        db.close()
    onehot = np.zeros((batch_size, num_classes), dtype=np.float32)
    if num_classes > 0:
        onehot[np.arange(batch_size), np.asarray(labels)] = 1.0
    return features, onehot


def write_feature_lmdb(path: str, features: np.ndarray, labels: np.ndarray) -> None:
    """Write (N, feat_dim) features and their (N,) labels as a feature LMDB
    at ``path`` (a split directory), ``length`` 2N as the reference stores
    it."""
    with lmdb_lite.Writer(path) as w:
        for i, (feat, label) in enumerate(zip(features, labels)):
            w.put(f"feat-{i}", np.asarray(feat, np.float32).tobytes())
            w.put(f"y-{i}", str(int(label)))
        w.put("length", str(2 * len(features)))
