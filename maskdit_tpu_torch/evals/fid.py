"""FID: streaming Inception statistics and the Frechet distance.

Counterpart of maskdit_tpu/evals/fid.py (the reference's EDM-style
fid.py): features accumulate as (sum x, sum x^T x) in fp64, so memory is
O(d^2) whatever the sample count (fid.py:63-75), and the distance closes
with scipy's ``sqrtm`` (fid.py:87-91). Under several processes each
streams its rank-strided images and ``merge_across_hosts`` sums the
accumulators over them (maskdit_tpu/evals/fid.py:36, 88, 107-122).
"""

from __future__ import annotations

import os
from typing import Callable, Optional

import numpy as np
import scipy.linalg

from maskdit_tpu_torch.data.datasets import ImageFolderDataset
from maskdit_tpu_torch.parallel.dist import (
    all_reduce_sum_array, is_main_process, mprint, process_count, process_index,
)


class StreamingStats:
    """Accumulate mu / sigma from feature batches (fp64 accumulators)."""

    def __init__(self, dim: int = 2048):
        self.raw_mean = np.zeros(dim, dtype=np.float64)
        self.raw_cov = np.zeros((dim, dim), dtype=np.float64)
        self.count = 0

    def update(self, features: np.ndarray) -> None:
        f = np.asarray(features, dtype=np.float64)
        self.raw_mean += f.sum(axis=0)
        self.raw_cov += f.T @ f
        self.count += f.shape[0]

    def merge_across_hosts(self) -> None:
        """The sums over every process (unchanged with one)."""
        self.raw_mean = all_reduce_sum_array(self.raw_mean)
        self.raw_cov = all_reduce_sum_array(self.raw_cov)
        self.count = int(all_reduce_sum_array(np.asarray([self.count], np.int64))[0])

    def finalize(self) -> tuple[np.ndarray, np.ndarray]:
        mu = self.raw_mean / self.count
        sigma = self.raw_cov / self.count - np.outer(mu, mu)
        return mu, sigma


def calculate_fid_from_inception_stats(
    mu: np.ndarray, sigma: np.ndarray, mu_ref: np.ndarray, sigma_ref: np.ndarray
) -> float:
    """Frechet distance (reference: fid.py:87-91)."""
    m = np.square(mu - mu_ref).sum()
    s = scipy.linalg.sqrtm(np.dot(sigma, sigma_ref))
    return float(np.real(m + np.trace(sigma + sigma_ref - s * 2)))


def calculate_inception_stats(
    image_path: str,
    detector: Callable,
    num_expected: Optional[int] = None,
    seed: int = 0,
    max_batch_size: int = 64,
    feature: str = "pool",
) -> tuple[np.ndarray, np.ndarray]:
    """Stream an image folder through the detector (reference: fid.py:28-83):
    this process's rank-strided images, then the statistics of all."""
    mprint(f'Loading images from "{image_path}"...')
    dataset = ImageFolderDataset(image_path, max_size=num_expected, random_seed=seed)
    try:
        if num_expected is not None and len(dataset) < num_expected:
            raise ValueError(f"found {len(dataset)} images, expected at least {num_expected}")
        if len(dataset) < 2:
            raise ValueError("need at least 2 images to compute statistics")
        stats = StreamingStats({"pool": 2048, "spatial": 2023}[feature])
        indices = np.arange(len(dataset))[process_index()::process_count()]
        for start in range(0, len(indices), max_batch_size):
            images = np.stack([dataset[int(i)][0] for i in
                               indices[start:start + max_batch_size]])
            if images.shape[1] == 1:
                images = np.repeat(images, 3, axis=1)
            stats.update(detector(images)[feature])
    finally:
        dataset.close()
    stats.merge_across_hosts()
    return stats.finalize()


def calc(image_path: str, ref_path: str, num_expected: int, seed: int, batch: int,
         detector: Callable, feature: str = "pool") -> float:
    """FID of a generated-image folder against reference statistics
    (reference: fid.py:96-118)."""
    with np.load(ref_path) as ref:
        mu_ref, sigma_ref = ref["mu"], ref["sigma"]
    mu, sigma = calculate_inception_stats(image_path, detector, num_expected, seed, batch,
                                          feature)
    return calculate_fid_from_inception_stats(mu, sigma, mu_ref, sigma_ref)


def ref(dataset_path: str, dest_path: str, batch: int, detector: Callable,
        feature: str = "pool") -> None:
    """Reference statistics of a dataset folder (reference: fid.py:121-134);
    rank 0 writes them."""
    mu, sigma = calculate_inception_stats(dataset_path, detector, None, 0, batch, feature)
    if is_main_process():
        os.makedirs(os.path.dirname(dest_path) or ".", exist_ok=True)
        np.savez(dest_path, mu=mu, sigma=sigma)
        print(f"saved reference stats to {dest_path}")
