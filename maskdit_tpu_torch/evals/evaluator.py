"""ADM-style second-opinion metrics: IS, FID, sFID, precision / recall.

Counterpart of maskdit_tpu/evals/evaluator.py (the reference's TF1
evaluator surface: IS :226-239, FID / sFID :115-163, precision / recall
through ManifoldEstimator :252-440) over the port's InceptionV3 features.
Pairwise distances run on the device, in fp32 with TF32 off, so that which
sample falls inside which radius does not depend on the caller's flags.
"""

from __future__ import annotations

import ast
import struct
import warnings
import zipfile
from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import scipy.linalg
import torch

from maskdit_tpu_torch.data.datasets import ImageFolderDataset
from maskdit_tpu_torch.utils.precision import exact_fp32


def inception_score(logits: np.ndarray, split_size: int = 5000) -> float:
    """IS = exp(E_x KL(p(y|x) || p(y))), averaged over fixed-size splits
    (reference: evaluator.py:226-239 with split_size 5000)."""
    logits = np.asarray(logits, dtype=np.float64)
    probs = np.exp(logits - logits.max(axis=1, keepdims=True))
    probs /= probs.sum(axis=1, keepdims=True)
    scores = []
    for i in range(0, len(probs), split_size):
        chunk = probs[i : i + split_size]
        kl = chunk * (np.log(chunk + 1e-30) - np.log(chunk.mean(axis=0, keepdims=True) + 1e-30))
        scores.append(np.exp(kl.sum(axis=1).mean()))
    return float(np.mean(scores))


def feature_stats(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mu, sigma) of a feature set (reference: evaluator.py:221-224)."""
    f = np.asarray(feats, dtype=np.float64)
    return f.mean(axis=0), np.cov(f, rowvar=False)


def frechet_distance_from_stats(
    stats_a: tuple[np.ndarray, np.ndarray],
    stats_b: tuple[np.ndarray, np.ndarray],
    eps: float = 1e-6,
) -> float:
    """The Frechet distance of two (mu, sigma) pairs, as
    ``calculate_fid_from_inception_stats`` computes it; where sqrtm of the
    product is not finite (a singular product: fewer samples than features,
    or features that are 0 in every sample), ``eps`` is added to both
    diagonals first, as the reference evaluator does (evaluator.py:148-156).
    The JAX package has no such fallback: it takes the trace of the
    non-finite product as it is (nan, inf, or a finite value where only
    off-diagonal entries are not finite)."""
    (mu_a, sigma_a), (mu_b, sigma_b) = stats_a, stats_b
    covmean = scipy.linalg.sqrtm(np.dot(sigma_a, sigma_b))
    if not np.isfinite(covmean).all():
        warnings.warn(f"fid calculation produces singular product; adding {eps} to diagonal "
                      "of cov estimates")
        offset = np.eye(len(sigma_a)) * eps
        sigma_a, sigma_b = sigma_a + offset, sigma_b + offset
        covmean = scipy.linalg.sqrtm(np.dot(sigma_a, sigma_b))
    m = np.square(mu_a - mu_b).sum()
    return float(np.real(m + np.trace(sigma_a + sigma_b - covmean * 2)))


def frechet_distance(feats_a: np.ndarray, feats_b: np.ndarray) -> float:
    """FID / sFID between two raw feature sets."""
    return frechet_distance_from_stats(feature_stats(feats_a), feature_stats(feats_b))


def _pairwise_sq_dists(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """||a_i - b_j||^2 in the expanded form (one matmul)."""
    with exact_fp32():
        a2 = (a * a).sum(dim=1)[:, None]
        b2 = (b * b).sum(dim=1)[None, :]
        return torch.clamp(a2 + b2 - 2.0 * (a @ b.T), min=0.0)


class ManifoldEstimator:
    """k-NN hypersphere manifold (reference: evaluator.py:252-372):
    radii[i] is the squared distance from feature i to its k-th nearest
    neighbour in its own set (k = nhood_size, ADM's 3), on ``device``."""

    def __init__(self, features: np.ndarray, nhood_size: int = 3, batch: int = 2048,
                 device="cuda"):
        self.features = torch.from_numpy(np.asarray(features, dtype=np.float32)).to(device)
        radii = []
        for i in range(0, len(self.features), batch):
            d = _pairwise_sq_dists(self.features[i : i + batch], self.features)
            # the k-th neighbour leaving out the point itself (distance 0,
            # the smallest): the (k + 1)-th smallest
            radii.append(torch.kthvalue(d, nhood_size + 1, dim=1).values)
        self.radii = torch.cat(radii)

    def evaluate(self, queries: np.ndarray, batch: int = 2048) -> np.ndarray:
        """For each query, 1 if it lies inside ANY feature's hypersphere."""
        q = torch.from_numpy(np.asarray(queries, dtype=np.float32)).to(self.features.device)
        out = []
        for i in range(0, len(q), batch):
            d = _pairwise_sq_dists(q[i : i + batch], self.features)
            out.append((d <= self.radii[None, :]).any(dim=1))
        return torch.cat(out).cpu().numpy().astype(np.float64)


def precision_recall(ref_features: np.ndarray, gen_features: np.ndarray,
                     nhood_size: int = 3, device="cuda") -> tuple[float, float]:
    """ADM precision / recall (reference: evaluator.py:390-440)."""
    ref_manifold = ManifoldEstimator(ref_features, nhood_size, device=device)
    gen_manifold = ManifoldEstimator(gen_features, nhood_size, device=device)
    precision = float(ref_manifold.evaluate(gen_features).mean())
    recall = float(gen_manifold.evaluate(ref_features).mean())
    return precision, recall


class Evaluator:
    """All ADM metrics from a detector and two image or feature sources.

    Images stream through ``features_from_batches`` in detector-sized
    batches (the reference streams the same way, evaluator.py:190-208);
    only the feature matrices are held, never the image set. Precision and
    recall run on ``device``.
    """

    def __init__(self, detector: Callable, batch: int = 64, device="cuda"):
        self.detector = detector
        self.batch = batch
        self.device = device

    def _detect(self, images_uint8_nchw: np.ndarray) -> dict[str, np.ndarray]:
        """One detector call; a ragged batch is padded to the batch size,
        so every call sees the same shape, as in the JAX package."""
        n = len(images_uint8_nchw)
        if images_uint8_nchw.shape[1] == 1:
            images_uint8_nchw = np.repeat(images_uint8_nchw, 3, axis=1)
        if n < self.batch:
            pad = np.zeros((self.batch - n, *images_uint8_nchw.shape[1:]), dtype=np.uint8)
            images_uint8_nchw = np.concatenate([images_uint8_nchw, pad])
        out = self.detector(images_uint8_nchw)
        return {k: np.asarray(v[:n]) for k, v in out.items()}

    def features_from_batches(self, batches: Iterable[np.ndarray]) -> dict[str, np.ndarray]:
        """Stream NCHW uint8 image batches -> stacked feature dict."""
        acc: dict[str, list] = {"pool": [], "spatial": [], "logits": []}
        for batch in batches:
            batch = np.asarray(batch)
            for i in range(0, len(batch), self.batch):
                out = self._detect(batch[i : i + self.batch])
                for k in acc:
                    acc[k].append(out[k])
        if not acc["pool"]:
            raise ValueError("no image batches supplied to the evaluator")
        return {k: np.concatenate(v) for k, v in acc.items()}

    def features_for(self, images_uint8_nchw: np.ndarray) -> dict[str, np.ndarray]:
        return self.features_from_batches([images_uint8_nchw])

    def compute_all(self, gen_images, ref_images=None,
                    ref_features: Optional[dict] = None) -> dict[str, float]:
        """All metrics. ``gen_images`` / ``ref_images`` may be arrays or
        iterables of NCHW uint8 batches (streaming)."""
        gen = self.features_from_batches(_as_batches(gen_images))
        if ref_features is None:
            if ref_images is None:
                raise ValueError("compute_all needs ref_images or ref_features")
            ref_features = self.features_from_batches(_as_batches(ref_images))
        prec, rec = precision_recall(ref_features["pool"], gen["pool"], device=self.device)
        return {
            "inception_score": inception_score(gen["logits"]),
            "fid": frechet_distance(gen["pool"], ref_features["pool"]),
            "sfid": frechet_distance(gen["spatial"], ref_features["spatial"]),
            "precision": prec,
            "recall": rec,
        }


def _as_batches(images) -> Iterable[np.ndarray]:
    if isinstance(images, np.ndarray):
        return [images]
    return images


# ---------------------------------------------------------------------------
# Streaming npz ingest (bounded memory for 50K-image batch files)
# ---------------------------------------------------------------------------

def npz_array_info(path: str, key: str = "arr_0") -> tuple[tuple, np.dtype]:
    """Shape/dtype of one array in an npz without loading its data."""
    with zipfile.ZipFile(path) as zf, zf.open(_npz_member(zf, key)) as f:
        shape, _, dtype = _read_npy_header(f)
        return shape, dtype


def stream_npz_batches(
    path: str, batch_size: int, key: str = "arr_0", to_nchw: bool = True
) -> Iterator[np.ndarray]:
    """Yield row batches of npz[key] reading sequentially from the zip
    stream — peak memory is one batch, not the array (the reference
    streams the same way, evaluator.py:516-546 StreamingNpzArrayReader).

    Fortran-ordered arrays can't be row-streamed; those fall back to a
    full load.
    """
    with zipfile.ZipFile(path) as zf:
        member = _npz_member(zf, key)
        with zf.open(member) as f:
            shape, fortran, dtype = _read_npy_header(f)
            if fortran:
                arr = np.load(path)[key]
                for i in range(0, len(arr), batch_size):
                    yield _maybe_nchw(arr[i : i + batch_size], to_nchw)
                return
            row_elems = int(np.prod(shape[1:], dtype=np.int64))
            row_bytes = row_elems * dtype.itemsize
            for start in range(0, shape[0], batch_size):
                n = min(batch_size, shape[0] - start)
                data = f.read(n * row_bytes)
                if len(data) != n * row_bytes:
                    raise IOError(
                        f"truncated npy member {member!r} in {path!r}"
                    )
                batch = np.frombuffer(data, dtype=dtype).reshape(n, *shape[1:])
                yield _maybe_nchw(batch, to_nchw)


def _maybe_nchw(batch: np.ndarray, to_nchw: bool) -> np.ndarray:
    """ADM batch files are NHWC uint8; the detector wants NCHW."""
    if to_nchw and batch.ndim == 4 and batch.shape[-1] in (1, 3):
        return np.ascontiguousarray(batch.transpose(0, 3, 1, 2))
    return batch


def _npz_member(zf: zipfile.ZipFile, key: str) -> str:
    names = zf.namelist()
    want = key + ".npy"
    if want in names:
        return want
    npys = [n for n in names if n.endswith(".npy")]
    if not npys:
        raise KeyError(f"no .npy members in archive (looked for {key!r})")
    return npys[0]


def _read_npy_header(f) -> tuple[tuple, bool, np.dtype]:
    """Parse an npy stream header; returns (shape, fortran_order, dtype)."""
    magic = f.read(6)
    if magic != b"\x93NUMPY":
        raise IOError("not an npy stream")
    major, _minor = struct.unpack("BB", f.read(2))
    if major == 1:
        (hlen,) = struct.unpack("<H", f.read(2))
    else:
        (hlen,) = struct.unpack("<I", f.read(4))
    header = ast.literal_eval(f.read(hlen).decode("latin1"))
    return (
        tuple(header["shape"]),
        bool(header["fortran_order"]),
        np.dtype(header["descr"]),
    )


def stream_folder_batches(
    folder: str, batch_size: int, max_images: Optional[int] = None
) -> Iterator[np.ndarray]:
    """Yield NCHW uint8 batches from a PNG directory (streaming analogue of
    the reference's all-in-RAM png2npz ingest, evaluator.py:54-67)."""
    ds = ImageFolderDataset(folder, max_size=max_images)
    try:
        for start in range(0, len(ds), batch_size):
            yield np.stack(
                [ds[i][0] for i in range(start, min(start + batch_size, len(ds)))]
            )
    finally:
        ds.close()


def npz_has_key(path: str, key: str) -> bool:
    with zipfile.ZipFile(path) as zf:
        return key + ".npy" in zf.namelist()


def png_folder_to_npz(folder: str, out_path: str, max_images: Optional[int] = None) -> None:
    """PNG dir -> npz batch file (reference: evaluator.py:54-67 ingest)."""
    ds = ImageFolderDataset(folder, max_size=max_images)
    try:
        arr = np.stack([ds[i][0].transpose(1, 2, 0) for i in range(len(ds))])
    finally:
        ds.close()
    np.savez(out_path, arr_0=arr)
