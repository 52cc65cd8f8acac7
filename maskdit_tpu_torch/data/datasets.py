"""Datasets of the port.

Counterpart of maskdit_tpu/data/datasets.py (the reference's
train_utils/datasets.py, cited by line below):

  * ``Dataset``: a thin map-style base. View bookkeeping (random subset via
    ``max_size``, epoch doubling via ``xflip``) lives in :func:`plan_view`,
    label encoding in :func:`encode_label`; subclasses implement
    ``fetch(record_id)``.
  * ``ImageNetLatentDataset``: the latent LMDB (keys ``z-{i}``, ``y-{i}``,
    ``length``; reference datasets.py:240-304), read by the native reader
    (data/native_io.py) unless the caller asks for the Python one.
  * ``ImageLMDB`` / ``imagenet_lmdb_dataset``: the raw-image LMDB cache of
    an ImageFolder tree that latent extraction reads (datasets.py:55-129).
  * ``ImageFolderDataset``: the FID ingestion path (datasets.py:310-410).
  * ``center_crop_arr``: ADM's center crop (datasets.py:19-37), on numpy.
  * ``SyntheticLatentDataset``: deterministic fake latents for tests and
    benchmarks.

The JAX module imports Pillow at its top; the card's machine need not have
it. Here PNGs are decoded by the port's codec (``utils/png.py``), Pillow is
imported only to decode another format (JPEG, BMP, WebP), and the crop's
resampling is Pillow's 8-bit separable resample written out in numpy
(``resize_uint8``), equal to Pillow's bit for bit.

Flip convention: the latent pipeline stores horizontally-flipped copies at
extraction time as records [N, 2N), so ``xflip`` there means "include the
stored flipped half". Image datasets flip the decoded array at load time
(``flips = "decode"``).
"""

from __future__ import annotations

import io
import json
import math
import os
import zipfile
from typing import Optional, Sequence

import numpy as np

from maskdit_tpu_torch.data import lmdb_lite
from maskdit_tpu_torch.data.native_io import open_reader
from maskdit_tpu_torch.utils.png import decode_png

IMAGE_EXTENSIONS = frozenset({".png", ".jpg", ".jpeg", ".bmp", ".webp"})

# ---------------------------------------------------------------------------
# Pillow's resample (libImaging/Resample.c) for 8-bit images
# ---------------------------------------------------------------------------

PRECISION_BITS = 32 - 8 - 2  # fixed-point bits of the 8-bit coefficients


def _box_filter(x: np.ndarray) -> np.ndarray:
    return ((x > -0.5) & (x <= 0.5)).astype(np.float64)


def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    near = ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    far = (((x - 5) * x + 8) * x - 4) * a
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


# Pillow's filter, and its support at scale 1
FILTERS = {"box": (_box_filter, 0.5), "bicubic": (_bicubic_filter, 2.0)}


def _coefficients(in_size: int, out_size: int, filter_name: str):
    """``precompute_coeffs`` + ``normalize_coeffs_8bpc``: per output pixel
    the first input pixel and the fixed-point weights (zero past the
    pixel's window), as Pillow computes them in double."""
    filt, support = FILTERS[filter_name]
    scale = float(in_size) / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    inside = taps[None, :] < xmax[:, None]
    w = np.where(inside, filt(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5)
                             * (1.0 / filterscale)), 0.0)
    total = np.zeros(out_size)
    for x in range(ksize):  # Pillow's order of summation
        total = total + w[:, x]
    w = np.where(total[:, None] != 0.0, w / np.where(total == 0.0, 1.0, total)[:, None], w)
    fixed = w * (1 << PRECISION_BITS)
    kk = np.where(w < 0, np.trunc(-0.5 + fixed), np.trunc(0.5 + fixed)).astype(np.int32)
    index = np.minimum(xmin[:, None] + taps[None, :], in_size - 1)
    return index, kk


def _resample_axis(arr: np.ndarray, axis: int, out_size: int, filter_name: str) -> np.ndarray:
    """One pass of ``ImagingResample{Horizontal,Vertical}_8bpc`` along
    ``axis`` of a uint8 array: integer sums with a half for rounding, then
    the top bits clipped to [0, 255]. The sums fit 32 bits, as in Pillow."""
    index, kk = _coefficients(arr.shape[axis], out_size, filter_name)
    src = np.ascontiguousarray(np.moveaxis(arr, axis, 0)).astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (PRECISION_BITS - 1), np.int32)
    extra = (1,) * (src.ndim - 1)
    for x in range(kk.shape[1]):
        acc += src[index[:, x]] * kk[:, x].reshape((-1,) + extra)
    out = np.clip(acc >> PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def _premultiply(arr: np.ndarray) -> np.ndarray:
    """RGBA -> RGBa (LA -> La): Pillow's MULDIV255 of each colour by alpha."""
    a = arr[..., -1:].astype(np.int64)
    t = arr[..., :-1].astype(np.int64) * a + 128
    return np.concatenate([((t >> 8) + t) >> 8, a], axis=-1).astype(np.uint8)


def _unpremultiply(arr: np.ndarray) -> np.ndarray:
    """RGBa -> RGBA: 255 * colour // alpha, clipped; alpha 0 and 255 as is."""
    a = arr[..., -1:].astype(np.int64)
    c = arr[..., :-1].astype(np.int64)
    div = np.minimum(255 * c // np.maximum(a, 1), 255)
    c = np.where((a == 0) | (a == 255), c, div)
    return np.concatenate([c, a], axis=-1).astype(np.uint8)


def resize_uint8(arr: np.ndarray, size: tuple[int, int], filter_name: str) -> np.ndarray:
    """``PIL.Image.fromarray(arr).resize(size, filter)`` for an 8-bit gray
    (H, W), gray + alpha (H, W, 2), RGB or RGBA array, ``size`` being (width,
    height): the horizontal pass, then the vertical one, each rounded to
    uint8; images with alpha are resampled premultiplied, as Pillow does."""
    h, w = arr.shape[:2]
    if (w, h) == tuple(size):
        return arr.copy()
    alpha = arr.ndim == 3 and arr.shape[2] in (2, 4)
    out = _premultiply(arr) if alpha else arr
    if size[0] != w:
        out = _resample_axis(out, 1, size[0], filter_name)
    if size[1] != h:
        out = _resample_axis(out, 0, size[1], filter_name)
    return _unpremultiply(out) if alpha else out


def center_crop_arr(image: np.ndarray, image_size: int) -> np.ndarray:
    """ADM center-crop of an 8-bit (H, W) or (H, W, C) array: BOX halvings
    while the short side is at least twice ``image_size``, a BICUBIC resize
    of the short side to ``image_size``, then the center square (the JAX
    package's ``center_crop_arr`` on a PIL image, without Pillow)."""
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        raise ValueError(f"center_crop_arr takes uint8 images, got {arr.dtype}")
    while min(arr.shape[:2]) >= 2 * image_size:
        h, w = arr.shape[:2]
        arr = resize_uint8(arr, (w // 2, h // 2), "box")
    h, w = arr.shape[:2]
    scale = image_size / min(w, h)
    arr = resize_uint8(arr, (round(w * scale), round(h * scale)), "bicubic")
    crop_y = (arr.shape[0] - image_size) // 2
    crop_x = (arr.shape[1] - image_size) // 2
    return arr[crop_y:crop_y + image_size, crop_x:crop_x + image_size]


def _decode_image(data: bytes, name: str) -> np.ndarray:
    """Image bytes -> uint8 (H, W) or (H, W, C). PNGs are decoded here;
    other formats need Pillow."""
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
    return arr


def to_rgb(arr: np.ndarray) -> np.ndarray:
    """Pillow's ``convert("RGB")`` of gray, gray + alpha, RGB and RGBA:
    gray is repeated, alpha dropped."""
    if arr.ndim == 2:
        return np.repeat(arr[:, :, None], 3, axis=2)
    if arr.shape[2] in (1, 2):
        return np.repeat(arr[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(arr[:, :, :3])


# ---------------------------------------------------------------------------
# Views and labels
# ---------------------------------------------------------------------------

def plan_view(
    num_records: int,
    max_size: Optional[int] = None,
    xflip: bool = False,
    seed: int = 0,
) -> np.ndarray:
    """Build the view->record index map for a dataset of ``num_records``.

    ``max_size`` keeps a seeded random subset (in ascending record order so
    sequential reads stay sequential); ``xflip`` then appends a second pass
    over the same subset, encoded as ``record_id + num_records``. Callers
    decode ids >= num_records as "the flipped variant of id - num_records".
    """
    ids = np.arange(num_records, dtype=np.int64)
    if max_size is not None and max_size < num_records:
        keep = np.random.RandomState(seed % (1 << 31)).permutation(num_records)
        ids = np.sort(ids[keep[:max_size]])
    if xflip:
        ids = np.concatenate([ids, ids + num_records])
    return ids


def encode_label(label, label_dim: int) -> np.ndarray:
    """Normalize a per-record label to the float32 array the model consumes.

    Integer class ids become one-hot vectors of length ``label_dim``;
    ``None`` becomes the empty (label_dim == 0) or zero vector; float
    arrays (precomputed embeddings / one-hots) pass through as float32.
    """
    if label is None:
        return np.zeros((label_dim,), dtype=np.float32)
    if isinstance(label, (int, np.integer)) or (
        isinstance(label, np.ndarray) and np.issubdtype(label.dtype, np.integer)
    ):
        vec = np.zeros((label_dim,), dtype=np.float32)
        vec[int(label)] = 1.0
        return vec
    return np.asarray(label, dtype=np.float32).copy()


class Dataset:
    """Map-style dataset base.

    Subclasses call ``_init_view`` once with the stored record count and
    per-sample array shape, then implement ``fetch(record_id)`` returning
    ``(array, label)``, where ``label`` is an int class id, a float vector,
    ``None``, or an ``[label, feature]`` pair. ``__getitem__`` resolves the
    subset/xflip view and encodes labels; datasets whose flips are not
    stored set ``flips = "decode"`` to flip at load time.
    """

    flips = "stored"

    def _init_view(
        self,
        num_records: int,
        sample_shape: Sequence[int],
        label_dim: int = 1000,
        max_size: Optional[int] = None,
        xflip: bool = False,
        random_seed: int = 0,
    ) -> None:
        self._num_records = int(num_records)
        self._sample_shape = tuple(int(s) for s in sample_shape)
        self._label_dim = int(label_dim)
        self._view = plan_view(self._num_records, max_size, xflip, random_seed)

    def fetch(self, record_id: int):
        raise NotImplementedError  # subclass hook

    def close(self) -> None:
        pass

    def __len__(self) -> int:
        return len(self._view)

    def __getitem__(self, idx: int):
        record_id = int(self._view[idx])
        flipped = False
        if record_id >= self._num_records and self.flips == "decode":
            record_id -= self._num_records
            flipped = True
        array, label = self.fetch(record_id)
        array = np.ascontiguousarray(array[..., ::-1] if flipped else array)
        if isinstance(label, list):  # [label, feature] join
            return array, [encode_label(label[0], self._label_dim), *label[1:]]
        return array, encode_label(label, self._label_dim)

    @property
    def resolution(self) -> int:
        c, h, w = self._sample_shape
        assert h == w, f"non-square samples: {self._sample_shape}"
        return h


# ---------------------------------------------------------------------------
# Latents
# ---------------------------------------------------------------------------

class ImageNetLatentDataset(Dataset):
    """Latent LMDB reader: keys z-{i} (float32 moments), y-{i} (int text),
    'length' (int text), the reference reader's schema (datasets.py:240-304),
    so extracted datasets are interchangeable. Flipped copies are stored
    (extract_latent's --xflip appends them as records [N, 2N)).

    ``native`` picks the reader (``self.reader_kind`` names it). A feature
    LMDB (``feat_path``, the ``ext_feature_dim`` path) is not ported yet:
    a directory there raises, where the JAX dataset would join it.
    """

    flips = "stored"

    def __init__(
        self,
        path: str,
        resolution: int = 32,
        num_channels: int = 4,
        split: str = "train",
        feat_path: Optional[str] = None,
        feat_dim: int = 0,
        native: bool = True,
        **view_kwargs,
    ):
        if feat_path not in (None, "None", "") and os.path.isdir(str(feat_path)):
            raise NotImplementedError(
                f"data.feat_path {feat_path!r}: external features (model.ext_feature_dim) "
                "are not ported yet")
        self._path = os.path.join(path, split)
        self._db = open_reader(self._path, native=native)
        self.reader_kind = self._db.kind
        length = int(self._db.get(b"length").decode("utf-8"))
        self._init_view(
            num_records=length,
            sample_shape=(num_channels, resolution, resolution),
            **view_kwargs,
        )

    def fetch(self, record_id: int):
        z = np.frombuffer(
            self._db.get(f"z-{record_id}".encode()), dtype=np.float32
        ).reshape([-1, self.resolution, self.resolution]).copy()
        y = int(self._db.get(f"y-{record_id}".encode()).decode("utf-8"))
        return z, y

    def close(self) -> None:
        self._db.close()


def write_latent_lmdb(
    path: str,
    moments: np.ndarray,  # (N, 2C, H, W) float32
    labels: np.ndarray,  # (N,) int
    start_idx: int = 0,
) -> None:
    """Write a latent dataset in the reference's LMDB key layout
    (extract_latent.py:58-108: z-{i} float32 bytes, y-{i} text, 'length')."""
    with lmdb_lite.Writer(path) as w:
        for i in range(len(moments)):
            idx = start_idx + i
            w.put(f"z-{idx}", moments[i].astype(np.float32).tobytes())
            w.put(f"y-{idx}", str(int(labels[i])))
        w.put("length", str(start_idx + len(moments)))


class SyntheticLatentDataset(Dataset):
    """Deterministic fake VAE moments with class labels, for tests and
    benchmarks: record i holds ``np.random.RandomState(i)`` normals of shape
    (2C, R, R) (or (C, R, R) without ``moments``) and class ``i %
    label_dim``, as the JAX dataset does."""

    def __init__(self, length: int = 256, resolution: int = 32, num_channels: int = 4,
                 label_dim: int = 1000, moments: bool = True):
        channels = num_channels * 2 if moments else num_channels
        self._init_view(num_records=length, sample_shape=(channels, resolution, resolution),
                        label_dim=label_dim)

    def fetch(self, record_id: int):
        rng = np.random.RandomState(record_id % (1 << 31))
        z = rng.randn(*self._sample_shape).astype(np.float32)
        return z, int(record_id % self._label_dim) if self._label_dim else None


# ---------------------------------------------------------------------------
# Images
# ---------------------------------------------------------------------------

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
    """Image bytes -> uint8 CHW (gray gets one channel)."""
    arr = _decode_image(data, name)
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
        self._view = plan_view(len(self._files), max_size, seed=random_seed)

    def __len__(self) -> int:
        return len(self._view)

    def __getitem__(self, idx: int) -> tuple[np.ndarray, np.ndarray]:
        name = self._files[int(self._view[idx])]
        image = _decode_image_chw(self._source.read(name), name)
        return image, np.zeros((0,), dtype=np.float32)

    def close(self) -> None:
        self._source.close()


class ImageLMDB(Dataset):
    """Raw-image LMDB reader (reference: ImageLMDB, datasets.py:95-129).

    Keys are relative file paths, values the original encoded image bytes;
    the ImageFolder cache that latent extraction reads. Returns
    center-cropped RGB uint8 CHW arrays and integer labels.
    """

    flips = "decode"

    def __init__(self, root: str, samples: list, class_to_idx: dict,
                 resolution: int = 256, **view_kwargs):
        self._db = open_reader(root)
        self.reader_kind = self._db.kind
        self._samples = samples  # [(path, class_idx), ...]
        self.class_to_idx = class_to_idx
        self._res = resolution
        self._init_view(
            num_records=len(samples),
            sample_shape=(3, resolution, resolution),
            label_dim=len(class_to_idx),
            **view_kwargs,
        )

    def fetch(self, record_id: int):
        path, target = self._samples[record_id]
        image = to_rgb(_decode_image(self._db.get(path.encode("ascii")), path))
        return center_crop_arr(image, self._res).transpose(2, 0, 1), int(target)

    def close(self) -> None:
        self._db.close()


def imagenet_lmdb_dataset(root: str, resolution: int = 256, **kwargs) -> ImageLMDB:
    """Build (or reuse) a raw-image LMDB cache for an ImageFolder tree.

    Reference: imagenet_lmdb_dataset (datasets.py:55-88). Every image
    file's bytes go into ``<root>_faster_imagefolder.lmdb`` keyed by
    relative path, beside a JSON manifest ``<root>_faster_imagefolder.json``
    (the JAX package's paths and layout, so either package reuses the
    other's cache).
    """
    root = root.rstrip("/")
    lmdb_path = root + "_faster_imagefolder.lmdb"
    manifest_path = root + "_faster_imagefolder.json"

    if os.path.isdir(lmdb_path) and os.path.isfile(manifest_path):
        with open(manifest_path) as f:
            manifest = json.load(f)
    else:
        classes = sorted(
            d for d in os.listdir(root) if os.path.isdir(os.path.join(root, d))
        )
        class_to_idx = {c: i for i, c in enumerate(classes)}
        samples = []
        writer = lmdb_lite.Writer(lmdb_path)
        for cls in classes:
            cdir = os.path.join(root, cls)
            for fname in sorted(os.listdir(cdir)):
                if os.path.splitext(fname)[1].lower() not in IMAGE_EXTENSIONS:
                    continue
                rel = os.path.join(cls, fname)
                with open(os.path.join(cdir, fname), "rb") as f:
                    writer.put(rel.encode("ascii"), f.read())
                samples.append([rel, class_to_idx[cls]])
        writer.commit()
        manifest = {"samples": samples, "class_to_idx": class_to_idx}
        with open(manifest_path, "w") as f:
            json.dump(manifest, f)

    return ImageLMDB(
        lmdb_path,
        [(p, t) for p, t in manifest["samples"]],
        manifest["class_to_idx"],
        resolution=resolution,
        **kwargs,
    )
