"""The port's latent LMDB layer against the JAX package's.

- ``lmdb_lite.Writer``: the same puts give the same bytes as the JAX writer
  (hypothesis keys and values, across overflow values and multi-level
  trees), and each package's readers read the other's files.
- The native reader (data/csrc/lmdb_lite.cc, built with g++ at first use)
  reads what the Python reader reads; ``open_reader(native=True)`` raises
  with the compiler's message when the source does not build, and never
  falls back to the Python reader.
- ``ImageNetLatentDataset`` items and its ``max_size`` / ``xflip`` views,
  and the ``DataLoader`` batches over it, equal the JAX ones.
- ``center_crop_arr`` (numpy) equals the JAX one (Pillow) bit for bit, on
  seeded images below, at and above twice the target, at odd sizes, gray,
  gray + alpha, RGB and RGBA; and ``imagenet_lmdb_dataset`` yields the JAX
  crops and labels from the same manifest and cache paths.
"""

import os

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from maskdit_tpu.data import datasets as jax_datasets
from maskdit_tpu.data import lmdb_lite as jax_lmdb
from maskdit_tpu.data import loader as jax_loader
from maskdit_tpu_torch.data import datasets, lmdb_lite, native_io
from maskdit_tpu_torch.data.loader import DataLoader
from maskdit_tpu_torch.utils.png import write_png


def _write(writer_cls, path: str, records: dict) -> bytes:
    with writer_cls(path) as w:
        for k, v in records.items():
            w.put(k, v)
    with open(os.path.join(path, "data.mdb"), "rb") as f:
        return f.read()


def _check_same_bytes_and_cross_read(tmp_path, records: dict) -> None:
    ours = _write(lmdb_lite.Writer, str(tmp_path / "ours"), records)
    theirs = _write(jax_lmdb.Writer, str(tmp_path / "theirs"), records)
    assert ours == theirs
    readers = [lmdb_lite.Reader(str(tmp_path / "theirs")), jax_lmdb.Reader(str(tmp_path / "ours")),
               native_io.NativeReader(str(tmp_path / "theirs"))]
    for r in readers:
        assert len(r) == len(records)
        for k, v in records.items():
            assert r.get(k) == v, k
        assert r.get(b"\xff" * 3 + b"missing") is None
        r.close()
    assert list(lmdb_lite.Reader(str(tmp_path / "theirs")).items()) == sorted(records.items())


@settings(max_examples=25, deadline=None)
@given(st.dictionaries(st.binary(min_size=1, max_size=48),
                       st.one_of(st.binary(max_size=300), st.binary(min_size=1900, max_size=9000)),
                       max_size=40))
def test_writer_bytes_equal_jax_on_hypothesis_records(tmp_path_factory, records):
    _check_same_bytes_and_cross_read(tmp_path_factory.mktemp("db"), records)


@settings(max_examples=6, deadline=None)
@given(st.integers(300, 2600), st.integers(0, 2 ** 31 - 1), st.integers(8, 500))
def test_writer_bytes_equal_jax_on_multilevel_trees(tmp_path_factory, n, seed, size):
    """Hundreds to thousands of records of up to ``size`` bytes (leaf pages
    of a few nodes: two and three levels), every 97th an overflow chain."""
    rng = np.random.default_rng(seed)
    records = {f"z-{i}".encode(): rng.bytes(int(rng.integers(1, size))) for i in range(n)}
    for i in range(0, n, 97):
        records[f"big-{i}".encode()] = rng.bytes(int(rng.integers(2100, 13000)))
    records[b"length"] = str(n).encode()
    _check_same_bytes_and_cross_read(tmp_path_factory.mktemp("db"), records)


def test_native_reader_matches_python_reader(tmp_path):
    path = str(tmp_path / "db")
    rng = np.random.RandomState(0)
    records = {}
    with lmdb_lite.Writer(path) as w:
        for i in range(2500):
            key = f"z-{i}".encode()
            records[key] = rng.bytes(9000) if i % 11 == 0 else rng.bytes(rng.randint(1, 150))
            w.put(key, records[key])
    native, python = native_io.open_reader(path), native_io.open_reader(path, native=False)
    assert (native.kind, python.kind) == ("native", "python")
    assert isinstance(python, lmdb_lite.Reader) and len(native) == len(python) == 2500
    for key, val in records.items():
        assert native.get(key) == python.get(key) == val, key
    assert native.get(b"nope") is None and native.get("z-99999") is None
    native.close()
    python.close()


def test_native_reader_refuses_a_file_that_is_not_lmdb(tmp_path):
    bad = tmp_path / "bad.mdb"
    bad.write_bytes(b"\x00" * 16384)
    with pytest.raises(IOError, match="not an LMDB"):
        native_io.open_reader(str(bad))


def test_open_reader_raises_when_the_source_does_not_build(tmp_path, monkeypatch):
    """No silent fallback: a source that does not compile raises with the
    compiler's message, where the JAX ``open_reader`` returns its Python
    reader."""
    path = str(tmp_path / "db")
    with lmdb_lite.Writer(path) as w:
        w.put(b"k", b"v")
    broken = tmp_path / "lmdb_lite.cc"
    broken.write_text(native_io.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native_io, "SOURCE", broken)
    monkeypatch.setattr(native_io, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        native_io.open_reader(path)
    assert native_io.open_reader(path, native=False).get(b"k") == b"v"
    assert not list((tmp_path / "build").glob("*.so"))


# -- the latent dataset and the loader ------------------------------------

N, RES, CH = 12, 4, 8


@pytest.fixture(scope="module")
def latent_root(tmp_path_factory):
    """N records and, as records [N, 2N), their stored flips (``length``
    N: the view's ``xflip`` reads the second half)."""
    root = tmp_path_factory.mktemp("latents")
    rng = np.random.default_rng(0)
    moments = rng.normal(size=(2 * N, CH, RES, RES)).astype(np.float32)
    labels = rng.integers(0, 10, 2 * N)
    with lmdb_lite.Writer(str(root / "train")) as w:
        for i in range(2 * N):
            w.put(f"z-{i}", moments[i].tobytes())
            w.put(f"y-{i}", str(labels[i]))
        w.put("length", str(N))
    return str(root)


def test_write_latent_lmdb_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    moments = rng.normal(size=(5, CH, RES, RES)).astype(np.float32)
    labels = rng.integers(0, 1000, 5)
    for mod, name in ((datasets, "ours"), (jax_datasets, "theirs")):
        mod.write_latent_lmdb(str(tmp_path / name), moments, labels, start_idx=3)
    assert ((tmp_path / "ours" / "data.mdb").read_bytes()
            == (tmp_path / "theirs" / "data.mdb").read_bytes())


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("view", [{}, {"xflip": True}, {"max_size": 5, "random_seed": 3},
                                  {"max_size": 7, "xflip": True, "random_seed": 11}],
                         ids=["all", "xflip", "max_size", "max_size_xflip"])
def test_latent_dataset_items_equal_jax(latent_root, native, view):
    ours = datasets.ImageNetLatentDataset(latent_root, resolution=RES, num_channels=4,
                                          label_dim=10, native=native, **view)
    theirs = jax_datasets.ImageNetLatentDataset(latent_root, resolution=RES, num_channels=4,
                                                label_dim=10, **view)
    assert ours.reader_kind == ("native" if native else "python")
    assert len(ours) == len(theirs)
    np.testing.assert_array_equal(ours._view, theirs._view)
    for i in range(len(ours)):
        (x, y), (tx, ty) = ours[i], theirs[i]
        assert x.shape == (CH, RES, RES) and x.dtype == np.float32
        np.testing.assert_array_equal(x, tx)
        np.testing.assert_array_equal(y, ty)
    ours.close()
    theirs.close()


def test_latent_dataset_refuses_a_feature_lmdb(latent_root, tmp_path):
    """``data.feat_path`` (the ``ext_feature_dim`` path), which the port once
    refused: a feature LMDB with the latent LMDB's labels joins record by
    record, each item ``[onehot, feature]`` equal to the JAX dataset's
    (flipped records too); "None" joins nothing; without a feature width
    the directory is refused, as the JAX dataset asserts one."""
    from maskdit_tpu_torch.data.features import write_feature_lmdb

    reader = lmdb_lite.Reader(os.path.join(latent_root, "train"))
    labels = [int(reader.get(f"y-{i}")) for i in range(2 * N)]
    reader.close()
    feats = np.random.default_rng(4).normal(size=(2 * N, 16)).astype(np.float32)
    write_feature_lmdb(str(tmp_path / "train"), feats, labels)
    kw = dict(resolution=RES, feat_path=str(tmp_path), feat_dim=16, label_dim=10, xflip=True)
    ours = datasets.ImageNetLatentDataset(latent_root, **kw)
    theirs = jax_datasets.ImageNetLatentDataset(latent_root, **kw)
    assert len(ours) == len(theirs) == 2 * N
    for i in range(2 * N):
        (x, (y, f)), (tx, (ty, tf)) = ours[i], theirs[i]
        np.testing.assert_array_equal(x, tx)
        np.testing.assert_array_equal(y, ty)
        np.testing.assert_array_equal(f, tf)
    with pytest.raises(ValueError, match="ext_feature_dim"):
        datasets.ImageNetLatentDataset(latent_root, resolution=RES, feat_path=str(tmp_path))
    plain = datasets.ImageNetLatentDataset(latent_root, resolution=RES, feat_path="None")
    assert len(plain) == N and not isinstance(plain[0][1], list)


@pytest.mark.parametrize("seed,xflip", [(0, False), (5, True)])
def test_loader_batches_over_the_lmdb_equal_jax(latent_root, seed, xflip):
    kw = dict(resolution=RES, num_channels=4, label_dim=10, xflip=xflip)
    ours = DataLoader(datasets.ImageNetLatentDataset(latent_root, **kw), 5, seed=seed,
                      num_workers=2)
    theirs = jax_loader.DataLoader(jax_datasets.ImageNetLatentDataset(latent_root, **kw), 5,
                                   seed=seed, num_workers=1, process_index=0, process_count=1)
    for a, b, _ in zip(iter(ours), iter(theirs), range(7)):  # past the first epoch
        assert a.keys() == b.keys() == {"x", "y"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


# -- images: the crop and the raw-image cache ------------------------------

# (height, width, channels or None for gray, target): below, at and above
# twice the target (BOX halvings), odd sizes, upscaling, and alpha
CROPS = [
    (300, 400, 3, 256), (512, 512, 3, 256), (513, 700, 3, 256), (1100, 777, 3, 256),
    (255, 255, 3, 256), (31, 47, 3, 32), (64, 64, 3, 32), (65, 129, 3, 32),
    (127, 255, 3, 32), (33, 33, 3, 32), (200, 17, 3, 16), (95, 96, 3, 48),
    (300, 400, None, 256), (129, 71, None, 32), (40, 64, None, 16),
    (300, 400, 4, 256), (129, 71, 4, 32), (64, 100, 4, 16), (77, 91, 2, 32),
    (523, 611, 4, 128),
]


@pytest.mark.parametrize("h,w,c,target", CROPS,
                         ids=[f"{h}x{w}x{c or 1}-{t}" for h, w, c, t in CROPS])
def test_center_crop_equals_pillow(h, w, c, target):
    """Smooth content (an upsampled random grid) plus noise, so that the
    filters' weights all matter; alpha takes 0, 255 and values between."""
    rng = np.random.default_rng(h * 1000 + w)
    shape = (h, w) if c is None else (h, w, c)
    grid = rng.uniform(0, 255, (8, 8) + shape[2:])
    smooth = grid[np.arange(h) * 8 // h][:, np.arange(w) * 8 // w]
    arr = np.clip(smooth + rng.normal(0, 20, shape), 0, 255).astype(np.uint8)
    if c in (2, 4):
        arr[..., -1] = rng.choice([0, 1, 77, 128, 254, 255], size=(h, w))
    got = datasets.center_crop_arr(arr, target)
    want = np.asarray(jax_datasets.center_crop_arr(Image.fromarray(arr), target))
    assert got.shape == want.shape == (target, target) + shape[2:]
    np.testing.assert_array_equal(got, want)


def test_imagenet_lmdb_dataset_equals_jax(tmp_path):
    """The same PNG tree (gray, RGB and RGBA files written by Pillow, every
    row filter) through both packages' raw-image caches: the same manifest,
    the same cache bytes, the same crops and labels; and each package
    reuses the cache the other built."""
    rng = np.random.default_rng(0)
    for tree in ("ours", "theirs"):
        for cls in ("n02", "n01"):
            os.makedirs(tmp_path / tree / cls)
    sizes = [(70, 90, "RGB"), (40, 33, "L"), (100, 64, "RGBA"), (64, 64, "RGB")]
    for i, (h, w, mode) in enumerate(sizes):
        shape = (h, w) if mode == "L" else (h, w, len(mode))
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        for tree in ("ours", "theirs"):
            Image.fromarray(arr, mode).save(tmp_path / tree / ("n01", "n02")[i % 2] / f"{i}.png")
    (tmp_path / "ours" / "n01" / "notes.txt").write_text("not an image")
    ours = datasets.imagenet_lmdb_dataset(str(tmp_path / "ours"), resolution=32)
    theirs = jax_datasets.imagenet_lmdb_dataset(str(tmp_path / "theirs"), resolution=32)
    assert ((tmp_path / "ours_faster_imagefolder.json").read_text()
            == (tmp_path / "theirs_faster_imagefolder.json").read_text())
    assert ((tmp_path / "ours_faster_imagefolder.lmdb" / "data.mdb").read_bytes()
            == (tmp_path / "theirs_faster_imagefolder.lmdb" / "data.mdb").read_bytes())
    assert len(ours) == len(theirs) == len(sizes) and ours.reader_kind == "native"
    for i in range(len(ours)):
        (x, y), (tx, ty) = ours[i], theirs[i]
        assert x.shape == (3, 32, 32)
        np.testing.assert_array_equal(x, tx)
        np.testing.assert_array_equal(y, ty)
    # a cache the other package built is reused, not rebuilt
    (tmp_path / "ours" / "n01" / "0.png").unlink()
    again = jax_datasets.imagenet_lmdb_dataset(str(tmp_path / "ours"), resolution=32)
    np.testing.assert_array_equal(again[0][0], ours[0][0])
    write_png(str(tmp_path / "theirs" / "n01" / "extra.png"), np.zeros((40, 40, 3), np.uint8))
    assert len(datasets.imagenet_lmdb_dataset(str(tmp_path / "theirs"), resolution=32)) == 4
