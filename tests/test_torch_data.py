"""The port's synthetic latent dataset and loader against the JAX package's.

The same records, the same per-epoch order (seed + epoch, rank 0 of
world 1) and the same batches, collated in numpy; and the background prefetch,
which must stop its thread when the consumer stops.
"""

import threading

import numpy as np
import pytest
import torch

from maskdit_tpu.data import datasets as jax_datasets
from maskdit_tpu.data import loader as jax_loader
from maskdit_tpu_torch.data import DataLoader, SyntheticLatentDataset, prefetch, to_device

DATA = dict(length=37, resolution=8, num_channels=4, label_dim=6)


def test_synthetic_records_match_jax():
    ours = SyntheticLatentDataset(**DATA)
    theirs = jax_datasets.SyntheticLatentDataset(**DATA)
    assert len(ours) == len(theirs) == DATA["length"]
    for i in (0, 1, 5, 36):
        (x, y), (tx, ty) = ours[i], theirs[i]
        np.testing.assert_array_equal(x, tx)
        np.testing.assert_array_equal(y, ty)
        assert x.shape == (8, 8, 8) and y.dtype == np.float32 and y.sum() == 1.0
    with pytest.raises(IndexError):
        ours[DATA["length"]]


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("shuffle,resample", [(True, False), (False, False), (True, True)])
def test_epoch_order_and_batches_match_jax(seed, shuffle, resample):
    kw = dict(batch_size=4, shuffle=shuffle, seed=seed, resample=resample)
    ours = DataLoader(SyntheticLatentDataset(**DATA), num_workers=2, **kw)
    theirs = jax_loader.DataLoader(jax_datasets.SyntheticLatentDataset(**DATA),
                                   process_index=0, process_count=1,
                                   num_workers=1, **kw)
    for epoch in range(3):
        np.testing.assert_array_equal(ours.epoch_indices(epoch), theirs.epoch_indices(epoch))
    # 12 batches of 4 run past the end of the first epoch of 37 records,
    # whose last partial batch is dropped
    for a, b, _ in zip(iter(ours), iter(theirs), range(12)):
        assert a.keys() == b.keys() == {"x", "y"}
        for k in a:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])


def test_loader_refuses_a_dataset_smaller_than_a_batch():
    with pytest.raises(ValueError, match="batch_size"):
        next(iter(DataLoader(SyntheticLatentDataset(length=3, resolution=4), 4)))


def test_prefetch_keeps_order_and_stops_its_thread():
    loader = DataLoader(SyntheticLatentDataset(**DATA), 4, num_workers=2, seed=1)
    got = []
    for batch in prefetch(iter(loader)):
        got.append(batch["x"])
        if len(got) == 5:
            break
    want = [b["x"] for b, _ in zip(iter(loader), range(5))]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not [t for t in threading.enumerate() if t.name == "prefetch"]


def test_prefetch_raises_the_producers_error():
    def items():
        yield 1
        raise RuntimeError("bad record")

    out = []
    with pytest.raises(RuntimeError, match="bad record"):
        for x in prefetch(items()):
            out.append(x)
    assert out == [1]


def test_to_device_on_cpu():
    batch = {"x": np.ones((2, 3), np.float32), "y": np.zeros((2, 4), np.float32)}
    out = to_device(batch, torch.device("cpu"))
    assert out["x"].dtype == torch.float32 and out["x"].shape == (2, 3)
    torch.testing.assert_close(out["y"], torch.zeros(2, 4))
