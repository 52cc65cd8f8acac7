"""The port's WebDataset layer (data/wds.py) against the JAX package's.

The same records written by both writers give the same shard bytes; the
indexed dataset and the streaming iterators read the same sequences, over
a grid of (rank, world, epoch, seed, shuffle buffer, resample); and the
port's module imports neither jax nor the JAX package (tests/
test_torch_import.py checks that).
"""

import os

import numpy as np
import pytest

from maskdit_tpu.data import wds as jax_wds
from maskdit_tpu_torch.data import wds

RES, CH = 4, 8


def _records(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [(f"{i:07d}", rng.normal(size=(CH, RES, RES)).astype(np.float32),
             int(rng.integers(0, 1000))) for i in range(n)]


@pytest.fixture(scope="module")
def shard_root(tmp_path_factory):
    """23 records in 5 shards of at most 5 (the last one short)."""
    root = tmp_path_factory.mktemp("wds")
    wds.write_wds_shards(_records(23), str(root), pattern="s-%04d.tar", maxcount=5)
    return str(root)


@pytest.mark.parametrize("maxcount,maxsize", [(5, 10 ** 10), (10010, 10 ** 10), (100, 1500)],
                         ids=["count", "one", "size"])
def test_shards_equal_jax_byte_for_byte(tmp_path, maxcount, maxsize):
    records = _records(17, seed=maxcount)
    ours = wds.write_wds_shards(records, str(tmp_path / "ours"), maxcount=maxcount,
                                maxsize=maxsize)
    theirs = jax_wds.write_wds_shards(records, str(tmp_path / "theirs"), maxcount=maxcount,
                                      maxsize=maxsize)
    assert [os.path.basename(p) for p in ours] == [os.path.basename(p) for p in theirs]
    for a, b in zip(ours, theirs):
        with open(a, "rb") as fa, open(b, "rb") as fb:
            assert fa.read() == fb.read(), a
        assert wds.index_tar(a) == jax_wds.index_tar(b)
    assert wds.list_shards(str(tmp_path / "ours")) == ours


def test_indexed_dataset_equals_jax(shard_root):
    ours = wds.WebDatasetLatents(shard_root, resolution=RES, num_channels=CH, label_dim=1000)
    theirs = jax_wds.WebDatasetLatents(shard_root, resolution=RES, num_channels=CH,
                                       label_dim=1000)
    assert len(ours) == len(theirs) == 23
    for i in range(23):
        (x, y), (tx, ty) = ours[i], theirs[i]
        np.testing.assert_array_equal(x, tx)
        np.testing.assert_array_equal(y, ty)
    ours.close()
    theirs.close()
    shards = wds.list_shards(shard_root)
    assert [(k, l.tolist(), c) for k, l, c in wds.iterate_samples(shards)] == \
        [(k, l.tolist(), c) for k, l, c in jax_wds.iterate_samples(shards)]


# (rank, world, epoch, seed, shuffle buffer, resample)
GRID = [
    (0, 1, 0, 0, 1000, False), (0, 1, 3, 7, 4, False), (1, 3, 0, 2, 1, False),
    (2, 3, 5, 9, 3, False), (0, 2, 1, 4, 0, True), (1, 2, 1, 4, 6, True),
    (4, 7, 2, 1, 2, True), (3, 5, 0, 2 ** 32 - 3, 5, False),
]


@pytest.mark.parametrize("rank,world,epoch,seed,buffer,resample", GRID)
def test_rank_shard_streams_equal_jax(shard_root, rank, world, epoch, seed, buffer, resample):
    kw = dict(process_index=rank, process_count=world, epoch=epoch, seed=seed,
              shuffle_buffer=buffer, resample=resample)
    ours = list(wds.iterate_rank_shards(shard_root, **kw))
    theirs = list(jax_wds.iterate_rank_shards(shard_root, **kw))
    assert len(ours) == len(theirs)
    for (x, y), (tx, ty) in zip(ours, theirs):
        np.testing.assert_array_equal(x, tx)
        assert y == ty


@pytest.mark.parametrize("rank,world,seed,buffer,resample",
                         [(0, 1, 0, 1000, False), (1, 2, 3, 4, False), (2, 4, 5, 3, True)])
def test_streaming_loader_equals_jax(shard_root, rank, world, seed, buffer, resample):
    """Batches of 4 across several epochs (records carry over epoch ends)."""
    kw = dict(batch_size=4, label_dim=1000, seed=seed, shuffle_buffer=buffer,
              process_index=rank, process_count=world, resample=resample)
    ours = wds.StreamingWDSLoader(shard_root, **kw)
    theirs = jax_wds.StreamingWDSLoader(shard_root, **kw)
    for a, b, _ in zip(iter(ours), iter(theirs), range(9)):
        assert a.keys() == b.keys() == {"x", "y"}
        for k in a:
            assert a[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k])


def test_streaming_loader_defaults_to_rank_0_of_1_and_refuses_idle_ranks(shard_root):
    loader = wds.StreamingWDSLoader(shard_root, 4)
    assert (loader.rank, loader.world) == (0, 1)
    with pytest.raises(ValueError, match="gets no shard"):
        wds.StreamingWDSLoader(shard_root, 4, process_index=5, process_count=6)
    wds.StreamingWDSLoader(shard_root, 4, process_index=5, process_count=6, resample=True)
    with pytest.raises(IOError, match="no .tar shards"):
        wds.list_shards(os.path.dirname(shard_root))


def test_indexed_reads_are_safe_across_the_loaders_threads(shard_root):
    """The loader's worker threads share the dataset's open shards: every
    record read by 8 threads at once equals its read alone."""
    from concurrent.futures import ThreadPoolExecutor

    ds = wds.WebDatasetLatents(shard_root, resolution=RES, num_channels=CH)
    alone = [ds[i] for i in range(len(ds))]
    with ThreadPoolExecutor(8) as pool:
        for _ in range(20):
            order = np.random.default_rng(_).permutation(len(ds))
            for i, (x, y) in zip(order, pool.map(lambda i: ds[int(i)], order)):
                np.testing.assert_array_equal(x, alone[i][0])
                np.testing.assert_array_equal(y, alone[i][1])
    ds.close()
