"""WebDataset-format tar shard reading/writing (stdlib tarfile, no deps).

The reference's 512-res pipeline stores latents as WebDataset tar shards
with members ``{key}.latent`` (pickled numpy array) and ``{key}.cls``
(int text) (reference: lmdb2wds.py:20-26, train_wds.py:54-64).

Two read modes:

* ``WebDatasetLatents`` — *indexed random access*: shards are indexed once
  at open (tar headers only), then records are fetched with per-record
  seeks, so the same map-style DataLoader (shuffle, rank-striding,
  deterministic epochs) serves LMDB and WDS data. IO constraint: this is
  the right mode for local SSD/NVMe; on network storage, random seeks
  into hundreds of shards per host defeat readahead and are slow.
* ``iterate_rank_shards`` — *shard-sequential streaming*: whole shards
  are assigned per rank (the reference's nodesplitter split-by-shard,
  train_wds.py:35-42) and each worker reads its shards linearly with a
  bounded shuffle buffer (the reference's ``.shuffle(1000)``). This is
  the mode that survives network filesystems / object stores; epochs are
  only approximately shuffled, exactly like the reference's pipeline.

``write_wds_shards`` produces shards byte-compatible with webdataset's
ShardWriter consumers, and byte-identical to the JAX package's writer.

The port's copy of maskdit_tpu/data/wds.py: it imports neither jax nor the
JAX package's datasets, and ``StreamingWDSLoader`` takes the process index
and count from the process group (``parallel/dist.py``) unless told. The
indexed reader reads with ``os.pread``: the loader's worker threads share
its open shards, and the JAX reader's seek + read on a shared file object
returns another record's bytes when two threads interleave.
"""

from __future__ import annotations

import io
import os
import pickle
import tarfile
import threading
from typing import Iterable, Iterator, Optional

import numpy as np

from maskdit_tpu_torch.data.datasets import Dataset, encode_label
from maskdit_tpu_torch.parallel import dist


def index_tar(path: str) -> dict[str, dict[str, tuple[int, int]]]:
    """Scan tar headers: key -> {ext: (data_offset, size)}."""
    samples: dict[str, dict[str, tuple[int, int]]] = {}
    with tarfile.open(path, "r") as tf:
        for member in tf:
            if not member.isfile():
                continue
            base = os.path.basename(member.name)
            key, _, ext = base.partition(".")
            samples.setdefault(key, {})[ext] = (member.offset_data, member.size)
    return samples


class WebDatasetLatents(Dataset):
    """Map-style reader over a directory of latent tar shards."""

    def __init__(
        self,
        root: str,
        resolution: int = 64,
        num_channels: int = 8,
        label_dim: int = 1000,
        **view_kwargs,
    ):
        self._shards = list_shards(root)
        # global index: (shard_idx, latent_off, latent_sz, cls_off, cls_sz)
        self._index: list[tuple[int, int, int, int, int]] = []
        for si, shard in enumerate(self._shards):
            ents = index_tar(shard)
            for key in sorted(ents):
                e = ents[key]
                if "latent" in e and "cls" in e:
                    self._index.append((si, *e["latent"], *e["cls"]))
        self._fds: dict[int, int] = {}
        self._fd_lock = threading.Lock()
        self._init_view(
            num_records=len(self._index),
            sample_shape=(num_channels, resolution, resolution),
            label_dim=label_dim,
            **view_kwargs,
        )

    def _read(self, shard_idx: int, offset: int, size: int) -> bytes:
        """Positional reads: the loader's worker threads share the open
        shards (a shared file position, as in the JAX reader's seek + read,
        would let one thread's seek land between another's seek and read)."""
        fd = self._fds.get(shard_idx)
        if fd is None:
            with self._fd_lock:
                fd = self._fds.get(shard_idx)
                if fd is None:
                    fd = self._fds[shard_idx] = os.open(self._shards[shard_idx], os.O_RDONLY)
        return os.pread(fd, size, offset)

    def fetch(self, record_id: int):
        si, l_off, l_sz, c_off, c_sz = self._index[record_id]
        latent = pickle.loads(self._read(si, l_off, l_sz))
        label = int(self._read(si, c_off, c_sz).decode("utf-8"))
        return np.asarray(latent, dtype=np.float32), label

    def close(self) -> None:
        with self._fd_lock:
            for fd in self._fds.values():
                os.close(fd)
            self._fds.clear()


def write_wds_shards(
    records: Iterable[tuple[str, np.ndarray, int]],
    outdir: str,
    pattern: str = "shard-%06d.tar",
    maxcount: int = 10010,
    maxsize: int = 10 ** 10,
) -> list[str]:
    """Write (key, latent, cls) records into tar shards (ShardWriter clone)."""
    os.makedirs(outdir, exist_ok=True)
    paths: list[str] = []
    tf: Optional[tarfile.TarFile] = None
    count = size = shard_id = 0

    def open_shard():
        nonlocal tf, count, size, shard_id
        path = os.path.join(outdir, pattern % shard_id)
        paths.append(path)
        tf = tarfile.open(path, "w")
        shard_id += 1
        count = size = 0

    def close_shard():
        nonlocal tf
        if tf is not None:
            tf.close()
            tf = None

    def add(name: str, data: bytes):
        nonlocal count, size
        info = tarfile.TarInfo(name)
        info.size = len(data)
        tf.addfile(info, io.BytesIO(data))
        size += len(data)

    for key, latent, cls in records:
        if tf is None or count >= maxcount or size >= maxsize:
            close_shard()
            open_shard()
        add(f"{key}.latent", pickle.dumps(np.asarray(latent)))
        add(f"{key}.cls", str(int(cls)).encode("utf-8"))
        count += 1
    close_shard()
    return paths


def list_shards(root: str) -> list[str]:
    """Sorted .tar shard paths under a directory."""
    shards = sorted(
        os.path.join(root, f) for f in os.listdir(root) if f.endswith(".tar")
    )
    if not shards:
        raise IOError(f"no .tar shards found in {root}")
    return shards


def iterate_rank_shards(
    root: str,
    process_index: int = 0,
    process_count: int = 1,
    epoch: int = 0,
    seed: int = 0,
    shuffle_buffer: int = 1000,
    resample: bool = False,
) -> Iterator[tuple[np.ndarray, int]]:
    """Shard-sequential streaming iterator for one rank.

    Mirrors the reference's multi-node WDS pipeline: *shards* (not
    records) are split across ranks (train_wds.py:35-42 nodesplitter) so
    every worker reads its tar files strictly linearly — the IO pattern
    network storage needs — with per-epoch shard-order shuffling and a
    bounded in-memory shuffle buffer (train_wds.py:67-97 .shuffle(1000)).

    ``resample=True`` switches to the reference's ``--resample`` mode
    (train_wds.py:72-75,374: webdataset ``resampled=True`` with the
    nodesplitter disabled): every rank draws its shards iid WITH
    replacement from the FULL shard list — ranks are decorrelated by
    seed, not partitioned, so any fleet size works and the stream is
    i.i.d. at the shard level while tar reads stay strictly linear.
    One "epoch" here draws ceil(num_shards / process_count) shards, the
    per-rank share of one nominal pass (the reference bounds epochs by
    batch count via ``.with_epoch``, train_wds.py:95-96 — the trainer's
    step budget plays that role for us).

    Yields (latent float32, int label). In split mode, ranks with no
    shard this epoch (more ranks than shards) yield nothing — size the
    shard count to the fleet, as the reference requires.
    """
    shards = list_shards(root)
    rng = np.random.RandomState((seed + epoch) % (2**32))
    if resample:
        # fold the rank into the stream so ranks draw independently;
        # keep (seed+epoch) rng for the shuffle buffer below. RandomState
        # seeds are capped at 2**32-1 and StreamingWDSLoader increments
        # epoch forever, so reduce the fold mod 2**32.
        draw = np.random.RandomState(
            ((seed + epoch) * 1000003 + 7919 * process_index) % (2**32)
        )
        n_mine = -(-len(shards) // process_count)  # ceil
        mine = [shards[i] for i in draw.randint(0, len(shards), size=n_mine)]
    else:
        order = rng.permutation(len(shards))
        mine = [shards[i] for i in order[process_index::process_count]]

    def records() -> Iterator[tuple[np.ndarray, int]]:
        for _, latent, cls in iterate_samples(mine):
            yield np.asarray(latent, dtype=np.float32), int(cls)

    if shuffle_buffer <= 1:
        yield from records()
        return
    buf: list[tuple[np.ndarray, int]] = []
    for item in records():
        if len(buf) < shuffle_buffer:
            buf.append(item)
            continue
        j = rng.randint(len(buf))
        buf[j], item = item, buf[j]
        yield item
    rng.shuffle(buf)
    yield from buf


class StreamingWDSLoader:
    """Infinite batch loader over ``iterate_rank_shards`` (streaming mode).

    The trainer's drop-in alternative to ``DataLoader(WebDatasetLatents)``
    for network storage: selected by ``data.streaming: true``. Yields the
    same ``{'x': (B, C, H, W) float32, 'y': (B, K) float32}`` dicts,
    rolling from epoch to epoch with per-epoch shard reshuffles. Records
    left over when an epoch's shards run dry carry into the next epoch's
    first batch (a continuous stream never drops a tail — the analogue of
    the reference's infinite ``.repeat()`` WDS pipeline, train_wds.py:97).
    """

    def __init__(
        self,
        root: str,
        batch_size: int,
        label_dim: int = 1000,
        seed: int = 0,
        shuffle_buffer: int = 1000,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        resample: bool = False,
    ):
        self.root = root
        self.batch_size = batch_size
        self.label_dim = label_dim
        self.seed = seed
        self.shuffle_buffer = shuffle_buffer
        self.resample = resample
        self.rank = dist.process_index() if process_index is None else process_index
        self.world = dist.process_count() if process_count is None else process_count
        self.num_shards = len(list_shards(root))  # validates root up front
        if not resample and self.rank >= self.num_shards:
            # this rank owns zero shards EVERY epoch -> __iter__ would spin
            # without ever yielding; surface the sizing error immediately.
            # (resample mode draws with replacement from the full shard
            # list, so any fleet size works — reference train_wds.py:72-75.)
            raise ValueError(
                f"rank {self.rank} gets no shard: {self.num_shards} shards "
                f"< {self.world} ranks — add shards, shrink the fleet, or "
                f"set data.resampled: true"
            )

    def _collate(self, pending) -> dict[str, np.ndarray]:
        return {
            "x": np.stack([z for z, _ in pending]).astype(np.float32),
            "y": np.stack(
                [encode_label(c, self.label_dim) for _, c in pending]
            ).astype(np.float32),
        }

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        epoch = 0
        pending: list[tuple[np.ndarray, int]] = []
        while True:
            for item in iterate_rank_shards(
                self.root, self.rank, self.world, epoch, self.seed,
                self.shuffle_buffer, resample=self.resample,
            ):
                pending.append(item)
                if len(pending) == self.batch_size:
                    yield self._collate(pending)
                    pending = []
            epoch += 1


def iterate_samples(shard_paths: list[str]) -> Iterator[tuple[str, np.ndarray, int]]:
    """Streaming iteration (for conversion pipelines)."""
    for path in shard_paths:
        with tarfile.open(path, "r") as tf:
            current: dict[str, bytes] = {}
            current_key = None
            for member in tf:
                if not member.isfile():
                    continue
                key, _, ext = os.path.basename(member.name).partition(".")
                if current_key is not None and key != current_key and current:
                    if "latent" in current and "cls" in current:
                        yield (
                            current_key,
                            pickle.loads(current["latent"]),
                            int(current["cls"].decode()),
                        )
                    current = {}
                current_key = key
                current[ext] = tf.extractfile(member).read()
            if current and "latent" in current and "cls" in current:
                yield (
                    current_key,
                    pickle.loads(current["latent"]),
                    int(current["cls"].decode()),
                )
