"""Host-side data loading: shuffling, batching, prefetch and the copy to
the device.

Counterpart of maskdit_tpu/data/loader.py without jax: a per-epoch
shuffle, of which each process reads its rank-strided slice (the JAX
loader's :55-72, the analogue of the WDS nodesplitter, train_wds.py:35-42),
worker threads that load samples, full batches collated in numpy, and a
background thread that keeps a few batches ready. ``to_device`` copies a batch to the card through pinned
memory without blocking the host.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterator, Optional

import numpy as np
import torch

from maskdit_tpu_torch.parallel import dist


class DataLoader:
    """Epoch-based shuffled loader over a map-style dataset of (x, y).

    Yields {'x': (B, ...) float32, 'y': (B, K) float32} numpy batches (and
    'feat' (B, F) float32 from a dataset that joins features) of
    this process's rows, forever (epochs roll over), with the JAX loader's
    per-epoch order; the last partial batch of an epoch is dropped.
    ``process_index`` / ``process_count`` default to the process group's
    rank and size (0 of 1 without one).
    """

    def __init__(
        self,
        dataset: Any,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 2,
        resample: bool = False,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.resample = resample
        self.rank = dist.process_index() if process_index is None else process_index
        self.world = dist.process_count() if process_count is None else process_count

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """This process's sample indices of ``epoch``, in order."""
        n = len(self.dataset)
        rng = np.random.RandomState((self.seed + epoch) % (1 << 31))
        if self.resample:
            # iid with replacement; disjoint per rank by striding the draw
            idx = rng.randint(0, n, size=n)
        else:
            idx = np.arange(n)
            if self.shuffle:
                rng.shuffle(idx)
        return idx[self.rank::self.world]

    def batches(self, epoch: int) -> Iterator[dict[str, np.ndarray]]:
        idx = self.epoch_indices(epoch)
        n_batches = len(idx) // self.batch_size
        chunks = (idx[b * self.batch_size:(b + 1) * self.batch_size] for b in range(n_batches))
        if self.num_workers == 1:
            for chunk in chunks:
                yield self._collate([self.dataset[int(i)] for i in chunk])
            return
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(self.num_workers)
        try:
            for chunk in chunks:
                yield self._collate(list(pool.map(lambda i: self.dataset[int(i)], chunk)))
        finally:
            pool.shutdown(wait=False, cancel_futures=True)

    @staticmethod
    def _collate(samples) -> dict[str, np.ndarray]:
        """The batch of (x, y) samples; a ``[onehot, feature]`` condition (the
        feature-LMDB join) gives ``feat`` beside ``y`` (JAX loader.py:
        103-111)."""
        xs, conds = zip(*samples)
        batch = {"x": np.stack(xs).astype(np.float32)}
        if isinstance(conds[0], list):
            batch["y"] = np.stack([c[0] for c in conds]).astype(np.float32)
            batch["feat"] = np.stack([c[1] for c in conds]).astype(np.float32)
        else:
            batch["y"] = np.stack(conds).astype(np.float32)
        return batch

    def __iter__(self) -> Iterator[dict[str, np.ndarray]]:
        # the JAX loader's check (:118-131): a slice smaller than a batch
        # would spin through empty epochs forever
        per_rank = len(self.epoch_indices(0))
        if per_rank < self.batch_size:
            raise ValueError(
                f"dataset yields {per_rank} samples/rank/epoch < batch_size "
                f"{self.batch_size}: no full batch would ever be produced "
                "(shrink the batch or grow/replicate the dataset)"
            )
        epoch = 0
        while True:
            yield from self.batches(epoch)
            epoch += 1


def to_device(batch: dict[str, np.ndarray], device: torch.device) -> dict[str, torch.Tensor]:
    """numpy batch -> tensors on ``device``; to a card through pinned host
    memory with a non-blocking copy."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        else:
            t = t.to(device)
        out[k] = t
    return out


def prefetch(iterator: Iterator[Any], size: int = 2) -> Iterator[Any]:
    """Run ``iterator`` in a background thread, ``size`` items ahead.

    Closing the returned generator (a ``break`` out of the loop over it
    does) stops the thread and closes ``iterator``.
    """
    q: queue.Queue = queue.Queue(maxsize=size)
    stop = threading.Event()
    done = object()
    error: list[BaseException] = []

    def put(item) -> bool:
        """Queue ``item`` unless the consumer has gone; False if it has."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in iterator:
                if not put(item):
                    return
        except BaseException as e:  # surfaced to the consumer
            error.append(e)
        put(done)

    thread = threading.Thread(target=worker, name="prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                if error:
                    raise error[0]
                return
            yield item
    finally:
        stop.set()
        thread.join()
        close = getattr(iterator, "close", None)
        if close is not None:
            close()
