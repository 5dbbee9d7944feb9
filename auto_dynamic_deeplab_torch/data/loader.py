"""Host-side batching/prefetching loader (a numpy-only copy of
auto_dynamic_deeplab_tpu/data/loader.py).

Replaces torch.utils.data.DataLoader + DistributedSampler: a thread pool maps
dataset items (PIL decode + numpy augmentation release the GIL in zlib/
numpy), batches are prefetched a queue-depth ahead so host input overlaps
device compute, and `shard=(rank, world)` gives per-host sharding for
multi-host data parallelism (dataloaders/__init__.py:32-35).

A native C++ decode/augment engine can be plugged in via ``fetch_fn``.
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import numpy as np


def _default_collate(samples):
    out = {}
    for key in samples[0]:
        out[key] = np.stack([s[key] for s in samples])
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        num_workers: int = 4,
        seed: int = 0,
        shard: Tuple[int, int] = (0, 1),
        prefetch: int = 2,
        fetch_fn: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shard = shard
        self.prefetch = prefetch
        self.fetch_fn = fetch_fn
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _indices(self):
        n = len(self.dataset)
        order = np.arange(n)
        if self.shuffle:
            np.random.RandomState(self.seed + self.epoch).shuffle(order)
        rank, world = self.shard
        return order[rank::world]

    def __len__(self):
        n = len(self._indices())
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        indices = self._indices()
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def fetch(idx, rng):
            if self.fetch_fn is not None:
                return self.fetch_fn(self.dataset, idx, rng)
            try:
                return self.dataset.__getitem__(idx, rng=rng)
            except TypeError:
                return self.dataset[idx]

        def producer():
            base = self.seed * 7919 + self.epoch * 613
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for b in range(nb):
                        if stop.is_set():
                            return
                        batch_idx = indices[
                            b * self.batch_size : (b + 1) * self.batch_size
                        ]
                        rngs = [
                            np.random.RandomState(base + int(i) * 31 + b)
                            for i in batch_idx
                        ]
                        samples = list(pool.map(fetch, batch_idx, rngs))
                        q.put(_default_collate(samples))
            except BaseException as exc:  # propagate to the consumer
                q.put(exc)
            else:
                q.put(None)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    break
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            # Drain until the producer exits: it may be blocked in q.put with
            # a full queue (e.g. the iterator was abandoned after one batch),
            # so keep consuming until the thread is dead — otherwise daemon
            # threads race interpreter shutdown ("cannot schedule new futures
            # after shutdown").
            while t.is_alive():
                try:
                    q.get(timeout=0.05)
                except queue.Empty:
                    pass
            t.join(timeout=5)


def peek_batch(loader):
    """First batch of a loader with deterministic producer cleanup.

    ``next(iter(loader))`` abandons the generator; its prefetch thread then
    races interpreter shutdown. Closing the generator runs the finally block
    (stop + drain) immediately.
    """
    it = iter(loader)
    try:
        return next(it)
    finally:
        it.close()
