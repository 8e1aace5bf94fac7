"""Sharded, threaded, prefetching batch loader (host side): a copy of
``movedepth_tpu/data/loader.py``.

``ShardedIndexSampler`` shuffles per epoch from (seed, epoch), shards with
``indices[rank::world]`` and drops the last partial batch when asked;
``Loader`` decodes samples on a thread pool (PIL and numpy release the
GIL) and keeps a bounded queue of collated numpy batches, so the same
dataset and seed give the JAX package's batches. Unlike the JAX package's
loader, a sample that fails to load raises in the consumer instead of
leaving it waiting.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Sequence

import numpy as np


class ShardedIndexSampler:
    """Epoch-seeded, rank-sharded index stream."""

    def __init__(self, n: int, batch_size: int, rank: int = 0,
                 world_size: int = 1, shuffle: bool = True,
                 drop_last: bool = True, seed: int = 1):
        self.n = n
        self.batch_size = batch_size
        self.rank = rank
        self.world_size = world_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed

    def epoch_indices(self, epoch: int) -> np.ndarray:
        if self.shuffle:
            rng = np.random.default_rng(
                np.random.SeedSequence([self.seed, epoch]))
            idx = rng.permutation(self.n)
        else:
            idx = np.arange(self.n)
        idx = idx[self.rank::self.world_size]
        if self.drop_last:
            idx = idx[: len(idx) // self.batch_size * self.batch_size]
        return idx

    def batches(self, epoch: int) -> List[np.ndarray]:
        idx = self.epoch_indices(epoch)
        return [idx[i:i + self.batch_size]
                for i in range(0, len(idx), self.batch_size)]

    def __len__(self) -> int:
        per_rank = len(range(self.rank, self.n, self.world_size))
        if self.drop_last:
            return per_rank // self.batch_size
        return -(-per_rank // self.batch_size)


def collate(samples: Sequence[Dict[str, np.ndarray]]) -> Dict[str,
                                                             np.ndarray]:
    keys = samples[0].keys()
    return {k: np.stack([s[k] for s in samples], 0) for k in keys}


class _Failed:
    def __init__(self, error: Exception):
        self.error = error


class Loader:
    """Threaded prefetching loader over a map-style dataset."""

    def __init__(self, dataset, batch_size: int, rank: int = 0,
                 world_size: int = 1, shuffle: bool = True,
                 drop_last: bool = True, num_workers: int = 8,
                 prefetch: int = 4, seed: int = 1):
        self.dataset = dataset
        self.sampler = ShardedIndexSampler(
            len(dataset), batch_size, rank, world_size, shuffle, drop_last,
            seed)
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.sampler)

    def epoch(self, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)
        batches = self.sampler.batches(epoch)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item):
            """Queue ``item``; False once the consumer has gone away."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    pass
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    # two batches in flight: decode batch i+1 while i waits
                    futs = []
                    for b in batches:
                        futs.append([pool.submit(self.dataset.__getitem__,
                                                 int(i)) for i in b])
                        while len(futs) > 2:
                            done = futs.pop(0)
                            if not put(collate([f.result() for f in done])):
                                return
                    for done in futs:
                        if not put(collate([f.result() for f in done])):
                            return
                put(None)
            except Exception as e:  # handed to the consumer, re-raised
                put(_Failed(e))

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, _Failed):
                    raise item.error
                yield item
        finally:
            stop.set()
