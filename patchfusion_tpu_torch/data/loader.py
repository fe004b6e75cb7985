"""Host-side batching + prefetching data loader (a copy of
patchfusion_tpu/data/loader.py).

Stands in for the reference's torch DataLoader + DistributedSampler
(tools/train.py:171-201, tools/test.py:218-230): per-process index sharding
(the DistributedSampler equivalent) and a thread-pool prefetch pipeline
feeding numpy batches, which the engine moves to the device.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

_STACK_EXCLUDE = ("img_file_basename",)


def collate(samples: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Stack numeric fields, list the rest (the torch default_collate
    behavior the reference relies on)."""
    out: Dict[str, Any] = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if k in _STACK_EXCLUDE or isinstance(vals[0], str):
            out[k] = vals
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


class ShardedSampler:
    """DistributedSampler-equivalent index sharding: each process sees
    ceil(N/world) indices, padded by wraparound, optionally shuffled with an
    epoch-seeded RNG (matches torch semantics so multi-host runs partition
    the dataset identically)."""

    def __init__(self, n: int, world_size: int = 1, rank: int = 0,
                 shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.n = n
        self.world = world_size
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def indices(self) -> List[int]:
        idx = np.arange(self.n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        if self.drop_last:
            per = self.n // self.world
            idx = idx[:per * self.world]
        else:
            per = -(-self.n // self.world)
            pad = per * self.world - self.n
            if pad:
                idx = np.concatenate([idx, idx[:pad]])
        return list(idx[self.rank::self.world])


class DataLoader:
    """Thread-prefetched batch iterator over a map-style dataset."""

    def __init__(self, dataset, batch_size: int = 1,
                 sampler: Optional[ShardedSampler] = None,
                 num_workers: int = 4, shuffle: bool = False,
                 drop_last: bool = False, prefetch: int = 2, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.sampler = sampler or ShardedSampler(
            len(dataset), shuffle=shuffle, seed=seed, drop_last=drop_last)
        self.num_workers = max(1, num_workers)
        self.drop_last = drop_last
        self.prefetch = prefetch

    def __len__(self) -> int:
        n = len(self.sampler.indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        idx = self.sampler.indices()
        batches = [idx[i:i + self.batch_size]
                   for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            batches = [b for b in batches if len(b) == self.batch_size]

        pool = ThreadPoolExecutor(self.num_workers)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                futures = [pool.submit(
                    lambda b=b: collate([self.dataset[i] for i in b]))
                    for b in batches]
                for f in futures:
                    if stop.is_set():
                        return
                    q.put(f.result())
            except BaseException as e:  # propagate to the consumer: a
                # loader failure must fail the run, not end the epoch early
                q.put(e)
            finally:
                q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            pool.shutdown(wait=False)
