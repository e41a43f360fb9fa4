"""Host data loading, counterpart of ``videoseal_tpu/data/loader.py``: each
process iterates its shard of the index space (process_index /
process_count), a thread decodes ahead, and batches are dicts of numpy
arrays (imgs, masks) that the training loop moves to the device."""

from __future__ import annotations

import queue
import threading

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        self.ds = dataset
        self.bs = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.pi = process_index
        self.pc = process_count
        self.epoch = 0

    def set_epoch(self, epoch: int):
        """The shuffle of `epoch` (DistributedSampler.set_epoch)."""
        self.epoch = epoch

    def _indices(self):
        n = len(self.ds)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        return idx[self.pi::self.pc]  # this process's shard

    def __len__(self):
        n = len(self._indices())
        return n // self.bs if self.drop_last else -(-n // self.bs)

    def __iter__(self):
        idx = self._indices()
        nb = len(self)
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def worker():
            try:
                for b in range(nb):
                    if stop.is_set():
                        return
                    batch_idx = idx[b * self.bs:(b + 1) * self.bs]
                    items = [self.ds[int(i)] for i in batch_idx]
                    imgs = np.stack([it[0] for it in items])
                    masks = np.stack([it[1] for it in items])
                    q.put({"imgs": imgs, "masks": masks})
                q.put(None)
            except Exception as e:  # surface decode errors to the consumer
                q.put(e)

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
