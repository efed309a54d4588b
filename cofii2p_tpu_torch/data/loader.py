"""Batch collation and the threaded prefetching batch loader (a numpy copy
of cofii2p_tpu/data/loader.py, with the device staging done in PyTorch).

The host work is light (the pyramid and the supervision run on the
device), so a thread pool with a prefetch queue keeps the card fed.
Batches are dicts of stacked numpy arrays, or of tensors on the card with
``to_device``.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from cofii2p_tpu_torch.utils.profiling import span


def _collate(samples: list[dict]) -> dict:
    out = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if np.isscalar(vals[0]) or isinstance(vals[0], (int, float)):
            out[k] = np.asarray(vals)
        else:
            out[k] = np.stack(vals)
    return out


class BatchLoader:
    def __init__(self, dataset, batch_size: int, shuffle: bool = False, seed: int = 0, drop_last: bool = True,
                 num_workers: int = 8, prefetch: int = 2, to_device=None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.prefetch = prefetch
        # a CUDA device: the producer thread stages each batch in pinned
        # host memory and copies it without blocking, so the copy overlaps
        # the previous step's compute
        self.to_device = None if to_device is None else torch.device(to_device)

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _stage(self, batch: dict) -> dict:
        index = batch.pop("index", None)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory().to(self.to_device, non_blocking=True)
                 for k, v in batch.items()}
        if index is not None:
            batch["index"] = index
        return batch

    def epoch(self, epoch: int = 0) -> Iterator[dict]:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(order)
        nb = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size] for i in range(nb)]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            with cf.ThreadPoolExecutor(self.num_workers) as pool:
                for idxs in batches:
                    if stop.is_set():
                        return
                    batch = _collate(list(pool.map(self.dataset.__getitem__, idxs)))
                    if self.to_device is not None:
                        batch = self._stage(batch)
                    q.put(batch)
            q.put(None)

        th = threading.Thread(target=produce, daemon=True)
        th.start()
        try:
            while True:
                with span("cofii2p.loader.wait"):
                    item = q.get()
                if item is None:
                    return
                yield item
        finally:
            stop.set()
            # let a producer blocked on a full queue see the stop flag
            while th.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    th.join(0.01)
