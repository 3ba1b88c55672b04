"""Host-side batch loader with background prefetch, the port's copy of
``supervised_dispnet_tpu/data/loader.py`` for datasets with a vectorized
``get_batch(ids)`` (the packed datasets).

A producer thread gathers upcoming batches while the card computes, with
``num_workers`` threads gathering batches side by side and handing them on
in order, so every worker count gives the same batches; batches are dicts
of stacked numpy arrays with static shapes (drop_last).
"""

from __future__ import annotations

import collections
import queue
import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class BatchLoader:
    """Iterates dict batches over a dataset with ``__len__`` and ``get_batch``."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, prefetch: int = 4, seed: int = 0,
                 epoch_size: int | None = None):
        self.dataset = dataset
        self.num_workers = max(1, num_workers)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0
        n_batches = len(dataset) // batch_size
        self.epoch_size = min(epoch_size, n_batches) if epoch_size else n_batches

    def __len__(self) -> int:
        return self.epoch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(order)
        self.epoch += 1
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(self.epoch_size)]

        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def put(item) -> bool:
            """Bounded put that gives up once the consumer stopped, so the
            producer never waits forever on a full queue."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            # an exception in the producer must reach the consumer, or the
            # training loop would wait on q.get() forever
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    # up to num_workers batches in flight, handed on in order
                    running: collections.deque = collections.deque()
                    for idxs in batches:
                        running.append(pool.submit(self.dataset.get_batch, idxs))
                        if len(running) == self.num_workers and not put(
                                running.popleft().result()):
                            return
                    while running:
                        if not put(running.popleft().result()):
                            return
                put(None)
            except BaseException as e:  # noqa: BLE001 - re-raised by the consumer
                put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            t.join(timeout=5.0)
