"""Host-side data loader (port of ``articulatory_tpu/data/loader.py``):
shuffle with a numpy generator seeded by ``seed + epoch`` (so one seed gives
both packages the same batches), batch, collate, and with ``num_workers``
threads prefetch ahead of the training loop. Batch samplers and sharding
across processes are not ported."""

from __future__ import annotations

import concurrent.futures
import queue
import threading
from collections import deque
from typing import Callable, Iterator

import numpy as np

PREFETCH = 2  # batches collated ahead of the consumer


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 collate_fn: Callable | None = None, drop_last: bool = False,
                 num_workers: int = 0, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn or (lambda items: items)
        self.drop_last = drop_last
        self.num_workers = num_workers
        self.seed = seed
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        """Reseed the shuffle per epoch."""
        self.epoch = epoch

    def _batches(self) -> Iterator[list[int]]:
        indices = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(indices)
        for i in range(0, len(indices), self.batch_size):
            batch = indices[i:i + self.batch_size]
            if self.drop_last and len(batch) < self.batch_size:
                return
            yield list(batch)

    def _load_batch(self, idxs: list[int]):
        return self.collate_fn([self.dataset[i] for i in idxs])

    def __iter__(self):
        if self.num_workers <= 0:
            for idxs in self._batches():
                yield self._load_batch(idxs)
            return
        # threads load and collate ahead; the consumer takes batches in order
        batch_queue: queue.Queue = queue.Queue(maxsize=PREFETCH)
        done = object()
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    batch_queue.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                with concurrent.futures.ThreadPoolExecutor(
                        self.num_workers) as pool:
                    inflight: deque = deque()
                    for idxs in self._batches():
                        while len(inflight) >= self.num_workers + PREFETCH:
                            if not put(inflight.popleft().result()):
                                return
                        if stop.is_set():
                            return
                        inflight.append(pool.submit(self._load_batch, idxs))
                    while inflight:
                        if not put(inflight.popleft().result()):
                            return
            except Exception as e:  # hand I/O errors to the consumer
                put(_ProducerError(e))
                return
            put(done)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = batch_queue.get()
                if item is done:
                    break
                if isinstance(item, _ProducerError):
                    raise item.exc
                yield item
        finally:  # retire the producer even if the consumer stopped early
            stop.set()
            while True:
                try:
                    batch_queue.get_nowait()
                except queue.Empty:
                    break
            thread.join(timeout=30)


class _ProducerError:
    def __init__(self, exc: Exception):
        self.exc = exc
