"""Host-side data loader (port of ``articulatory_tpu/data/loader.py``):
shuffle with a numpy generator seeded by ``seed + epoch`` (so one seed gives
both packages the same batches), batch, collate, and with ``num_workers``
threads prefetch ahead of the training loop. A ``batch_sampler`` (e.g.
``data/samplers.py::SizeAwareSampler``) gives the batches' indices instead,
its list made once an epoch.

Sharding across processes is the JAX package's: with ``num_shards > 1`` the
epoch's index list is wrap-padded to a multiple of ``num_shards`` and shard
``shard_id`` takes every ``num_shards``-th index from ``shard_id`` on, so
every rank sees the same number of batches of the same size. A
``batch_sampler`` with more than one shard raises, as in JAX.

``collate_seed`` makes the collater's random draws a function of
``(collate_seed, epoch, shard_id, batch index)``: each batch is collated
with its own ``numpy`` generator (passed as ``rng=``), so the batches do not
depend on the order the worker threads collate them in, and
``set_epoch(epoch, start)`` skips the epoch's first ``start`` batches
without loading them, the batches after them unchanged (an exact resume
within an epoch). Without it the collater keeps its own generator, as the
JAX package's does.
"""

from __future__ import annotations

import concurrent.futures
import queue
import threading
from collections import deque
from typing import Callable, Iterable, Iterator

import numpy as np

PREFETCH = 2  # batches collated ahead of the consumer


class DataLoader:
    def __init__(self, dataset, batch_size: int = 1, shuffle: bool = False,
                 collate_fn: Callable | None = None, drop_last: bool = False,
                 batch_sampler: Iterable[list[int]] | None = None,
                 num_workers: int = 0, seed: int = 0, shard_id: int = 0,
                 num_shards: int = 1, collate_seed: int | None = None):
        if batch_sampler is not None and num_shards > 1:
            # equal batch counts across ranks, but not equal shapes: a
            # size-aware sampler packs variable batches (as in JAX)
            raise ValueError(
                "batch_sampler is not supported with num_shards > 1: "
                "variable per-batch shapes cannot be made globally uniform "
                "across hosts. Use batch_size + package_mode "
                "window/random_window for multi-host training.")
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.collate_fn = collate_fn or (lambda items: items)
        self.drop_last = drop_last
        self.batch_sampler = batch_sampler
        self._sampled: tuple[int, list[list[int]]] | None = None
        self.num_workers = num_workers
        self.seed = seed
        self.shard_id, self.num_shards = shard_id, num_shards
        self.collate_seed = collate_seed
        self.epoch = 0
        self.start = 0

    def set_epoch(self, epoch: int, start: int = 0) -> None:
        """Reseed the shuffle per epoch; skip the epoch's first ``start``
        batches (each batch's draws need ``collate_seed`` to stay put)."""
        self.epoch, self.start = epoch, start

    def _sampler_batches(self) -> list[list[int]]:
        """The batch sampler's batches for this epoch, listed once."""
        if self._sampled is None or self._sampled[0] != self.epoch:
            if hasattr(self.batch_sampler, "set_epoch"):
                self.batch_sampler.set_epoch(self.epoch)
            self._sampled = (self.epoch, list(self.batch_sampler))
        return self._sampled[1]

    def _all_batches(self) -> Iterator[list[int]]:
        if self.batch_sampler is not None:
            yield from self._sampler_batches()
            return
        n = len(self.dataset)
        indices = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(indices)
        if self.num_shards > 1:
            # wrap-pad so every rank sees the same number of equal batches
            total = -(-n // self.num_shards) * self.num_shards
            if total > n:
                indices = np.concatenate([indices, indices[: total - n]])
            indices = indices[self.shard_id::self.num_shards]
        for i in range(0, len(indices), self.batch_size):
            batch = indices[i:i + self.batch_size]
            if self.drop_last and len(batch) < self.batch_size:
                return
            yield list(batch)

    def _batches(self) -> Iterator[tuple[int, list[int]]]:
        """(batch index in the epoch, indices), from ``start`` on."""
        for b, idxs in enumerate(self._all_batches()):
            if b >= self.start:
                yield b, idxs

    def __len__(self) -> int:
        if self.batch_sampler is not None:
            return len(self._sampler_batches())
        n = -(-len(self.dataset) // self.num_shards)  # wrap-padded shard
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _load_batch(self, b: int, idxs: list[int]):
        items = [self.dataset[i] for i in idxs]
        if self.collate_seed is None:
            return self.collate_fn(items)
        rng = np.random.default_rng(
            [self.collate_seed, self.epoch, self.shard_id, b])
        return self.collate_fn(items, rng=rng)

    def __iter__(self):
        if self.num_workers <= 0:
            for b, idxs in self._batches():
                yield self._load_batch(b, idxs)
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
                    for b, idxs in self._batches():
                        while len(inflight) >= self.num_workers + PREFETCH:
                            if not put(inflight.popleft().result()):
                                return
                        if stop.is_set():
                            return
                        inflight.append(pool.submit(self._load_batch, b,
                                                    idxs))
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
