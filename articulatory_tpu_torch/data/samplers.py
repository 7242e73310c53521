"""Batch samplers (port of ``articulatory_tpu/data/samplers.py``)."""

from __future__ import annotations

import logging
import random
from typing import Iterator, Sequence


class SizeAwareSampler:
    """Packs shuffled utterances into batches of at most ``max_len`` samples
    in all (an utterance longer than that still fills a batch of its own,
    with a warning); the last partial batch is dropped. The shuffle comes
    from ``(seed, epoch)``, so every iteration of an epoch gives the same
    packing, and ``set_epoch`` moves to the next."""

    def __init__(self, audio_lens: Sequence[int], max_len: int = 2000,
                 seed: int | None = None):
        self.audio_lens = list(audio_lens)
        self.max_len = max_len
        self.seed = 0 if seed is None else int(seed)
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = int(epoch)

    def __iter__(self) -> Iterator[list[int]]:
        indices = list(range(len(self.audio_lens)))
        random.Random(self.seed * 1_000_003 + self.epoch).shuffle(indices)
        batch: list[int] = []
        batch_length = 0
        for idx in indices:
            length = self.audio_lens[idx]
            if length > self.max_len:
                logging.warning(f"example {idx} cannot fit within the "
                                f"desired batch length")
            if length + batch_length > self.max_len:
                yield batch
                batch, batch_length = [], 0
            batch.append(idx)
            batch_length += length
