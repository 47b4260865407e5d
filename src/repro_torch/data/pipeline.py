"""Batching (a copy of ``Batches`` from the JAX package's
``repro/data/pipeline.py``; numpy only, so the same seed gives the same
batches).  ``Batches`` is a light epoch-shuffling iterator over host
arrays; callers move each batch to their device."""
from __future__ import annotations

from typing import Iterator

import numpy as np


class Batches:
    def __init__(self, arrays: dict, batch_size: int, *, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True):
        self.arrays = arrays
        n = next(iter(arrays.values())).shape[0]
        if any(a.shape[0] != n for a in arrays.values()):
            raise ValueError("every array needs the same leading dim")
        self.n = n
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rng = np.random.default_rng(seed)

    def epoch(self) -> Iterator[dict]:
        idx = self.rng.permutation(self.n) if self.shuffle else np.arange(self.n)
        stop = self.n - self.batch_size + 1 if self.drop_last else self.n
        for s in range(0, stop, self.batch_size):
            sl = idx[s:s + self.batch_size]
            yield {k: v[sl] for k, v in self.arrays.items()}

    def __iter__(self):
        while True:
            yield from self.epoch()
