"""Batching and placement (the torch twin of the JAX package's
``repro/data/pipeline.py``).

``Batches`` is a light epoch-shuffling iterator over host arrays (numpy
only, so the same seed gives the same batches); callers move each batch
to their device.  ``shard_batch`` places a batch on a mesh with the
canonical batch sharding (``batch_pspec``): one dict a data shard, its
contiguous rows on its device — the rows a JAX ``NamedSharding`` gives
each data shard.
"""
from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


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


def batch_pspec(mesh, ndim: int) -> tuple:
    """The batch's partition spec on ``mesh``: its rows over the data
    axes (``("pod", "data")`` where both exist, else the one present, or
    None), every other dim whole."""
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    lead = axes if len(axes) > 1 else (axes[0] if axes else None)
    return (lead,) + (None,) * (ndim - 1)


def shard_batch(batch: dict, mesh) -> list:
    """``batch`` (arrays or tensors with a leading row dim) placed by
    :func:`batch_pspec` on a :class:`repro_torch.launch.mesh.TierMesh`:
    one dict a data shard, in shard order, holding the shard's
    contiguous rows on its device (model shard 0's,
    ``mesh.data_devices()``).  A batch whose rows the data axis does not
    divide raises ValueError."""
    devices = mesh.data_devices()
    D = len(devices)
    out = [{} for _ in devices]
    for k, v in batch.items():
        v = torch.as_tensor(v)
        if v.shape[0] % D:
            raise ValueError(f"batch {k!r} of {v.shape[0]} rows does not "
                             f"split over {D} data shards")
        n = v.shape[0] // D
        for d, dev in enumerate(devices):
            out[d][k] = v[d * n:(d + 1) * n].to(dev, non_blocking=True)
    return out
