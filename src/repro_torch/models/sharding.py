"""The data-parallel size of a tier mesh (the torch twin of
``data_axis_size`` in the JAX package's ``repro/models/sharding.py``).

The JAX module also holds GSPMD sharding constraints (``shard_hint``,
``shard_seq_if_heads_unshardable``) and the mesh context they resolve
against (``active_mesh``, ``set_mesh``).  The port's engine shards a tier
by explicit launches, one per data shard on that shard's device, so
there is no compiler to constrain; those helpers belong to tensor
sharding over the ``model`` axis, a later slice of the port.
"""
from __future__ import annotations

import math


def data_axis_size(mesh) -> int:
    """Total data parallelism of ``mesh``: the product of its ``pod`` and
    ``data`` axis sizes (1 for no mesh or a model-only mesh).  The serving
    engine partitions each tier's request rows and KV block pool into
    this many shards."""
    if mesh is None:
        return 1
    sizes = dict(mesh.shape)
    return math.prod(sizes[a] for a in ("pod", "data") if a in sizes)
