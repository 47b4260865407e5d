"""Collective traffic and op histograms of a counted step (the torch twin
of the JAX package's ``repro/launch/hlo.py``).

The JAX package reads its collectives from the SPMD-partitioned HLO
text.  The port compiles no HLO: its collectives are Python calls
(``launch.mesh.all_reduce`` / ``all_gather`` / ``spec_gather`` /
``group_sum``, ``sharding.train_shard_params``' fsdp gathers,
``transformer.route_data_shards``' route gather and scatter,
``ModelShards.replicate``), each of which reports an event to an active
count (``kernels.counting.collective``).  :func:`collective_stats` sums
those events per op kind, as the per-device output bytes of each
collective, and converts to on-wire bytes with the standard ring
factors:

    all-reduce         2(n-1)/n ~ 2x output size
    all-gather         (n-1)/n  ~ 1x
    reduce-scatter     (n-1)/n  ~ 1x
    all-to-all         (n-1)/n  ~ 1x
    collective-permute 1x
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

_WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


@dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, float] = field(default_factory=dict)
    count_by_op: Dict[str, float] = field(default_factory=dict)

    @property
    def total_wire_bytes(self) -> float:
        return sum(_WIRE_FACTOR[k] * v for k, v in self.bytes_by_op.items())

    @property
    def total_raw_bytes(self) -> float:
        return sum(self.bytes_by_op.values())


def collective_stats(events, devices: int = 1) -> CollectiveStats:
    """Per-device collective traffic from a count's events (``(op kind,
    output bytes, devices delivered to)``, ``Count.collectives``) of a
    program over ``devices`` devices: each op kind's output bytes and
    deliveries summed over the events and divided by ``devices`` — the
    mean device's, as one device's HLO module gives JAX its own."""
    stats = CollectiveStats()
    for op, nbytes, n in events:
        stats.bytes_by_op[op] = stats.bytes_by_op.get(op, 0.0) + nbytes
        stats.count_by_op[op] = stats.count_by_op.get(op, 0) + n
    for d in (stats.bytes_by_op, stats.count_by_op):
        for k in d:
            d[k] /= devices
    return stats


def op_histogram(counts, top: int = 20):
    """The ``top`` most called aten ops of a count (``Count.ops``: op
    name -> calls) — handy for spotting remat recompute and layout
    churn."""
    return sorted(counts.items(), key=lambda kv: -kv[1])[:top]
