"""Roofline terms of a counted step on the NVIDIA H100 (the torch twin of
the JAX package's ``repro/launch/roofline.py``).

    compute term    = sum over rate kinds of FLOPs / that kind's peak
    memory term     = bytes / HBM bandwidth
    collective term = wire bytes / NVLink bandwidth

The counts are per device (the dry-run's mesh totals over its device
count, ``launch.dryrun``), so the terms are one card's times.  The rates
are ``launch.mesh``'s data-sheet figures for one NVIDIA H100 80GB HBM3
(SXM) at its 700 W power limit: a matrix product's FLOPs go at the peak
its implementation can reach at most — aten products in f32 with TF32
off (the port's setting) at ``PEAK_FLOPS_F32`` = 67 TFLOP/s, in bf16 at
``PEAK_FLOPS_BF16`` = 989 TFLOP/s; the 3xTF32 ``mma.sync`` kernels on
f32 inputs at ``PEAK_FLOPS_TF32 / 3`` = 165 TFLOP/s of f32 products
(three TF32 products each), on bf16 inputs at ``PEAK_FLOPS_TF32`` = 495
TFLOP/s; the CUDA-core kernels (gate, router, scans) at
``PEAK_FLOPS_F32`` — and bytes at ``HBM_BW`` = 3.35 TB/s, wire bytes at
``NVLINK_BW`` = 450 GB/s each way.  A card set below 700 W runs below
these.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import Optional

from repro_torch.launch.mesh import (HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16,
                                     PEAK_FLOPS_F32, PEAK_FLOPS_TF32)

# FLOP/s of each rate kind (``kernels.counting``)
RATES = {"f32": PEAK_FLOPS_F32, "bf16": PEAK_FLOPS_BF16,
         "tf32": PEAK_FLOPS_TF32, "tf32x3": PEAK_FLOPS_TF32 / 3}


@dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    chips: int
    # raw measurements (per device)
    flops_per_chip: float
    bytes_per_chip: float
    wire_bytes_per_chip: float
    collective_detail: dict
    # analytic
    model_flops: float           # 6*N*D (dense) / 6*N_active*D (MoE), global
    # derived times (seconds)
    t_compute: float
    t_memory: float
    t_collective: float
    bottleneck: str
    useful_flops_ratio: float    # MODEL_FLOPS / (FLOPs*chips)
    memory_per_device_gb: float
    peak_memory_gb: Optional[float] = None
    note: str = ""

    def to_json(self):
        return json.dumps(asdict(self), indent=1)


def compute_seconds(flops_by_rate: dict) -> float:
    """The compute term: each rate kind's FLOPs over its peak."""
    return sum(f / RATES[k] for k, f in flops_by_rate.items())


def analyze(*, arch: str, shape: str, mesh_name: str, chips: int,
            cost: dict, collectives, model_flops: float,
            memory: Optional[dict] = None, note: str = "") -> Roofline:
    """One record from a step's per-device counts: ``cost``'s
    ``"flops"`` (by rate kind) and ``"bytes accessed"``, ``collectives``
    (a ``launch.hlo.CollectiveStats``), and ``memory``'s
    ``"argument_bytes"`` and ``"peak_bytes"`` (the dry-run's argument
    bytes of the largest device and its peak estimate)."""
    flops = float(sum(cost["flops"].values()))
    nbytes = float(cost.get("bytes accessed", 0.0))
    wire = collectives.total_wire_bytes

    t_c = compute_seconds(cost["flops"])
    t_m = nbytes / HBM_BW
    t_x = wire / NVLINK_BW
    terms = {"compute": t_c, "memory": t_m, "collective": t_x}
    return Roofline(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_chip=flops, bytes_per_chip=nbytes,
        wire_bytes_per_chip=wire,
        collective_detail={"bytes_by_op": collectives.bytes_by_op,
                           "count_by_op": collectives.count_by_op},
        model_flops=model_flops,
        t_compute=t_c, t_memory=t_m, t_collective=t_x,
        bottleneck=max(terms, key=terms.get),
        useful_flops_ratio=(model_flops / (flops * chips)) if flops else 0.0,
        memory_per_device_gb=(memory or {}).get("argument_bytes", 0.0) / 1e9,
        peak_memory_gb=(None if memory is None
                        else memory["peak_bytes"] / 1e9),
        note=note,
    )


def model_flops_for(cfg, shape, kind: str) -> float:
    """6*N*D rule.  Train counts fwd+bwd (6ND); prefill counts forward only
    (2ND); decode counts one token (2*N_active per token * batch)."""
    n_active = cfg.active_param_count()
    if kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch
