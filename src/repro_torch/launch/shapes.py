"""Assigned input shapes and per-(arch × shape) inputs on a mesh (the
torch twin of the JAX package's ``repro/launch/shapes.py``).

:func:`input_specs` returns empty ``meta``-device tensors (no memory) of
the shapes one device holds for everything a step takes besides its
params and optimizer state (``models.params.param_shapes``,
``launch.steps.opt_state_shapes``); :func:`input_pspecs` gives their
partition specs, from ``data.batch_pspec`` and ``cache.cache_specs``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import batch_pspec
from repro_torch.launch.mesh import axis_sizes, local_shape
from repro_torch.models.cache import cache_shapes, cache_specs


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


def batch_shardable(shape: InputShape, mesh) -> bool:
    """Whether the data axes (``pod`` × ``data``) divide the batch; if not
    (``long_500k``'s batch of 1) a decode splits its cache's sequence
    over them instead (``cache_specs(shard_seq=True)``)."""
    sizes = axis_sizes(mesh)
    return shape.global_batch % math.prod(
        sizes.get(a, 1) for a in ("pod", "data")) == 0


def global_inputs(cfg: ModelConfig, shape_name: str,
                  dtype=torch.bfloat16) -> dict:
    """The step's inputs at their global shapes as ``(shape, dtype)``:
    ``tokens`` [B, S] (+ ``frontend_embeds``) for train and prefill;
    ``token`` and ``pos`` [B, 1] for decode (its cache is
    ``cache_shapes``' at ``mesh=None``)."""
    s = SHAPES[shape_name]
    B = s.global_batch
    if s.kind in ("train", "prefill"):
        out = {"tokens": ((B, s.seq_len), torch.int32)}
        if cfg.frontend:
            out["frontend_embeds"] = ((B, cfg.frontend_len,
                                       cfg.frontend_dim), dtype)
        return out
    return {"token": ((B, 1), torch.int32), "pos": ((B, 1), torch.int32)}


def input_pspecs(cfg: ModelConfig, shape_name: str, mesh,
                 seq_over_model: bool = False) -> dict:
    """The partition specs of :func:`input_specs`' inputs: the batch's
    rows over the data axes when they divide it (``data.batch_pspec``),
    else whole; a decode's cache by ``cache_specs``, its sequence split
    (``shard_seq``) where the batch is not."""
    s = SHAPES[shape_name]
    shardable = batch_shardable(s, mesh)
    specs = {k: batch_pspec(mesh, len(shp)) if shardable
             else (None,) * len(shp)
             for k, (shp, _) in global_inputs(cfg, shape_name).items()}
    if s.kind == "decode":
        specs["cache"] = cache_specs(cfg, s.global_batch, s.seq_len, mesh,
                                     shard_seq=not shardable,
                                     seq_over_model=seq_over_model)
    return specs


def input_specs(cfg: ModelConfig, shape_name: str, mesh,
                dtype=torch.bfloat16, seq_over_model: bool = False) -> dict:
    """Empty ``meta`` tensors of one device's inputs for one (arch ×
    shape) pair on ``mesh``.

    train/prefill: ``{"tokens" [B, S] (+ "frontend_embeds")}``.
    decode: ``{"token" [B, 1], "pos" [B, 1], "cache": tree}`` — one new
    token against a ``seq_len`` KV cache.  For a batch the data axes do
    not divide (``long_500k``) the cache's sequence dim is split over
    them instead (:func:`input_pspecs`)."""
    s = SHAPES[shape_name]
    sizes = axis_sizes(mesh)
    specs = input_pspecs(cfg, shape_name, mesh, seq_over_model)
    out = {k: torch.empty(local_shape(shp, specs[k], sizes), dtype=dt,
                          device="meta")
           for k, (shp, dt) in global_inputs(cfg, shape_name,
                                             dtype).items()}
    if s.kind == "decode":
        out["cache"] = cache_shapes(cfg, s.global_batch, s.seq_len,
                                    mesh=mesh, dtype=dtype,
                                    shard_seq=not batch_shardable(s, mesh),
                                    seq_over_model=seq_over_model)
    return out
