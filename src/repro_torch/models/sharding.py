"""Sharding of a tier over its mesh (the torch twin of the JAX package's
``repro/models/sharding.py``): the data-parallel size of a tier mesh, and
the tensor parallelism of its ``model`` axis written out explicitly.

The JAX package places its arrays under ``NamedSharding`` and lets GSPMD
insert the collectives; ``shard_hint`` and
``shard_seq_if_heads_unshardable`` add the activation constraints GSPMD
cannot infer, against the mesh that ``set_mesh`` activates and
``active_mesh`` reads.  The port compiles nothing: each model shard's
launches run eagerly on its own device over its own slices of the
weights (:func:`model_shard_params`) and its own KV heads, and the
engine calls the collectives itself (:func:`all_reduce` after each
attention and FFN, :func:`all_gather` of the vocab-parallel logits).
There is no compiler to constrain and no mesh context to activate, so
those four helpers have no counterpart here.

The layout, as the JAX package's ``param_specs`` gives it
(:func:`repro_torch.models.params.param_specs`): attention is
head-parallel (``wq``/``wk``/``wv`` columns and ``wo`` rows by heads),
a dense FFN splits ``ffn`` (``wi``/``wi0``/``wi1`` columns, ``wo`` rows),
a MoE FFN splits its experts (or, when the model axis does not divide
them, ``ffn`` inside every expert) with the router replicated, and the
embedding and LM head split the vocabulary when the model axis divides
it.  Which KV heads a shard holds is decided once, by
:func:`kv_head_range`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import torch

from repro_torch.models.params import declare_model


def data_axis_size(mesh) -> int:
    """Total data parallelism of ``mesh``: the product of its ``pod`` and
    ``data`` axis sizes (1 for no mesh or a model-only mesh).  The serving
    engine partitions each tier's request rows and KV block pool into
    this many shards."""
    if mesh is None:
        return 1
    sizes = dict(mesh.shape)
    return math.prod(sizes[a] for a in ("pod", "data") if a in sizes)


def model_axis_size(mesh) -> int:
    """The size of ``mesh``'s ``model`` axis (1 for no mesh)."""
    return 1 if mesh is None else int(dict(mesh.shape).get("model", 1))


def kv_heads_per_shard(cfg, m: int) -> int:
    """The KV heads each of ``m`` model shards holds.  ``KV % m == 0``:
    ``KV / m`` of them.  ``m % KV == 0``: the one KV head that the
    shard's ``H / m`` query heads read, so that head's ``wk``/``wv``
    columns and its cache are replicated over the ``m / KV`` shards that
    read it (gemma3-1b's single KV head; the JAX package's
    ``paged_cache_specs`` leaves such heads unsplit too).  Otherwise, or
    when ``m`` does not divide the query heads, no head-parallel layout
    exists: ValueError naming the shapes."""
    H, KV = cfg.num_heads, cfg.num_kv_heads
    if m < 1 or H % m or (KV % m and m % KV):
        raise ValueError(
            f"{cfg.name}: a model axis of {m} has no head-parallel layout "
            f"for {H} query heads and {KV} KV heads (it must divide the "
            "query heads, and divide or be a multiple of the KV heads)")
    return KV // m if KV % m == 0 else 1


def kv_head_range(cfg, index: int, m: int) -> tuple:
    """``(first, count)``: the KV heads model shard ``index`` of ``m``
    holds, ``count`` by :func:`kv_heads_per_shard` and ``first`` the head
    its first query head reads.  The one place that decides which KV
    heads a shard holds: its ``wk``/``wv`` columns
    (:func:`model_shard_params`) and its cache (:func:`shard_config`)
    both follow it."""
    count = kv_heads_per_shard(cfg, m)
    group = cfg.num_heads // cfg.num_kv_heads
    return index * (cfg.num_heads // m) // group, count


def shard_config(cfg, m: int):
    """``cfg`` as one of ``m`` model shards sees it: ``H / m`` query
    heads over :func:`kv_heads_per_shard` KV heads (the same head width),
    so the attention code and kernels run unchanged at the shard's head
    counts, and a serving pool declares each shard's cache from it."""
    if m == 1:
        return cfg
    return dataclasses.replace(cfg, num_heads=cfg.num_heads // m,
                               num_kv_heads=kv_heads_per_shard(cfg, m))


def shard_leaf(t, spec: Sequence, index: int, m: int):
    """Model shard ``index``'s slice (a view) of ``t`` along the dim
    ``spec`` puts ``"model"`` on, of ``m`` equal slices; ``t`` itself
    when ``spec`` splits no dim over ``model``.  ``"data"`` entries (the
    fsdp rule) are not sliced: a data shard holds every ``d_model`` row
    its launches read, the JAX package's all-gather done at placement."""
    for dim, axis in enumerate(spec):
        if axis == "model":
            n = t.shape[dim] // m
            return t.narrow(dim, index * n, n)
    return t


def model_shard_params(params, cfg, specs, index: int, m: int):
    """Model shard ``index``'s weights, as views of ``params`` (a whole
    parameter tree of ``cfg``; ``meta`` tensors give the shard's shapes):
    every leaf sliced by its spec (:func:`shard_leaf`; ``specs`` from
    :func:`repro_torch.models.params.param_specs`), except the KV
    projections of attention (``wk``/``wv``, whose columns are
    ``fused_heads`` in the declaration), which take the columns of the
    shard's own KV heads (:func:`kv_head_range`).  Where ``m`` divides
    the KV heads that is the spec's equal split; where ``m`` outnumbers
    them the spec would cut a head's width, and the shard holds the head
    its query heads read whole."""
    first, count = kv_head_range(cfg, index, m)
    hd = cfg.head_dim

    def walk(p, decl, s, key=None):
        if isinstance(p, dict):
            return {k: walk(v, decl[k], s[k], k) for k, v in p.items()}
        if key in ("wk", "wv") and decl.axes[-1] == "fused_heads":
            return p.narrow(-1, first * hd, count * hd)
        return shard_leaf(p, s, index, m)
    return walk(params, declare_model(cfg), specs)


class ModelShards:
    """The ``model`` axis of one data shard: its ``m`` devices in model
    shard order (a device may repeat: several model shards on one card,
    or the CPU tests).  Shard 0's device holds the gathered logits, and
    runs what the spec leaves replicated (an indivisible vocabulary, an
    FFN the axis divides nowhere)."""

    def __init__(self, devices: Sequence):
        self.devices: List[torch.device] = [torch.device(d)
                                            for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def replicate(self, t) -> list:
        """``t`` on every shard's device (itself where it already is)."""
        return [t.to(d, non_blocking=True) for d in self.devices]


def all_reduce(parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The sum of ``parts`` (one partial a model shard, each on its
    shard's device) on every shard's device: summed in shard order on
    shard 0's device, then copied to each shard's.  The copies are
    asynchronous device-to-device copies on the current streams, so no
    host sync; where the devices are the same it is a plain add, and
    every shard gets the one result."""
    dev = parts[0].device
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(dev, non_blocking=True)
    return [total.to(p.device, non_blocking=True) for p in parts]


def all_gather(parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """``parts`` concatenated along ``dim`` in shard order, on shard 0's
    device (asynchronous copies, no host sync)."""
    dev = parts[0].device
    return torch.cat([p.to(dev, non_blocking=True) for p in parts], dim)
