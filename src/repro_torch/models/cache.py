"""Decode caches, dense and block-paged (the torch twin of
``repro/models/cache.py``).

Cache structure mirrors the model layout::

    {"head": {"layer0": {...}}, "period": {"block0": stacked...}, "tail": ...}

Each layer slot is ``{"mixer": <per-kind state>, "ffn": <per-kind
state>}``; period entries carry a leading ``num_periods`` stack dim:

  * attn  -> {"k": [B,S,KV,hd], "v": [B,S,KV,hd]} (int8 adds f32
    ``k_scale``/``v_scale`` [B,S,KV])
  * mamba -> {"conv": [B,d_conv-1,d_inner], "ssm": [B,d_inner,d_state]
    f32}
  * rwkv6 -> {"x_prev": [B,1,D], "state": [B,H,hd,hd] f32}
  * rwkv_cmix ffn -> {"x_prev": [B,1,D]}; other ffns -> {}

:func:`init_cache` builds the dense arena (one ``[max_seq]`` row per
request).  In the block-paged cache (:func:`init_paged_cache`) attention
k/v live in one shared block pool per layer, ``[num_blocks, block_size,
kv_heads, hd]``, reached through per-request page tables
(``repro_torch.serving.slots``); recurrent state has no sequence dim and
stays one row per request.  Block 0 is the null block that page tables
are padded with: it is never allocated, and padding writes land there.

The JAX package returns a new cache from every step (and donates the old
buffers on accelerators); here decode steps update the cache in place.

:func:`paged_cache_specs` gives a block-paged cache's partition specs on
a tier mesh (tuples of ``"data"``, ``"model"`` or None per dim, by the
JAX package's :func:`cache_spec_leaf` rules): the ``kv_blocks`` pool
and per-row recurrent ``batch`` dims over ``data``, KV heads, RWKV-6
heads and Mamba ``d_inner`` over ``model`` when divisible, as a
description of the JAX placement (the serving engine declares each model
shard's cache by :func:`repro_torch.models.sharding.shard_config`, whose
``model_shards`` sizes the recurrent leaves: a ``ShardConfig``'s
``[B, H / m, hd, hd]`` RWKV-6 state and ``[B, d_conv - 1, d_in / m]`` /
``[B, d_in / m, n]`` Mamba state).  :func:`cache_specs` gives the dense
arena's: by default the request rows over the data axes, which is how
the engine's sharded dense arena and the sharded serve step
(``launch.steps.make_serve_step(mesh=)``) split them; with
``shard_seq`` (a batch of 1, ``long_500k``) the KV sequence over the
data axes instead, and with ``seq_over_model`` over ``model`` too where
no KV-head dim divides it, as the JAX package's dry-run places its
caches and as the sharded serve step decodes over them (its
sequence-split decode).  :func:`cache_shapes` gives each leaf's
per-device shape on the ``meta`` device, as ``params.param_shapes``
does for the weights.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.configs.base import Layer, ModelConfig
from repro_torch.launch.mesh import local_shape
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.models.sharding import shards_of


class CP(NamedTuple):
    """Cache leaf declaration: shape + logical axes + dtype."""
    shape: tuple
    axes: tuple
    dtype: object


def _mixer_cache_decl(cfg: ModelConfig, m, B: int, S: int, dtype) -> dict:
    if m.kind == "attn":
        kv = (B, S, cfg.num_kv_heads, cfg.head_dim)
        ax = ("batch", "kv_seq", "kv_heads", None)
        if cfg.kv_quant == "int8":
            sc = (B, S, cfg.num_kv_heads)
            sax = ("batch", "kv_seq", "kv_heads")
            return {"k": CP(kv, ax, torch.int8), "v": CP(kv, ax, torch.int8),
                    "k_scale": CP(sc, sax, torch.float32),
                    "v_scale": CP(sc, sax, torch.float32)}
        return {"k": CP(kv, ax, dtype), "v": CP(kv, ax, dtype)}
    # one model shard's recurrent leaves (a shard_config) at the shard's
    # width: d_inner / m Mamba channels, H / m RWKV-6 heads
    shards = shards_of(cfg)
    if m.kind == "mamba":
        d_in = m.expand * cfg.d_model // shards
        return {"conv": CP((B, m.d_conv - 1, d_in),
                           ("batch", None, "d_inner"), dtype),
                "ssm": CP((B, d_in, m.d_state), ("batch", "d_inner", None),
                          torch.float32)}
    if m.kind == "rwkv6":
        h = cfg.d_model // m.head_dim // shards
        return {"x_prev": CP((B, 1, cfg.d_model), ("batch", None, None),
                             dtype),
                "state": CP((B, h, m.head_dim, m.head_dim),
                            ("batch", "heads", None, None), torch.float32)}
    raise NotImplementedError(f"{m.kind} cache is not ported")


def _ffn_cache_decl(cfg: ModelConfig, f, B: int, dtype) -> dict:
    if f.kind == "dense" and f.act == "rwkv_cmix":
        return {"x_prev": CP((B, 1, cfg.d_model), ("batch", None, None),
                             dtype)}
    return {}


def _layer_cache_decl(cfg, layer: Layer, B, S, dtype):
    return {"mixer": _mixer_cache_decl(cfg, layer.mixer, B, S, dtype),
            "ffn": _ffn_cache_decl(cfg, layer.ffn, B, dtype)}


def _stack(decl, n):
    return tree_map(lambda c: CP((n,) + c.shape, ("stack",) + c.axes,
                                 c.dtype), decl)


def declare_cache(cfg: ModelConfig, batch: int, seq_len: int,
                  dtype=torch.float32) -> dict:
    decl = {}
    if cfg.head:
        decl["head"] = {f"layer{i}": _layer_cache_decl(cfg, l, batch,
                                                       seq_len, dtype)
                        for i, l in enumerate(cfg.head)}
    if cfg.num_periods:
        period = {f"block{i}": _layer_cache_decl(cfg, l, batch, seq_len,
                                                 dtype)
                  for i, l in enumerate(cfg.period)}
        decl["period"] = _stack(period, cfg.num_periods)
    if cfg.tail:
        decl["tail"] = {f"layer{i}": _layer_cache_decl(cfg, l, batch,
                                                       seq_len, dtype)
                        for i, l in enumerate(cfg.tail)}
    return decl


def _zeros(decl, device):
    return tree_map(lambda c: torch.zeros(c.shape, dtype=c.dtype,
                                          device=device), decl)


def init_cache(cfg: ModelConfig, batch: int, seq_len: int,
               dtype=torch.float32, device="cuda"):
    """The dense arena: ``batch`` rows of ``seq_len`` KV positions (and
    each row's recurrent state), zeros on ``device``."""
    return _zeros(declare_cache(cfg, batch, seq_len, dtype), device)


def _page_leaf(c: CP, num_blocks: int, block_size: int) -> CP:
    """Rewrite an attention KV leaf ``[.., batch, kv_seq(=block_size),
    ..]`` into the shared block-pool layout ``[.., kv_blocks, block,
    ..]``.  Leaves without a ``kv_seq`` axis (recurrent state) keep their
    per-row layout."""
    if "kv_seq" not in c.axes:
        return c
    shape, axes = list(c.shape), list(c.axes)
    b, s = axes.index("batch"), axes.index("kv_seq")
    shape[b], axes[b] = num_blocks, "kv_blocks"
    shape[s], axes[s] = block_size, "block"
    return CP(tuple(shape), tuple(axes), c.dtype)


def declare_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                        block_size: int, dtype=torch.float32) -> dict:
    """Cache declaration with attention KV in a shared block pool
    ``[num_blocks, block_size, kv_heads, hd]`` per layer and recurrent
    state in ``[batch, ...]`` request rows."""
    decl = declare_cache(cfg, batch, block_size, dtype)
    return tree_map(lambda c: _page_leaf(c, num_blocks, block_size), decl)


def init_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                     block_size: int, dtype=torch.float32, device="cuda"):
    return _zeros(declare_paged_cache(cfg, batch, num_blocks, block_size,
                                      dtype), device)


def cache_spec_leaf(c: CP, mesh, *, shard_seq: bool = False,
                    seq_over_model: bool = False) -> tuple:
    """One cache leaf's partition spec on ``mesh`` (the JAX package's
    rule): ``batch`` / ``kv_blocks`` over the data axes (``("pod",
    "data")`` where both exist) when divisible; ``kv_heads`` /
    ``d_inner`` / ``heads`` over ``model`` when divisible.  With
    ``shard_seq`` (a batch of 1) the ``kv_seq`` dim goes over the data
    axes instead of the batch; with ``seq_over_model`` over ``model``
    too where no KV-head dim divides the model axis (the cache would
    otherwise be replicated across it) — both when the sequence
    divides."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    data_axes = tuple(a for a in ("pod", "data") if a in sizes)
    data_total = math.prod(sizes[a] for a in data_axes) if data_axes else 1
    model = sizes.get("model", 1)
    kv_shardable = model > 1 and any(
        a in ("kv_heads", "d_inner", "heads") and s % model == 0
        for a, s in zip(c.axes, c.shape))
    spec = [None] * len(c.shape)
    for i, (a, s) in enumerate(zip(c.axes, c.shape)):
        if a in ("batch", "kv_blocks") and not shard_seq \
                and data_total > 1 and s % data_total == 0:
            spec[i] = data_axes if len(data_axes) > 1 else data_axes[0]
        elif a == "kv_seq":
            axes = list(data_axes) if shard_seq and data_total > 1 else []
            if seq_over_model and not kv_shardable and model > 1:
                axes.append("model")
            total = math.prod(sizes[x] for x in axes)
            if axes and s % total == 0:
                spec[i] = tuple(axes) if len(axes) > 1 else axes[0]
        elif a in ("kv_heads", "d_inner", "heads") and model > 1 \
                and s % model == 0:
            spec[i] = "model"
    return tuple(spec)


def paged_cache_specs(cfg: ModelConfig, batch: int, num_blocks: int,
                      block_size: int, mesh, dtype=torch.float32):
    """Partition specs of a block-paged serving cache on ``mesh``: the
    ``kv_blocks`` pool dim and per-row recurrent ``batch`` dims over the
    data axes, KV heads over ``model`` when divisible.  This describes
    the JAX package's placement, which the parity tests hold the port
    to; the serving engine does not read it.  Its pool declares each
    model shard's cache by
    :func:`repro_torch.models.sharding.shard_config`: where the model
    axis outnumbers the KV heads the spec leaves them whole on every
    device, while a shard holds only the one head its query heads read
    (:func:`repro_torch.models.sharding.kv_head_range`)."""
    decl = declare_paged_cache(cfg, batch, num_blocks, block_size, dtype)
    return tree_map(lambda c: cache_spec_leaf(c, mesh), decl)


def cache_specs(cfg: ModelConfig, batch: int, seq_len: int, mesh,
                dtype=torch.float32, shard_seq: bool = False,
                seq_over_model: bool = False):
    """Partition specs of the dense arena (:func:`declare_cache`) on
    ``mesh``, by :func:`cache_spec_leaf` (its options as it takes
    them): at the defaults the layout of the JAX package's dense serving
    pool, the request rows over the data axes.  The engine's
    ``DenseTierSlotPool`` holds each data shard's rows on its device."""
    return tree_map(lambda c: cache_spec_leaf(
        c, mesh, shard_seq=shard_seq, seq_over_model=seq_over_model),
        declare_cache(cfg, batch, seq_len, dtype))


def cache_shapes(cfg: ModelConfig, batch: int, seq_len: int, mesh=None,
                 dtype=torch.bfloat16, shard_seq: bool = False,
                 seq_over_model: bool = False):
    """Every dense cache leaf as an empty ``meta``-device tensor (no
    memory): its global shape, or with ``mesh`` the shape one device
    holds under :func:`cache_specs` (each split dim divided by the
    product of its axes' sizes)."""
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape)) if mesh else {}

    def leaf(c: CP):
        spec = (cache_spec_leaf(c, mesh, shard_seq=shard_seq,
                                seq_over_model=seq_over_model)
                if mesh is not None else (None,) * len(c.shape))
        return torch.empty(local_shape(c.shape, spec, sizes), dtype=c.dtype,
                           device="meta")
    return tree_map(leaf, declare_cache(cfg, batch, seq_len, dtype))


def has_recurrent_state(cfg: ModelConfig) -> bool:
    """True if any cache leaf is per-request recurrent state (no kv_seq
    dim): such state advances on every decode step, so it cannot be
    carried across prefill chunks or replayed after a block-exhaustion
    stall (see ``CascadeEngine``)."""
    return any("kv_seq" not in c.axes
               for c in tree_leaves(declare_cache(cfg, 1, 1)))
