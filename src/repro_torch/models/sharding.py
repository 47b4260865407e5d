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
engine calls the collectives itself (``launch.mesh.all_reduce`` after
each attention and FFN, ``launch.mesh.all_gather`` of the vocab-parallel
logits).  There is no compiler to constrain and no mesh context to
activate, so those four helpers have no counterpart here.  The
placement helpers of trees split by their specs (``spec_slice``,
``group_sum``, ``sync_grads``, …) live with the mesh in
:mod:`repro_torch.launch.mesh`.

The layout, as the JAX package's ``param_specs`` gives it
(:func:`repro_torch.models.params.param_specs`): attention is
head-parallel (``wq``/``wk``/``wv`` columns and ``wo`` rows by heads),
a dense FFN splits ``ffn`` (``wi``/``wi0``/``wi1`` columns, ``wo`` rows),
a MoE FFN splits its experts (or, when the model axis does not divide
them, ``ffn`` inside every expert) with the router replicated, and the
embedding and LM head split the vocabulary when the model axis divides
it.  Which KV heads a shard holds is decided once, by
:func:`kv_head_range`; which RWKV-6 heads and Mamba channels, by
:func:`inner_range`.  The recurrent mixers split ``d_inner``: RWKV-6's
``wr``/``wk``/``wv``/``wg``/``wB`` columns and ``wo`` rows by whole
heads (its per-head ``w0``, ``ln_x`` and ``bonus``, which the spec
leaves replicated, narrowed to the shard's heads), Mamba's channels
(``in_proj``'s columns of both its ``x`` and ``z`` halves, the
per-channel leaves, ``x_proj`` and ``out_proj`` rows); the RWKV-6
channel mix splits ``ffn`` in its key and value and ``d_inner`` in its
receptance gate; a frontend's ``frontend_proj`` splits its rows.
:func:`check_model_axis` refuses a model axis no layer layout allows.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import counting
from repro_torch.launch.mesh import (all_gather, axis_members, axis_sizes,
                                     device_coords, shard_leaf, spec_axes)
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


def _kinds(cfg) -> set:
    return {layer.mixer.kind for layer in cfg.layers}


def check_model_axis(cfg, m: int) -> None:
    """ValueError naming the shapes where a model axis of ``m`` has no
    layout for ``cfg``: attention's heads (:func:`kv_heads_per_shard`),
    RWKV-6 heads or Mamba channels it does not divide, or a frontend's
    ``frontend_dim`` rows it does not divide.  Raised where the spec
    leaves such a leaf whole too: a shard runs its share of every
    mixer, so a layer the axis cannot split has no place to run."""
    kinds = _kinds(cfg)
    if "attn" in kinds:
        kv_heads_per_shard(cfg, m)
    for layer in cfg.layers:
        mix = layer.mixer
        if mix.kind == "rwkv6" and (cfg.d_model // mix.head_dim) % m:
            raise ValueError(
                f"{cfg.name}: a model axis of {m} cuts the RWKV-6 heads: "
                f"{cfg.d_model // mix.head_dim} heads of {mix.head_dim} "
                f"(d_model {cfg.d_model}) do not divide into {m} shards")
        if mix.kind == "mamba" and (mix.expand * cfg.d_model) % m:
            raise ValueError(
                f"{cfg.name}: a model axis of {m} does not divide the Mamba "
                f"d_inner of {mix.expand * cfg.d_model} channels "
                f"(expand {mix.expand} x d_model {cfg.d_model})")
    if cfg.frontend and cfg.frontend_dim % m:
        raise ValueError(
            f"{cfg.name}: a model axis of {m} does not divide the "
            f"{cfg.frontend} frontend's {cfg.frontend_dim} frontend_proj "
            "rows")


def inner_range(cfg, mixer, index: int, m: int) -> tuple:
    """``(first, count)``: the ``d_inner`` channels of ``mixer`` (an
    RWKV-6 or Mamba layer's spec) that model shard ``index`` of ``m``
    holds, the ``index``-th of ``m`` equal runs: RWKV-6's whole heads
    (``count / head_dim`` of them, from head ``first / head_dim``), or
    Mamba's channels.  The one place that decides a shard's recurrent
    width: its weights (:func:`model_shard_params`, the spec's equal
    split, and the per-head and ``in_proj`` leaves narrowed here) and
    its cache (:func:`shard_config`) both follow it.  ValueError where
    the axis cuts a head or a channel run (:func:`check_model_axis`)."""
    check_model_axis(cfg, m)
    width = (cfg.d_model if mixer.kind == "rwkv6"
             else mixer.expand * cfg.d_model)
    return index * (width // m), width // m


@dataclasses.dataclass(frozen=True)
class ShardConfig(ModelConfig):
    """A :class:`ModelConfig` as one of ``model_shards`` model shards
    sees it (:func:`shard_config`): the cache declarations read the
    recurrent widths from ``model_shards``."""
    model_shards: int = 1


def shards_of(cfg) -> int:
    """The model shards ``cfg`` describes one of (1 for a whole
    model's config)."""
    return getattr(cfg, "model_shards", 1)


def shard_config(cfg, m: int):
    """``cfg`` as one of ``m`` model shards sees it: ``H / m`` query
    heads over :func:`kv_heads_per_shard` KV heads (the same head width),
    so the attention code and kernels run unchanged at the shard's head
    counts, and a serving pool declares each shard's cache from it; its
    ``model_shards`` gives the recurrent leaves their shard's width
    (:func:`inner_range`: RWKV-6 state over ``H / m`` heads, Mamba's
    conv and ssm state over ``d_inner / m`` channels).  A model without
    attention layers keeps its head counts."""
    if m == 1:
        return cfg
    check_model_axis(cfg, m)
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    if "attn" in _kinds(cfg):
        fields.update(num_heads=cfg.num_heads // m,
                      num_kv_heads=kv_heads_per_shard(cfg, m))
    fields["model_shards"] = m
    return ShardConfig(**fields)


def _inner_rule(cfg, mixer, name: str, index: int, m: int):
    """How model shard ``index`` of ``m`` takes a recurrent mixer's leaf
    ``name`` other than by its spec, as a function of the whole leaf (or
    None): RWKV-6's per-head ``w0``/``ln_x`` (``[.., d]``) and ``bonus``
    (``[.., H, hd]``), narrowed to the shard's heads; Mamba's ``in_proj``
    ``[.., d, 2·d_in]`` as the ``[.., d, 2, d_in / m]`` view of the
    shard's channels of both halves (:func:`inner_range`)."""
    if mixer.kind == "mamba" and name == "in_proj":
        lo, n = inner_range(cfg, mixer, index, m)
        return lambda t: t.unflatten(-1, (2, -1)).narrow(-1, lo, n)
    if mixer.kind == "rwkv6" and name in ("w0", "ln_x", "bonus"):
        lo, n = inner_range(cfg, mixer, index, m)
        if name == "bonus":
            hd = mixer.head_dim
            return lambda t: t.narrow(-2, lo // hd, n // hd)
        return lambda t: t.narrow(-1, lo, n)
    return None


# each section of a parameter tree, and the key prefix of its layers
_SECTIONS = {"head": "layer", "period": "block", "tail": "layer"}


def _shard_walk(tree, cfg, specs, index: int, m: int, leaf):
    """``leaf(p, spec, rule, path)`` over the leaves of ``tree`` (a tree
    of ``cfg``'s parameter structure), ``rule`` the function that takes
    model shard ``index``'s slice of the whole leaf where the shard holds
    it other than by its spec (:func:`model_shard_params`), else None;
    ``path`` the leaf's keys."""
    kv_rule = None
    if "attn" in _kinds(cfg) and cfg.num_kv_heads % m:
        first, count = kv_head_range(cfg, index, m)
        hd = cfg.head_dim
        kv_rule = lambda t: t.narrow(-1, first * hd, count * hd)  # noqa: E731

    def walk(p, decl, s, path, layer):
        if isinstance(p, dict):
            out = {}
            for k, v in p.items():
                sub = layer
                if path and path[-1] in _SECTIONS and layer is None:
                    sub = getattr(cfg, path[-1])[int(
                        k[len(_SECTIONS[path[-1]]):])]
                out[k] = walk(v, decl[k], s[k], path + (k,), sub)
            return out
        key = path[-1]
        rule = None
        if key in ("wk", "wv") and decl.axes[-1] == "fused_heads":
            rule = kv_rule
        elif len(path) > 1 and path[-2] == "mixer" and layer is not None:
            rule = _inner_rule(cfg, layer.mixer, key, index, m)
        return leaf(p, s, rule, path)
    return walk(tree, declare_model(cfg), specs, (), None)


def model_shard_params(params, cfg, specs, index: int, m: int):
    """Model shard ``index``'s weights, as views of ``params`` (a whole
    parameter tree of ``cfg``; ``meta`` tensors give the shard's shapes):
    every leaf sliced by its spec (:func:`shard_leaf`; ``specs`` from
    :func:`repro_torch.models.params.param_specs`), except

    * the KV projections of attention (``wk``/``wv``, whose columns are
      ``fused_heads`` in the declaration) where ``m`` outnumbers the KV
      heads: the spec would cut a head's width, and the shard holds the
      head its query heads read whole (:func:`kv_head_range`; where
      ``m`` divides the KV heads the spec's equal split is that rule);
    * RWKV-6's per-head ``w0``, ``ln_x`` and ``bonus``, which the spec
      replicates, narrowed to the shard's heads, as its
      ``wr``/``wk``/``wv``/``wg``/``wB`` columns are split; and Mamba's
      ``in_proj``, whose two halves ``x | z`` each hold every channel,
      as the shard's channels of both (the spec's equal split of its
      last dim would give shard 0 all of ``x``): :func:`_inner_rule`.

    The RWKV-6 channel mix needs no exception: the spec splits its key
    ``wk`` columns and value ``wv`` rows on ``ffn`` and its receptance
    ``wr`` columns on ``d_inner``."""
    return _shard_walk(params, cfg, specs, index, m,
                       lambda p, s, rule, path: rule(p) if rule
                       else shard_leaf(p, s, index, m))


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
        """``t`` on every shard's device (itself where it already is): a
        ``collective-permute`` from shard 0 to the counts."""
        out = [t.to(d, non_blocking=True) for d in self.devices]
        counting.collective("collective-permute", out)
        return out


# --------------------------------------------------------------------------
# Training over a mesh: trees placed by their specs (``launch.mesh``)
# --------------------------------------------------------------------------


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def train_shard_params(placed, cfg, specs, mesh):
    """Each device's weights for a sharded step's forward (train,
    prefill or serve: ``launch.steps``), ``[e][j]`` over ``mesh``'s
    grid, from a placed tree (``placed[e][j]``, by ``specs``),
    differentiable back to the placed leaves:

    * a leaf the spec splits over a data axis (the fsdp rule) is
      gathered whole along that dim on each device from the slices of
      the devices that split it (the JAX package's all-gather before
      use); its gradient comes back to each slice summed over the
      devices that read it;
    * a leaf model shard ``j`` holds other than by its spec
      (:func:`model_shard_params`: a KV head the model axis outnumbers,
      RWKV-6's per-head leaves, Mamba's ``in_proj``) is gathered whole
      over the model axis where the spec splits it, then sliced by its
      rule;
    * every other leaf is the device's placed slice, which is its model
      shard's slice by :func:`model_shard_params` already."""
    sizes, grid = axis_sizes(mesh), mesh.grid
    E, M = grid.shape

    def fsdp(path, spec, e, j):
        t = _get(placed[e][j], path)
        dims = [d for d, entry in enumerate(spec)
                if entry not in (None, "model")]
        if not dims:
            return t
        axes = spec_axes(spec[dims[0]])
        return all_gather(
            [_get(placed[a][b], path).to(grid[e, j], non_blocking=True)
             for a, b in axis_members(sizes, device_coords(sizes, e, j),
                                      axes)], dims[0])

    out = []
    for e in range(E):
        row = []
        for j in range(M):
            def leaf(p, s, rule, path, e=e, j=j):
                t = fsdp(path, s, e, j)
                if rule is None or M == 1:
                    return t
                if "model" in s:
                    t = all_gather([fsdp(path, s, e, k).to(
                        grid[e, j], non_blocking=True) for k in range(M)],
                        list(s).index("model"))
                return rule(t)
            row.append(_shard_walk(placed[e][j], cfg, specs, j, M, leaf))
        out.append(row)
    return out
