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
from repro_torch.models.params import declare_model, tree_map


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


# --------------------------------------------------------------------------
# Training over a mesh: trees placed by their specs
# --------------------------------------------------------------------------
#
# A placed tree is a grid ``placed[d][j]`` of trees, one a device of a
# ``(data, model)`` mesh: each leaf the device's slice of the global leaf
# by its spec (``"data"`` dims split by ``d``, ``"model"`` dims by ``j``,
# whole along the rest), as a JAX ``NamedSharding`` gives each device its
# addressable shard.  A leaf the spec replicates is held by every device
# it is replicated over.


AXIS_INDEX = {"data": 0, "model": 1}


def _subtrees(tree, like) -> list:
    """The subtrees of ``tree`` at the leaves of ``like`` (the same
    structure down to them), in ``tree_leaves`` order."""
    out = []
    tree_map(lambda _, t: out.append(t), like, tree)
    return out


def leaf_specs(tree, specs) -> list:
    """The spec of each leaf of ``tree``, in ``tree_leaves`` order
    (``specs`` a tree of tuples of the same structure)."""
    return [tuple(s) for s in _subtrees(specs, tree)]


def map_leaves(fn, specs, *grids) -> list:
    """``fn(spec, *parts)`` for each leaf of placed trees: ``parts`` the
    ``[d][j]`` grid of that leaf in each of ``grids`` (the first's trees
    give the leaves; a later grid may hold a subtree at each, as an
    optimizer's state does).  Returns the results in :func:`tree_leaves`
    order."""
    like = grids[0][0][0]
    flat = [[[_subtrees(t, like) for t in row] for row in g] for g in grids]
    return [fn(s, *([[ls[i] for ls in row] for row in f] for f in flat))
            for i, s in enumerate(leaf_specs(like, specs))]


def grid_of(like, per_leaf) -> list:
    """Placed trees of ``like``'s structure from ``per_leaf``, each
    leaf's ``[d][j]`` grid in ``tree_leaves`` order (as
    :func:`map_leaves` returns them)."""
    out = []
    for d, row in enumerate(like):
        out.append([])
        for j, t in enumerate(row):
            it = iter(g[d][j] for g in per_leaf)
            out[-1].append(tree_map(lambda _: next(it), t))
    return out


def spec_slice(t, spec: Sequence, d: int, j: int, mesh_shape):
    """Device ``(d, j)``'s slice (a view) of the global leaf ``t`` by
    ``spec`` on a mesh of ``mesh_shape = (D, M)``: the ``"data"`` dim
    narrowed to data shard ``d``'s, then :func:`shard_leaf`'s."""
    for dim, axis in enumerate(spec):
        if axis == "data":
            n = t.shape[dim] // mesh_shape[0]
            t = t.narrow(dim, d * n, n)
    return shard_leaf(t, spec, j, mesh_shape[1])


def spec_gather(parts, spec: Sequence, device=None):
    """The global leaf from its slices ``parts[d][j]`` (the inverse of
    :func:`spec_slice`), on ``device`` (default: device ``(0, 0)``'s)."""
    device = parts[0][0].device if device is None else device
    rows = [torch.cat([p.to(device, non_blocking=True) for p in row],
                      list(spec).index("model")) if "model" in spec
            else row[0].to(device, non_blocking=True) for row in parts]
    return (torch.cat(rows, list(spec).index("data")) if "data" in spec
            else rows[0])


def group_sum(parts, axes) -> list:
    """``parts[d][j]`` (one tensor a device) summed over the devices that
    differ only along the mesh ``axes`` (``"data"``, ``"model"``): each
    device gets its group's sum (:func:`all_reduce`, in row-major device
    order, so every member holds the same bits).  No axis: ``parts``."""
    axes = set(axes) & set(AXIS_INDEX)
    if not axes:
        return parts
    D, M = len(parts), len(parts[0])
    out = [[None] * M for _ in range(D)]
    ds = range(D) if "data" in axes else None
    ms = range(M) if "model" in axes else None
    for d0 in ([0] if ds else range(D)):
        for j0 in ([0] if ms else range(M)):
            members = [(d, j) for d in (ds or [d0]) for j in (ms or [j0])]
            for (d, j), t in zip(members, all_reduce(
                    [parts[d][j] for d, j in members])):
                out[d][j] = t
    return out


def sync_grads(grads, specs) -> list:
    """Data-parallel (and replicated-leaf) gradient sums: each leaf's
    gradient summed over the devices that hold the same slice of it —
    the mesh axes its spec does not split — so that every replica takes
    the whole gradient and steps alike.  ``grads`` and the result are
    placed trees."""
    return grid_of(grads, map_leaves(
        lambda s, g: group_sum(g, set(AXIS_INDEX) - set(s)), specs, grads))


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def train_shard_params(placed, cfg, specs, devices):
    """Each device's weights for the train forward, ``[d][j]``, from a
    placed tree (``placed[d][j]``, by ``specs``; ``devices`` the mesh's
    ``[D, M]`` device array), differentiable back to the placed leaves:

    * a leaf the spec splits over ``data`` (the fsdp rule) is gathered
      whole along that dim on each device from its data shards' slices
      (the JAX package's all-gather before use); its gradient comes back
      to each slice summed over the data shards that read it;
    * a leaf model shard ``j`` holds other than by its spec
      (:func:`model_shard_params`: a KV head the model axis outnumbers,
      RWKV-6's per-head leaves, Mamba's ``in_proj``) is gathered whole
      over the model axis where the spec splits it, then sliced by its
      rule;
    * every other leaf is the device's placed slice, which is its model
      shard's slice by :func:`model_shard_params` already."""
    D, M = len(placed), len(placed[0])

    def fsdp(path, spec, d, j):
        t = _get(placed[d][j], path)
        if "data" not in spec:
            return t
        dev = devices[d][j]
        return torch.cat([_get(placed[e][j], path).to(dev, non_blocking=True)
                          for e in range(D)], list(spec).index("data"))

    out = []
    for d in range(D):
        row = []
        for j in range(M):
            def leaf(p, s, rule, path, d=d, j=j):
                t = fsdp(path, s, d, j)
                if rule is None or M == 1:
                    return t
                if "model" in s:
                    t = torch.cat([fsdp(path, s, d, k).to(
                        devices[d][j], non_blocking=True) for k in range(M)],
                        list(s).index("model"))
                return rule(t)
            row.append(_shard_walk(placed[d][j], cfg, specs, j, M, leaf))
        out.append(row)
    return out
