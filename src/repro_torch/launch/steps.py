"""Step functions: train, prefill and serve (the torch twin of
``repro/launch/steps.py``).

``make_train_step`` is next-token LM training (L_org + MoE aux);
``make_ltc_train_step`` is the paper's Eq 4 applied to the fast member
of a cascade pair, the expensive member frozen (``repro_torch.core.
losses``).  A train step takes and returns plain parameter trees: it
differentiates a detached copy of every leaf with ``torch.autograd.grad``
and applies the optimizer's functional ``update``, as the JAX package
differentiates its pure loss.

**Sharded training.**  In the JAX package a step is sharded by the
placement of its inputs (params by ``param_specs``, the optimizer state
by :func:`opt_state_specs`, the batch by ``shard_batch``) and GSPMD
inserts the collectives.  Here the step is built with ``mesh=`` (a
:class:`repro_torch.launch.mesh.TierMesh` of ``(data, model)``
shards) and takes placed trees (:func:`place`: ``placed[d][j]`` device
``(d, j)``'s slices by the specs) and the global batch, which it splits
by ``shard_batch``.  One autograd graph spans the mesh: each data shard
runs its rows (``transformer.forward_data_shards`` in train mode, its
model shards over their heads, units, experts and vocabulary columns
through ``mesh.all_reduce`` / ``all_gather``, each MoE layer routed
once over the global batch), the loss is the mean of the shards' means,
each replica's gradient is summed over the devices holding the same
slice (``mesh.sync_grads``: the data-parallel all-reduce), and each
device steps its own slices (``opt.update_sharded``).  :func:`gather`
gives the global tree back, for checkpoints and the tests.

**Sharded prefill and serve.**  ``make_prefill_step(cfg, mesh=)`` and
``make_serve_step(cfg, mesh=)`` take placed params (and, to serve, the
dense cache placed by ``cache.cache_specs``) and the global batch: each
data shard runs ``forward_data_shards`` in ``prefill`` / dense
``decode`` mode over its rows, each MoE layer routed once over the
global batch in its ``[B, S]`` token order (``transformer.MoeLayout``),
as the JAX package's jitted step routes it; the last logits (and
``conf``) are gathered on device ``(0, 0)``.  A mesh with a ``pod`` axis
runs ``pod × data`` data shards (``mesh.TierMesh.grid``).

**The sequence-split decode.**  A decode whose batch the data axes do
not divide (``long_500k``'s batch of 1) takes its cache placed by
``cache_specs(shard_seq=True)``: the sequence split over the data axes,
and with ``seq_over_model`` over ``model`` too where no KV-head dim
divides it.  Every data shard then runs the whole batch, and each
attention layer attends each device's keys, the partials merged over
the devices that split them (``transformer.SeqSplit``,
``launch.mesh.lse_merge``), as GSPMD partitions the JAX program's
softmax over the split keys.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import losses
from repro_torch.data.pipeline import shard_batch
from repro_torch.launch.mesh import (all_gather, axis_members, axis_sizes,
                                     device_coords, map_leaves, spec_axes,
                                     spec_gather, spec_slice, sync_grads)
from repro_torch.models import cache as cache_lib
from repro_torch.models import params as params_lib
from repro_torch.models import sharding, transformer
from repro_torch.models.params import tree_leaves, tree_map, value_and_grad
from repro_torch.optim import get_optimizer


def make_optimizer(cfg: ModelConfig):
    if cfg.optimizer in ("sgd", "sgd_momentum"):
        return get_optimizer("sgd_momentum", momentum=0.9)
    if cfg.optimizer == "adamw":
        return get_optimizer("adamw", weight_decay=0.01)
    return get_optimizer("adafactor")


def _remat(cfg: ModelConfig, force_remat: bool) -> ModelConfig:
    """Activation checkpointing of the periods as the training default:
    without it every layer's attention and FFN intermediates stay live
    for backward."""
    if force_remat and cfg.num_periods and not cfg.remat:
        return dataclasses.replace(cfg, remat=True)
    return cfg


# --------------------------------------------------------------------------
# Train
# --------------------------------------------------------------------------


def lm_loss(params, cfg: ModelConfig, batch, chunked_ce: int = 0):
    labels = batch["tokens"][:, 1:]
    if chunked_ce:
        hidden, aux = transformer.forward(params, cfg, batch, mode="train",
                                          return_hidden=True)
        proj = transformer.lm_proj(params, cfg)
        loss = losses.chunked_lm_loss(
            hidden[:, :-1], proj, labels,
            chunk=min(chunked_ce, labels.shape[1]))
    else:
        logits, aux = transformer.train_logits(params, cfg, batch)
        loss = losses.cross_entropy(logits[:, :-1], labels)
    loss = loss + losses.moe_aux_loss(aux)
    return loss, {"loss": loss}


def make_train_step(cfg: ModelConfig, lr: float = 1e-3,
                    force_remat: bool = True, microbatches: int = 1,
                    chunked_ce: int = 0, mesh=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss"})`` and its optimizer.  ``microbatches`` accumulates the
    gradients of equal splits of the batch (their f32 sum over the
    count, the loss their mean); ``chunked_ce`` takes the loss over
    sequence chunks of that size (``chunked_lm_loss``).  With ``mesh``
    (the module docstring) ``params`` and ``opt_state`` are placed trees
    (:func:`place`); each microbatch's rows are split over the data
    shards after the split into microbatches, as the JAX package shards
    each microbatch."""
    cfg = _remat(cfg, force_remat)
    opt = make_optimizer(cfg)
    if mesh is not None:
        return _sharded_train_step(cfg, opt, mesh, lr, microbatches,
                                   chunked_ce), opt

    def loss_fn(p, b):
        return lm_loss(p, cfg, b, chunked_ce=chunked_ce)

    def train_step(params, opt_state, batch):
        m, grads = _accumulate(loss_fn, params, batch, microbatches,
                               lambda b: b)
        with torch.no_grad():
            params, opt_state = opt.update(params, grads, opt_state, lr)
        return params, opt_state, m

    return train_step, opt


def _accumulate(loss_fn, params, batch, microbatches: int, split):
    """(metrics, gradients) of ``loss_fn(params, split(b))`` over the
    batch (``microbatches`` 1), or its gradients accumulated over equal
    row splits of it: their f32 sum over the count, the loss their
    mean."""
    if microbatches == 1:
        (_, m), grads = value_and_grad(loss_fn, params, split(batch))
        return {k: v.detach() for k, v in m.items()}, grads
    M = microbatches
    grads = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                           device=p.device), params)
    ls = []
    for i in range(M):
        mb = {k: v.reshape(M, v.shape[0] // M, *v.shape[1:])[i]
              for k, v in batch.items()}
        (loss, _), g = value_and_grad(loss_fn, params, split(mb))
        grads = tree_map(torch.add, grads, g)
        ls.append(loss)
    return ({"loss": torch.stack(ls).mean()},
            tree_map(lambda g: g / M, grads))


def _mesh_groups(mesh) -> list:
    """Each data shard's ``ModelShards`` (None without a model axis)."""
    E, M = mesh.grid.shape
    return [None if M == 1 else sharding.ModelShards(mesh.model_devices(e))
            for e in range(E)]


def sharded_forward(placed, cfg: ModelConfig, specs, mesh, shards,
                    return_hidden: bool = False, mode: str = "train",
                    caches=None, pos=None, layout=None, split=None):
    """The forward of placed params on ``mesh`` over the data shards'
    batches ``shards`` (``shard_batch``): (each data shard's output of
    ``transformer.forward_data_shards`` in ``mode`` — in train mode
    ``(logits or hidden, aux)`` —, its weights — a tree, or one a model
    shard —, its ``ModelShards``), differentiable back to the placed
    leaves (``sharding.train_shard_params``).  ``caches``, ``pos``,
    ``layout`` and ``split`` as ``forward_data_shards`` takes them
    (None: none)."""
    groups = _mesh_groups(mesh)
    comp = sharding.train_shard_params(placed, cfg, specs, mesh)
    weights = [row[0] if g is None else row for row, g in zip(comp, groups)]
    n = len(shards)
    outs = transformer.forward_data_shards(
        weights, cfg, shards, mode=mode, caches=caches or [None] * n,
        pos=pos or [None] * n, pages=[None] * n, groups=groups,
        layout=layout, return_hidden=return_hidden, split=split)
    return outs, weights, groups


def _shard_mean(values, device):
    """The mean of the data shards' scalars, on ``device``: with equal
    rows a shard, the global batch's mean."""
    return torch.stack([v.to(device, non_blocking=True)
                        for v in values]).mean()


def _sharded_train_step(cfg, opt, mesh, lr, microbatches, chunked_ce):
    sharding.check_model_axis(cfg, sharding.model_axis_size(mesh))
    specs = params_lib.param_specs(cfg, mesh)
    sizes = axis_sizes(mesh)
    dev = mesh.grid[0, 0]

    def loss_fn(placed, shards):
        outs, weights, groups = sharded_forward(placed, cfg, specs, mesh,
                                                shards, bool(chunked_ce))
        per = []
        for (out, _), b, w, g in zip(outs, shards, weights, groups):
            labels = b["tokens"][:, 1:].to(out.device)
            if chunked_ce:
                per.append(losses.chunked_lm_loss(
                    out[:, :-1], transformer.lm_proj_shards(g, w, cfg),
                    labels, chunk=min(chunked_ce, labels.shape[1])))
            else:
                per.append(losses.cross_entropy(out[:, :-1], labels))
        loss = _shard_mean(per, dev) + losses.moe_aux_loss(outs[0][1])
        return loss, {"loss": loss}

    def train_step(placed, opt_state, batch):
        m, grads = _accumulate(loss_fn, placed, batch, microbatches,
                               lambda b: shard_batch(b, mesh))
        grads = sync_grads(grads, specs, sizes)
        with torch.no_grad():
            placed, opt_state = opt.update_sharded(placed, grads, opt_state,
                                                   lr, specs, sizes)
        return placed, opt_state, m

    return train_step


def make_ltc_train_step(fast_cfg: ModelConfig, exp_cfg: ModelConfig,
                        *, w: float = 1.0, cost_c: float = 0.5,
                        lr: float = 1e-3, mesh=None):
    """Eq 4 for LM cascades: ``train_step(fast_params, opt_state,
    exp_params, batch) -> (fast_params, opt_state, {"l_org",
    "l_casc"})``.  The frozen expensive model's forward runs on the same
    batch (its ``frontend_embeds`` too, as the JAX step passes it) under
    ``torch.no_grad()`` to supply the 1[exp wrong] indicator; its tokens
    are clamped to its vocabulary (the JAX
    package's gather clamps an index, so a token past it embeds as the
    last id), the labels are not.  The fast model's periods are
    checkpointed as :func:`make_train_step` does by default (the JAX LtC
    step keeps ``cfg.remat``): recomputation changes no value and keeps
    the published gemma3-1b's activations off the card.  With ``mesh``
    both members' params are placed trees, each by its own specs (the
    frozen one replicated over the data shards, split over the model
    axis), and the frozen forward runs on each data shard's rows."""
    fast_cfg = _remat(fast_cfg, True)
    opt = make_optimizer(fast_cfg)
    if mesh is not None:
        return _sharded_ltc_step(fast_cfg, exp_cfg, opt, mesh, w, cost_c,
                                 lr), opt

    def loss_fn(fast_params, exp_logits, batch):
        fast_logits, aux = transformer.train_logits(fast_params, fast_cfg,
                                                    batch)
        labels = batch["tokens"][:, 1:]
        loss, m = losses.ltc_loss(fast_logits[:, :-1], exp_logits, labels,
                                  w=w, cost_c=cost_c)
        return loss + losses.moe_aux_loss(aux), m

    def train_step(fast_params, opt_state, exp_params, batch):
        with torch.no_grad():
            exp_logits, _ = transformer.train_logits(
                exp_params, exp_cfg, _exp_batch(batch, exp_cfg))
            exp_logits = exp_logits[:, :-1]
        (_, m), grads = value_and_grad(loss_fn, fast_params, exp_logits,
                                       batch)
        m = {k: v.detach() for k, v in m.items()}
        with torch.no_grad():
            fast_params, opt_state = opt.update(fast_params, grads,
                                                opt_state, lr)
        return fast_params, opt_state, m

    return train_step, opt


def _exp_batch(batch, exp_cfg):
    """The frozen model's batch: tokens clamped to its vocabulary."""
    return {**batch,
            "tokens": batch["tokens"].clamp(max=exp_cfg.vocab_size - 1)}


def _sharded_ltc_step(fast_cfg, exp_cfg, opt, mesh, w, cost_c, lr):
    for c in (fast_cfg, exp_cfg):
        sharding.check_model_axis(c, sharding.model_axis_size(mesh))
    specs = params_lib.param_specs(fast_cfg, mesh)
    exp_specs = params_lib.param_specs(exp_cfg, mesh)
    sizes = axis_sizes(mesh)
    dev = mesh.grid[0, 0]

    def loss_fn(placed, exp_logits, shards):
        outs, _, _ = sharded_forward(placed, fast_cfg, specs, mesh, shards)
        per = [losses.ltc_loss(out[:, :-1], el.to(out.device),
                               b["tokens"][:, 1:].to(out.device), w=w,
                               cost_c=cost_c)
               for (out, _), el, b in zip(outs, exp_logits, shards)]
        m = {k: _shard_mean([p[1][k] for p in per], dev)
             for k in ("l_org", "l_casc")}
        loss = (_shard_mean([p[0] for p in per], dev)
                + losses.moe_aux_loss(outs[0][1]))
        return loss, m

    def train_step(placed, opt_state, exp_placed, batch):
        shards = shard_batch(batch, mesh)
        with torch.no_grad():
            exp_outs, _, _ = sharded_forward(
                exp_placed, exp_cfg, exp_specs, mesh,
                [_exp_batch(b, exp_cfg) for b in shards])
            exp_logits = [o[:, :-1] for o, _ in exp_outs]
        (_, m), grads = value_and_grad(loss_fn, placed, exp_logits, shards)
        m = {k: v.detach() for k, v in m.items()}
        grads = sync_grads(grads, specs, sizes)
        with torch.no_grad():
            placed, opt_state = opt.update_sharded(placed, grads, opt_state,
                                                   lr, specs, sizes)
        return placed, opt_state, m

    return train_step


# --------------------------------------------------------------------------
# Serve
# --------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig, mesh=None):
    """``prefill_step(params, batch) -> (last logits [B, 1, V], part
    cache)``.  With ``mesh`` (the module docstring) ``params`` is a
    placed tree, the logits are gathered on device ``(0, 0)`` and the
    part cache is a grid ``[e][j]`` of each device's part cache over its
    rows, at its model shard's KV heads and recurrent widths."""
    if mesh is None:
        def prefill_step(params, batch):
            logits, cache = transformer.forward(params, cfg, batch,
                                                mode="prefill")
            return logits[:, -1:], cache
        return prefill_step

    specs = _sharded_serving(cfg, mesh)

    def prefill_step(placed, batch):
        shards = shard_batch(batch, mesh)
        outs, _, groups = sharded_forward(
            placed, cfg, specs, mesh, shards, mode="prefill",
            layout=_batch_layout(cfg, shards))
        return (_gather_rows([lg for lg, _ in outs]),
                [c if g else [c] for (_, c), g in zip(outs, groups)])

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh=None, seq_over_model: bool = False,
                    seq_len=None):
    """One decode step over the dense arena: next-token logits, the
    cascade gate's confidence (max softmax probability — the paper's
    conf) and the cache, updated in place.  With ``mesh`` (the module
    docstring) ``params`` and ``cache`` are placed trees (by
    ``param_specs`` and ``cache.cache_specs(shard_seq=, seq_over_model=)``,
    ``shard_seq`` where the data axes do not divide the batch), ``token``
    and ``pos`` the global ``[B, 1]`` batch; the logits and ``conf`` come
    back on device ``(0, 0)``, the placed cache updated in place.

    A batch the data axes divide is split over them (``shard_batch``)
    and the logits gathered.  One they do not divide (``long_500k``'s
    batch of 1) is replicated: every data shard runs the whole batch —
    each MoE layer routed by each replica over its own row, every
    recurrent leaf advanced alike on each — and the logits are data
    shard 0's.  Where the placement splits the cache's sequence (over
    the data axes under ``shard_seq``, over ``model`` too with
    ``seq_over_model`` where no KV-head dim divides it), each attention
    layer attends each device's keys and merges the partials
    (:func:`_seq_split`, ``transformer.SeqSplit``).  ``seq_len``, the
    cache's positions, is required with ``mesh`` (a placed leaf does not
    show whether its sequence is split); a cache whose leaves do not
    have the shapes ``cache_shapes`` gives each device raises
    ValueError."""
    if mesh is None:
        def serve_step(params, token, pos, cache):
            logits, new_cache = transformer.decode_step(params, cfg, token,
                                                        cache, pos)
            return logits, _conf(logits), new_cache
        return serve_step

    if seq_len is None:
        raise ValueError("make_serve_step(mesh=) needs seq_len, the dense "
                         "cache's positions")
    specs = _sharded_serving(cfg, mesh)
    n = sharding.data_axis_size(mesh)
    m = sharding.model_axis_size(mesh)

    def serve_step(placed, token, pos, cache):
        B = token.shape[0]
        shard_seq = B % n != 0
        split = _seq_split(cfg, mesh, cache, B, seq_len, shard_seq,
                           seq_over_model)
        if shard_seq:
            shards = [{"tokens": token.to(d, non_blocking=True),
                       "pos": pos.to(d, non_blocking=True)}
                      for d in mesh.data_devices()]
        else:
            shards = shard_batch({"tokens": token, "pos": pos}, mesh)
        caches = [[c if split is not None and split.over_model
                   else _shard_cache(c, cfg, j, m) for j, c in enumerate(row)]
                  for row in cache]
        outs, _, _ = sharded_forward(
            placed, cfg, specs, mesh, shards, mode="decode",
            caches=[row if m > 1 else row[0] for row in caches],
            pos=[b["pos"] for b in shards],
            layout=None if shard_seq else _batch_layout(cfg, shards),
            split=split)
        logits = (outs[0][0] if shard_seq
                  else _gather_rows([lg for lg, _ in outs]))
        return logits, _conf(logits), cache

    return serve_step


def _seq_split(cfg: ModelConfig, mesh, cache, B: int, T: int,
               shard_seq: bool, seq_over_model: bool):
    """The ``transformer.SeqSplit`` of a placed dense cache of ``B`` rows
    and ``T`` positions (``cache[e][j]`` device ``(e, j)``'s tree) under
    ``cache_specs(shard_seq=, seq_over_model=)``, or None where that
    placement splits no ``kv_seq`` dim.  Device ``(e, j)`` holds the
    keys from ``i · T / n`` (``i`` its place among the ``n`` devices that
    split the dim, row-major over the spec's axes: the data axes, then
    ``model``, as JAX orders them); a group is the devices that differ
    only along those axes, in key order.  Every device's leaves must
    have ``cache_shapes``' shapes (ValueError: a cache placed for
    another split)."""
    want = cache_lib.cache_shapes(cfg, B, T, mesh, shard_seq=shard_seq,
                                  seq_over_model=seq_over_model)
    for e, row in enumerate(cache):
        for j, tree in enumerate(row):
            bad = []
            tree_map(lambda w, t: bad.append((tuple(t.shape), tuple(w.shape)))
                     if t.shape != w.shape else None, want, tree)
            if bad:
                raise ValueError(
                    f"{cfg.name}: device ({e}, {j})'s cache leaves (shape, "
                    f"expected) {bad} are not those of a {T}-position cache "
                    f"of {B} rows placed with shard_seq={shard_seq}, "
                    f"seq_over_model={seq_over_model}")
    kv = next((c for c in tree_leaves(cache_lib.declare_cache(cfg, B, T))
               if "kv_seq" in c.axes), None)
    if kv is None:
        return None
    axes = spec_axes(cache_lib.cache_spec_leaf(
        kv, mesh, shard_seq=shard_seq,
        seq_over_model=seq_over_model)[kv.axes.index("kv_seq")])
    if not axes:
        return None
    sizes = axis_sizes(mesh)
    L = T // math.prod(sizes[a] for a in axes)
    E, M = mesh.grid.shape
    offsets = [[0] * M for _ in range(E)]
    groups = []
    for e in range(E):
        for j in range(M):
            members = axis_members(sizes, device_coords(sizes, e, j), axes)
            offsets[e][j] = members.index((e, j)) * L
            if members not in groups:
                groups.append(members)
    return transformer.SeqSplit(offsets, groups, "model" in axes)


def _conf(logits):
    return torch.softmax(logits.float(), -1).amax(-1)


def _sharded_serving(cfg: ModelConfig, mesh):
    """The param specs of a sharded serving step, after refusing a model
    axis ``cfg``'s layers do not allow."""
    sharding.check_model_axis(cfg, sharding.model_axis_size(mesh))
    return params_lib.param_specs(cfg, mesh)


def _gather_rows(parts):
    """The data shards' ``[b, ...]`` outputs in shard order on the first
    shard's device: gathered, or the one shard's."""
    return parts[0] if len(parts) == 1 else all_gather(parts, 0)


def _batch_layout(cfg: ModelConfig, shards):
    """For a MoE model, the data shards' token slots in the global
    ``[B, S]`` batch, row-major (each shard's contiguous rows): the
    order the JAX package's jitted step routes each MoE layer in.  None
    without MoE layers."""
    if not any(layer.ffn.kind == "moe" for layer in cfg.layers):
        return None
    per = [b["tokens"].numel() for b in shards]
    starts = np.cumsum([0] + per)
    return transformer.MoeLayout(
        [np.arange(a, a + p) for a, p in zip(starts, per)], int(starts[-1]))


def _shard_cache(tree, cfg: ModelConfig, j: int, m: int):
    """Model shard ``j`` of ``m``'s view of a device's dense cache tree
    placed by ``cache_specs``: where the spec leaves the KV heads whole
    (the model axis outnumbers them) the shard's own by
    ``sharding.kv_head_range``, as its ``wk``/``wv`` columns; every
    other leaf as placed (views: the decode's in-place writes land in
    the placed tree)."""
    if m == 1 or cfg.num_kv_heads % m == 0 or "attn" not in {
            layer.mixer.kind for layer in cfg.layers}:
        return tree
    first, count = sharding.kv_head_range(cfg, j, m)
    decl = cache_lib.declare_cache(cfg, 1, 1)

    def leaf(t, c):
        if "kv_heads" in c.axes:
            return t.narrow(c.axes.index("kv_heads"), first, count)
        return t
    return tree_map(leaf, tree, decl)


# --------------------------------------------------------------------------
# Sharding trees
# --------------------------------------------------------------------------


def opt_state_specs(opt_name: str, cfg: ModelConfig, mesh):
    """Partition specs of the optimizer state, derived from
    ``param_specs`` (tuples, as ``params.logical_to_spec`` gives them):
    sgd's ``mu`` and adamw's ``m``, ``v`` mirror the params; adafactor's
    ``vr`` drops the last param dim's entry, ``vc`` the second-to-last's
    (a leaf of rank 1 keeps its ``v`` whole spec); ``step`` is
    replicated."""
    pspecs = params_lib.param_specs(cfg, mesh)
    if opt_name in ("sgd_momentum", "sgd"):
        return {"mu": pspecs, "step": ()}
    if opt_name == "adamw":
        return {"m": pspecs, "v": pspecs, "step": ()}

    def leaf(spec):
        if len(spec) >= 2:
            return {"vr": spec[:-1], "vc": spec[:-2] + spec[-1:]}
        return {"v": spec}
    return {"v": tree_map(lambda _, s: leaf(s),
                          params_lib.declare_model(cfg), pspecs),
            "step": ()}


def opt_state_shapes(opt, cfg: ModelConfig, mesh, dtype=torch.float32):
    """The optimizer state as ``meta``-device tensors (no memory) of the
    shapes one device of ``mesh`` holds under :func:`opt_state_specs`:
    ``opt.init`` of ``params.param_shapes``' per-device shapes."""
    return opt.init(params_lib.param_shapes(cfg, dtype=dtype, mesh=mesh))


def place(tree, specs, mesh) -> list:
    """``tree`` (global leaves) placed on ``mesh`` by ``specs``:
    ``placed[e][j]`` the tree of grid device ``(e, j)``'s slices
    (``mesh.spec_slice``) on its device — views where the leaf is
    already there."""
    sizes, grid = axis_sizes(mesh), mesh.grid
    return [[tree_map(lambda t, s, e=e, j=j: spec_slice(
        t, s, device_coords(sizes, e, j), sizes).to(grid[e, j],
                                                    non_blocking=True),
        tree, specs) for j in range(grid.shape[1])]
        for e in range(grid.shape[0])]


def gather(placed, specs, device=None, sizes=None):
    """The global tree of a placed one (the inverse of :func:`place`), on
    ``device`` (default: device ``(0, 0)``'s); ``sizes`` the mesh's axis
    sizes (default the grid's ``(data, model)``)."""
    whole = iter(map_leaves(
        lambda s, g: spec_gather(g, s, sizes, device), specs, placed))
    return tree_map(lambda _: next(whole), placed[0][0])
