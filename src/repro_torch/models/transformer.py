"""Model stack: embeddings -> head layers -> periods -> tail -> LM head
(the torch twin of ``repro/models/transformer.py``).

The repeated ``period`` runs as a Python loop over weights (and cache)
stacked on a leading ``num_periods`` dim; indexing the stack gives
views, so the in-place cache writes of each period land in the stacked
leaves.  The serving executors call :func:`ragged_step` (ragged),
:func:`mixed_step` (padded), :func:`ragged_verify` (ragged under
speculation, with :func:`decode_step` for the draft loop),
:func:`prefill_chunk` then :func:`decode_step` (split), or
:func:`prefill` then :func:`decode_step` (the uniform one-shot prefill
path, over a block-paged or dense cache).  Training calls
:func:`forward` in ``"train"`` mode (or :func:`train_logits`): every
position's logits, or the final-norm hidden states, with the MoE layers'
aux losses and, for a config with ``early_exit_periods``, each exit
head's logits; ``cfg.remat`` recomputes each period's layers in backward
(``torch.utils.checkpoint``), as the JAX package checkpoints its period
scan body; the forward draws no random numbers, so no generator state is
kept for the recompute (nor read from the device, which a dry-run's
``meta`` trace could not).

**Tensor parallelism** (a tier mesh's ``model`` axis): the serving steps
take ``group=`` (a :class:`repro_torch.models.sharding.ModelShards`),
``params`` as one tree of slices per model shard
(:func:`repro_torch.models.sharding.model_shard_params`) and ``cache`` as
one tree per model shard (the shard's KV heads).  The function is the
unsharded one, as the JAX package's GSPMD placement computes it, with
the collectives written out (:func:`forward_data_shards`): the embedding
looks up each shard's vocabulary range and all-reduces; every layer runs
its attention and FFN once per model shard, on the shard's device, over
its heads, hidden units or experts, and all-reduces the partial outputs,
so the residual stream (and every norm) is replicated on each model
device; the LM head computes each shard's vocabulary columns and gathers
them in vocabulary order on shard 0's device, where the caller's
confidence gate runs once.  Every serving mode: the chunked steps, the
uniform prefill (one part cache a model shard), paged and dense decode.
An RWKV-6 layer runs each shard's heads (its ``wr``/``wk``/``wv``/``wg``
columns, its ``w0``, ``bonus`` and ``ln_x``, its state rows) and a Mamba
layer each shard's channels (``in_proj``'s columns of both halves, the
conv and scan), its ``x_proj`` product all-reduced before ``dt``, ``B``
and ``C`` are sliced; the RWKV-6 channel mix all-reduces its value
product and multiplies it by each shard's gate columns, gathered; a
frontend's projection all-reduces each shard's rows.

**Data shards with MoE layers**: a data-sharded tier runs each shard's
step on its own rows, which changes nothing for attention, dense FFNs
and the recurrent layers, whose tokens do not meet; a MoE layer ranks
every token of the launch for expert capacity.  The JAX package routes
a data-sharded tier's launch over its whole batch, so
:func:`forward_data_shards` advances the shards layer by layer and
routes each MoE layer once over all of them
(:func:`route_data_shards`, in the JAX batch's slot order,
:class:`MoeLayout`); every other layer runs on each shard alone.

**A sequence-split dense decode** (``forward_data_shards(split=)``, a
:class:`SeqSplit`): the cache's keys are split over devices, so each
attention layer runs on every device at once (:func:`_split_attention`:
each attends its own keys, the partials merged over the devices that
split them); the other layers run on each data shard alone, each data
shard holding the whole batch.

**Training over a mesh** (``launch.steps`` built with ``mesh=``):
:func:`forward_data_shards` in ``"train"`` mode runs a step's data
shards and their model shards as one differentiable graph — the
collectives are ``.to`` copies, adds and concatenations, which autograd
carries back — each MoE layer routed once over the global batch
(:func:`moe_train_shards`), each period checkpointed across every shard
under ``cfg.remat``, the exit heads' columns gathered like the LM
head's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import counting
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.mesh import all_gather, all_reduce, lse_merge
from repro_torch.models import blocks
from repro_torch.models import sharding
from repro_torch.models.params import tree_map


def _add_aux(a, b):
    return {k: a[k] + b[k] for k in a}


def _apply_layers(params, cfg, layers, key, x, cache, pos, mode,
                  pages=None, aux=None):
    """Apply ``layers`` in order, layer ``i``'s weights (and cache) at
    ``f"{key}{i}"``.  Returns (x, each layer's new or in-place-updated
    cache slot, aux): in train mode (``aux`` given) the slots are left
    out and each layer's MoE losses are added to ``aux`` in order, as
    the JAX package's ``_add_aux`` carries them."""
    new = {}
    for i, layer in enumerate(layers):
        k = f"{key}{i}"
        x, slot = blocks.apply_layer(
            params[k], cfg, layer, x, None if cache is None else cache[k],
            pos, mode, pages=pages)
        if aux is None:
            new[k] = slot
        else:
            aux = _add_aux(aux, slot)
    return x, new, aux


def _apply_periods(params, cfg: ModelConfig, x, cache, pos, mode,
                   pages=None, aux=None, exits=None):
    """Loop over the stacked period weights (+cache).  ``pages`` is the
    same for every layer.  Prefill starts from no cache and returns each
    period's new part cache stacked on the leading ``num_periods`` dim
    (the JAX package's tree); train mode returns no cache and, with
    ``cfg.remat``, recomputes each period in backward; the other modes
    update ``cache`` in place and return it.  An ``exits`` dict receives
    the hidden state after each period ``i`` in ``cfg.early_exit_periods``
    at ``i`` (the JAX package's ``ys["hidden"][i]``)."""
    new = []
    for i in range(cfg.num_periods):
        args = (tree_map(lambda a: a[i], params["period"]), cfg, cfg.period,
                "block", x,
                None if cache is None else tree_map(lambda a: a[i], cache),
                pos, mode, pages, aux)
        if mode == "train" and cfg.remat:
            x, out_i, aux = checkpoint(_apply_layers, *args,
                                       use_reentrant=False,
                                       preserve_rng_state=False)
        else:
            x, out_i, aux = _apply_layers(*args)
        if mode == "prefill":
            new.append(out_i)
        if exits is not None and i in cfg.early_exit_periods:
            exits[i] = x
    if mode == "prefill":
        return x, _stack(new), aux
    return x, cache, aux


def _stack(periods):
    """Each period's prefill part cache stacked on a leading
    ``num_periods`` dim (the JAX package's tree)."""
    return tree_map(lambda *leaves: torch.stack(leaves), *periods)


def _positions(batch, x, pos, mode):
    """``pos``, or ``arange(S)`` per row where train and prefill leave it
    out."""
    if pos is not None:
        return pos
    if mode not in ("train", "prefill"):
        raise ValueError(f"{mode} requires pos")
    B, S = batch["tokens"].shape
    return torch.arange(S, dtype=torch.int32,
                        device=x.device)[None].expand(B, S)


def _logits(params, cfg: ModelConfig, x):
    x = blocks.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return x @ lm_proj(params, cfg)


def _out_logits(params, cfg: ModelConfig, x, mode):
    """A serving forward's logits: the last position's only in prefill
    (:func:`forward`)."""
    return _logits(params, cfg, x[:, -1:] if mode == "prefill" else x)


def _exit_logits(p, cfg: ModelConfig, h):
    """An early-exit head: its own norm, then its ``[D, V]`` projection."""
    h = blocks.rmsnorm(h, p["norm"], cfg.norm_eps)
    return h @ p["proj"]


_CHUNKED = ("prefill_chunk", "mixed_step", "ragged_step")


def _frontend_positions(cfg: ModelConfig, x, mode) -> bool:
    """Whether ``x``'s first ``frontend_len`` positions take a modality
    frontend's projected embeddings: a frontend model outside decode.
    The chunked modes do not inject them and raise, as in the JAX
    package, as does a prompt shorter than the frontend's positions."""
    if not cfg.frontend or mode == "decode":
        return False
    if mode in _CHUNKED:
        raise NotImplementedError(
            "chunked/unified token-batch steps do not inject modality "
            "frontend embeddings; frontend models require the dense "
            "uniform prefill path")
    if x.shape[1] < cfg.frontend_len:
        raise ValueError(
            f"{cfg.name}: a prompt of {x.shape[1]} tokens is shorter than "
            f"the frontend's {cfg.frontend_len} positions")
    return True


def _embed(params, cfg: ModelConfig, batch, mode):
    """The token embeddings of ``batch["tokens"]`` [B, S]; for a model
    with a modality frontend, outside decode, the first ``frontend_len``
    positions take ``batch["frontend_embeds"] [B, frontend_len,
    frontend_dim]`` projected through ``frontend_proj`` instead (the
    sanctioned stub: precomputed patch or frame embeddings).  The chunked
    modes do not inject them and raise, as in the JAX package."""
    x = params["embed"][batch["tokens"].long()]
    if not _frontend_positions(cfg, x, mode):
        return x
    emb = batch["frontend_embeds"] @ params["frontend_proj"]
    return torch.cat([emb.to(x.dtype), x[:, cfg.frontend_len:]], dim=1)


def zero_frontend(cfg: ModelConfig, rows: int, device) -> dict:
    """``{"frontend_embeds": zeros [rows, frontend_len, frontend_dim]}``
    for a model with a modality frontend, else ``{}``: what the engine's
    uniform prefill and the launchers feed in place of precomputed
    embeddings, as the JAX package does."""
    if not cfg.frontend:
        return {}
    return {"frontend_embeds": torch.zeros(
        (rows, cfg.frontend_len, cfg.frontend_dim), dtype=torch.float32,
        device=device)}


def lm_proj(params, cfg: ModelConfig):
    """The output projection matrix [D, V] (tied or separate)."""
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def _sections(cfg: ModelConfig):
    """(section, period index or None, layers, key prefix) in order: the
    head layers, each period, the tail layers."""
    if cfg.head:
        yield "head", None, cfg.head, "layer"
    for i in range(cfg.num_periods):
        yield "period", i, cfg.period, "block"
    if cfg.tail:
        yield "tail", None, cfg.tail, "layer"


def _section(tree, section: str, i):
    """A section's subtree; a period's is its stacked leaves indexed."""
    if i is None:
        return tree[section]
    return tree_map(lambda a: a[i], tree[section])


def _ffn_split(p, spec) -> bool:
    """Whether a model shard's FFN slice ``p`` holds part of the layer
    (hidden units or experts) rather than all of it (a layer the model
    axis divides nowhere stays whole, and runs once)."""
    if spec.kind == "moe":
        return p["wo"].shape[0] < spec.num_experts \
            or p["wo"].shape[1] < spec.d_ff
    if spec.act == "rwkv_cmix":
        return p["wv"].shape[0] < spec.d_ff
    return p["wo"].shape[0] < spec.d_ff


def _mixer_shards(group, ps, shard_cfg, layer, xs, caches, pos, mode,
                  pages):
    """The mixer half of :func:`repro_torch.models.blocks.apply_layer`
    over the model shards: each shard's mixer over its attention heads
    (its KV written into its own cache), RWKV-6 heads or Mamba channels
    (its recurrent state in its own cache), all-reduced into the
    residual.  A Mamba layer all-reduces its ``x_proj`` product too,
    between :func:`~repro_torch.models.blocks.mamba_in` and
    :func:`~repro_torch.models.blocks.mamba_out`.  ``xs``, ``pos``,
    ``pages`` and ``caches`` (None in prefill) hold one entry a model
    shard, on its device.  Returns (the residual, its FFN input, the
    mixers' new or in-place-updated caches) a model shard."""
    m, spec = group.size, layer.mixer
    hs = [blocks.rmsnorm(x, p["norm1"], shard_cfg.norm_eps)
          for x, p in zip(xs, ps)]
    cs = [None] * m if caches is None else [c["mixer"] for c in caches]
    if spec.kind == "mamba":
        firsts = [blocks.mamba_in(p["mixer"], shard_cfg, spec, h, c, mode)
                  for p, h, c in zip(ps, hs, cs)]
        projs = all_reduce([f[2] for f in firsts])
        outs = [blocks.mamba_out(p["mixer"], shard_cfg, spec, f, pr, c, mode)
                for p, f, pr, c in zip(ps, firsts, projs, cs)]
    else:
        mixer = blocks.MIXERS[spec.kind]
        outs = [mixer(p["mixer"], shard_cfg, spec, h, c, pos[j], mode,
                      pages=pages[j])
                for j, (p, h, c) in enumerate(zip(ps, hs, cs))]
    xs = [x + y for x, y in zip(xs, all_reduce([y for y, _ in outs]))]
    return xs, [blocks.rmsnorm(x, p["norm2"], shard_cfg.norm_eps)
                for x, p in zip(xs, ps)], [c for _, c in outs]


def _ffn_shards(group, ps, cfg, spec, hs, routes=None, caches=None,
                mode=None):
    """The FFN half over the model shards: each shard's partial, all-
    reduced (a layer the model axis does not divide runs once, on shard
    0, and is copied).  ``routes`` (a MoE layer on a data-sharded tier)
    hands each model shard its share of the tier's route.  The RWKV-6
    channel mix all-reduces its value product and multiplies it by the
    gate's columns each shard holds, gathered
    (:func:`_cmix_shards`).  Returns (the FFN's output, its new or
    in-place-updated cache) a model shard."""
    if spec.act == "rwkv_cmix":
        return _cmix_shards(group, ps, cfg, spec, hs, caches, mode)

    def ffn(p, h, j):
        if spec.kind == "moe":
            return blocks.moe_ffn(p, cfg, spec, h, shard=j,
                                  route=None if routes is None
                                  else routes[j])
        return blocks.dense_ffn(p, cfg, spec, h)
    stateless = [{}] * group.size
    if _ffn_split(ps[0]["ffn"], spec):
        return all_reduce([ffn(p["ffn"], h, j) for j, (p, h)
                                    in enumerate(zip(ps, hs))]), stateless
    return group.replicate(ffn(ps[0]["ffn"], hs[0], 0)), stateless


def _cmix_shards(group, ps, cfg, spec, hs, caches, mode):
    """The RWKV-6 channel mix over the model shards: each shard's
    ``relu(xk @ wk)² @ wv`` over its ``ffn`` units, all-reduced (once on
    shard 0 where the axis does not divide ``ffn``), then each shard's
    gate columns ``sigmoid(xr @ wr)`` times its columns of the sum,
    gathered in column order and copied to every shard.  Each shard
    writes its own copy of the ``x_prev`` token shift."""
    cs = ([None] * group.size if caches is None
          else [c["ffn"] for c in caches])
    gates, kvs, new = zip(*[blocks.rwkv_cmix_parts(
        p["ffn"], cfg, spec, h, c, mode) for p, h, c in zip(ps, hs, cs)])
    kv = (all_reduce(kvs) if _ffn_split(ps[0]["ffn"], spec)
          else group.replicate(kvs[0]))
    cols, o = [], 0
    for g, k in zip(gates, kv):
        cols.append(g * k[..., o:o + g.shape[-1]])
        o += g.shape[-1]
    return group.replicate(all_gather(cols, -1)), list(new)


def _embed_shards(group, params, cfg: ModelConfig, tokens, mode=None,
                  frontend_embeds=None):
    """The token embeddings on every model device: each shard looks up
    the ids of its vocabulary range (zeros for the rest) and the parts
    are all-reduced; a vocabulary the model axis does not divide is
    looked up once, on shard 0's device, and copied.  A model with a
    modality frontend, given the serving ``mode`` (outside decode;
    :func:`_embed`), takes the projected ``frontend_embeds`` over its
    first ``frontend_len`` positions: each shard projects its slice of
    the embeddings' last dim through its ``frontend_proj`` rows, and the
    partials are all-reduced."""
    held = params[0]["embed"].shape[0]
    if held == cfg.vocab_size:
        xs = group.replicate(params[0]["embed"][
            tokens.to(group.devices[0]).long()])
    else:
        parts = []
        for j, (p, dev) in enumerate(zip(params, group.devices)):
            ids = tokens.to(dev, non_blocking=True).long() - j * held
            hit = ((ids >= 0) & (ids < held))[..., None]
            e = p["embed"][ids.clamp(0, held - 1)]
            parts.append(torch.where(hit, e, torch.zeros_like(e)))
        xs = all_reduce(parts)
    if mode is None or not _frontend_positions(cfg, xs[0], mode):
        return xs
    # check_model_axis holds frontend_dim divisible: each shard has rows
    rows = params[0]["frontend_proj"].shape[0]
    emb = all_reduce([
        frontend_embeds.to(d, non_blocking=True)[..., j * rows:(j + 1) * rows]
        @ p["frontend_proj"]
        for j, (p, d) in enumerate(zip(params, group.devices))])
    fl = cfg.frontend_len
    return [torch.cat([e.to(x.dtype), x[:, fl:]], dim=1)
            for e, x in zip(emb, xs)]


def _logits_shards(group, params, cfg: ModelConfig, xs, exit_head=None):
    """Every position's logits on shard 0's device: each shard's
    vocabulary columns from its replica of the residual stream, gathered
    in vocabulary order; an LM head the model axis does not split runs
    once, on shard 0.  ``exit_head``: early-exit head ``i``'s logits
    (:func:`_exit_logits`) instead."""
    def head(p, x):
        if exit_head is None:
            return _logits(p, cfg, x)
        return _exit_logits(p["exit_heads"][f"exit{exit_head}"], cfg, x)
    proj = (lm_proj(params[0], cfg) if exit_head is None
            else params[0]["exit_heads"][f"exit{exit_head}"]["proj"])
    if proj.shape[1] == cfg.vocab_size:
        return head(params[0], xs[0])
    return all_gather([head(p, x) for p, x in zip(params, xs)], -1)


class MoeLayout:
    """Where each data shard's token slots sit in the batch the JAX
    package routes a MoE layer over: that batch has ``total`` token
    slots (its groups, ``gs`` and ``cap`` follow from it), and
    ``slots[s][i]`` is the place of data shard ``s``'s local token slot
    ``i`` (its ``[B, S]`` batch flattened), or ``total`` for a slot the
    JAX batch does not hold (a shard's own flat padding, a uniform
    prefill's zero rows).  Every slot of the JAX batch that no shard
    holds ranks after every held one, so its router logits are taken as
    zeros."""

    def __init__(self, slots, total: int):
        self.slots = [np.asarray(s, np.int64) for s in slots]
        self.total = int(total)
        self._on = {}
        self._groups = {}

    def on(self, device) -> list:
        """``slots`` as tensors on ``device`` (copied once)."""
        if device not in self._on:
            self._on[device] = [torch.from_numpy(s).to(device)
                                for s in self.slots]
        return self._on[device]

    def groups(self, gs: int) -> list:
        """Each shard's (first group, number of groups) of the routing
        groups of ``gs`` slots that its held slots fall in ((0, 0) for a
        shard holding none)."""
        if gs not in self._groups:
            out = []
            for s in self.slots:
                held = s[s < self.total]
                g0 = int(held.min()) // gs if held.size else 0
                out.append((g0, int(held.max()) // gs - g0 + 1
                            if held.size else 0))
            self._groups[gs] = out
        return self._groups[gs]


def route_data_shards(spec, logits, layout: MoeLayout):
    """One ``moe_route`` launch over a data-sharded tier's whole batch,
    as the JAX package routes it: each shard's router logits ``[N_s,
    E]`` (on its device) are gathered into the JAX batch's ``[total,
    E]`` on shard 0's device, grouped (``gs = min(1024, total)``), and
    routed there.  Each shard gets back its slots' ``(dest, w, rows)`` on
    its own device, for :func:`repro_torch.models.blocks.moe_ffn`: its
    own capacity buffer holds ``rows = n·cap`` rows an expert, the ``n``
    groups its slots fall in, so a kept pair of group ``g`` in expert
    ``e``'s queue at rank ``r`` goes to row ``e·rows + (g − g0)·cap + r``
    (``g0`` the shard's first group); a dropped pair, or a slot the JAX
    batch does not hold, goes to the spare row ``E·rows`` with weight
    0."""
    total = layout.total
    gs = min(blocks.MOE_GROUP_SIZE, total)
    if total % gs:
        raise ValueError(f"{total} token slots do not split into MoE "
                         f"groups of {gs}")
    cap = blocks.moe_capacity(spec, gs)
    rows = total // gs * cap
    dev = logits[0].device
    slots = layout.on(dev)
    full = torch.zeros(total + 1, logits[0].shape[-1], dtype=torch.float32,
                       device=dev)
    for lg, sl in zip(logits, slots):
        full.index_copy_(0, sl, lg.to(dev, non_blocking=True))
    counting.collective("all-gather", [full[:total]])
    _, _, dest, w = kernel_ops.moe_route(
        full[:total].view(total // gs, gs, -1), spec.top_k, cap)
    k, E = spec.top_k, spec.num_experts
    dest = torch.cat([dest.reshape(total, k),
                      dest.new_full((1, k), E * rows)])
    w = torch.cat([w.reshape(total, k), w.new_zeros(1, k)])
    out = []
    for lg, sl, (g0, n) in zip(logits, slots, layout.groups(gs)):
        d, own = _local_dest(dest[sl], g0, n, cap, rows, E)
        out.append((d.to(lg.device, non_blocking=True),
                    w[sl].to(lg.device, non_blocking=True), own))
    counting.collective("all-to-all", [o[:2] for o in out])
    return out


def _local_dest(dest, g0: int, n: int, cap: int, rows: int, E: int):
    """A data shard's picks of a route over the whole batch, into its own
    capacity buffer of the ``n`` groups from ``g0`` its slots fall in:
    ``(dest, own)``, ``own = n·cap`` rows an expert.  A kept pair's row
    ``e·rows + g·cap + r`` becomes ``e·own + (g − g0)·cap + r``; a
    dropped pair (``E·rows``) the spare row ``E·own``."""
    own = n * cap
    e = dest // rows
    return torch.where(dest < E * rows, e * own + dest - e * rows - g0 * cap,
                       E * own), own


def moe_train_shards(groups, ws, cfg: ModelConfig, spec, hs):
    """A MoE layer's FFN in a sharded train forward (the JAX package's
    ``moe_ffn`` over the global batch): each data shard's router logits
    (from its model shard 0's replica of the layer input, ``hs[s][j]``)
    gathered in the global row-major token order on data shard 0's
    device, grouped (``gs = min(1024, B·S)``, so a group may span data
    shards) and routed there in one ``moe_route`` launch
    (:func:`repro_torch.models.blocks.moe_train_route`, whose aux losses
    are the global batch's); each data shard takes its slots' picks into
    the buffer of the groups they fall in (:func:`_local_dest`) and its
    model shards run their experts (or their slice of every expert's
    units) on them, all-reduced.  The gates' gradient flows back through
    the gather to each shard's router.  ``ws[s][j]`` is device ``(s,
    j)``'s layer weights; ``groups[s]`` None for a shard without a model
    axis.  Returns (each data shard's output a model shard, aux)."""
    n, E, k = len(hs), spec.num_experts, spec.top_k
    full = all_gather([blocks.moe_logits(
        ws[s][0]["ffn"], hs[s][0].reshape(-1, cfg.d_model))
        for s in range(n)], 0)                                # [N, E]
    N = full.shape[0]
    gs = min(blocks.MOE_GROUP_SIZE, N)
    if N % gs or N % n:
        raise ValueError(f"{N} token slots over {n} data shards do not "
                         f"split into MoE groups of {gs}")
    dest, w, rows, aux = blocks.moe_train_route(spec,
                                                full.view(N // gs, gs, -1))
    cap, per = rows // (N // gs), N // n
    dest, w = dest.reshape(N, k), w.reshape(N, k)
    ys = []
    for s in range(n):
        g0 = s * per // gs
        d, own = _local_dest(dest[s * per:(s + 1) * per], g0,
                             ((s + 1) * per - 1) // gs - g0 + 1, cap, rows,
                             E)
        ws_s, w_s = ws[s], w[s * per:(s + 1) * per]
        devs = [h.device for h in hs[s]]

        picks = [(d.to(dv, non_blocking=True), w_s.to(dv, non_blocking=True))
                 for dv in devs]
        counting.collective("all-to-all", picks)

        def ffn(j):
            return blocks.moe_ffn(
                ws_s[j]["ffn"], cfg, spec, hs[s][j], shard=j, train=True,
                route=picks[j] + (own,))
        if groups[s] is None:
            ys.append([ffn(0)])
        elif _ffn_split(ws_s[0]["ffn"], spec):
            ys.append(all_reduce([ffn(j) for j in range(len(devs))]))
        else:
            ys.append(groups[s].replicate(ffn(0)))
    return ys, aux


@dataclasses.dataclass(frozen=True)
class SeqSplit:
    """A dense decode cache split along its sequence over a mesh
    (``launch.steps.make_serve_step``): device ``(s, j)`` (data shard
    ``s``, model shard ``j``) holds the keys from ``offsets[s][j]`` of
    every row; each of ``groups`` lists the devices whose keys together
    are the whole sequence, in key order; ``over_model``: the model axis
    splits the keys too, so each of its devices holds every KV head
    (and attends every query head) over its keys."""
    offsets: list
    groups: list
    over_model: bool


def _heads_gather(parts, dim: int, devices) -> list:
    """``parts`` concatenated along ``dim`` on each of ``devices``: one
    all-gather."""
    out = [torch.cat([p.to(d, non_blocking=True) for p in parts], dim)
           for d in devices]
    counting.collective("all-gather", out)
    return out


def _split_attention(split: SeqSplit, cfg, shard_cfg, spec, ws, xs, cs,
                     ps):
    """An attention layer's mixer over a sequence-split dense cache, on
    every device of the mesh (``ws``, ``xs``, ``cs``, ``ps``: data shard
    ``s``'s weights, residuals, layer caches and positions a model
    shard): each device projects its query and KV heads; under
    ``over_model`` the queries (and the KV heads a shard lacks) are
    gathered over its model shards, as its cache holds every KV head;
    it writes the new key and value where it holds ``pos``
    (``blocks.write_owned``) and attends its own keys
    (``blocks.split_scores``); each group's partials are merged
    (``launch.mesh.lse_merge``; over an int8 cache the max and sum
    first, then each device's part of the output under them, summed —
    the order GSPMD gives the JAX program); each device keeps its own
    query heads' rows for its ``wo`` rows, and a data shard's model
    shards all-reduce the products, as :func:`_mixer_shards` does.
    Returns (the residuals, the FFN inputs, the caches) a data shard."""
    n, m = len(xs), len(xs[0])
    devs = [(s, j) for s in range(n) for j in range(m)]
    hs = {(s, j): blocks.rmsnorm(xs[s][j], ws[s][j]["norm1"],
                                 shard_cfg.norm_eps) for s, j in devs}
    qkv = {d: blocks.attention_qkv(ws[d[0]][d[1]]["mixer"], shard_cfg, spec,
                                   hs[d], ps[d[0]][d[1]]) for d in devs}
    H, KV, hd = shard_cfg.num_heads, shard_cfg.num_kv_heads, cfg.head_dim
    if split.over_model:
        # the model axis outnumbers the KV heads: each shard computes the
        # one its query heads read, and the first shard holding each
        # head supplies it
        firsts = [sharding.kv_head_range(cfg, j, m)[0] for j in range(m)]
        holders = [firsts.index(h) for h in sorted(set(firsts))]
        for s in range(n):
            row = [qkv[s, j] for j in range(m)]
            devices = [r[0].device for r in row]
            q = _heads_gather([r[0] for r in row], 2, devices)
            if KV < cfg.num_kv_heads:
                k = _heads_gather([row[j][1] for j in holders], 2, devices)
                v = _heads_gather([row[j][2] for j in holders], 2, devices)
            else:
                k, v = [r[1] for r in row], [r[2] for r in row]
            for j in range(m):
                qkv[s, j] = q[j], k[j], v[j]
        H, KV = cfg.num_heads, cfg.num_kv_heads
    parts = {}
    for s, j in devs:
        q, k, v = qkv[s, j]
        cache, pos = cs[s][j]["mixer"], ps[s][j]
        t0 = split.offsets[s][j]
        blocks.write_owned(cache, pos, t0, k[:, 0], v[:, 0])
        parts[s, j] = blocks.split_scores(
            q.reshape(q.shape[0], 1, KV, H // KV, hd), cache, pos, t0,
            spec.window)
    quant = "k_scale" in cs[0][0]["mixer"]
    outs = {}
    for members in split.groups:
        if quant:
            stats = lse_merge([(None, parts[d][1], parts[d][2])
                               for d in members])
            got = all_reduce([blocks.split_out_scaled(
                parts[d][0], cs[d[0]][d[1]]["mixer"], mm, ll)
                for d, (_, mm, ll) in zip(members, stats)])
        else:
            got = [o for o, _, _ in lse_merge([
                (blocks.split_out(parts[d][0], cs[d[0]][d[1]]["mixer"]),
                 parts[d][1], parts[d][2]) for d in members])]
        outs.update(zip(members, got))
    Hl = shard_cfg.num_heads
    out_xs, out_hs = [], []
    for s in range(n):
        ys = []
        for j in range(m):
            o = outs[s, j]
            o = o.reshape(o.shape[0], 1, H * hd)
            if H > Hl:                           # this shard's query heads
                o = o[..., j * Hl * hd:(j + 1) * Hl * hd]
            ys.append(o.to(xs[s][j].dtype) @ ws[s][j]["mixer"]["wo"])
        ys = all_reduce(ys) if m > 1 else ys
        x = [a + y for a, y in zip(xs[s], ys)]
        out_xs.append(x)
        out_hs.append([blocks.rmsnorm(a, w["norm2"], shard_cfg.norm_eps)
                       for a, w in zip(x, ws[s])])
    return out_xs, out_hs, [[cs[s][j]["mixer"] for j in range(m)]
                            for s in range(n)]


def forward_data_shards(params, cfg: ModelConfig, batches, *, mode: str,
                        caches, pos, pages, groups, layout=None,
                        return_hidden: bool = False, split=None):
    """:func:`forward` of each data shard of a tier, the shards advanced
    layer by layer so that each MoE layer routes once over the tier's
    whole batch (:func:`route_data_shards`, in the JAX package's slot
    order, ``layout``; None: each shard routes its own tokens) instead of
    over each shard's own tokens; every other layer runs on each shard
    alone, on its device.  ``params``, ``batches``, ``caches`` (None in
    prefill and train), ``pos`` (None: ``arange``), ``pages`` (None:
    prefill, train, or decode over the dense arena) and ``groups`` hold
    one entry a data shard.  A shard with a model axis (``groups[s]``,
    the module docstring) holds one params and one cache tree a model
    shard, runs each layer's mixer and FFN over its model shards with
    the all-reduces written out, and gathers its logits on model shard
    0's device; its MoE layers route once a model shard.  Returns
    (logits, cache) a data shard, as :func:`forward`: in prefill the
    last position's logits and the new part cache — over a model axis,
    one part cache a model shard, at its heads and widths.

    In ``"train"`` mode the shards are a train step's data shards (equal
    rows, the global batch in shard order) and every MoE layer routes
    once over all of them in the global token order
    (:func:`moe_train_shards`, one route however many model shards;
    ``layout`` is not read); ``cfg.remat`` recomputes each period of
    every shard in backward, the collectives inside.  Returns (each
    shard's every-position logits — or with ``return_hidden`` its model
    shard 0's final-norm hidden states —, aux) a data shard: ``aux`` the
    global batch's MoE losses, on data shard 0's device, with the
    shard's ``"exit_logits"`` (each exit head's vocabulary columns
    gathered) for a config with ``early_exit_periods``.

    ``split`` (a :class:`SeqSplit`; dense ``decode`` only): the dense
    caches hold each device's share of the keys, and every attention
    layer runs over all devices at once (:func:`_split_attention`)."""
    n = len(batches)
    m = 1 if groups[0] is None else groups[0].size
    train = mode == "train"
    xs, ps, pg = [], [], []
    for s in range(n):
        g = groups[s]
        if g is None:
            xs.append([_embed(params[s], cfg, batches[s], mode)])
            ps.append(_positions(batches[s], xs[s][0], pos[s], mode))
            pg.append(pages[s])
            continue
        xs.append(_embed_shards(g, params[s], cfg, batches[s]["tokens"],
                                mode, batches[s].get("frontend_embeds")))
        ps.append(g.replicate(_positions(batches[s], xs[s][0], pos[s],
                                         mode)))
        pg.append([None if pages[s] is None else
                   {k: v.to(d, non_blocking=True)
                    for k, v in pages[s].items()} for d in g.devices])
    shard_cfg = sharding.shard_config(cfg, m)
    widths = [m if groups[s] else 1 for s in range(n)]
    # each data shard's new part cache in prefill, one a model shard
    new = [[{} for _ in range(widths[s])] for s in range(n)]

    def run_layers(xs, aux, wt, ct, layers, prefix):
        xs = [list(x) for x in xs]
        slots = [[{} for _ in range(widths[s])] for s in range(n)]
        for li, layer in enumerate(layers):
            key = f"{prefix}{li}"
            w = [[t[key] for t in wt[s]] for s in range(n)]
            c = [None if ct[s] is None else [t[key] for t in ct[s]]
                 for s in range(n)]
            if split is not None and layer.mixer.kind == "attn":
                xs, hs, mix = _split_attention(
                    split, cfg, shard_cfg, layer.mixer, w, xs, c,
                    [ps[s] if groups[s] else [ps[s]] for s in range(n)])
            else:
                hs, mix = [], []
                for s in range(n):
                    if groups[s] is not None:
                        xs[s], h, mx = _mixer_shards(
                            groups[s], w[s], shard_cfg, layer, xs[s], c[s],
                            ps[s], mode, pg[s])
                    else:
                        x, h, mx = blocks.mixer_half(
                            w[s][0], cfg, layer, xs[s][0],
                            None if c[s] is None else c[s][0]["mixer"],
                            ps[s], mode, pg[s])
                        xs[s], h, mx = [x], [h], [mx]
                    hs.append(h)
                    mix.append(mx)
            for s in range(n):
                for j, mj in enumerate(mix[s]):
                    slots[s][j][key] = {"mixer": mj}
            spec = layer.ffn
            if train and spec.kind == "moe":
                ys, got = moe_train_shards(groups, w, cfg, spec, hs)
                aux = _add_aux(aux, got)
                xs = [[x + y for x, y in zip(xs[s], ys[s])]
                      for s in range(n)]
                continue
            # a MoE layer over a layout: one route a model shard, over
            # every data shard's router logits (the router is replicated)
            routes = [[None] * m for _ in range(n)]
            moe = spec.kind == "moe" and layout is not None
            for j in range(m if moe else 0):
                got = route_data_shards(spec, [blocks.moe_logits(
                    w[s][j]["ffn"], hs[s][j].reshape(-1, cfg.d_model))
                    for s in range(n)], layout)
                for s in range(n):
                    routes[s][j] = got[s]
            for s in range(n):
                if groups[s] is not None:
                    ys, fc = _ffn_shards(groups[s], w[s], cfg, spec, hs[s],
                                         routes[s], c[s], mode)
                    xs[s] = [x + y for x, y in zip(xs[s], ys)]
                else:
                    x, f = blocks.ffn_half(
                        w[s][0], cfg, layer, xs[s][0], hs[s][0],
                        None if c[s] is None else c[s][0]["ffn"], mode,
                        route=routes[s][0])
                    xs[s], fc = [x], [f]
                for j, fj in enumerate(fc):
                    slots[s][j][key]["ffn"] = fj
        return xs, aux, slots

    aux = blocks.zero_aux(xs[0][0].device) if train else None
    exits = {}
    for section, i, layers, prefix in _sections(cfg):
        # each data shard's weights and cache trees of the section, one a
        # model shard
        wt = [[_section(t, section, i) for t in
               (params[s] if groups[s] else [params[s]])] for s in range(n)]
        ct = [None if caches[s] is None else
              [_section(t, section, i) for t in
               (caches[s] if groups[s] else [caches[s]])] for s in range(n)]
        args = (xs, aux, wt, ct, layers, prefix)
        if train and cfg.remat and i is not None:
            xs, aux, slots = checkpoint(run_layers, *args,
                                        use_reentrant=False,
                                        preserve_rng_state=False)
        else:
            xs, aux, slots = run_layers(*args)
        if train and i in cfg.early_exit_periods:
            exits[i] = xs
        if mode == "prefill":
            for s in range(n):
                for j, sl in enumerate(slots[s]):
                    if i is None:
                        new[s][j][section] = sl
                    else:
                        new[s][j].setdefault(section, []).append(sl)
    if train:
        return [_train_out(params[s], cfg, groups[s], xs[s], aux,
                           {i: e[s] for i, e in exits.items()},
                           return_hidden) for s in range(n)]
    out = []
    for s in range(n):
        parts = [{k: _stack(v) if k == "period" else v for k, v in t.items()}
                 for t in new[s]] if mode == "prefill" else None
        if groups[s] is not None:
            last = [x[:, -1:] if mode == "prefill" else x for x in xs[s]]
            out.append((_logits_shards(groups[s], params[s], cfg, last),
                        parts if mode == "prefill" else caches[s]))
        else:
            out.append((_out_logits(params[s], cfg, xs[s][0], mode),
                        parts[0] if mode == "prefill" else caches[s]))
    return out


def _train_out(params, cfg: ModelConfig, group, xs, aux, exits,
               return_hidden: bool):
    """A data shard's train-mode output of :func:`forward_data_shards`:
    (logits gathered on model shard 0's device, or its final-norm hidden
    states; ``aux`` with the shard's exit logits)."""
    if exits:
        aux = {**aux, "exit_logits": tuple(
            _exit_logits(params["exit_heads"][f"exit{i}"], cfg, exits[i][0])
            if group is None else
            _logits_shards(group, params, cfg, exits[i], exit_head=i)
            for i in cfg.early_exit_periods)}
    p0 = params if group is None else params[0]
    if return_hidden:
        return blocks.rmsnorm(xs[0], p0["final_norm"], cfg.norm_eps), aux
    if group is None:
        return _logits(params, cfg, xs[0]), aux
    return _logits_shards(group, params, cfg, xs), aux


def lm_proj_shards(group, params, cfg: ModelConfig):
    """The output projection ``[D, V]`` on model shard 0's device: each
    model shard's vocabulary columns gathered in order (``params`` one
    tree a model shard), or shard 0's whole head where the model axis
    does not split it; ``params`` itself without a ``group``."""
    if group is None:
        return lm_proj(params, cfg)
    if lm_proj(params[0], cfg).shape[1] == cfg.vocab_size:
        return lm_proj(params[0], cfg)
    return all_gather([lm_proj(p, cfg) for p in params], -1)


def forward(params, cfg: ModelConfig, batch: dict, *, mode: str,
            cache=None, pos=None, pages=None, return_hidden: bool = False,
            group=None):
    """Returns (logits, cache) — in ``"train"`` mode (logits, aux).
    ``batch = {"tokens": [B, S] int32}`` (for a model with a modality
    frontend, in ``"train"`` and ``"prefill"``, also ``"frontend_embeds":
    [B, frontend_len, frontend_dim]``, which replace the first
    ``frontend_len`` positions' embeddings; :func:`_embed`), ``pos [B,
    S]`` absolute positions, and ``mode`` one of:

    * ``"train"``: no cache, ``pos`` defaulting to ``arange(S)`` per row;
      every position's logits ``[B, S, V]`` — or, with
      ``return_hidden``, the final-norm hidden states ``[B, S, D]`` for a
      caller that applies the LM head itself
      (:func:`repro_torch.core.losses.chunked_lm_loss`) — and ``aux =
      {"lb_loss", "z_loss"}``, the MoE layers' losses summed over the
      layers (zeros without MoE), with ``"exit_logits"`` for a config
      with ``early_exit_periods``: a tuple of ``[B, S, V]``, one per
      exit in that order, each head over the hidden state after its
      period (before the tail);

    or one of the serving modes of
    :func:`repro_torch.models.blocks.attention`:

    * ``"prefill"``: ``cache=None``, ``pos`` defaulting to ``arange(S)``
      per row; returns the logits of the **last position only**,
      ``[B, 1, V]`` (the engine reads nothing else, and the final norm
      and LM head act per position, so these equal the JAX package's
      ``logits[:, -1:]``; a gemma3 prefill of 8 x 640 tokens would
      otherwise hold a 5.4 GB ``[8, 640, 262144]`` f32 transient), and
      the new part cache, the JAX package's tree.  Serving computes no
      exit logits (the JAX package computes them in prefill too, and its
      engine reads none);
    * ``"ragged_step"`` (a flat ``[1, W]`` batch, ``pages =
      {"page_table": [R, P], "q_len": [R], "q_start": [R]}``),
      ``"mixed_step"`` / ``"prefill_chunk"`` (a padded ``[B, C]`` batch,
      ``pages = {"page_table", "q_len"}``) or ``"decode"`` (``[B, 1]``,
      ``pages = {"page_table"}`` over a block-paged cache, or ``None``
      over the dense arena): all positions' logits, and the cache updated
      in place.

    With ``group``: ``params`` and ``cache`` hold one tree a model shard
    (:func:`forward_data_shards`), a prefill returns one part cache a
    model shard, and train mode its logits (or hidden states) on model
    shard 0's device."""
    if mode not in ("train", "prefill", "ragged_step", "mixed_step",
                    "prefill_chunk", "decode"):
        raise NotImplementedError(f"forward mode {mode!r} is not ported")
    if group is not None:
        return forward_data_shards([params], cfg, [batch], mode=mode,
                                   caches=[cache], pos=[pos], pages=[pages],
                                   groups=[group],
                                   return_hidden=return_hidden)[0]
    x = _embed(params, cfg, batch, mode)
    pos = _positions(batch, x, pos, mode)
    if mode not in ("train", "prefill") and cache is None:
        raise ValueError(f"{mode} requires a cache")
    new_cache = {}
    c = cache or {}
    aux = blocks.zero_aux(x.device) if mode == "train" else None
    if cfg.head:
        x, new_cache["head"], aux = _apply_layers(
            params["head"], cfg, cfg.head, "layer", x, c.get("head"), pos,
            mode, pages, aux)
    exits = {} if mode == "train" and cfg.early_exit_periods else None
    if cfg.num_periods:
        x, new_cache["period"], aux = _apply_periods(
            params, cfg, x, c.get("period"), pos, mode, pages, aux, exits)
    if cfg.tail:
        x, new_cache["tail"], aux = _apply_layers(
            params["tail"], cfg, cfg.tail, "layer", x, c.get("tail"), pos,
            mode, pages, aux)
    if mode == "train":
        if exits:
            aux = {**aux, "exit_logits": tuple(
                _exit_logits(params["exit_heads"][f"exit{i}"], cfg, exits[i])
                for i in cfg.early_exit_periods)}
        if return_hidden:
            return blocks.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux
        return _logits(params, cfg, x), aux
    return _out_logits(params, cfg, x, mode), new_cache


def train_logits(params, cfg: ModelConfig, batch: dict):
    """Every position's logits [B, S, V] and the aux losses (with the
    exit heads' logits, if any)."""
    return forward(params, cfg, batch, mode="train")


def prefill(params, cfg: ModelConfig, batch: dict, pos=None, group=None):
    """Uniform one-shot prefill of ``batch["tokens"]`` [B, S] (every row
    a whole prompt at positions ``0..S-1`` unless ``pos`` says
    otherwise): returns (last-position logits [B, 1, V], part cache),
    the part cache being the dense ``[B, S, ...]`` tree
    ``TierSlotPool.write_prefill`` / ``DenseTierSlotPool.write_prefill``
    scatter into the arena — with ``group``, one such tree a model
    shard, at the shard's KV heads and recurrent widths."""
    return forward(params, cfg, batch, mode="prefill", pos=pos, group=group)


def prefill_chunk(params, cfg: ModelConfig, tokens, cache, pos, pages,
                  group=None):
    """One chunked-prefill step: tokens [B, C] int32 (row b's chunk,
    padded past ``pages['q_len'][b]``); pos [B, C] per-row absolute
    positions; pages {"page_table": [B, P], "q_len": [B]}.  Writes the
    chunk's KV through the page tables and returns (logits [B, C, V],
    cache); logits past a row's q_len are unspecified."""
    return forward(params, cfg, {"tokens": tokens}, mode="prefill_chunk",
                   cache=cache, pos=pos, pages=pages, group=group)


def last_slot_gather(logits, q_len, *, flat: bool):
    """Gather each engine row's logits at its last live slot.

    ``flat=False``: logits [B, C, V], row b's slots are ``[0, q_len[b])``
    of its own row, so its last live slot is ``q_len - 1`` (clamped to
    0).  ``flat=True``: logits [1, W, V], row b owns flat slots
    ``[row_start[b], row_start[b] + q_len[b])``, so its last live slot is
    ``cumsum(q_len) - 1``, clipped into the flat width.  Rows with
    ``q_len == 0`` gather unspecified logits; callers discard them."""
    if flat:
        csum = torch.cumsum(q_len, 0)
        last = (csum - 1).clamp(0, logits.shape[1] - 1)
        return logits[0, last]
    rows = torch.arange(logits.shape[0], device=logits.device)
    last = (q_len.long() - 1).clamp(min=0)
    return logits[rows, last]


def mixed_step(params, cfg: ModelConfig, tokens, cache, pos, pages,
               group=None):
    """One padded mixed prefill+decode step: tokens [B, C] int32 — row
    b's next prefill chunk, its decode token in slot 0, or padding —
    with ``pages['q_len'][b]`` live slots; pos [B, C]; pages
    {"page_table": [B, P], "q_len": [B]}.  Every attention layer runs the
    mixed kernel; returns (last_logits [B, V], cache), each row's logits
    at its last live slot.  ``q_len == 0`` rows return unspecified
    logits."""
    logits, cache = forward(params, cfg, {"tokens": tokens},
                            mode="mixed_step", cache=cache, pos=pos,
                            pages=pages, group=group)
    return last_slot_gather(logits, pages["q_len"], flat=False), cache


def ragged_step(params, cfg: ModelConfig, tokens, cache, pos, pages,
                group=None):
    """One ragged flat token-batch prefill+decode step (O(live tokens)).

    tokens [1, W] int32 — the tick's live tokens packed contiguously:
    engine row b's ``pages['q_len'][b]`` tokens occupy flat slots
    ``[row_start[b], row_start[b] + q_len[b])``; the tail past
    ``sum(q_len)`` is bucket padding.  pos [1, W] per-token absolute
    positions; pages {"page_table": [R, P], "q_len": [R], "q_start": [R]}
    over a block-paged cache.  Scatters every live token's KV through its
    row's page table, runs the ragged attention kernel in every layer,
    and returns (last_logits [R, V], cache) in engine-row order.
    ``q_len == 0`` rows return unspecified logits.
    """
    logits, cache = forward(params, cfg, {"tokens": tokens},
                            mode="ragged_step", cache=cache, pos=pos,
                            pages=pages, group=group)
    return last_slot_gather(logits, pages["q_len"], flat=True), cache


def ragged_verify(params, cfg: ModelConfig, tokens, cache, pos, pages,
                  group=None):
    """The speculative verify's step: :func:`ragged_step`'s flat ``[1,
    W]`` layout, KV writes and pages contract, but returning every
    position's logits ``[1, W, V]`` (with the cache) instead of the
    last-slot gather, so a verify row (``q_len = 1 + k`` flat slots) is
    scored at every drafted position in the one launch.  Padding slots
    and ``q_len == 0`` rows yield unspecified logits.  With ``group``
    the logits are gathered on model shard 0's device."""
    return forward(params, cfg, {"tokens": tokens}, mode="ragged_step",
                   cache=cache, pos=pos, pages=pages, group=group)


def decode_step(params, cfg: ModelConfig, token, cache, pos, pages=None,
                group=None):
    """token [B, 1] int32; pos [B, 1] per-row decode positions;
    ``pages={"page_table": [B, P]}`` over a block-paged cache, where
    every attention layer runs the paged decode kernel, or ``pages=None``
    over the dense arena (plain torch attention over each row's
    ``[max_seq]`` keys).  Recurrent layers step their per-row state in
    place either way.  Returns (logits [B, 1, V], cache)."""
    return forward(params, cfg, {"tokens": token}, mode="decode",
                   cache=cache, pos=pos, pages=pages, group=group)
