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
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import Layer, ModelConfig
from repro_torch.models.params import tree_leaves, tree_map


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
    if m.kind == "mamba":
        d_in = m.expand * cfg.d_model
        return {"conv": CP((B, m.d_conv - 1, d_in),
                           ("batch", None, "d_inner"), dtype),
                "ssm": CP((B, d_in, m.d_state), ("batch", "d_inner", None),
                          torch.float32)}
    if m.kind == "rwkv6":
        h = cfg.d_model // m.head_dim
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


def has_recurrent_state(cfg: ModelConfig) -> bool:
    """True if any cache leaf is per-request recurrent state (no kv_seq
    dim): such state advances on every decode step, so it cannot be
    carried across prefill chunks or replayed after a block-exhaustion
    stall (see ``CascadeEngine``)."""
    return any("kv_seq" not in c.axes
               for c in tree_leaves(declare_cache(cfg, 1, 1)))
