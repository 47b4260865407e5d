"""Block-paged KV cache (the torch twin of the paged half of
``repro/models/cache.py``).

Cache structure mirrors the model layout::

    {"head": {"layer0": {...}}, "period": {"block0": stacked...}, "tail": ...}

Each layer slot is ``{"mixer": {"k", "v"[, "k_scale", "v_scale"]},
"ffn": {}}``; period entries carry a leading ``num_periods`` stack dim.
Attention k/v live in one shared block pool per layer, ``[num_blocks,
block_size, kv_heads, hd]`` (int8 pools add ``[num_blocks, block_size,
kv_heads]`` f32 scales), reached through per-request page tables
(``repro_torch.serving.slots``).  Block 0 is the null block that page
tables are padded with: it is never allocated, and padding writes land
there.

The JAX package returns a new cache from every step (and donates the old
buffers on accelerators); here the pools are updated in place.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.configs.base import Layer, ModelConfig
from repro_torch.models.params import tree_map


class CP(NamedTuple):
    """Cache leaf declaration: shape + logical axes + dtype."""
    shape: tuple
    axes: tuple
    dtype: object


def _mixer_cache_decl(cfg: ModelConfig, m, B: int, S: int, dtype) -> dict:
    if m.kind != "attn":
        raise NotImplementedError(f"{m.kind} cache is not ported")
    kv = (B, S, cfg.num_kv_heads, cfg.head_dim)
    ax = ("batch", "kv_seq", "kv_heads", None)
    if cfg.kv_quant == "int8":
        sc = (B, S, cfg.num_kv_heads)
        sax = ("batch", "kv_seq", "kv_heads")
        return {"k": CP(kv, ax, torch.int8), "v": CP(kv, ax, torch.int8),
                "k_scale": CP(sc, sax, torch.float32),
                "v_scale": CP(sc, sax, torch.float32)}
    return {"k": CP(kv, ax, dtype), "v": CP(kv, ax, dtype)}


def _layer_cache_decl(cfg, layer: Layer, B, S, dtype):
    return {"mixer": _mixer_cache_decl(cfg, layer.mixer, B, S, dtype),
            "ffn": {}}


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


def _page_leaf(c: CP, num_blocks: int, block_size: int) -> CP:
    """Rewrite a KV leaf ``[.., batch, kv_seq(=block_size), ..]`` into the
    shared block-pool layout ``[.., kv_blocks, block, ..]``."""
    shape, axes = list(c.shape), list(c.axes)
    b, s = axes.index("batch"), axes.index("kv_seq")
    shape[b], axes[b] = num_blocks, "kv_blocks"
    shape[s], axes[s] = block_size, "block"
    return CP(tuple(shape), tuple(axes), c.dtype)


def declare_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                        block_size: int, dtype=torch.float32) -> dict:
    """Cache declaration with attention KV in a shared block pool
    ``[num_blocks, block_size, kv_heads, hd]`` per layer."""
    decl = declare_cache(cfg, batch, block_size, dtype)
    return tree_map(lambda c: _page_leaf(c, num_blocks, block_size), decl)


def init_paged_cache(cfg: ModelConfig, batch: int, num_blocks: int,
                     block_size: int, dtype=torch.float32, device="cuda"):
    decl = declare_paged_cache(cfg, batch, num_blocks, block_size, dtype)
    return tree_map(lambda c: torch.zeros(c.shape, dtype=c.dtype,
                                          device=device), decl)
