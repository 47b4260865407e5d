"""Transformer building blocks (the torch twin of the serving half of
``repro/models/blocks.py``).

The mixer signature is the JAX package's::

    y, cache = attention(p, cfg, spec, x, cache, pos, mode, pages=None)

with ``mode == "ragged_step"``, the one mode the serving path runs: the
batch is one flat ``[1, W]`` token row packed by the prefix sum of the
per-row live counts ``q_len``, and ``pages`` carries ``{"page_table":
[R, P], "q_len": [R], "q_start": [R]}`` over a cache from
:func:`repro_torch.models.cache.init_paged_cache`.  The KV pools are
updated in place and the same cache dict comes back.

``dense_ffn(p, cfg, spec, x) -> y`` covers the ``swiglu`` and ``gelu``
FFNs.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops


def rmsnorm(x, scale, eps=1e-6):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


# --------------------------------------------------------------------------
# Rotary embeddings
# --------------------------------------------------------------------------


def _rope_angles(pos, dim, theta):
    """pos [..., S] -> cos/sin [..., S, dim//2] (float32)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32,
                        device=pos.device) / dim
    inv = 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                       device=pos.device), exps)
    ang = pos.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def _apply_rot(x, cos, sin):
    """x [..., S, H, d]; cos/sin [..., S, d//2] broadcast over heads."""
    x1, x2 = x.float().chunk(2, dim=-1)
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s],
                     dim=-1).to(x.dtype)


def apply_rope(q, k, pos, cfg: ModelConfig, kind: str):
    """kind: 'rope' | 'none'.  q [B,S,H,d], k [B,S,KV,d], pos [B,S]."""
    if kind == "none":
        return q, k
    if kind != "rope":
        raise NotImplementedError(f"rope kind {kind!r} is not ported")
    cos, sin = _rope_angles(pos, q.shape[-1], cfg.rope_theta)
    return _apply_rot(q, cos, sin), _apply_rot(k, cos, sin)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------


def _quant_i8(x, eps=1e-8):
    """Symmetric per-(token, head) int8 quantization of [B,S,KV,d]."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1) / 127.0 + eps
    q = torch.round(x32 / scale[..., None])     # half to even, as jnp
    return q.clamp(-127, 127).to(torch.int8), scale


def attention(p, cfg: ModelConfig, spec, x, cache, pos, mode, pages=None):
    if mode != "ragged_step":
        raise NotImplementedError(f"attention mode {mode!r} is not ported")
    if pages is None:
        raise ValueError("ragged_step requires pages={'page_table', "
                         "'q_len', 'q_start'} over a block-paged cache")
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KV
    q = (x @ p["wq"]).reshape(B, S, KV, G, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    qr, k = apply_rope(q.reshape(B, S, H, hd), k, pos, cfg, spec.rope)
    q = qr.reshape(B, S, KV, G, hd)

    # Ragged flat token-batch step: engine row b's q_len[b] live tokens
    # occupy flat slots [row_start[b], row_start[b] + q_len[b]); the tail
    # past sum(q_len) is bucket padding.  Each flat token's owning row
    # comes from the prefix sum; its KV write goes through that row's
    # page table at the token's absolute position, padding to the null
    # block 0 (duplicate writes there: the winner is unspecified and
    # block 0 is never attended).
    pt = pages["page_table"]                        # [R, P] int32
    q_len = pages["q_len"]                          # [R] int32
    q_start = pages["q_start"]                      # [R] int32
    R, P = pt.shape
    bs = cache["k"].shape[1]
    csum = torch.cumsum(q_len, 0)
    tok = torch.arange(S, device=x.device)
    row = torch.searchsorted(csum, tok, right=True).clamp(max=R - 1)
    valid = tok < csum[-1]
    p_tok = pos[0].long()                           # [W] abs positions
    page = (p_tok // bs).clamp(max=P - 1)
    blk = torch.where(valid, pt[row, page].long(), 0)
    off = p_tok % bs
    # in place: the pools are this layer's slice of the tier's arena (the
    # JAX package writes a new cache and donates the old buffers instead)
    if "k_scale" in cache:
        kq, ksc = _quant_i8(k)
        vq, vsc = _quant_i8(v)
        cache["k"].index_put_((blk, off), kq[0])
        cache["v"].index_put_((blk, off), vq[0])
        cache["k_scale"].index_put_((blk, off), ksc[0])
        cache["v_scale"].index_put_((blk, off), vsc[0])
        out = kernel_ops.ragged_attention(
            q[0], cache["k"], cache["v"], pt, q_start, q_len,
            k_scale=cache["k_scale"], v_scale=cache["v_scale"],
            window=spec.window)
    else:
        cache["k"].index_put_((blk, off), k[0].to(cache["k"].dtype))
        cache["v"].index_put_((blk, off), v[0].to(cache["v"].dtype))
        out = kernel_ops.ragged_attention(
            q[0], cache["k"], cache["v"], pt, q_start, q_len,
            window=spec.window)
    y = out[None].to(x.dtype).reshape(B, S, H * hd) @ p["wo"]
    return y, cache


# --------------------------------------------------------------------------
# FFN and layer
# --------------------------------------------------------------------------


def dense_ffn(p, cfg: ModelConfig, spec, x):
    if spec.act == "swiglu":
        h = F.silu(x @ p["wi0"]) * (x @ p["wi1"])
    elif spec.act == "gelu":
        h = F.gelu(x @ p["wi"], approximate="tanh")   # jax.nn.gelu default
    else:
        raise NotImplementedError(f"ffn act {spec.act!r} is not ported")
    return h @ p["wo"]


def apply_layer(p, cfg: ModelConfig, layer, x, cache, pos, mode,
                pages=None):
    """Pre-norm residual layer: x + mixer(norm(x)); x + ffn(norm(x))."""
    if layer.mixer.kind != "attn" or layer.ffn.kind != "dense":
        raise NotImplementedError(
            f"{layer.mixer.kind}/{layer.ffn.kind} layers are not ported")
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    y, new_mix = attention(p["mixer"], cfg, layer.mixer, h, cache["mixer"],
                           pos, mode, pages=pages)
    x = x + y
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    x = x + dense_ffn(p["ffn"], cfg, layer.ffn, h)
    return x, {"mixer": new_mix, "ffn": {}}
