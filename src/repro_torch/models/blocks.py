"""Transformer building blocks (the torch twin of the serving half of
``repro/models/blocks.py``).

The mixer signature is the JAX package's::

    y, cache = attention(p, cfg, spec, x, cache, pos, mode, pages=None)

over a block-paged cache from
:func:`repro_torch.models.cache.init_paged_cache`, in the modes the
serving executors run:

* ``"ragged_step"`` (ragged executor): one flat ``[1, W]`` token row
  packed by the prefix sum of the per-row live counts; ``pages`` carries
  ``{"page_table": [R, P], "q_len": [R], "q_start": [R]}``;
* ``"mixed_step"`` (padded executor) and ``"prefill_chunk"`` (split
  executor's chunk launch): a padded ``[B, C]`` batch, row ``b``'s
  ``q_len[b]`` live slots at positions ``pos[b]``; ``pages`` carries
  ``{"page_table": [B, P], "q_len": [B]}``;
* ``"decode"`` (split executor's decode launch): one token per row at
  ``pos [B, 1]``; ``pages`` carries ``{"page_table": [B, P]}``.

The KV pools are updated in place and the same cache dict comes back.
Dense caches (``pages=None``) are not ported.

``dense_ffn(p, cfg, spec, x) -> y`` covers the ``swiglu`` and ``gelu``
FFNs, ``moe_ffn(p, cfg, spec, x) -> y`` the token-choice top-k mixture of
experts; ``apply_ffn`` picks one by the layer's FFN kind.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kernel_ops

MOE_GROUP_SIZE = 1024


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


def _write_kv(cache, blk, off, k, v):
    """Scatter new keys/values into the pools at (block, offset), in
    place (the JAX package writes a new cache and donates the old buffers
    instead).  Duplicate writes to the null block 0 leave an unspecified
    winner there; block 0 is never attended by a live query."""
    if "k_scale" in cache:
        kq, ksc = _quant_i8(k)
        vq, vsc = _quant_i8(v)
        cache["k"].index_put_((blk, off), kq)
        cache["v"].index_put_((blk, off), vq)
        cache["k_scale"].index_put_((blk, off), ksc)
        cache["v_scale"].index_put_((blk, off), vsc)
    else:
        cache["k"].index_put_((blk, off), k.to(cache["k"].dtype))
        cache["v"].index_put_((blk, off), v.to(cache["v"].dtype))


def _scales(cache) -> dict:
    return {"k_scale": cache.get("k_scale"), "v_scale": cache.get("v_scale")}


def attention(p, cfg: ModelConfig, spec, x, cache, pos, mode, pages=None):
    if mode not in ("ragged_step", "mixed_step", "prefill_chunk", "decode"):
        raise NotImplementedError(f"attention mode {mode!r} is not ported")
    if pages is None:
        raise NotImplementedError(
            f"{mode} over a dense cache is not ported: pass pages= over a "
            "block-paged cache")
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KV
    q = (x @ p["wq"]).reshape(B, S, KV, G, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    qr, k = apply_rope(q.reshape(B, S, H, hd), k, pos, cfg, spec.rope)
    q = qr.reshape(B, S, KV, G, hd)
    pt = pages["page_table"]                        # [R or B, P] int32
    P = pt.shape[1]
    bs = cache["k"].shape[1]

    if mode == "ragged_step":
        # Ragged flat token-batch step: engine row b's q_len[b] live
        # tokens occupy flat slots [row_start[b], row_start[b] + q_len[b]);
        # the tail past sum(q_len) is bucket padding.  Each flat token's
        # owning row comes from the prefix sum; its KV write goes through
        # that row's page table at the token's absolute position, padding
        # to the null block 0.
        q_len = pages["q_len"]                      # [R] int32
        R = pt.shape[0]
        csum = torch.cumsum(q_len, 0)
        tok = torch.arange(S, device=x.device)
        row = torch.searchsorted(csum, tok, right=True).clamp(max=R - 1)
        valid = tok < csum[-1]
        p_tok = pos[0].long()                       # [W] abs positions
        page = (p_tok // bs).clamp(max=P - 1)
        blk = torch.where(valid, pt[row, page].long(), 0)
        _write_kv(cache, blk, p_tok % bs, k[0], v[0])
        out = kernel_ops.ragged_attention(
            q[0], cache["k"], cache["v"], pt, pages["q_start"], q_len,
            window=spec.window, **_scales(cache))[None]
    elif mode == "decode":
        # Paged decode: row b's one new token at pos[b, 0] scatters into
        # (page_table[b, pos // bs], pos % bs) — the page index clamped
        # into the table, and unmapped pages (masked or stalled rows) hit
        # the null block, whose output the engine discards — then the
        # paged decode kernel attends the row's pages.
        p_row = pos[:, 0].long()                    # [B]
        page = (p_row // bs).clamp(max=P - 1)
        blk = pt[torch.arange(B, device=x.device), page].long()
        _write_kv(cache, blk, p_row % bs, k[:, 0], v[:, 0])
        out = kernel_ops.paged_attention(
            q[:, 0].contiguous(), cache["k"], cache["v"], pt,
            pos[:, 0].contiguous(), window=spec.window, **_scales(cache))
    else:
        # Padded token-batch step: row b's S slots (positions pos[b],
        # q_len[b] of them live) scatter through its page table — the
        # page index clamped into the table and the dead slots
        # (i >= q_len) sent to the null block 0 — then one causal flash
        # over the live slots: the mixed kernel in mixed_step mode (decode
        # rows ride in the batch with q_len == 1), its prefill-only
        # contract in prefill_chunk mode.
        q_len = pages["q_len"]                      # [B] int32
        p_tok = pos.long()                          # [B, C]
        page = (p_tok // bs).clamp(max=P - 1)
        blk = torch.gather(pt.long(), 1, page)
        valid = torch.arange(S, device=x.device)[None, :] \
            < q_len.long()[:, None]
        blk = torch.where(valid, blk, 0)
        _write_kv(cache, blk, p_tok % bs, k, v)
        attn = (kernel_ops.mixed_attention if mode == "mixed_step"
                else kernel_ops.paged_prefill_attention)
        out = attn(q, cache["k"], cache["v"], pt, pos[:, 0].contiguous(),
                   q_len, window=spec.window, **_scales(cache))
    y = out.to(x.dtype).reshape(B, S, H * hd) @ p["wo"]
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


def moe_ffn(p, cfg: ModelConfig, spec, x):
    """GShard-style token-choice top-k MoE (``repro/models/blocks.py::
    moe_ffn``), routed by the ``router_gate`` kernel.

    The ``N = B·S`` token slots, padding included, split into ``G``
    groups of ``gs = min(1024, N)``.  Each token picks its top ``k``
    experts (renormalised gates); a (token, pick) pair's place in its
    expert's queue is its rank in (slot, pick) order over the group, and
    pairs at rank ``>= cap = min(gs, max(1, ceil(gs·k·capacity_factor /
    E)))`` are dropped — their gate is not renormalised again.  The JAX
    package's one-hot dispatch and combine einsums become an index
    scatter into the dense ``[E, G·cap, d]`` capacity buffer and a
    weighted sum over each token's kept picks: dispatch is 0/1 and every
    (expert, slot) holds at most one token, so the function is the same
    and only the order of the combine's sum differs.  The expert
    products stay batched matrix products over the capacity buffer.

    Serving reads only the output: the load-balance and z aux losses the
    JAX function also returns (for training) are not computed.
    """
    B, S, D = x.shape
    E, K = spec.num_experts, spec.top_k
    N = B * S
    gs = min(MOE_GROUP_SIZE, N)
    G = N // gs
    xg = x.reshape(G, gs, D)
    logits = (xg @ p["router"]).float()                      # [G, gs, E]
    gates, idx = kernel_ops.router_gate(logits, K)           # [G, gs, K]
    cap = max(1, int(math.ceil(gs * K * spec.capacity_factor / E)))
    cap = min(cap, gs)

    # rank of each (slot, pick) pair in its expert's queue, (slot, pick)
    # order over the group
    pick = idx.long().reshape(G, gs * K)
    onehot = F.one_hot(pick, E)                              # [G, gs·K, E]
    rank = (onehot.cumsum(1) - onehot).gather(2, pick[..., None])[..., 0]
    keep = rank < cap
    # kept pair -> row (e·G + g)·cap + rank of the capacity buffer; a
    # dropped pair writes the spare last row, which nothing reads
    grp = torch.arange(G, device=x.device)[:, None]
    dest = torch.where(keep, (pick * G + grp) * cap + rank, E * G * cap)
    dest = dest.reshape(-1)
    buf = x.new_zeros(E * G * cap + 1, D)
    buf[dest] = xg[:, :, None, :].expand(G, gs, K, D).reshape(-1, D)
    xin = buf[:-1].view(E, G * cap, D)
    if spec.act == "swiglu":
        h = F.silu(torch.bmm(xin, p["wi0"])) * torch.bmm(xin, p["wi1"])
    elif spec.act == "gelu":
        h = F.gelu(torch.bmm(xin, p["wi"]), approximate="tanh")
    else:
        raise NotImplementedError(f"moe act {spec.act!r} is not ported")
    eout = torch.bmm(h, p["wo"]).reshape(E * G * cap, D)
    # combine: each token's kept picks, weighted by their gates
    w = torch.where(keep, gates.reshape(G, gs * K), 0.0).to(x.dtype)
    picked = eout[torch.where(keep, dest.reshape(G, gs * K), 0)]
    out = (w[..., None] * picked).reshape(G, gs, K, D).sum(2)
    return out.reshape(B, S, D)


def apply_ffn(p, cfg: ModelConfig, spec, x):
    if spec.kind == "moe":
        return moe_ffn(p, cfg, spec, x)
    return dense_ffn(p, cfg, spec, x)


def apply_layer(p, cfg: ModelConfig, layer, x, cache, pos, mode,
                pages=None):
    """Pre-norm residual layer: x + mixer(norm(x)); x + ffn(norm(x))."""
    if layer.mixer.kind != "attn" or layer.ffn.kind not in ("dense", "moe"):
        raise NotImplementedError(
            f"{layer.mixer.kind}/{layer.ffn.kind} layers are not ported")
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    y, new_mix = attention(p["mixer"], cfg, layer.mixer, h, cache["mixer"],
                           pos, mode, pages=pages)
    x = x + y
    h = rmsnorm(x, p["norm2"], cfg.norm_eps)
    x = x + apply_ffn(p["ffn"], cfg, layer.ffn, h)
    return x, {"mixer": new_mix, "ffn": {}}
