"""Transformer, Mamba and RWKV-6 building blocks (the torch twin of the
serving half of ``repro/models/blocks.py``).

The mixer signature is the JAX package's::

    y, cache = mixer(p, cfg, spec, x, cache, pos, mode, pages=None)

Attention runs in ``"train"`` (every position of a full sequence, the
causal or windowed mask over the materialised scores, no cache: the
training forward, differentiable) and in the modes the serving
executors use:

* ``"prefill"`` (uniform one-shot prefill): every row's whole prompt at
  positions ``0..S-1``; no cache in, and the new part cache ``{"k",
  "v"}`` (int8 with scales under ``kv_quant="int8"``) out, for
  ``TierSlotPool.write_prefill`` to scatter; attention runs in the
  ``flash_attention`` kernel on the unquantised keys and values;
* ``"ragged_step"`` (ragged executor): one flat ``[1, W]`` token row
  packed by the prefix sum of the per-row live counts; ``pages`` carries
  ``{"page_table": [R, P], "q_len": [R], "q_start": [R]}``;
* ``"mixed_step"`` (padded executor) and ``"prefill_chunk"`` (split
  executor's chunk launch): a padded ``[B, C]`` batch, row ``b``'s
  ``q_len[b]`` live slots at positions ``pos[b]``; ``pages`` carries
  ``{"page_table": [B, P], "q_len": [B]}``;
* ``"decode"``: one token per row at ``pos [B, 1]``, over a block-paged
  cache (``pages={"page_table": [B, P]}``, the paged decode kernel) or,
  with ``pages=None``, the dense ``[B, max_seq, KV, hd]`` arena (plain
  torch: the JAX package has no kernel there).

Decode and the paged steps update the cache in place and return the same
dict.  The Mamba mixer (:func:`mamba`), the RWKV-6 time mix
(:func:`rwkv6`) and channel mix (:func:`rwkv_cmix`) run in ``"train"``
(no cache) and ``"prefill"`` (the ``mamba_scan`` and ``rwkv6_scan``
kernels from the zero state, through :class:`_MambaScan` and
:class:`_RWKV6Scan`: the kernel forward, a plain-torch backward) and
``"decode"`` (one plain-torch step from the cached state) only: their
recurrent state cannot be carried across chunks, and the chunked modes
raise as in the JAX package.

``dense_ffn(p, cfg, spec, x) -> y`` covers the ``swiglu`` and ``gelu``
FFNs, ``moe_ffn(p, cfg, spec, x) -> y`` the token-choice top-k mixture of
experts; ``apply_ffn(p, cfg, spec, x, cache, mode) -> (y, cache)`` picks
one by the layer's FFN kind, with the channel mix's token-shift cache.
In ``"train"`` mode :func:`train_ffn` returns ``(y, aux)`` instead, the
MoE layer's load-balance and router z losses (:func:`moe_ffn_train`)
or zeros.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import mamba_scan as _mamba_kernel
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels import rwkv6_scan as _rwkv_kernel

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


# M-RoPE's patch grid width: positions below frontend_len are the
# patches of one image, row-major on a grid of this width
MROPE_GRID = 32


def apply_rope(q, k, pos, cfg: ModelConfig, kind: str,
               frontend_len: int = 0):
    """kind: 'rope' | 'mrope' | 'none'.  q [B,S,H,d], k [B,S,KV,d], pos
    [B,S]."""
    if kind == "none":
        return q, k
    d = q.shape[-1]
    if kind == "rope":
        cos, sin = _rope_angles(pos, d, cfg.rope_theta)
        return _apply_rot(q, cos, sin), _apply_rot(k, cos, sin)
    if kind != "mrope":
        raise NotImplementedError(f"rope kind {kind!r} is not ported")
    # M-RoPE [arXiv:2409.12191]: head_dim split into (temporal, height,
    # width) sections.  An image position (pos < frontend_len) takes
    # temporal 0 and its (row, column) on the patch grid; a text position
    # uses pos in all three sections.
    is_img = pos < frontend_len
    zero = torch.zeros_like(pos)
    sections = (torch.where(is_img, zero, pos),
                torch.where(is_img, torch.div(pos, MROPE_GRID,
                                              rounding_mode="floor"), pos),
                torch.where(is_img, pos % MROPE_GRID, pos))
    qs, ks = [], []
    off = 0
    for p_sec, n in zip(sections, _mrope_sections(d)):
        cos, sin = _rope_angles(p_sec, n, cfg.rope_theta)
        qs.append(_apply_rot(q[..., off:off + n], cos, sin))
        ks.append(_apply_rot(k[..., off:off + n], cos, sin))
        off += n
    return torch.cat(qs, dim=-1), torch.cat(ks, dim=-1)


def _mrope_sections(d):
    """M-RoPE's (temporal, height, width) section widths of head width
    ``d``: (16, 56, 56) at 128."""
    t = d // 8
    hw = (d - t) // 2
    return (t, hw, d - t - hw)


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
    """Scatter new keys/values into the pools at (block, offset) — or
    into the dense arena at (row, position) — in place (the JAX package
    writes a new cache and donates the old buffers instead).  Duplicate writes to the null block 0 leave an unspecified
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


def _gqa_scores_to_out(q, k, v, mask, k_scale=None, v_scale=None):
    """Materialised-scores attention (the JAX package's jnp path): q
    [B,S,KV,G,d]; k, v [B,T,KV,d]; mask broadcastable to
    [B,KV,G,S,T] (True where a query sees a key).  An int8 cache
    folds its per-token scales into the scores and the probabilities,
    and the probabilities meet the values in bf16, as the JAX package
    computes it."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.einsum("bskgd,btkd->bkgst", q.float(), k.float()) * scale
    if k_scale is not None:
        scores = scores * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    probs = torch.softmax(scores, dim=-1)
    if v_scale is not None:
        probs = probs * v_scale.permute(0, 2, 1)[:, :, None, None, :]
        probs = probs.to(torch.bfloat16).float()
        out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
        return out.to(torch.bfloat16)
    return torch.einsum("bkgst,btkd->bskgd", probs.to(v.dtype), v)


# Train-mode attention: above this sequence length the queries go in
# chunks of _Q_CHUNK, bounding the [.., chunk, S] score matrix (the JAX
# package's thresholds)
_Q_CHUNK = 1024
_CHUNK_THRESHOLD = 4096


def _train_attention(spec, q, k, v, pos):
    """Full-sequence causal (or windowed) GQA for training, through the
    materialised scores as the JAX package's train path computes it (it
    runs no Pallas kernel there, and the port's ``flash_attention``
    kernel has no backward): q [B,S,KV,G,d], k, v [B,S,KV,d], pos
    [B,S]."""
    S = q.shape[1]
    k_pos = pos[:, None, None, None, :]                  # [B,1,1,1,S]

    def masked(qc, qp):
        q_pos = qp[:, None, None, :, None]               # [B,1,1,c,1]
        mask = k_pos <= q_pos
        if spec.window is not None:
            mask = mask & (k_pos > q_pos - spec.window)
        return _gqa_scores_to_out(qc, k, v, mask)

    if S < _CHUNK_THRESHOLD:
        return masked(q, pos)
    return torch.cat([masked(q[:, s:s + _Q_CHUNK], pos[:, s:s + _Q_CHUNK])
                      for s in range(0, S, _Q_CHUNK)], dim=1)


def attention(p, cfg: ModelConfig, spec, x, cache, pos, mode, pages=None):
    if mode not in ("train", "prefill", "ragged_step", "mixed_step",
                    "prefill_chunk", "decode"):
        raise NotImplementedError(f"attention mode {mode!r} is not ported")
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    G = H // KV
    q = (x @ p["wq"]).reshape(B, S, KV, G, hd)
    k = (x @ p["wk"]).reshape(B, S, KV, hd)
    v = (x @ p["wv"]).reshape(B, S, KV, hd)
    qr, k = apply_rope(q.reshape(B, S, H, hd), k, pos, cfg, spec.rope,
                       cfg.frontend_len)
    q = qr.reshape(B, S, KV, G, hd)

    if mode == "train":
        out = _train_attention(spec, q, k, v, pos)
        return out.reshape(B, S, H * hd).to(x.dtype) @ p["wo"], None

    if mode == "prefill":
        # Uniform one-shot prefill: every row holds a whole prompt at
        # positions 0..S-1, so the flash kernel's raw-index causal (and
        # window) mask is the JAX package's position mask.  Its
        # [B, H, S, d] / [B, KV, T, d] layout is made by transposes.
        out = kernel_ops.flash_attention(
            qr.transpose(1, 2).contiguous(), k.transpose(1, 2).contiguous(),
            v.transpose(1, 2).contiguous(), causal=True, window=spec.window)
        y = out.transpose(1, 2).reshape(B, S, H * hd).to(x.dtype) @ p["wo"]
        if cfg.kv_quant == "int8":
            kq, ksc = _quant_i8(k)
            vq, vsc = _quant_i8(v)
            return y, {"k": kq, "v": vq, "k_scale": ksc, "v_scale": vsc}
        return y, {"k": k, "v": v}

    if pages is None:
        if mode != "decode":
            raise ValueError(f"{mode} requires pages= over a block-paged "
                             "cache")
        return _dense_decode(p, cfg, spec, x, q, k, v, cache, pos)

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


def _dense_decode(p, cfg: ModelConfig, spec, x, q, k, v, cache, pos):
    """One new token per row against the dense arena: row b's key and
    value are written in place at ``pos[b, 0]`` of its own row, then row
    b attends its keys at ``t <= pos`` (and ``t > pos - window``)."""
    B, S, _ = x.shape
    ck = cache["k"]
    if ck.shape[0] != B:
        raise ValueError(f"dense decode: cache has {ck.shape[0]} rows for a "
                         f"batch of {B} (a block pool needs pages=)")
    rows = torch.arange(B, device=x.device)
    p_row = pos[:, 0].long()
    _write_kv(cache, rows, p_row, k[:, 0], v[:, 0])
    idx = torch.arange(ck.shape[1], device=x.device)[None, :]
    mask = idx <= p_row[:, None]
    if spec.window is not None:
        mask &= idx > p_row[:, None] - spec.window
    out = _gqa_scores_to_out(q, cache["k"], cache["v"],
                             mask[:, None, None, None, :], **_scales(cache))
    y = out.reshape(B, S, cfg.num_heads * cfg.head_dim).to(x.dtype) \
        @ p["wo"]
    return y, cache


# --------------------------------------------------------------------------
# Recurrent mixers: Mamba and the RWKV-6 time mix
# --------------------------------------------------------------------------

_CHUNKED = ("prefill_chunk", "mixed_step", "ragged_step")


def _recurrent_mode(name: str, mode: str) -> None:
    if mode in _CHUNKED:
        raise NotImplementedError(
            "chunked/unified token-batch steps carry no recurrent state "
            f"across chunks; {name} layers require the dense uniform "
            "prefill path")
    if mode not in ("train", "prefill", "decode"):
        raise NotImplementedError(f"{name} mode {mode!r} is not ported")


def _scan_grads(steps, saved, grads):
    """The backward of a scan kernel: re-run the recurrence step by step
    in plain torch (``steps``, the kernel's plain version: the JAX
    package's ``lax.scan`` step body, which ``jax.grad`` differentiates
    there) on detached copies of the saved inputs, and return
    ``torch.autograd.grad`` of its outputs ``(y, final state)`` against
    the incoming ``grads``.  The final state, which training leaves
    unused, comes with no gradient and is left out."""
    inputs = [t.detach().requires_grad_(True) for t in saved]
    with torch.enable_grad():
        outs = steps(*inputs)
    pairs = [(o, g) for o, g in zip(outs, grads) if g is not None]
    return torch.autograd.grad([o for o, _ in pairs], inputs,
                               [g for _, g in pairs])


class _RWKV6Scan(torch.autograd.Function):
    """``(y, S_T) = _RWKV6Scan.apply(r, k, v, w, u)``: the
    ``rwkv6_scan`` kernel made differentiable in r, k, v, w [B, H, T,
    hd] and u [H, hd] (f32; u's gradient summed over the batch).  The
    forward launches the kernel (the plain version on a CPU tensor); the
    backward is :func:`_scan_grads` — no backward kernel."""

    @staticmethod
    def forward(ctx, r, k, v, w, u):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        return kernel_ops.rwkv6_scan(r, k, v, w, u)

    @staticmethod
    def backward(ctx, g_y, g_state):
        return _scan_grads(_rwkv_kernel.rwkv6_scan_ref, ctx.saved_tensors,
                           (g_y, g_state))


class _MambaScan(torch.autograd.Function):
    """``(y, h_T) = _MambaScan.apply(x, dt, B_t, C_t, A)``: the
    ``mamba_scan`` kernel made differentiable in x, dt [B, T, d], B_t,
    C_t [B, T, n] and A [d, n] (f32), as :class:`_RWKV6Scan`."""

    @staticmethod
    def forward(ctx, x, dt, B_t, C_t, A):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, B_t, C_t, A)
        return kernel_ops.mamba_scan(x, dt, B_t, C_t, A)

    @staticmethod
    def backward(ctx, g_y, g_state):
        return _scan_grads(_mamba_kernel.mamba_scan_ref, ctx.saved_tensors,
                           (g_y, g_state))


def _causal_conv(x, w, b, cache, mode):
    """Depthwise causal conv: x [B,S,d_in], w [d_conv,d_in].  Prefill
    (and train) sums the ``d_conv`` shifted copies of x (zeros before the
    start) and returns a copy of the last ``d_conv-1`` inputs as the
    decode cache; decode convolves the cached inputs and the new token
    and returns the shifted window."""
    d_conv = w.shape[0]
    if mode == "decode":
        window = torch.cat([cache, x], dim=1)               # [B,d_conv,d]
        y = torch.einsum("bcd,cd->bd", window.float(), w.float())[:, None]
        return (y + b).to(x.dtype), window[:, 1:]
    S = x.shape[1]
    xp = F.pad(x, (0, 0, d_conv - 1, 0))
    y = xp[:, 0:S].float() * w[0].float()
    for i in range(1, d_conv):
        y = y + xp[:, i:i + S].float() * w[i].float()
    # a copy, so the cache does not keep the whole [B, S, d_in] input
    return (y + b).to(x.dtype), x[:, -(d_conv - 1):].clone()


def mamba(p, cfg: ModelConfig, spec, x, cache, pos, mode, pages=None):
    """Mamba-1 selective SSM mixer (``repro/models/blocks.py::mamba``).
    Prefill and train run the scan in the ``mamba_scan`` kernel from
    h = 0 (through :class:`_MambaScan`, differentiable); prefill returns
    ``{"conv", "ssm"}`` (the last ``d_conv-1`` conv inputs and the final
    state), train no cache; decode takes one plain-torch step from the
    cached state and writes both leaves in place.  The two halves
    :func:`mamba_in` and :func:`mamba_out`, which a tensor-parallel tier
    runs on each model shard with the ``x_proj`` product all-reduced
    between them."""
    first = mamba_in(p, cfg, spec, x, cache, mode)
    return mamba_out(p, cfg, spec, first, first[2], cache, mode)


def mamba_in(p, cfg: ModelConfig, spec, x, cache, mode) -> tuple:
    """The first half of :func:`mamba`, up to the ``x_proj`` product:
    ``(xi, z, proj, new_conv)`` — the conv branch after its activation,
    the gate branch, ``xi @ x_proj`` ``[B, S, r + 2n]`` and the conv
    window to cache.  On a model shard ``in_proj`` is the ``[d, 2,
    d_in / m]`` view of the shard's channels of both halves
    (:func:`repro_torch.models.sharding.model_shard_params`) and ``proj``
    the shard's partial sum over its ``x_proj`` rows, which the caller
    all-reduces before :func:`mamba_out` slices ``dt``, ``B_t`` and
    ``C_t`` from it."""
    _recurrent_mode("mamba", mode)
    w = p["in_proj"]
    if w.dim() == 3:
        xi, z = x @ w[:, 0], x @ w[:, 1]
    else:
        xi, z = (x @ w).chunk(2, dim=-1)
    xi, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"],
                                cache["conv"] if mode == "decode" else None,
                                mode)
    xi = F.silu(xi)
    return xi, z, xi @ p["x_proj"], new_conv                 # [B,S,r+2n]


def mamba_out(p, cfg: ModelConfig, spec, first, proj, cache, mode):
    """The second half of :func:`mamba` from :func:`mamba_in`'s ``first``
    and the whole ``x_proj`` product ``proj``: the selective scan over
    the channels ``p`` holds, the skip and the gate, then ``out_proj``
    (a model shard's partial over its rows).  Returns ``(y, cache)``."""
    xi, z, _, new_conv = first
    n = spec.d_state
    dt_rank = math.ceil(cfg.d_model / 16)
    dt = F.softplus(proj[..., :dt_rank] @ p["dt_proj"]
                    + p["dt_bias"]).float()                  # [B,S,d_in]
    Bt = proj[..., dt_rank:dt_rank + n].float()              # [B,S,n]
    Ct = proj[..., dt_rank + n:].float()                     # [B,S,n]
    A = -torch.exp(p["A_log"].float())                       # [d_in,n]
    xf = xi.float()

    if mode == "decode":
        h0 = cache["ssm"].float()
        h1 = torch.exp(dt[:, 0, :, None] * A) * h0 \
            + (dt[:, 0] * xf[:, 0])[..., None] * Bt[:, 0, None, :]
        y = torch.einsum("bdn,bn->bd", h1, Ct[:, 0])[:, None]
        cache["ssm"].copy_(h1)
        cache["conv"].copy_(new_conv)
        new_cache = cache
    else:
        # the kernel takes contiguous f32: B_t and C_t are slices of proj
        y, h1 = _MambaScan.apply(xf.contiguous(), dt.contiguous(),
                                 Bt.contiguous(), Ct.contiguous(),
                                 A.contiguous())
        new_cache = None if mode == "train" else {"conv": new_conv,
                                                  "ssm": h1}

    y = y + xf * p["D"].float()
    y = (y * F.silu(z.float())).to(xi.dtype)
    return y @ p["out_proj"], new_cache


def _token_shift(x, x_prev, mode):
    """Each position's previous token: ``x_prev`` [B,1,D] (the cached
    last token) in decode, else x shifted right by one with zeros at the
    start."""
    if mode == "decode":
        return x_prev
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)


def rwkv6(p, cfg: ModelConfig, spec, x, cache, pos, mode, pages=None):
    """RWKV-6 time mix (``repro/models/blocks.py::rwkv6``).  ``x`` is the
    normed layer input; its last token is cached as ``x_prev``.  Prefill
    and train run the WKV recurrence in the ``rwkv6_scan`` kernel from
    the zero state (through :class:`_RWKV6Scan`, differentiable); prefill
    returns ``{"x_prev", "state"}``, train no cache; decode takes one
    step from the cached state and writes both leaves in place.

    The heads are those of ``p``'s ``wr`` columns: on a model shard
    (:func:`repro_torch.models.sharding.model_shard_params`) its ``H /
    m`` heads, with ``w0``, ``bonus`` and ``ln_x`` narrowed to them and
    ``wo``'s rows, so the output is the shard's partial sum; ``x`` and
    ``x_prev`` stay ``d_model`` wide."""
    _recurrent_mode("rwkv6", mode)
    B, S, D = x.shape
    hd = spec.head_dim
    H = p["wr"].shape[-1] // hd      # a model shard's heads: its columns
    xs = _token_shift(x, cache["x_prev"] if mode == "decode" else None,
                      mode)

    def lerp(mix):
        return x + (xs - x) * mix

    r = (lerp(p["mix_r"]) @ p["wr"]).reshape(B, S, H, hd).float()
    k = (lerp(p["mix_k"]) @ p["wk"]).reshape(B, S, H, hd).float()
    v = (lerp(p["mix_v"]) @ p["wv"]).reshape(B, S, H, hd).float()
    g = F.silu(lerp(p["mix_g"]) @ p["wg"])
    # data-dependent decay (the Finch contribution), in f32: w in (0, 1)
    xw = lerp(p["mix_w"])
    w = torch.exp(-torch.exp((p["w0"] + torch.tanh(xw @ p["wA"]) @ p["wB"])
                             .float())).reshape(B, S, H, hd)
    u = p["bonus"].float()                                   # [H, hd]

    if mode == "decode":
        s0 = cache["state"].float()
        kv = k[:, 0, :, :, None] * v[:, 0, :, None, :]       # [B,H,hd,hd]
        y = torch.einsum("bhk,bhkv->bhv", r[:, 0],
                         s0 + u[..., None] * kv)[:, None]
        cache["state"].copy_(w[:, 0, :, :, None] * s0 + kv)
        cache["x_prev"].copy_(x[:, -1:])
        new_cache = cache
    else:
        y, s1 = _RWKV6Scan.apply(
            *(t.transpose(1, 2).contiguous() for t in (r, k, v, w)), u)
        y = y.transpose(1, 2)                                # [B,S,H,hd]
        # a copy, so the cache does not keep the whole [B, S, D] input
        new_cache = None if mode == "train" else {
            "x_prev": x[:, -1:].clone(), "state": s1}

    # per-head group norm (population variance), then gate + projection
    mean = y.mean(dim=-1, keepdim=True)
    var = y.var(dim=-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 64e-5)
    y = y.reshape(B, S, H * hd) * p["ln_x"].float()
    out = (y.to(x.dtype) * g) @ p["wo"]
    return out, new_cache


MIXERS = {"attn": attention, "mamba": mamba, "rwkv6": rwkv6}


# --------------------------------------------------------------------------
# FFN and layer
# --------------------------------------------------------------------------


def rwkv_cmix(p, cfg: ModelConfig, spec, x, cache, mode):
    """RWKV-6 channel mix (the ``rwkv_cmix`` branch of the JAX
    ``dense_ffn``): token-shift lerp, squared-relu key, receptance gate.
    Returns (y, cache): prefill (and train) a new ``{"x_prev"}``, decode
    the same cache with ``x_prev`` written in place."""
    gate, kv, new_cache = rwkv_cmix_parts(p, cfg, spec, x, cache, mode)
    return gate * kv, new_cache


def rwkv_cmix_parts(p, cfg: ModelConfig, spec, x, cache, mode):
    """:func:`rwkv_cmix` before its product: ``(sigmoid(xr @ wr),
    relu(xk @ wk)² @ wv, cache)``.  On a model shard the key and value
    split ``ffn``, so the second is a partial sum to all-reduce, and the
    receptance ``wr`` splits its output columns, so the first is the
    shard's columns of the gate, which multiplies the whole sum."""
    _recurrent_mode("rwkv_cmix", mode)
    xs = _token_shift(x, cache["x_prev"] if mode == "decode" else None,
                      mode)
    xk = x + (xs - x) * p["mix_k"]
    xr = x + (xs - x) * p["mix_r"]
    kv = torch.square(F.relu(xk @ p["wk"])) @ p["wv"]
    gate = torch.sigmoid(xr @ p["wr"])
    if mode == "decode":
        cache["x_prev"].copy_(x[:, -1:])
        return gate, kv, cache
    return gate, kv, {"x_prev": x[:, -1:].clone()}


def dense_ffn(p, cfg: ModelConfig, spec, x):
    if spec.act == "swiglu":
        h = F.silu(x @ p["wi0"]) * (x @ p["wi1"])
    elif spec.act == "gelu":
        h = F.gelu(x @ p["wi"], approximate="tanh")   # jax.nn.gelu default
    else:
        raise NotImplementedError(
            f"ffn act {spec.act!r} is not a stateless FFN"
            + (" (the channel mix is rwkv_cmix)" if spec.act == "rwkv_cmix"
               else ""))
    return h @ p["wo"]


def _moe_group(p, spec, x):
    """The ``N = B·S`` token slots, padding included, in ``G`` groups of
    ``gs = min(1024, N)``: (xg [G, gs, d], router logits [G, gs, E] f32,
    cap = :func:`moe_capacity`)."""
    B, S, D = x.shape
    gs = min(MOE_GROUP_SIZE, B * S)
    xg = x.reshape(B * S // gs, gs, D)
    return xg, moe_logits(p, xg), moe_capacity(spec, gs)


def moe_logits(p, x):
    """The router logits of ``x``'s token slots, ``[..., E]`` f32."""
    return (x @ p["router"]).float()


def moe_capacity(spec, gs: int) -> int:
    """An expert's queue length in a group of ``gs`` token slots:
    ``min(gs, max(1, ceil(gs·k·capacity_factor / E)))``."""
    return min(max(1, int(math.ceil(
        gs * spec.top_k * spec.capacity_factor / spec.num_experts))), gs)


def _moe_experts(p, spec, x, dest, w, rows_per_expert: int, *, inplace):
    """Dispatch, expert products and combine of the ``N`` token slots of
    ``x`` [N, d].  A kept pair's ``dest`` [N, k] is its row of expert
    ``e``'s ``rows_per_expert`` in the dense ``[E, rows_per_expert, d]``
    capacity buffer (``e · G·cap + g·cap + rank`` for ``x``'s own route);
    a dropped pair's is the spare last row (written by
    every dropped pair, read by no expert) and its ``w`` is 0.
    ``inplace`` scatters into the buffer and writes the experts' products
    through ``out=``; autograd follows neither, so training passes
    False.  Returns [N, d]."""
    N, D = x.shape
    E, K = p["wo"].shape[0], spec.top_k     # the experts held here
    rows = E * rows_per_expert
    dest = dest.reshape(-1)
    src = x[:, None, :].expand(N, K, D).reshape(-1, D)
    if inplace:
        buf = x.new_zeros(rows + 1, D)
        buf[dest] = src
    else:
        buf = x.new_zeros(rows + 1, D).index_put((dest,), src)
    xin = buf[:-1].view(E, rows_per_expert, D)
    if spec.act == "swiglu":
        h = F.silu(torch.bmm(xin, p["wi0"])) * torch.bmm(xin, p["wi1"])
    elif spec.act == "gelu":
        h = F.gelu(torch.bmm(xin, p["wi"]), approximate="tanh")
    else:
        raise NotImplementedError(f"moe act {spec.act!r} is not ported")
    # the experts' rows, then a zero spare row that dropped pairs read
    if inplace:
        eout = x.new_empty(rows + 1, D)
        torch.bmm(h, p["wo"], out=eout[:-1].view(E, rows_per_expert, D))
        eout[-1].zero_()
    else:
        eout = torch.cat([torch.bmm(h, p["wo"]).reshape(rows, D),
                          x.new_zeros(1, D)])
    # combine: each token's picks, weighted by their gates (0 if dropped)
    out = (w.reshape(-1, 1).to(x.dtype) * eout[dest]).view(N, K, D)
    return out.sum(1)


def _shard_picks(dest, w, lo: int, experts: int, rows_per_expert: int):
    """A model shard's picks of an expert-parallel MoE layer: the pairs
    routed to its ``experts`` experts from expert ``lo`` on keep their
    row of the shard's own ``[experts, G·cap, d]`` capacity buffer, in
    local ids; every other pair (another shard's, or dropped) goes to the
    buffer's spare last row with weight 0.  A pair's queue rank is its
    rank in its expert's queue, which no other expert's picks change, so
    the kept rows are the unsharded buffer's rows of these experts."""
    n = experts * rows_per_expert
    local = dest - lo * rows_per_expert
    keep = (local >= 0) & (local < n)
    return torch.where(keep, local, n), torch.where(keep, w,
                                                   torch.zeros_like(w))


def moe_ffn(p, cfg: ModelConfig, spec, x, shard: int = 0, route=None,
            train: bool = False):
    """GShard-style token-choice top-k MoE (``repro/models/blocks.py::
    moe_ffn``), routed and ranked by the ``moe_route`` kernel.

    The token slots split into groups (:func:`_moe_group`).  Each token
    picks its top ``k`` experts (renormalised gates); a (token, pick)
    pair's place in its expert's queue is its rank in (slot, pick) order
    over the group, and pairs at rank ``>= cap`` are dropped — their
    gate is not renormalised again.  One launch gives each pair's row of
    the dense ``[E, G·cap, d]`` capacity buffer (a spare last row when
    dropped) and its combine weight (0 when dropped).  The JAX package's
    one-hot dispatch and combine einsums become an index scatter into
    that buffer and a weighted sum over each token's picks
    (:func:`_moe_experts`): dispatch is 0/1 and every (expert, slot)
    holds at most one token, so the function is the same and only the
    order of the combine's sum differs.  The expert products stay
    batched matrix products over the capacity buffer.

    ``route = (dest, w, rows)`` hands in the routing of ``x``'s token
    slots instead (``dest``/``w`` [B·S, k], into a capacity buffer of
    ``rows`` rows an expert): a data shard's share of a route taken over
    the whole tier's batch
    (:func:`repro_torch.models.transformer.route_data_shards`).

    Serving reads only the output; training calls
    :func:`moe_ffn_train`, which also returns the load-balance and z
    aux losses.

    On model shard ``shard`` of a tensor-parallel tier, ``p`` holds the
    shard's slice and the result is its partial sum, which the caller
    all-reduces.  Expert-parallel (``p`` holds fewer experts than the
    layer's): the shard routes its copy of the input over every expert
    with the replicated router, in one ``moe_route`` launch, and keeps
    the picks of its own experts (:func:`_shard_picks`); the other
    pairs add nothing.  ``ffn`` split inside every expert: every shard
    routes alike and computes its slice of each expert's hidden units.
    ``train`` keeps the dispatch and the products out of place, so that
    autograd follows them (a sharded train step hands in its route,
    :func:`moe_train_route`).
    """
    if route is None:
        xg, logits, cap = _moe_group(p, spec, x)
        _, _, dest, w = kernel_ops.moe_route(logits, spec.top_k, cap)
        route = (dest, w, xg.shape[0] * cap)
    dest, w, rows = route
    held = p["wo"].shape[0]
    if held < spec.num_experts:
        dest, w = _shard_picks(dest, w, shard * held, held, rows)
    return _moe_experts(p, spec, x.reshape(-1, x.shape[-1]), dest, w,
                        rows, inplace=not train).reshape(x.shape)


def moe_train_route(spec, logits):
    """The train route of router logits ``[G, gs, E]`` (f32, grouped):
    ``(dest, w, rows, aux)``, differentiable in ``logits`` through ``w``.

    The ``moe_route`` kernel routes ``logits.detach()``: its ``idx`` and
    ``dest`` are integer decisions.  The gates are recomputed from
    ``softmax(logits)`` gathered at ``idx`` and renormalised (as the JAX
    package takes them from ``lax.top_k`` of the probabilities), so the
    gradient reaches the router, and zeroed where the pair was dropped;
    ``rows = G·cap`` rows an expert.  ``aux`` is the JAX package's
    Switch-Transformer pair over all ``G·gs`` slots:
    ``lb_loss = E·Σ_e mean(probs_e)·mean(kept picks of e)`` and
    ``z_loss = mean(logsumexp(logits)²)``."""
    E = spec.num_experts
    G, gs = logits.shape[:2]
    cap = moe_capacity(spec, gs)
    _, idx, dest, _ = kernel_ops.moe_route(logits.detach(), spec.top_k, cap)
    probs = torch.softmax(logits, dim=-1)
    gates = probs.gather(-1, idx.long())                     # [G, gs, K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    kept = dest != E * G * cap
    w = torch.where(kept, gates, torch.zeros_like(gates))
    picks = F.one_hot(idx.long(), E).float() * kept[..., None].float()
    lb = E * (probs.mean(dim=(0, 1)) * picks.sum(2).mean(dim=(0, 1))).sum()
    z = torch.logsumexp(logits, dim=-1).square().mean()
    return dest, w, G * cap, {"lb_loss": lb, "z_loss": z}


def moe_ffn_train(p, cfg: ModelConfig, spec, x):
    """:func:`moe_ffn` for training: (y, aux), differentiable in x and
    every weight, the router included (:func:`moe_train_route`)."""
    xg, logits, _ = _moe_group(p, spec, x)
    dest, w, rows, aux = moe_train_route(spec, logits)
    y = _moe_experts(p, spec, xg.reshape(-1, xg.shape[-1]), dest, w, rows,
                     inplace=False)
    return y.reshape(x.shape), aux


def zero_aux(device) -> dict:
    return {"lb_loss": torch.zeros((), device=device),
            "z_loss": torch.zeros((), device=device)}


def train_ffn(p, cfg: ModelConfig, spec, x):
    """The layer's FFN in train mode: (y, aux)."""
    if spec.kind == "moe":
        return moe_ffn_train(p, cfg, spec, x)
    if spec.act == "rwkv_cmix":
        return rwkv_cmix(p, cfg, spec, x, None, "train")[0], \
            zero_aux(x.device)
    return dense_ffn(p, cfg, spec, x), zero_aux(x.device)


def apply_ffn(p, cfg: ModelConfig, spec, x, cache, mode, route=None):
    """The layer's FFN: (y, cache) — the channel mix's token-shift cache,
    or ``{}`` for the stateless FFNs.  ``route``: a MoE layer's routing
    handed in (:func:`moe_ffn`)."""
    if spec.kind == "moe":
        return moe_ffn(p, cfg, spec, x, route=route), {}
    if spec.act == "rwkv_cmix":
        return rwkv_cmix(p, cfg, spec, x, cache, mode)
    return dense_ffn(p, cfg, spec, x), {}


def mixer_half(p, cfg: ModelConfig, layer, x, cache, pos, mode,
               pages=None):
    """A layer's first residual half, ``x + mixer(norm1(x))``: returns
    (x, ``norm2(x)`` — the FFN half's input —, the mixer's new or
    in-place-updated cache).  ``cache`` is the mixer's (None in prefill
    and train)."""
    if layer.mixer.kind not in MIXERS or layer.ffn.kind not in ("dense",
                                                               "moe"):
        raise NotImplementedError(
            f"{layer.mixer.kind}/{layer.ffn.kind} layers are not ported")
    h = rmsnorm(x, p["norm1"], cfg.norm_eps)
    y, new_mix = MIXERS[layer.mixer.kind](p["mixer"], cfg, layer.mixer, h,
                                          cache, pos, mode, pages=pages)
    x = x + y
    return x, rmsnorm(x, p["norm2"], cfg.norm_eps), new_mix


def ffn_half(p, cfg: ModelConfig, layer, x, h, cache, mode, route=None):
    """A layer's second residual half, ``x + ffn(h)`` with ``h`` from
    :func:`mixer_half`: returns (x, the FFN's cache) — in train mode
    (x, aux), the FFN's ``{"lb_loss", "z_loss"}``."""
    if mode == "train":
        y, aux = train_ffn(p["ffn"], cfg, layer.ffn, h)
        return x + y, aux
    y, new_ffn = apply_ffn(p["ffn"], cfg, layer.ffn, h, cache, mode,
                           route=route)
    return x + y, new_ffn


def apply_layer(p, cfg: ModelConfig, layer, x, cache, pos, mode,
                pages=None):
    """Pre-norm residual layer: x + mixer(norm(x)); x + ffn(norm(x)).
    ``cache`` is the layer's ``{"mixer", "ffn"}`` slot (None in prefill
    and train); returns (x, the layer's new or in-place-updated slot) —
    in train mode (x, aux), the FFN's ``{"lb_loss", "z_loss"}``."""
    x, h, new_mix = mixer_half(p, cfg, layer, x,
                               cache.get("mixer") if cache else None, pos,
                               mode, pages)
    x, new_ffn = ffn_half(p, cfg, layer, x, h,
                          cache.get("ffn") if cache else None, mode)
    if mode == "train":
        return x, new_ffn
    return x, {"mixer": new_mix, "ffn": new_ffn}
