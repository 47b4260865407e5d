"""Ragged flat token-batch paged attention: CUDA launcher and plain
version.

The tick's live tokens pack **contiguously** into one flat ``[W]`` axis
— row ``b`` owns flat slots ``[row_start[b], row_start[b] + q_len[b])``
where ``row_start`` is the exclusive prefix sum of ``q_len`` and
``q_len[b]`` is any value in ``[0, C]``.  ``W`` is the live-token total
padded up to the engine's bucket width, so compute scales with what is
actually live, not ``rows × chunk``.  Flat slot ``t`` of row ``b`` sits
at absolute position ``q_start[b] + t - row_start[b]`` and attends its
row's keys (causal, optionally windowed) through the row's page table;
padding slots output zeros.  int8 pools dequantize with per-token
scales.

``csrc/ragged_attention.cu`` replaces the TPU kernel
``repro/kernels/ragged_attention.py::ragged_attention``.  The TPU design
flattened the (tile, row) incidence into a host-side work list so a
sequential grid could keep each output tile resident; CUDA blocks run in
parallel, so the kernel instead gives each (flat token, KV head) its own
block, which finds its row from the prefix sum of ``q_len`` itself.

:func:`ragged_attention` launches the kernel on CUDA tensors only;
:func:`ragged_attention_ref` is the plain PyTorch version (the CPU path
and the kernel's oracle).  Model code calls the dispatching wrapper
``repro_torch.kernels.ops.ragged_attention``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels

_Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SIG = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p])


def ragged_attention_ref(q, k_pages, v_pages, page_table, q_start, q_len,
                         *, k_scale=None, v_scale=None, window=None):
    """Gather-then-attend version of the ragged kernel (a twin of the JAX
    package's ``kernels/ref.py::ragged_attention_ref``).

    q [W, KV, G, hd]; k_pages/v_pages [N, bs, KV, hd] (int8 with scales
    [N, bs, KV], or float); page_table [R, P] int32; q_start, q_len [R]
    int32.  Returns [W, KV, G, hd] in q's dtype, zeros past sum(q_len).
    """
    W, KV, G, hd = q.shape
    R, P = page_table.shape
    bs = k_pages.shape[1]
    pt = page_table.long()
    k = k_pages[pt].float()                           # [R,P,bs,KV,hd]
    v = v_pages[pt].float()
    if k_scale is not None:
        k = k * k_scale[pt].float()[..., None]
        v = v * v_scale[pt].float()[..., None]
    T = P * bs
    k = k.reshape(R, T, KV, hd)
    v = v.reshape(R, T, KV, hd)
    q_len = q_len.long()
    csum = torch.cumsum(q_len, 0)
    tok = torch.arange(W, device=q.device)
    row = torch.searchsorted(csum, tok, right=True).clamp(max=R - 1)
    valid = tok < csum[-1]
    row_start = csum - q_len
    pos_q = q_start.long()[row] + (tok - row_start[row])     # [W]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("wkgd,wtkd->wkgt", q.float(), k[row]) * scale
    t_idx = torch.arange(T, device=q.device)[None, None, None, :]
    pq = pos_q[:, None, None, None]
    mask = t_idx <= pq
    if window is not None:
        mask &= t_idx > pq - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("wkgt,wtkd->wkgd", p, v[row])
    out = torch.where(valid[:, None, None, None], out, torch.zeros_like(out))
    return out.to(q.dtype)


def ragged_attention(q, k_pages, v_pages, page_table, q_start, q_len, *,
                     k_scale=None, v_scale=None, window=None):
    """The CUDA kernel (same arguments as :func:`ragged_attention_ref`;
    every tensor contiguous and on one card).  Every live query's own
    key must already be scattered into the pool."""
    name = "ragged_attention"
    kernels.require_cuda(name, q, k_pages, v_pages, page_table, q_start,
                         q_len, k_scale, v_scale)
    if q.dim() != 4 or k_pages.dim() != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: q [W,KV,G,hd] and pools [N,bs,KV,hd] "
                         f"expected, got {tuple(q.shape)} / "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    W, KV, G, hd = q.shape
    N, bs, KVp, hdp = k_pages.shape
    R, P = page_table.shape
    if (KVp, hdp) != (KV, hd):
        raise ValueError(f"{name}: pool heads/dim {(KVp, hdp)} != q's "
                         f"{(KV, hd)}")
    if q.dtype not in _Q_DTYPES or k_pages.dtype not in _KV_DTYPES \
            or v_pages.dtype != k_pages.dtype:
        raise TypeError(f"{name}: unsupported dtypes q={q.dtype} "
                        f"k={k_pages.dtype} v={v_pages.dtype}")
    if (k_pages.dtype == torch.int8) != (k_scale is not None) \
            or (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: int8 pools need k_scale and v_scale "
                         "(and float pools take none)")
    if k_scale is not None and (
            tuple(k_scale.shape) != (N, bs, KV)
            or tuple(v_scale.shape) != (N, bs, KV)
            or k_scale.dtype != torch.float32
            or v_scale.dtype != torch.float32):
        raise ValueError(f"{name}: scales must be f32 [N, bs, KV]")
    for t, nm in ((page_table, "page_table"), (q_start, "q_start"),
                  (q_len, "q_len")):
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: {nm} must be int32, got {t.dtype}")
    if tuple(q_start.shape) != (R,) or tuple(q_len.shape) != (R,):
        raise ValueError(f"{name}: q_start/q_len must be [R={R}]")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive")
    out = torch.empty_like(q)
    fn = kernels.load(name).ragged_attention
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    p = kernels.ptr
    err = fn(p(q), p(k_pages), p(v_pages), p(k_scale), p(v_scale),
             p(page_table), p(q_start), p(q_len), p(out),
             W, KV, G, hd, R, P, bs, 0 if window is None else int(window),
             _Q_DTYPES[q.dtype], _KV_DTYPES[k_pages.dtype],
             kernels.stream_handle(q.device))
    kernels.check_launch(err, name)
    return out
