"""Unified mixed prefill+decode paged attention: CUDA launcher and plain
version.

The padded token batch of the unified executor: each row contributes a
width-``C`` slice of the tick's work — its next prefill chunk
(``q_len = C`` or the shorter final tail), its single decode token
(``q_len = 1``), or nothing (``q_len = 0``, a stalled or idle row).  Row
``b``'s slot ``i`` sits at position ``q_start[b] + i`` and attends the
keys at ``t <= q_start[b] + i`` (windowed if asked) through its page
table.  Slots ``i >= q_len[b]`` output zeros.  int8 pools dequantize with
per-token scales.

``csrc/mixed_attention.cu`` replaces the TPU kernel
``repro/kernels/mixed_attention.py::mixed_attention`` (which
``prefill_attention.py::paged_prefill_attention`` delegates to).  The
TPU grid kept one ``[C * G, hd]`` accumulator per (row, head) in VMEM
across an ordered page sweep; here each (row, slot, KV head) is a block
whose warps walk that slot's visible pages side by side
(``csrc/paged_attend.cuh``; the paged decode and ragged kernels moved
to the tensor-core tile body of ``csrc/paged_tile.cuh``).

:func:`mixed_attention` launches the kernel on CUDA tensors only;
:func:`mixed_attention_ref` is the plain PyTorch version (the CPU path
and the kernel's oracle).  Model code calls the dispatching wrappers
``repro_torch.kernels.ops.mixed_attention`` and
``ops.paged_prefill_attention``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels
from repro_torch.kernels.paged_attention import (KV_DTYPES, Q_DTYPES,
                                                 check_paged_args,
                                                 gather_pages)

_SIG = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_void_p])


def mixed_attention_ref(q, k_pages, v_pages, page_table, q_start, q_len, *,
                        k_scale=None, v_scale=None, window=None):
    """Gather-then-attend version of the mixed kernel (a twin of the JAX
    package's ``kernels/ref.py::mixed_attention_ref``, which delegates to
    ``paged_prefill_attention_ref``: the same function).

    q [B, C, KV, G, hd]; k_pages/v_pages [N, bs, KV, hd] (int8 with
    scales [N, bs, KV], or float); page_table [B, P] int32; q_start,
    q_len [B] int32.  Returns [B, C, KV, G, hd] in q's dtype, zeros at
    slots ``i >= q_len[b]``.
    """
    B, C, KV, G, hd = q.shape
    k, v = gather_pages(k_pages, v_pages, page_table, k_scale, v_scale)
    scale = 1.0 / math.sqrt(hd)
    T = k.shape[1]
    s = torch.einsum("bckgd,btkd->bkgct", q.float(), k) * scale
    slot = torch.arange(C, device=q.device)
    pos_q = q_start.long()[:, None] + slot[None, :]            # [B, C]
    t_idx = torch.arange(T, device=q.device)[None, None, None, None, :]
    pq = pos_q[:, None, None, :, None]
    mask = t_idx <= pq
    if window is not None:
        mask &= t_idx > pq - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgct,btkd->bckgd", p, v)
    valid = (slot[None, :] < q_len.long()[:, None])[:, :, None, None, None]
    return torch.where(valid, out, torch.zeros_like(out)).to(q.dtype)


def mixed_attention(q, k_pages, v_pages, page_table, q_start, q_len, *,
                    k_scale=None, v_scale=None, window=None):
    """The CUDA kernel (same arguments as :func:`mixed_attention_ref`;
    every tensor contiguous and on one card).  Every live slot's own key
    must already be scattered into the pool."""
    name = "mixed_attention"
    KV, G, hd, P, bs = check_paged_args(
        name, q, k_pages, v_pages, page_table, k_scale, v_scale, window,
        q_dims=5)
    kernels.require_cuda(name, q, q_start, q_len)
    B, C = q.shape[:2]
    for t, nm in ((q_start, "q_start"), (q_len, "q_len")):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"{name}: {nm} must be int32 [B={B}]")
    out = torch.empty_like(q)
    fn = kernels.load(name).mixed_attention
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    p = kernels.ptr
    err = fn(p(q), p(k_pages), p(v_pages), p(k_scale), p(v_scale),
             p(page_table), p(q_start), p(q_len), p(out), B, C, KV, G, hd,
             P, bs, 0 if window is None else int(window), Q_DTYPES[q.dtype],
             KV_DTYPES[k_pages.dtype], kernels.stream_handle(q.device))
    kernels.check_launch(err, name)
    return out
