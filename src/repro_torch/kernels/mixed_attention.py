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
across an ordered page sweep; here the padded rows are the ragged
kernel's work items at a fixed stride — ``64 // G`` consecutive slots of
one row and one KV head a block — attended by the tensor-core tile body
of ``csrc/paged_tile.cuh`` (shared with the ragged and paged decode
kernels), and where the grid would leave the card idle an item's pages
split across ``plan_page_splits`` blocks that a second kernel merges for
the live slots.  The tile body takes head widths
``TILE_HEAD_DIMS = (32, 64, 112, 128, 256)`` (not every multiple of 32
up to 256) and at most 64 query heads per KV head; every registered
config is inside that: gemma3 256, phi4, jamba, starcoder2, qwen2-vl and
moonshot 128, kimi 112, granite and musicgen 64.

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
from repro_torch.kernels.paged_attention import (
    KV_DTYPES, Q_DTYPES, TILE_ROWS, check_aligned, check_paged_args,
    check_tile_shape, gather_pages, plan_page_splits, rows_work,
    split_workspace)

_SIG = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [ctypes.c_void_p])


def work_items(B: int, C: int, G: int) -> int:
    """The mixed kernel's grid x: ``B * ceil(C / BT)`` tiles of ``BT = 64
    // G`` slots, each row's ``C`` slots cut into whole tiles."""
    return B * -(-C // (TILE_ROWS // G))


def mixed_attention_work(q, k_pages, v_pages, page_table, q_start, q_len,
                         *, k_scale=None, v_scale=None, window=None,
                         exact: bool = False):
    """The work of one :func:`mixed_attention` call (same arguments;
    ``paged_attention.rows_work``): row ``b``'s first ``q_len[b]``
    slots at their positions, or from shapes alone every ``[B, C]``
    slot."""
    return rows_work(q, k_pages, page_table, q_start, q_len,
                     q.shape[0] * q.shape[1], window=window,
                     k_scale=k_scale, exact=exact)


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
                    k_scale=None, v_scale=None, window=None, splits=None):
    """The CUDA kernel (same arguments as :func:`mixed_attention_ref`;
    every tensor contiguous and on one card; hd in ``TILE_HEAD_DIMS``, at
    most 64 query heads per KV head).  Every live slot's own key must
    already be scattered into the pool.  ``splits`` overrides
    :func:`plan_page_splits` (the tests force 1 and many)."""
    name = "mixed_attention"
    check_tile_shape(name, q)
    KV, G, hd, P, bs = check_paged_args(
        name, q, k_pages, v_pages, page_table, k_scale, v_scale, window,
        q_dims=5)
    kernels.require_cuda(name, q, q_start, q_len)
    B, C = q.shape[:2]
    for t, nm in ((q_start, "q_start"), (q_len, "q_len")):
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"{name}: {nm} must be int32 [B={B}]")
    check_aligned(name, q, k_pages, v_pages)
    if splits is None:
        splits = plan_page_splits(work_items(B, C, G), KV, P, bs, hd,
                                  kernels.sm_count(q.device.index))
    out = torch.empty_like(q)
    ws_acc, ws_ml = split_workspace(splits, B * C, KV, G, hd, q.device)
    fn = kernels.load(name).mixed_attention
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    p = kernels.ptr
    with kernels.device_guard(q.device):
        err = fn(p(q), p(k_pages), p(v_pages), p(k_scale), p(v_scale),
                 p(page_table), p(q_start), p(q_len), p(out), p(ws_acc),
                 p(ws_ml), B, C, KV, G, hd, P, bs,
                 0 if window is None else int(window), splits,
                 Q_DTYPES[q.dtype], KV_DTYPES[k_pages.dtype],
                 kernels.stream_handle(q.device))
    kernels.check_launch(err, name)
    return out
