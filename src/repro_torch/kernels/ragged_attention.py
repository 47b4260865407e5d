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
parallel, so each block finds its own work item — ``64 // G`` consecutive
tokens of one row and one KV head — by scanning ``ceil(q_len / BT)`` over
the rows, and attends it with the tensor-core tile body of
``csrc/paged_tile.cuh`` (shared with the paged decode kernel): the
item's (token, query head) pairs are the rows of 3xTF32 ``mma.sync``
tiles, so one page read serves the whole token tile.  Where the grid
would leave the card idle (a decode tick), an item's visible pages split
across ``plan_page_splits`` blocks and a second kernel merges them.

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
from repro_torch.kernels.paged_attention import (
    KV_DTYPES, Q_DTYPES, TILE_ROWS, check_aligned, check_paged_args,
    check_tile_shape, gather_pages, plan_page_splits, sm_count,
    split_workspace)

_SIG = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 11 + [ctypes.c_void_p])


def work_items(W: int, R: int, G: int) -> int:
    """The ragged kernel's grid x: ``ceil(W / BT) + R`` with ``BT = 64 //
    G`` tokens an item, a bound on the work items of any ``q_len`` that
    packs into ``W`` slots over ``R`` rows."""
    return -(-W // (TILE_ROWS // G)) + R


def ragged_attention_ref(q, k_pages, v_pages, page_table, q_start, q_len,
                         *, k_scale=None, v_scale=None, window=None):
    """Gather-then-attend version of the ragged kernel (a twin of the JAX
    package's ``kernels/ref.py::ragged_attention_ref``).

    q [W, KV, G, hd]; k_pages/v_pages [N, bs, KV, hd] (int8 with scales
    [N, bs, KV], or float); page_table [R, P] int32; q_start, q_len [R]
    int32.  Returns [W, KV, G, hd] in q's dtype, zeros past sum(q_len).
    """
    W, KV, G, hd = q.shape
    R = page_table.shape[0]
    k, v = gather_pages(k_pages, v_pages, page_table, k_scale, v_scale)
    T = k.shape[1]
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
                     k_scale=None, v_scale=None, window=None, splits=None):
    """The CUDA kernel (same arguments as :func:`ragged_attention_ref`;
    every tensor contiguous and on one card).  Every live query's own
    key must already be scattered into the pool.  ``splits`` overrides
    :func:`plan_page_splits` (the tests force 1 and many)."""
    name = "ragged_attention"
    check_tile_shape(name, q)
    KV, G, hd, P, bs = check_paged_args(
        name, q, k_pages, v_pages, page_table, k_scale, v_scale, window,
        q_dims=4, row_per_query=False)
    kernels.require_cuda(name, q, q_start, q_len)
    W, R = q.shape[0], page_table.shape[0]
    for t, nm in ((q_start, "q_start"), (q_len, "q_len")):
        if t.dtype != torch.int32 or tuple(t.shape) != (R,):
            raise ValueError(f"{name}: {nm} must be int32 [R={R}]")
    check_aligned(name, q, k_pages, v_pages)
    if splits is None:
        splits = plan_page_splits(work_items(W, R, G), KV, P, bs, hd,
                                  sm_count(q.device.index))
    out = torch.empty_like(q)
    ws_acc, ws_ml = split_workspace(splits, W, KV, G, hd, q.device)
    fn = kernels.load(name).ragged_attention
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    p = kernels.ptr
    err = fn(p(q), p(k_pages), p(v_pages), p(k_scale), p(v_scale),
             p(page_table), p(q_start), p(q_len), p(out), p(ws_acc),
             p(ws_ml), W, KV, G, hd, R, P, bs,
             0 if window is None else int(window), splits,
             Q_DTYPES[q.dtype], KV_DTYPES[k_pages.dtype],
             kernels.stream_handle(q.device))
    kernels.check_launch(err, name)
    return out
