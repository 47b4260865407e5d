"""Paged flash-decode attention: CUDA launcher and plain version.

One new token per row attends its own pages of a block-paged KV pool
``[N, bs, KV, hd]``: row ``b``'s query sits at position ``pos[b]`` and
attends the keys at ``t <= pos[b]`` (and ``t > pos[b] - window`` with a
sliding window) gathered through its page table.  int8 pools dequantize
with per-token scales.  A row whose page-table row is all zeros attends
the null block 0; the split executor masks mid-prefill rows that way and
discards their output.

``csrc/paged_attention.cu`` replaces the TPU kernel
``repro/kernels/paged_attention.py::paged_attention``.  The TPU grid
swept a row's pages in order with its online-softmax state in VMEM; here
a row is one work item of the tensor-core tile body
``csrc/paged_tile.cuh`` (shared with the ragged kernel): its G query
heads are the live rows of 3xTF32 ``mma.sync`` tiles, K/V pages arrive
by double-buffered ``cp.async``, and a row's visible pages split across
``plan_page_splits`` blocks, whose states a second kernel merges in a
fixed order.

:func:`paged_attention` launches the kernel on CUDA tensors only;
:func:`paged_attention_ref` is the plain PyTorch version (the CPU path
and the kernel's oracle).  Model code calls the dispatching wrapper
``repro_torch.kernels.ops.paged_attention``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import kernels

Q_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
KV_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_SIG = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_void_p])

# the tile body of csrc/paged_tile.cuh: the head widths it is built for
# and the MMA rows of a block ((token, query head) pairs)
TILE_HEAD_DIMS = (32, 64, 112, 128, 256)
TILE_ROWS = 64


def kv_tile_keys(hd: int) -> int:
    """Keys of one K/V tile of the body at head width ``hd``."""
    return 64 if hd <= 64 else 32


def plan_page_splits(items: int, KV: int, P: int, bs: int, hd: int,
                     sms: int) -> int:
    """How many blocks share one work item's visible pages, from shapes
    the host knows without reading the device: ``items`` work items (B
    rows of a decode, or the ragged grid's ``ceil(W / BT) + R``) times
    ``KV`` heads is the unsplit grid, on a card of ``sms`` SMs.  One
    split when that grid already gives 2 blocks per SM; otherwise as many
    as fit in 2 blocks per SM (one wave: blocks past it queue behind the
    first wave; times by split count come from
    ``scripts/torch_paged_splits.py``), but never so many that a split
    would get fewer than 2 of the ``ceil(P * bs / BK)`` K/V tiles a row's
    page table spans."""
    blocks = items * KV
    target = 2 * sms
    if blocks >= target:
        return 1
    tiles = -(-P * bs // kv_tile_keys(hd))
    return max(1, min(target // blocks, tiles // 2))


def check_tile_shape(name, q):
    """The tile body's limits on q [..., KV, G, hd], checked before
    anything needs a card: hd one of ``TILE_HEAD_DIMS`` and at most
    ``TILE_ROWS`` query heads per KV head."""
    G, hd = q.shape[-2:]
    if hd not in TILE_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {hd} is not supported; the "
                         f"kernel is built for head_dim in {TILE_HEAD_DIMS}")
    if G > TILE_ROWS:
        raise ValueError(f"{name}: {G} query heads per KV head; at most "
                         f"{TILE_ROWS} are supported")


def check_aligned(name, *tensors):
    """The tile body copies 16-byte vectors of q and the pools."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: q and the pools must start on a 16-byte "
                         "boundary")


def split_workspace(splits: int, slots: int, KV: int, G: int, hd: int,
                    device):
    """The split kernels' (acc, (m, l)) workspace, or (None, None) for one
    split."""
    if splits == 1:
        return None, None
    rows = splits * slots * KV * G
    return (torch.empty(rows * hd, dtype=torch.float32, device=device),
            torch.empty(rows * 2, dtype=torch.float32, device=device))


def gather_pages(k_pages, v_pages, page_table, k_scale, v_scale):
    """Each row's keys and values through its page table, in f32 and
    dequantized: ``[R, P * bs, KV, hd]`` each."""
    R, P = page_table.shape
    pt = page_table.long()
    k = k_pages[pt].float()                           # [R,P,bs,KV,hd]
    v = v_pages[pt].float()
    if k_scale is not None:
        k = k * k_scale[pt].float()[..., None]
        v = v * v_scale[pt].float()[..., None]
    T = P * k_pages.shape[1]
    return (k.reshape(R, T, *k_pages.shape[2:]),
            v.reshape(R, T, *v_pages.shape[2:]))


def attention_rate(q, k_pages) -> str:
    """The rate kind of the tile body's products: 3xTF32 on f32 q and
    pools, one TF32 product on bf16 (or int8) ones."""
    f32 = q.dtype == torch.float32 and k_pages.dtype == torch.float32
    return "tf32x3" if f32 else "tf32"


def paged_work(q, k_pages, page_table, queries, *, window=None,
               k_scale=None):
    """(bytes, operations, rate kind) one paged attention call's data
    needs: q read and out written once, every K/V page some live query
    of a row can see read once (with its scales), the page table and
    per-row scalars once, and per live (query, visible key) pair 2*hd
    multiply-adds for q.k and for p.v per query head.  ``queries``
    lists (page-table row, position) of every live query;
    ``page_table`` is read on the host."""
    KV, G, hd = q.shape[-3:]
    bs = k_pages.shape[1]
    pt_h = page_table.cpu().numpy()
    pages, pairs = set(), 0
    for b, pos in queries:
        lo = max(0, pos - window + 1) if window else 0
        pairs += pos - lo + 1
        for j in range(lo // bs, pos // bs + 1):
            pages.add(int(pt_h[b, j]))
    kv_bytes = len(pages) * bs * KV * hd * k_pages.element_size() * 2
    if k_scale is not None:
        kv_bytes += len(pages) * bs * KV * 4 * 2
    nbytes = 2 * q.numel() * q.element_size() + kv_bytes + \
        4 * (page_table.numel() + 2 * page_table.shape[0])
    return nbytes, pairs * KV * G * 4 * hd, attention_rate(q, k_pages)


def paged_bound_work(q, k_pages, page_table, queries: int, *, window=None,
                     k_scale=None):
    """:func:`paged_work` from shapes alone, for a caller that cannot
    read the tables (a count on the ``meta`` device): the most the call
    could need — every page of the table read once (at most the pool),
    each of ``queries`` live queries against every key its row's pages
    hold (the window's at most)."""
    KV, G, hd = q.shape[-3:]
    N, bs = k_pages.shape[:2]
    R, P = page_table.shape
    pages = min(R * P, N)
    keys = P * bs if window is None else min(P * bs, window)
    kv_bytes = pages * bs * KV * hd * k_pages.element_size() * 2
    if k_scale is not None:
        kv_bytes += pages * bs * KV * 4 * 2
    nbytes = 2 * q.numel() * q.element_size() + kv_bytes + \
        4 * (page_table.numel() + 2 * R)
    return nbytes, queries * keys * KV * G * 4 * hd, \
        attention_rate(q, k_pages)


def paged_attention_work(q, k_pages, v_pages, page_table, pos, *,
                         k_scale=None, v_scale=None, window=None,
                         exact: bool = False):
    """The work of one :func:`paged_attention` call (same arguments):
    with ``exact`` each row's query at its position, read on the host
    (:func:`paged_work`); else :func:`paged_bound_work`."""
    if exact:
        return paged_work(q, k_pages, page_table,
                          list(enumerate(pos.cpu().tolist())),
                          window=window, k_scale=k_scale)
    return paged_bound_work(q, k_pages, page_table, q.shape[0],
                            window=window, k_scale=k_scale)


def rows_work(q, k_pages, page_table, q_start, q_len, slots: int, *,
              window=None, k_scale=None, exact: bool = False):
    """The work of a ragged or mixed call (their ``*_work``): with
    ``exact`` row ``b``'s ``q_len[b]`` live queries from position
    ``q_start[b]``, read on the host (:func:`paged_work`); else from
    shapes alone, all ``slots`` query slots live
    (:func:`paged_bound_work`)."""
    if not exact:
        return paged_bound_work(q, k_pages, page_table, slots,
                                window=window, k_scale=k_scale)
    ql_h, qs_h = q_len.cpu().tolist(), q_start.cpu().tolist()
    queries = [(b, qs_h[b] + i) for b in range(len(ql_h))
               for i in range(ql_h[b])]
    return paged_work(q, k_pages, page_table, queries, window=window,
                      k_scale=k_scale)


def paged_attention_ref(q, k_pages, v_pages, page_table, pos, *,
                        k_scale=None, v_scale=None, window=None):
    """Gather-then-attend version of the paged decode kernel (a twin of
    the JAX package's ``kernels/ref.py::paged_attention_ref``).

    q [B, KV, G, hd]; k_pages/v_pages [N, bs, KV, hd] (int8 with scales
    [N, bs, KV], or float); page_table [B, P] int32; pos [B] int32.
    Returns [B, KV, G, hd] in q's dtype.
    """
    hd = q.shape[-1]
    k, v = gather_pages(k_pages, v_pages, page_table, k_scale, v_scale)
    scale = 1.0 / math.sqrt(hd)
    T = k.shape[1]
    s = torch.einsum("bkgd,btkd->bkgt", q.float(), k) * scale
    t_idx = torch.arange(T, device=q.device)[None, None, None, :]
    pq = pos.long()[:, None, None, None]
    mask = t_idx <= pq
    if window is not None:
        mask &= t_idx > pq - window
    s = torch.where(mask, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bkgt,btkd->bkgd", p, v).to(q.dtype)


def check_paged_args(name, q, k_pages, v_pages, page_table, k_scale,
                     v_scale, window, *, q_dims: int, row_per_query=True):
    """The checks the paged launchers share: device and contiguity,
    shapes, dtypes, scales and window.  With ``row_per_query`` the page
    table has one row per leading index of q.  Returns (KV, G, hd, P,
    bs)."""
    kernels.require_cuda(name, q, k_pages, v_pages, page_table, k_scale,
                         v_scale)
    if q.dim() != q_dims or k_pages.dim() != 4 \
            or k_pages.shape != v_pages.shape:
        raise ValueError(f"{name}: q with {q_dims} dims and pools "
                         f"[N,bs,KV,hd] expected, got {tuple(q.shape)} / "
                         f"{tuple(k_pages.shape)} / {tuple(v_pages.shape)}")
    KV, G, hd = q.shape[-3:]
    N, bs, KVp, hdp = k_pages.shape
    if (KVp, hdp) != (KV, hd):
        raise ValueError(f"{name}: pool heads/dim {(KVp, hdp)} != q's "
                         f"{(KV, hd)}")
    if hd not in TILE_HEAD_DIMS:
        raise ValueError(f"{name}: head_dim must be one of "
                         f"{TILE_HEAD_DIMS}, got {hd}")
    if q.dtype not in Q_DTYPES or k_pages.dtype not in KV_DTYPES \
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
    if page_table.dtype != torch.int32 or page_table.dim() != 2 or (
            row_per_query and page_table.shape[0] != q.shape[0]):
        raise ValueError(f"{name}: page_table must be int32 [B, P]"
                         + (f" with B = {q.shape[0]}" if row_per_query
                            else ""))
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive")
    return KV, G, hd, page_table.shape[1], bs


def paged_attention(q, k_pages, v_pages, page_table, pos, *, k_scale=None,
                    v_scale=None, window=None, splits=None):
    """The CUDA kernel (same arguments as :func:`paged_attention_ref`;
    every tensor contiguous and on one card).  Each row's own key at
    ``pos`` must already be scattered into the pool.  ``splits`` overrides
    :func:`plan_page_splits` (the tests force 1 and many)."""
    name = "paged_attention"
    check_tile_shape(name, q)
    KV, G, hd, P, bs = check_paged_args(
        name, q, k_pages, v_pages, page_table, k_scale, v_scale, window,
        q_dims=4)
    kernels.require_cuda(name, q, pos)
    B = q.shape[0]
    if pos.dtype != torch.int32 or tuple(pos.shape) != (B,):
        raise ValueError(f"{name}: pos must be int32 [B={B}]")
    check_aligned(name, q, k_pages, v_pages)
    if splits is None:
        splits = plan_page_splits(B, KV, P, bs, hd,
                                  kernels.sm_count(q.device.index))
    out = torch.empty_like(q)
    ws_acc, ws_ml = split_workspace(splits, B, KV, G, hd, q.device)
    fn = kernels.load(name).paged_attention
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    p = kernels.ptr
    with kernels.device_guard(q.device):
        err = fn(p(q), p(k_pages), p(v_pages), p(k_scale), p(v_scale),
                 p(page_table), p(pos), p(out), p(ws_acc), p(ws_ml), B, KV, G,
                 hd, P, bs, 0 if window is None else int(window), splits,
                 Q_DTYPES[q.dtype], KV_DTYPES[k_pages.dtype],
                 kernels.stream_handle(q.device))
    kernels.check_launch(err, name)
    return out
