"""Dense flash attention: CUDA launcher and plain version.

Causal (or not) and sliding-window grouped-query attention over dense
``[B, H, S, d]`` queries and ``[B, KV, T, d]`` keys and values, with
``scale = 1/sqrt(d)`` and the mask on raw indices (``kpos <= qpos``;
``kpos > qpos - window`` with a window).  The uniform one-shot prefill
(``blocks.attention`` in ``"prefill"`` mode) runs it in every attention
layer.

``csrc/flash_attention.cu`` replaces the TPU kernel
``repro/kernels/flash_attention.py::flash_attention``.  The TPU grid
swept a q tile's KV tiles in order with its online-softmax state in
VMEM; here one block of 4 warps owns a 64-query tile of one head (16
rows a warp) and loops over 32-key tiles (64 at d <= 64), double-buffered
in shared memory by asynchronous copies, skipping tiles no query of the
block can see.  Q.K^T and P.V run on the tensor cores (``mma.sync``
TF32 tiles); f32 inputs keep f32 accuracy by 3xTF32 (each operand split
into two TF32 terms, three products per f32 product), bf16 inputs, exact
in TF32, take one product for Q.K^T and two for P.V.

:func:`flash_attention` launches the kernel on CUDA tensors only;
:func:`flash_attention_ref` is the plain PyTorch version (the CPU path
and the kernel's oracle).  Model code calls the dispatching wrapper
``repro_torch.kernels.ops.flash_attention``.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch import kernels

HEAD_DIMS = (32, 64, 112, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIG = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p]


def visible_pairs(S: int, T: int, causal: bool = True, window=None) -> int:
    """(query, key) pairs the kernel computes for S queries at positions
    ``0..S-1`` over T keys: ``kpos <= qpos`` when causal, ``kpos > qpos -
    window`` with a window."""
    i = np.arange(S)
    hi = np.minimum(i, T - 1) if causal else np.full(S, T - 1)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(S, np.int64)
    return int(np.maximum(hi - lo + 1, 0).sum())


def flash_attention_work(q, k, v, *, causal: bool = True, window=None):
    """(bytes, operations, rate kind) of one :func:`flash_attention`
    call, from shapes alone: q, k, v read and out written once; 4·d
    operations per visible (query, key) pair and query head; the 3xTF32
    products on f32 inputs, one TF32 product on bf16."""
    B, H, S, d = q.shape
    pairs = visible_pairs(S, k.shape[2], causal, window)
    nbytes = 2 * q.numel() * q.element_size() + \
        2 * k.numel() * k.element_size()
    return (nbytes, pairs * B * H * 4 * d,
            "tf32x3" if q.dtype == torch.float32 else "tf32")


def flash_attention_ref(q, k, v, *, causal: bool = True, window=None):
    """Materialised-scores version (the JAX package's
    ``kernels/ref.py::flash_attention_ref``): q [B, H, S, d]; k, v
    [B, KV, T, d] (H % KV == 0).  Returns [B, H, S, d] in q's dtype."""
    B, H, S, d = q.shape
    KV, T = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(d)
    qg = q.reshape(B, KV, G, S, d).float()
    scores = torch.einsum("bkgsd,bktd->bkgst", qg, k.float()) * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,bktd->bkgsd", p, v.float())
    return out.reshape(B, H, S, d).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """The CUDA kernel (same arguments as :func:`flash_attention_ref`;
    q, k and v contiguous, on one card, all f32 or all bf16, d in
    ``HEAD_DIMS``)."""
    name = "flash_attention"
    kernels.require_cuda(name, q, k, v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{name}: q [B,H,S,d] and k/v [B,KV,T,d] expected, "
                         f"got {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    B, H, S, d = q.shape
    Bk, KV, T, dk = k.shape
    if Bk != B or dk != d or KV < 1 or H % KV:
        raise ValueError(f"{name}: k/v {tuple(k.shape)} do not fit q "
                         f"{tuple(q.shape)} (H % KV == 0 needed)")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim must be one of {HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name}: unsupported dtypes q={q.dtype} "
                        f"k={k.dtype} v={v.dtype}")
    if T < 1:
        raise ValueError(f"{name}: no keys")
    if window is not None and window <= 0:
        raise ValueError(f"{name}: window must be positive")
    # the kernel copies 16-byte vectors
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{name}: q, k and v must start on a 16-byte "
                         "boundary")
    out = torch.empty_like(q)
    fn = kernels.load(name).flash_attention
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    p = kernels.ptr
    with kernels.device_guard(q.device):
        err = fn(p(q), p(k), p(v), p(out), B, H, KV, S, T, d,
                 int(bool(causal)), 0 if window is None else int(window), _DTYPES[q.dtype],
                 kernels.stream_handle(q.device))
    kernels.check_launch(err, name)
    return out
