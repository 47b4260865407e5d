"""RWKV-6 WKV scan: CUDA launcher and plain version.

Per (batch row, head), from the zero state::

    y_t = r_t · (S + u ⊙ k_t v_tᵀ);   S ← diag(w_t) S + k_t v_tᵀ

with the state ``S`` ``[hd, hd]`` (key index, value index) in f32.  The
uniform one-shot prefill (``blocks.rwkv6`` in ``"prefill"`` mode) runs
it in every RWKV-6 layer and keeps the final state as the layer's decode
cache, so both functions return ``(y, S_T)``; the TPU kernel returned
``y`` only.

``csrc/rwkv6_scan.cu`` replaces the TPU kernel
``repro/kernels/rwkv6_scan.py::rwkv6_scan``: a block per (b, h), each
thread holding an 8 x 4 tile of the state (8 rows by 4 value columns)
in registers, a column's partial sums of ``y`` combined by warp
shuffles, stepping through time on chunks of 16 steps that
``cp.async`` double-buffers in shared memory.

:func:`rwkv6_scan` launches the kernel on CUDA tensors only;
:func:`rwkv6_scan_ref` is the plain PyTorch version (the CPU path and
the kernel's oracle).  Model code calls the dispatching wrapper
``repro_torch.kernels.ops.rwkv6_scan``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels

HEAD_DIMS = (32, 64, 128)
_SIG = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def rwkv6_scan_work(r, k, v, w, u):
    """(bytes, operations, rate kind) of one :func:`rwkv6_scan` call:
    the five inputs read and y and the state written once; per step and
    head 5·hd² f32 operations (2·hd² for r·S, 3·hd² for the decayed
    update w ⊙ S + k vᵀ) and 3·hd for the bonus term."""
    B, H, T, hd = r.shape
    return (4 * (5 * r.numel() + u.numel() + B * H * hd * hd),
            (5 * hd * hd + 3 * hd) * T * B * H, "f32")


def rwkv6_scan_ref(r, k, v, w, u):
    """Step-by-step version (the JAX package's
    ``kernels/ref.py::rwkv6_scan_ref``, which also returns the state):
    r, k, v, w [B, H, T, hd]; u [H, hd].  Returns (y [B, H, T, hd],
    S_T [B, H, hd, hd]), both f32."""
    B, H, T, hd = r.shape
    r, k, v, w = (a.float() for a in (r, k, v, w))
    u = u.float()
    S = torch.zeros(B, H, hd, hd, dtype=torch.float32, device=r.device)
    ys = []
    for t in range(T):
        kv = k[:, :, t, :, None] * v[:, :, t, None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", r[:, :, t],
                               S + u[..., None] * kv))
        S = w[:, :, t, :, None] * S + kv
    y = torch.stack(ys, 2) if ys else r.new_zeros(B, H, 0, hd)
    return y, S


def rwkv6_scan(r, k, v, w, u):
    """The CUDA kernel (same arguments as :func:`rwkv6_scan_ref`; every
    tensor f32, contiguous and on one card; hd in {32, 64, 128})."""
    name = "rwkv6_scan"
    kernels.require_cuda(name, r, k, v, w, u)
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == w.shape):
        raise ValueError(f"{name}: r, k, v, w must share [B,H,T,hd], got "
                         f"{[tuple(a.shape) for a in (r, k, v, w)]}")
    B, H, T, hd = r.shape
    if tuple(u.shape) != (H, hd):
        raise ValueError(f"{name}: u must be [H={H}, hd={hd}], got "
                         f"{tuple(u.shape)}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim must be one of {HEAD_DIMS}, "
                         f"got {hd}")
    if any(a.dtype != torch.float32 for a in (r, k, v, w, u)):
        raise TypeError(f"{name}: every input must be float32")
    if any(a.data_ptr() % 16 for a in (r, k, v, w)):
        raise ValueError(f"{name}: r, k, v and w must start on a 16-byte "
                         "boundary")
    y = torch.empty_like(r)
    s_out = torch.empty(B, H, hd, hd, dtype=torch.float32, device=r.device)
    fn = kernels.load(name).rwkv6_scan
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    p = kernels.ptr
    with kernels.device_guard(r.device):
        err = fn(p(r), p(k), p(v), p(w), p(u), p(y), p(s_out), B, H, T, hd,
                 kernels.stream_handle(r.device))
    kernels.check_launch(err, name)
    return y, s_out
