"""Mamba-1 selective scan: CUDA launcher and plain version.

Per (batch row, channel c), from the zero state ``h [n]``::

    h_t = exp(dt_t[c] A[c]) ⊙ h_{t-1} + dt_t[c] x_t[c] B_t;   y_t[c] = h_t · C_t

in f32, with ``B_t`` and ``C_t`` shared by every channel of the row.  The
uniform one-shot prefill (``blocks.mamba`` in ``"prefill"`` mode) runs it
in every Mamba layer and keeps the final state as the layer's decode
cache, so both functions return ``(y, h_T)``; the TPU kernel returned
``y`` only.

``csrc/mamba_scan.cu`` replaces the TPU kernel
``repro/kernels/mamba_scan.py::mamba_scan``: one block per (batch row,
64 channels), each thread holding one channel's ``n`` state values and
its row of ``A`` (times log2 e, so each exponential is one ``ex2``) in
registers while the block steps through time.  The next 32 steps' x, dt,
B_t and C_t are copied into shared memory by ``cp.async`` while the
current 32 are stepped, so the scan waits on neither memory nor a
barrier per step; what bounds it is HBM bytes and the special function
units' exponentials, about equally at n = 16.

:func:`mamba_scan` launches the kernel on CUDA tensors only;
:func:`mamba_scan_ref` is the plain PyTorch version (the CPU path and the
kernel's oracle).  Model code calls the dispatching wrapper
``repro_torch.kernels.ops.mamba_scan``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels

STATE_DIMS = (8, 16)
_SIG = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def mamba_scan_work(x, dt, B_t, C_t, A):
    """(bytes, operations, rate kind) of one :func:`mamba_scan` call:
    the five inputs read and y and the state written once; per (b, t,
    channel) 7n + 1 f32 operations (dt·x, and per state value dt·A, its
    exponential, the decayed state, the input term's multiply-add and
    the output's)."""
    Bsz, T, d = x.shape
    n = A.shape[1]
    ins = sum(a.numel() for a in (x, dt, B_t, C_t, A))
    return (4 * (ins + x.numel() + Bsz * d * n), (7 * n + 1) * Bsz * T * d,
            "f32")


def mamba_scan_ref(x, dt, B_t, C_t, A):
    """Step-by-step version (the JAX package's
    ``kernels/ref.py::mamba_scan_ref``, which also returns the state):
    x, dt [B, T, d]; B_t, C_t [B, T, n]; A [d, n].  Returns (y [B, T, d],
    h_T [B, d, n]), both f32."""
    Bsz, T, d = x.shape
    x, dt, B_t, C_t, A = (a.float() for a in (x, dt, B_t, C_t, A))
    h = torch.zeros(Bsz, d, A.shape[1], dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(T):
        da = torch.exp(dt[:, t, :, None] * A)                 # [B, d, n]
        h = da * h + (dt[:, t] * x[:, t])[..., None] * B_t[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, C_t[:, t]))
    y = torch.stack(ys, 1) if ys else x.new_zeros(Bsz, 0, d)
    return y, h


def mamba_scan(x, dt, B_t, C_t, A):
    """The CUDA kernel (same arguments as :func:`mamba_scan_ref`; every
    tensor f32, contiguous and on one card, x, dt, B_t and C_t starting
    on a 16-byte boundary; n in {8, 16})."""
    name = "mamba_scan"
    kernels.require_cuda(name, x, dt, B_t, C_t, A)
    if x.dim() != 3 or x.shape != dt.shape:
        raise ValueError(f"{name}: x and dt must share [B,T,d], got "
                         f"{tuple(x.shape)} and {tuple(dt.shape)}")
    Bsz, T, d = x.shape
    if A.dim() != 2 or A.shape[0] != d:
        raise ValueError(f"{name}: A must be [d={d}, n], got "
                         f"{tuple(A.shape)}")
    n = A.shape[1]
    for label, t in (("B_t", B_t), ("C_t", C_t)):
        if tuple(t.shape) != (Bsz, T, n):
            raise ValueError(f"{name}: {label} must be [B={Bsz}, T={T}, "
                             f"n={n}], got {tuple(t.shape)}")
    if n not in STATE_DIMS:
        raise ValueError(f"{name}: d_state must be one of {STATE_DIMS}, "
                         f"got {n}")
    if any(a.dtype != torch.float32 for a in (x, dt, B_t, C_t, A)):
        raise TypeError(f"{name}: every input must be float32")
    if any(a.data_ptr() % 16 for a in (x, dt, B_t, C_t)):
        raise ValueError(f"{name}: x, dt, B_t and C_t must start on a "
                         "16-byte boundary")
    y = torch.empty_like(x)
    h_out = torch.empty(Bsz, d, n, dtype=torch.float32, device=x.device)
    fn = kernels.load(name).mamba_scan
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    p = kernels.ptr
    with kernels.device_guard(x.device):
        err = fn(p(x), p(dt), p(B_t), p(C_t), p(A), p(y), p(h_out), Bsz, T, d,
                 n, kernels.stream_handle(x.device))
    kernels.check_launch(err, name)
    return y, h_out
