"""Fused cascade confidence gate: CUDA launcher and plain version.

The paper's gate is ``conf = max softmax(logits)`` compared against δ.
At LLM vocab sizes (up to 262k here) a naive implementation reads the
logits three times (max, sum, normalise); ``csrc/confidence_gate.cu``
computes, in ONE streaming pass per row,

    conf     = max softmax probability        (the paper's score)
    entropy  = H(p)                           (alternative score)
    argmax   = top-1 token id (first maximum wins)
    logz     = logsumexp

from online-softmax accumulators (running max m, Σexp S, Σ(x-m)exp T):
``logZ = m + log S``, ``conf = exp(x_max - logZ)``, ``H = log S - T/S``.
It replaces the TPU kernel ``repro/kernels/confidence_gate.py``.

:func:`confidence_gate` launches the kernel on CUDA tensors only;
:func:`confidence_gate_ref` is the plain PyTorch version (the CPU path
and the kernel's oracle).  Model code calls the dispatching wrapper
``repro_torch.kernels.ops.confidence_gate``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIG = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p]


def confidence_gate_ref(logits):
    """logits [..., V] -> dict(conf, entropy, argmax, logz), each [...],
    computed in f32 (in f64 for f64 logits)."""
    x = logits.to(torch.promote_types(logits.dtype, torch.float32))
    p = torch.softmax(x, dim=-1)
    return {
        "conf": p.amax(dim=-1),
        "entropy": -(p * torch.log_softmax(x, dim=-1)).sum(dim=-1),
        "argmax": x.argmax(dim=-1).to(torch.int32),
        "logz": torch.logsumexp(x, dim=-1),
    }


def confidence_gate(logits):
    """The CUDA kernel: logits [..., V] (f32 or bf16, on the card) ->
    dict(conf, entropy, argmax, logz), each [...] (f32 / int32)."""
    kernels.require_cuda("confidence_gate", logits)
    if logits.dtype not in _DTYPES:
        raise TypeError(f"confidence_gate: unsupported dtype {logits.dtype}")
    if logits.dim() < 1 or logits.shape[-1] == 0:
        raise ValueError(f"confidence_gate: bad logits shape "
                         f"{tuple(logits.shape)}")
    lead = logits.shape[:-1]
    V = logits.shape[-1]
    if V >= 2 ** 31:
        raise ValueError(f"confidence_gate: vocab {V} exceeds int32 ids")
    x = logits.reshape(-1, V)
    R = x.shape[0]
    f32 = dict(dtype=torch.float32, device=x.device)
    conf = torch.empty(R, **f32)
    ent = torch.empty(R, **f32)
    logz = torch.empty(R, **f32)
    arg = torch.empty(R, dtype=torch.int32, device=x.device)
    lib = kernels.load("confidence_gate")
    fn = lib.confidence_gate
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    err = fn(kernels.ptr(x), R, V, _DTYPES[x.dtype], kernels.ptr(conf),
             kernels.ptr(ent), kernels.ptr(arg), kernels.ptr(logz),
             kernels.stream_handle(x.device))
    kernels.check_launch(err, "confidence_gate")
    return {"conf": conf.reshape(lead), "entropy": ent.reshape(lead),
            "argmax": arg.reshape(lead), "logz": logz.reshape(lead)}
