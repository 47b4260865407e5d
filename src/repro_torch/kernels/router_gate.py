"""MoE router gate: CUDA launcher and plain version.

Every MoE layer routes each of its tokens through this: softmax over the
``E`` expert logits, the ``k`` largest probabilities, then the picked
gates renormalised to sum to one (``max(sum, 1e-9)``).  It replaces the
TPU kernel ``repro/kernels/router_gate.py``; ``csrc/router_gate.cu``
does it in one warp per row, the row's logits held in registers.

Ties go to the lower expert index, as ``lax.top_k`` and the TPU
kernel's iterative argmax do.  :func:`router_gate` launches the kernel
on CUDA tensors only; :func:`router_gate_ref` is the plain PyTorch
version (the CPU path and the kernel's oracle).  Model code calls the
dispatching wrapper ``repro_torch.kernels.ops.router_gate``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import kernels

MAX_EXPERTS = 1024
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIG = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]


def router_gate_ref(logits, k: int):
    """logits [..., E] -> (gates [..., k] f32 renormalised, idx [..., k]
    int32), the softmax computed in f32.  A stable descending sort keeps
    equal probabilities in index order (``torch.topk`` promises no
    order among ties)."""
    p = torch.softmax(logits.float(), dim=-1)
    vals, idx = torch.sort(p, dim=-1, descending=True, stable=True)
    gates, idx = vals[..., :k], idx[..., :k]
    gates = gates / gates.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    return gates, idx.to(torch.int32)


def router_gate(logits, k: int):
    """The CUDA kernel: logits [..., E] (f32, bf16 or f16, on the card),
    ``1 <= k <= E <= 1024`` -> (gates [..., k] f32, idx [..., k] int32)."""
    kernels.require_cuda("router_gate", logits)
    if logits.dtype not in _DTYPES:
        raise TypeError(f"router_gate: unsupported dtype {logits.dtype}")
    if logits.dim() < 1:
        raise ValueError("router_gate: logits need an expert dim")
    E = logits.shape[-1]
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"router_gate: {E} experts, the kernel takes "
                         f"1..{MAX_EXPERTS}")
    if not 1 <= k <= E:
        raise ValueError(f"router_gate: k={k} outside 1..{E}")
    lead = logits.shape[:-1]
    x = logits.reshape(-1, E)
    R = x.shape[0]
    gates = torch.empty(R, k, dtype=torch.float32, device=x.device)
    idx = torch.empty(R, k, dtype=torch.int32, device=x.device)
    fn = kernels.load("router_gate").router_gate
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    err = fn(kernels.ptr(x), R, E, k, _DTYPES[x.dtype], kernels.ptr(gates),
             kernels.ptr(idx), kernels.stream_handle(x.device))
    kernels.check_launch(err, "router_gate")
    return gates.reshape(*lead, k), idx.reshape(*lead, k)
