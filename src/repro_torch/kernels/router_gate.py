"""MoE router gate and expert-queue ranks: CUDA launchers and plain
versions.

Every MoE layer routes each of its tokens through this: softmax over the
``E`` expert logits, the ``k`` largest probabilities, then the picked
gates renormalised to sum to one (``max(sum, 1e-9)``).  It replaces the
TPU kernel ``repro/kernels/router_gate.py``.  Ties go to the lower
expert index, as ``lax.top_k`` and the TPU kernel's iterative argmax do.

``csrc/router_gate.cu`` has two entry points on one row body (one warp
a row, the row's logits in registers):

- :func:`router_gate` — (gates, idx) of every row;
- :func:`moe_route` — the routing of ``moe_ffn``'s ``G`` groups of
  ``gs`` token slots plus, for every (slot, pick) pair, its rank in its
  expert's queue (the earlier pairs of the group, in (slot, pick) order,
  that picked the same expert), its row ``dest`` of the capacity buffer
  (the spare last row when the rank reaches ``cap``) and its combine
  weight (its gate, or 0 when dropped).  A group's rows are spread over
  blocks of :func:`route_blocks` rows; each block ranks its own pairs,
  and the group's last block (a per-group counter, kept zeroed per
  device and stream) adds the earlier blocks' counts in block order, so
  the integers do not depend on which block ends last.

Each launches its kernel on CUDA tensors only; :func:`router_gate_ref`
and :func:`moe_route_ref` are the plain PyTorch versions (the CPU path
and the kernels' oracles).  Model code calls the dispatching wrappers
``repro_torch.kernels.ops.router_gate`` and ``ops.moe_route``.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import kernels

MAX_EXPERTS = 1024
# csrc/router_gate.cu: the most rows a moe_route block takes (one warp
# and one bit of a 32-bit word each), and the default: of 8, 16 and 32,
# 16 gave the least device time at granite's bucket and jamba's prefill
# (scripts/torch_kernel_ab.py --only moe_route)
MAX_ROUTE_ROWS = 32
ROUTE_ROWS = 16
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIGS = {
    "router_gate": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p, ctypes.c_void_p],
    "moe_route": [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                  ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 7,
}
# entry point name -> the bound C function (bound once per process)
_ENTRIES: Dict[str, object] = {}


def _entry(name: str):
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(kernels.load("router_gate"), name)
        fn.argtypes = _SIGS[name]
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def route_blocks(gs: int, rows_per_block: int = ROUTE_ROWS
                 ) -> Tuple[int, int]:
    """(rows a block, blocks a group) of :func:`moe_route` for groups of
    ``gs`` slots, as the kernel cuts them: block b takes slots
    ``[b * rows, (b + 1) * rows)``."""
    rows = min(rows_per_block, gs)
    return rows, -(-gs // rows)


def _check_logits(name: str, logits, k: int) -> None:
    kernels.require_cuda(name, logits)
    if logits.dtype not in _DTYPES:
        raise TypeError(f"{name}: unsupported dtype {logits.dtype}")
    if logits.dim() < 1:
        raise ValueError(f"{name}: logits need an expert dim")
    E = logits.shape[-1]
    if not 1 <= E <= MAX_EXPERTS:
        raise ValueError(f"{name}: {E} experts, the kernel takes "
                         f"1..{MAX_EXPERTS}")
    if not 1 <= k <= E:
        raise ValueError(f"{name}: k={k} outside 1..{E}")


def router_gate_work(logits, k: int):
    """(bytes, operations, rate kind) of one :func:`router_gate` call:
    per row E logits read and k (gate, index) pairs written; E
    subtractions, exponentials and additions, k rounds of E
    comparisons, 2k divisions."""
    E = logits.shape[-1]
    R = logits.numel() // E
    return (logits.numel() * logits.element_size() + R * k * 8,
            R * (3 * E + k * E + 2 * k), "f32")


def moe_route_work(logits, k: int, cap: int):
    """(bytes, operations, rate kind) of one :func:`moe_route` call:
    the logits read, gates, idx, dest and weight written (4 + 4 + 8 + 4
    bytes a pair), the routing's operations per row as
    :func:`router_gate_work`'s plus 4 a pair for its rank and row (mask,
    count, compare, multiply-add)."""
    G, gs, E = logits.shape
    pairs = G * gs * k
    return (logits.numel() * logits.element_size() + pairs * 20,
            G * gs * (3 * E + k * E + 2 * k) + pairs * 4, "f32")


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
    _check_logits("router_gate", logits, k)
    E = logits.shape[-1]
    lead = logits.shape[:-1]
    x = logits.reshape(-1, E)
    R = x.shape[0]
    gates = torch.empty(R, k, dtype=torch.float32, device=x.device)
    idx = torch.empty(R, k, dtype=torch.int32, device=x.device)
    with kernels.device_guard(x.device):
        err = _entry("router_gate")(
            kernels.ptr(x), R, E, k, _DTYPES[x.dtype], kernels.ptr(gates),
            kernels.ptr(idx), kernels.stream_handle(x.device))
    kernels.check_launch(err, "router_gate")
    return gates.reshape(*lead, k), idx.reshape(*lead, k)


def moe_route_ref(logits, k: int, cap: int):
    """logits [G, gs, E] -> (gates [G, gs, k] f32, idx [G, gs, k] int32,
    dest [G, gs, k] int64, weight [G, gs, k] f32): ``router_gate_ref``'s
    routing, each (slot, pick) pair's rank in its expert's queue in
    (slot, pick) order over the group (a one-hot cumsum, as the JAX
    ``moe_ffn`` ranks), kept if the rank is below ``cap``; a kept pair's
    row ``(e·G + g)·cap + rank`` of the capacity buffer and its gate, a
    dropped pair's spare row ``E·G·cap`` and weight 0."""
    G, gs, E = logits.shape
    gates, idx = router_gate_ref(logits, k)
    pick = idx.long().reshape(G, gs * k)
    onehot = F.one_hot(pick, E)                              # [G, gs·k, E]
    rank = (onehot.cumsum(1) - onehot).gather(2, pick[..., None])[..., 0]
    keep = rank < cap
    grp = torch.arange(G, device=logits.device)[:, None]
    dest = torch.where(keep, (pick * G + grp) * cap + rank, E * G * cap)
    weight = torch.where(keep, gates.reshape(G, gs * k), 0.0)
    return (gates, idx, dest.reshape(G, gs, k),
            weight.reshape(G, gs, k))


def moe_route(logits, k: int, cap: int, *,
              rows_per_block: Optional[int] = None):
    """The CUDA kernel: logits [G, gs, E] (f32, bf16 or f16, on the
    card), ``1 <= k <= E <= 1024``, ``cap >= 1`` -> (gates, idx, dest,
    weight) as :func:`moe_route_ref`.  ``rows_per_block`` (1..32,
    default ``ROUTE_ROWS``) sets the rows a block routes and ranks."""
    _check_logits("moe_route", logits, k)
    if logits.dim() != 3:
        raise ValueError(f"moe_route: logits must be [G, gs, E], got "
                         f"{tuple(logits.shape)}")
    if cap < 1:
        raise ValueError(f"moe_route: cap={cap} must be at least 1")
    rpb = ROUTE_ROWS if rows_per_block is None else rows_per_block
    if not 1 <= rpb <= MAX_ROUTE_ROWS:
        raise ValueError(f"moe_route: rows_per_block={rpb} outside "
                         f"1..{MAX_ROUTE_ROWS}")
    G, gs, E = logits.shape
    dev = logits.device
    gw = torch.empty(2, G, gs, k, dtype=torch.float32, device=dev)
    idx = torch.empty(G, gs, k, dtype=torch.int32, device=dev)
    dest = torch.empty(G, gs, k, dtype=torch.int64, device=dev)
    stream = kernels.stream_handle(dev)
    hist = count = None
    _, nb = route_blocks(max(gs, 1), rpb)
    if nb > 1 and G > 0:
        hist = torch.empty(G * nb * E, dtype=torch.int32, device=dev)
        count = kernels.zeroed_counters(dev, stream.value or 0, G)
    gates, weight = gw
    p = kernels.ptr
    with kernels.device_guard(dev):
        err = _entry("moe_route")(
            p(logits), G, gs, E, k, cap, rpb, _DTYPES[logits.dtype],
            p(gates), p(idx), p(dest), p(weight), p(hist), p(count),
            stream)
    kernels.check_launch(err, "moe_route")
    return gates, idx, dest, weight
