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

Bytes bound the kernel, and the engine's 8 rows are too few blocks to
stream them at the card's rate, so each row is split across
:func:`plan_gate_splits` blocks (about four blocks per SM in all).  Split
boundaries sit on the 16-byte grid past the row's first 16-byte address
(:func:`gate_slices`), so every slice but the first streams 16-byte
loads from its start.  Each block merges its threads' states; the row's
last block to finish (a per-row counter, kept zeroed per device and
stream) merges the splits' partials in one fixed order, whichever block
finishes last, so two calls on the same logits give the same bits.

:func:`confidence_gate` launches the kernel on CUDA tensors only;
:func:`confidence_gate_ref` is the plain PyTorch version (the CPU path
and the kernel's oracle).  Model code calls the dispatching wrapper
``repro_torch.kernels.ops.confidence_gate``.
"""
from __future__ import annotations

import ctypes
from typing import List, Tuple

import torch

from repro_torch import kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_SIG = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_int, ctypes.c_longlong] + [ctypes.c_void_p] * 8)

# csrc/confidence_gate.cu: threads of a block, which is also the most
# splits its last block merges; the fewest elements worth a split; and
# the blocks an SM holds at once (4 x 256 threads at its 64 registers
# fill the register file: one wave)
GATE_THREADS = 256
MIN_SPLIT = 4096
BLOCKS_PER_SM = 4


def plan_gate_splits(rows: int, vocab: int, dtype_bytes: int,
                     sms: int) -> Tuple[int, int]:
    """(splits, chunk): how many blocks share one row of ``vocab``
    logits of ``dtype_bytes`` bytes each, and the elements of a split's
    slice, from the shapes and the card's ``sms`` alone.  About
    ``BLOCKS_PER_SM * sms`` blocks in all (one wave; times by variant:
    ``scripts/torch_kernel_ab.py``), at most ``GATE_THREADS`` a row and
    never a split of fewer than ``MIN_SPLIT`` elements; one split when
    ``rows`` alone fill that wave or the row is short.  ``chunk`` is a
    whole number of 16-byte vectors, and the count is cut so that every
    split is non-empty whatever the row's head (:func:`gate_slices`)."""
    vec = 16 // dtype_bytes
    target = min(BLOCKS_PER_SM * sms // max(rows, 1), GATE_THREADS,
                 vocab // MIN_SPLIT)
    if target < 2:
        return 1, vocab
    chunk = -(-vocab // target)
    chunk = -(-chunk // vec) * vec
    return -(-(vocab - vec + 1) // chunk), chunk


def gate_slices(vocab: int, head: int, splits: int,
                chunk: int) -> List[Tuple[int, int]]:
    """[lo, hi) of each split of a row whose first ``head`` elements lie
    before its first 16-byte address, as the kernel cuts it: split k > 0
    starts ``head + k * chunk`` elements in, and the last runs to the
    end."""
    bounds = [0] + [min(vocab, head + k * chunk)
                    for k in range(1, splits)] + [vocab]
    return list(zip(bounds[:-1], bounds[1:]))


def confidence_gate_work(logits):
    """(bytes, operations, rate kind) of one :func:`confidence_gate`
    call: the logits read once and 4 values a row written; 5 f32
    operations a logit (subtract, exponential, add, and the entropy's
    multiply-add)."""
    R = logits.numel() // max(logits.shape[-1], 1)
    return (logits.numel() * logits.element_size() + R * 4 * 4,
            logits.numel() * 5, "f32")


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
    splits, chunk = plan_gate_splits(R, V, x.element_size(),
                                     kernels.sm_count(x.device.index))
    # the host's work per call is part of the tick (the engine waits on
    # the host), so the f32 outputs share one allocation, and so do the
    # splits' partials: R * splits float4 (m, S, T, amax), then as many
    # int32 argmax ids
    f32 = dict(dtype=torch.float32, device=x.device)
    conf, ent, logz = torch.empty(3, R, **f32)
    arg = torch.empty(R, dtype=torch.int32, device=x.device)
    stream = kernels.stream_handle(x.device)
    part = part_idx = count = None
    if splits > 1 and R > 0:
        ws = torch.empty(R * splits * 5, **f32)
        part = ws.data_ptr()
        part_idx = part + 16 * R * splits
        count = kernels.zeroed_counters(x.device, stream.value or 0,
                                        R).data_ptr()
    lib = kernels.load("confidence_gate")
    fn = lib.confidence_gate
    fn.argtypes = _SIG
    fn.restype = ctypes.c_int
    p = kernels.ptr
    with kernels.device_guard(x.device):
        err = fn(p(x), R, V, _DTYPES[x.dtype], splits, chunk, p(conf), p(ent),
                 p(arg), p(logz), part, part_idx, count, stream)
    kernels.check_launch(err, "confidence_gate")
    return {"conf": conf.reshape(lead), "entropy": ent.reshape(lead),
            "argmax": arg.reshape(lead), "logz": logz.reshape(lead)}
