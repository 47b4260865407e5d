"""Dispatching wrappers for the hand-written kernels (the torch twin of
``repro/kernels/ops.py``).

A wrapper takes the plain PyTorch version only when its input lies on
the CPU (the tests' path).  On a CUDA tensor it launches the kernel or
raises; there is no fallback.  Each wrapper counts its kernel launches
in an integer attribute ``launches`` — the count a run reads to show
that its path went through the kernels.  Reset it by assignment
(``ops.ragged_attention.launches = 0``).  ``paged_prefill_attention``
launches the mixed kernel, so it counts into
``mixed_attention.launches``, and ``moe_route`` the router's, so it
counts into ``router_gate.launches``; ``rwkv6_scan`` and ``mamba_scan``
return the final state beside ``y``.  ``spec_accept`` is the speculative
verify's epilogue in plain torch on the tensors' device (no Pallas kernel
in the JAX package either), so it has no kernel and no count.

On a ``meta`` tensor a wrapper returns empty outputs of its kernel's
shapes: it neither launches nor runs the plain version (the dry-run's
traces, ``repro_torch.launch.dryrun``).  Under an active count
(:mod:`repro_torch.kernels.counting`) every call records its kernel's
``*_work`` under the kernel it launches (``moe_route`` as
``router_gate``, ``paged_prefill_attention`` as ``mixed_attention``) on
the CPU, the card and ``meta`` alike, and the plain version's aten ops
are not counted besides; the paged kernels' work there is their shape
bound (the tables stay on the device).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import confidence_gate as _gate
from repro_torch.kernels import counting
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import mamba_scan as _mamba
from repro_torch.kernels import mixed_attention as _mixed
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import prefill_attention as _prefill
from repro_torch.kernels import ragged_attention as _ragged
from repro_torch.kernels import router_gate as _router
from repro_torch.kernels import rwkv6_scan as _rwkv


def _on_cpu(t, name: str) -> bool:
    """Whether ``t`` takes the plain version (on the CPU) rather than the
    kernel (on CUDA); raises on any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")


def confidence_gate(logits):
    """logits [..., V] -> dict(conf, entropy, argmax, logz), each [...]."""
    with counting.kernel("confidence_gate", _gate.confidence_gate_work,
                         logits):
        if logits.is_meta:
            lead = logits.shape[:-1]
            f32 = dict(dtype=torch.float32, device=logits.device)
            return {"conf": torch.empty(lead, **f32),
                    "entropy": torch.empty(lead, **f32),
                    "argmax": torch.empty(lead, dtype=torch.int32,
                                          device=logits.device),
                    "logz": torch.empty(lead, **f32)}
        if _on_cpu(logits, "confidence_gate"):
            return _gate.confidence_gate_ref(logits)
        out = _gate.confidence_gate(logits)
        confidence_gate.launches += 1
        return out


confidence_gate.launches = 0


def spec_accept(argmax_w, conf_w, q_len, flat_tokens, k: int):
    """Accept/reject epilogue of a speculative ragged verify, on the
    device (the twin of the JAX package's ``ops.spec_accept``).

    ``argmax_w`` / ``conf_w`` [W]: every flat slot's pick from the
    confidence gate over the verify's ``[W, V]`` logits; ``q_len`` [R]
    the ragged layout, ``flat_tokens`` [1, W] the launch's tokens, ``k``
    the draft bound.  Returns ``tok`` / ``conf`` [R] (each row's
    last-live-slot pick, the non-speculative step's result),
    ``spec_tok`` / ``spec_conf`` [R, k+1] (the row's picks from its first
    flat slot on: position j scores drafted token j, j = 0 the row's
    last emitted token) and ``acc_len`` [R], the accepted draft count:
    the longest prefix where slot j's argmax equals the next drafted
    token ``flat_tokens[start + j + 1]``.  Rows with ``q_len <= 1`` get
    0."""
    w = argmax_w.shape[0]
    q_len = q_len.long()
    csum = torch.cumsum(q_len, 0)
    last = (csum - 1).clamp(0, w - 1)
    start = csum - q_len
    j = torch.arange(k + 1, device=q_len.device)
    idx = start[:, None] + j[None, :]
    spec_tok = argmax_w[idx.clamp(0, w - 1)].to(torch.int32)
    spec_conf = conf_w[idx.clamp(0, w - 1)]
    drafted = flat_tokens[0][(idx + 1).clamp(0, w - 1)]
    valid = j[None, :] < (q_len - 1)[:, None]
    match = (spec_tok == drafted) & valid
    acc_len = torch.cumprod(match.to(torch.int32), 1).sum(1).to(torch.int32)
    return {"tok": argmax_w[last].to(torch.int32), "conf": conf_w[last],
            "spec_tok": spec_tok, "spec_conf": spec_conf,
            "acc_len": acc_len}


def router_gate(logits, k: int):
    """MoE routing: logits [..., E] -> (gates [..., k] f32 renormalised,
    idx [..., k] int32); see :mod:`repro_torch.kernels.router_gate`."""
    with counting.kernel("router_gate", _router.router_gate_work, logits,
                         k):
        if logits.is_meta:
            return _meta_picks(logits, k, torch.float32, torch.int32)
        if _on_cpu(logits, "router_gate"):
            return _router.router_gate_ref(logits, k)
        out = _router.router_gate(logits, k)
        router_gate.launches += 1
        return out


router_gate.launches = 0


def moe_route(logits, k: int, cap: int):
    """MoE routing and expert-queue ranks in one launch: logits [G, gs,
    E] -> (gates, idx, dest, weight), each [G, gs, k]; see
    :mod:`repro_torch.kernels.router_gate`.  Counted in
    ``router_gate.launches``."""
    with counting.kernel("router_gate", _router.moe_route_work, logits, k,
                         cap):
        if logits.is_meta:
            return _meta_picks(logits, k, torch.float32, torch.int32,
                               torch.int64, torch.float32)
        if _on_cpu(logits, "moe_route"):
            return _router.moe_route_ref(logits, k, cap)
        out = _router.moe_route(logits, k, cap)
        router_gate.launches += 1
        return out


def _meta_picks(logits, k: int, *dtypes):
    """Empty ``[..., k]`` outputs of the routing kernels, one a dtype."""
    shape = logits.shape[:-1] + (k,)
    return tuple(torch.empty(shape, dtype=dt, device=logits.device)
                 for dt in dtypes)


def ragged_attention(q, k_pages, v_pages, page_table, q_start, q_len, *,
                     k_scale=None, v_scale=None, window=None):
    """One ragged flat-token step over a block-paged KV pool; see
    :mod:`repro_torch.kernels.ragged_attention` for the contract."""
    args = (q, k_pages, v_pages, page_table, q_start, q_len)
    kw = dict(k_scale=k_scale, v_scale=v_scale, window=window)
    with counting.kernel("ragged_attention", _ragged.ragged_attention_work,
                         *args, **kw):
        if q.is_meta:
            return torch.empty_like(q)
        if _on_cpu(q, "ragged_attention"):
            return _ragged.ragged_attention_ref(*args, **kw)
        out = _ragged.ragged_attention(*args, **kw)
        ragged_attention.launches += 1
        return out


ragged_attention.launches = 0


def paged_attention(q, k_pages, v_pages, page_table, pos, *, k_scale=None,
                    v_scale=None, window=None):
    """One paged decode step (one query per row at ``pos``); see
    :mod:`repro_torch.kernels.paged_attention` for the contract."""
    args = (q, k_pages, v_pages, page_table, pos)
    kw = dict(k_scale=k_scale, v_scale=v_scale, window=window)
    with counting.kernel("paged_attention", _paged.paged_attention_work,
                         *args, **kw):
        if q.is_meta:
            return torch.empty_like(q)
        if _on_cpu(q, "paged_attention"):
            return _paged.paged_attention_ref(*args, **kw)
        out = _paged.paged_attention(*args, **kw)
        paged_attention.launches += 1
        return out


paged_attention.launches = 0


def mixed_attention(q, k_pages, v_pages, page_table, q_start, q_len, *,
                    k_scale=None, v_scale=None, window=None):
    """One padded mixed prefill+decode step over a block-paged KV pool;
    see :mod:`repro_torch.kernels.mixed_attention` for the contract."""
    args = (q, k_pages, v_pages, page_table, q_start, q_len)
    kw = dict(k_scale=k_scale, v_scale=v_scale, window=window)
    with counting.kernel("mixed_attention", _mixed.mixed_attention_work,
                         *args, **kw):
        if q.is_meta:
            return torch.empty_like(q)
        if _on_cpu(q, "mixed_attention"):
            return _mixed.mixed_attention_ref(*args, **kw)
        out = _mixed.mixed_attention(*args, **kw)
        mixed_attention.launches += 1
        return out


mixed_attention.launches = 0


def paged_prefill_attention(q, k_pages, v_pages, page_table, q_start, q_len,
                            *, k_scale=None, v_scale=None, window=None):
    """One chunked-prefill step: the mixed kernel, counted in
    ``mixed_attention.launches``."""
    args = (q, k_pages, v_pages, page_table, q_start, q_len)
    kw = dict(k_scale=k_scale, v_scale=v_scale, window=window)
    with counting.kernel("mixed_attention", _mixed.mixed_attention_work,
                         *args, **kw):
        if q.is_meta:
            return torch.empty_like(q)
        if _on_cpu(q, "paged_prefill_attention"):
            return _prefill.paged_prefill_attention_ref(*args, **kw)
        out = _prefill.paged_prefill_attention(*args, **kw)
        mixed_attention.launches += 1
        return out


def flash_attention(q, k, v, *, causal: bool = True, window=None):
    """Dense causal / sliding-window GQA attention: q [B, H, S, d], k/v
    [B, KV, T, d]; see :mod:`repro_torch.kernels.flash_attention`."""
    kw = dict(causal=causal, window=window)
    with counting.kernel("flash_attention", _flash.flash_attention_work, q,
                         k, v, **kw):
        if q.is_meta:
            return torch.empty_like(q)
        if _on_cpu(q, "flash_attention"):
            return _flash.flash_attention_ref(q, k, v, **kw)
        out = _flash.flash_attention(q, k, v, **kw)
        flash_attention.launches += 1
        return out


flash_attention.launches = 0


def rwkv6_scan(r, k, v, w, u):
    """RWKV-6 WKV scan from the zero state: r, k, v, w [B, H, T, hd], u
    [H, hd] -> (y [B, H, T, hd], final state [B, H, hd, hd]), f32; see
    :mod:`repro_torch.kernels.rwkv6_scan`."""
    with counting.kernel("rwkv6_scan", _rwkv.rwkv6_scan_work, r, k, v, w,
                         u):
        if r.is_meta:
            B, H, _, hd = r.shape
            return torch.empty_like(r), r.new_empty(
                (B, H, hd, hd), dtype=torch.float32)
        if _on_cpu(r, "rwkv6_scan"):
            return _rwkv.rwkv6_scan_ref(r, k, v, w, u)
        out = _rwkv.rwkv6_scan(r, k, v, w, u)
        rwkv6_scan.launches += 1
        return out


rwkv6_scan.launches = 0


def mamba_scan(x, dt, B_t, C_t, A):
    """Mamba-1 selective scan from the zero state: x, dt [B, T, d], B_t,
    C_t [B, T, n], A [d, n] -> (y [B, T, d], final state [B, d, n]), f32;
    see :mod:`repro_torch.kernels.mamba_scan`."""
    with counting.kernel("mamba_scan", _mamba.mamba_scan_work, x, dt, B_t,
                         C_t, A):
        if x.is_meta:
            return torch.empty_like(x), x.new_empty(
                (x.shape[0], x.shape[2], A.shape[1]), dtype=torch.float32)
        if _on_cpu(x, "mamba_scan"):
            return _mamba.mamba_scan_ref(x, dt, B_t, C_t, A)
        out = _mamba.mamba_scan(x, dt, B_t, C_t, A)
        mamba_scan.launches += 1
        return out


mamba_scan.launches = 0
