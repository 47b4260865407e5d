"""Chunked paged prefill attention (the torch twin of
``repro/kernels/prefill_attention.py``).

Each row processes a chunk of ``C`` prompt tokens whose keys and values
were just scattered into the block-paged pool; row ``b``'s query ``i``
sits at position ``q_start[b] + i`` and attends causally through its
page table.  That contract is the prefill-only restriction of the mixed
prefill+decode one, so, as in the JAX package, this module has no kernel
of its own: it delegates to :mod:`repro_torch.kernels.mixed_attention`
(``csrc/mixed_attention.cu``).  Slots ``i >= q_len[b]`` output zeros.
"""
from __future__ import annotations

from repro_torch.kernels.mixed_attention import (mixed_attention,
                                                 mixed_attention_ref)


def paged_prefill_attention(q, k_pages, v_pages, page_table, q_start, q_len,
                            *, k_scale=None, v_scale=None, window=None):
    """One chunked-prefill attention step: q [B, C, KV, G, hd], pools
    [N, bs, KV, hd], page_table [B, P], q_start / q_len [B] int32.
    Launches the mixed kernel (CUDA tensors only)."""
    return mixed_attention(q, k_pages, v_pages, page_table, q_start, q_len,
                           k_scale=k_scale, v_scale=v_scale, window=window)


def paged_prefill_attention_ref(q, k_pages, v_pages, page_table, q_start,
                                q_len, *, k_scale=None, v_scale=None,
                                window=None):
    """Plain version (the JAX package's
    ``kernels/ref.py::paged_prefill_attention_ref``)."""
    return mixed_attention_ref(q, k_pages, v_pages, page_table, q_start,
                               q_len, k_scale=k_scale, v_scale=v_scale,
                               window=window)
