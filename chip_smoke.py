"""On-card smoke test of the torch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero
without printing a result):

  1. environment: card name and power limit (``nvidia-smi``), torch and
     CUDA versions, and the build of the eight CUDA kernels from
     ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel),
     with the ptxas register and spill lines of every kernel and, apart,
     of the attention kernels' head-width-112 instances;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it (gemma3-1b, phi4-mini-3.8b,
     granite-moe-3b-a800m, rwkv6-3b and jamba-v0.1-52b, whose Mamba
     layers run ``mamba_scan``, and phase 8's starcoder2-7b (G 9),
     musicgen-large, qwen2-vl-72b (flash at 8 x 1152), moonshot-v1-16b-a3b
     (``moe_route`` at 64 experts, top-6) and kimi-k2-1t-a32b (head width
     112 in f32, bf16 and over int8 pools; 384 experts, top-8); phase
     11's data shards: ``flash_attention`` at a shard's prefill batch of
     4 x 640 and granite's route gathered from two shards' logits
     (``transformer.route_data_shards``); phase 12's model shards:
     ``flash_attention`` at one shard's heads of phi4, gemma3 and
     qwen2-vl, ``rwkv6_scan`` at 20 heads, ``mamba_scan`` at 4096
     channels; phase 13's sharded train step: ``moe_route`` on granite's
     global route [1, 1024, 40] and ``rwkv6_scan`` at one model shard's
     [4, 20, 256, 64], there also the differentiable ``_RWKV6Scan``
     (forward and every input's gradient) against plain-torch autograd;
     the ragged kernel also at the
     flat
     widths 48 and 160 of phase 4e's bucket override), with CUDA-event
     times for the
     kernel and the plain version (for the gate and the router also back
     to back, :func:`device_ms`; for ``flash_attention`` also PyTorch's
     ``scaled_dot_product_attention`` as a yardstick; for the four
     tensor-core attention kernels, ``flash_attention``,
     ``ragged_attention``, ``paged_attention`` and
     ``mixed_attention``, their bound on the tensor cores beside the one
     on the CUDA cores; for the ragged, paged and mixed kernels, the
     gate and the two scans also their device time from the profiler,
     :func:`kernel_ms`, since the host's launch takes longer than a
     decode kernel, and for the split kernels the splits launched);
  3. the port's ragged, padded (``mixed_step``) and split
     (``prefill_chunk`` then ``decode_step``) steps end to end on the
     card against the same steps on the CPU (plain versions), at the
     smoke widths, and for granite at its published widths cut to 2
     layers; then the uniform ``prefill`` and the dense-arena
     ``decode_step`` the same way, at the smoke widths of gemma3-1b,
     phi4-mini-3.8b, rwkv6-3b and jamba-v0.1-52b, on a narrow 8-layer
     jamba period, for rwkv6-3b at its published widths cut to 2 layers
     and for jamba at its published widths cut to its layers 4 and 6
     (attention and Mamba, dense FFNs);
  4. the main path at full width: ``repro_torch.launch.serve_async.run``
     serving 16 requests through the published gemma3-1b ->
     phi4-mini-3.8b cascade (random f32 weights from a seed) on the
     default ragged executor, with the kernels' launch counters set to 0
     just before and read just after;
  4b. speculation, on phase 4's weights: the workload at ``gen_len`` 32
     on the ragged executor, gemma3-1b -> phi4-mini-3.8b and gemma3-1b
     -> gemma3-1b (self-speculation), each at k = 0 and k = 4: exact
     launch counts (``ragged_attention`` per attention layer and
     speculative launch, ``paged_attention`` per draft-tier attention
     layer and draft-loop step, ``confidence_gate`` per launch and step),
     the speculation counters, streams against k = 0 and every
     self-speculation rejection under the margin rule (a token
     difference is a near-tie only where the two tokens' logit gap is
     within the measured error of the verify window against the one-
     token paths: the verifier's own gap at a rejection, a
     teacher-forced prefill's, within twice that, for a stream
     difference), accept rates,
     per-gate ECE and agreement, tokens/s at k = 0 and k = 4;
  4c. prefix caching, on phase 4's weights: a row admitted over a
     published prefix against the same prompt uncached and
     teacher-forced (last-token logits within 1e-4; both tiers at full
     width), ``_copy_blocks`` bit-exact on a phi4-mini-3.8b f32 pool and
     an int8 one; then the workload with 0.75 of every prompt shared at
     a fixed δ of 1 (every request escalates) under a virtual clock: the
     ragged executor with ``--prefix-cache`` off and on, the padded and
     split executors with it on, and the ragged one on an 80-block arena
     that evicts index entries — exact launch counts, block
     conservation after each drain, hits on both tiers, live prefill
     tokens cut by exactly the cached ones, and streams against the
     cache-off run under the margin rule; then the ragged executor on
     the wall clock at the escalation budget, cache off and on
     (tokens/s, TTFT p50, peak memory);
  4d. overload, on phase 4c's workload and phase 4's weights, on 64 KV
     blocks a tier (where admission alone stalls for good): the ragged
     executor under ``--preemption youngest`` and ``fewest-tokens``, with
     ``youngest`` and ``--prefix-cache``, and the split executor under
     ``youngest`` — each drains, with exact launch counts, request and
     block conservation, the CPU rehearsal's preemptions, replayed tokens
     and ticks, and the fully provisioned run's streams under the margin
     rule; one seeded ``--inject-faults`` plan (shrink, storm, transient
     launch and fetch faults, one launch past its two retries: exactly
     one request FAILED), and a ``--deadline`` that sheds the
     rehearsal's 4 requests; then ``youngest`` on the wall clock at the
     escalation budget, a record beside 4c's fully provisioned run;
  4e. observability, on phase 4's weights (``check_observability``; alone:
     ``scripts/torch_observability_phase.py``): the workload on the
     ragged executor under a virtual clock untraced, then with
     ``--trace-out``, ``--profile`` and ``--metrics-interval`` (streams,
     launches and host syncs as untraced; the trace valid under
     ``scripts/check_trace.py``; one ``run_ragged/<tier>`` profiler range
     a ragged launch, the tier's ragged kernels inside), then with
     ``--trace-out`` alone: the host milliseconds per engine phase (admit,
     plan, launch, device_get, finish, tick) a tier, beside the
     profiler's device idle share; then ``--flat-buckets 16 48 160 512``
     (exact launch counts, streams under 4b's margin rule);
  5. the same workload, on the same weights, under the padded
     (``--no-ragged-step``) and the split (``--split-step``) executors,
     then the uniform one-shot prefill path on 16 prompts of exactly 640
     tokens (``--no-chunked-prefill``, and ``--dense-kv`` over the dense
     arena), then the gemma3-1b -> granite-moe-3b-a800m cascade (40
     experts, top-8) under all three executors, then gemma3-1b ->
     rwkv6-3b (uniform by itself: its RWKV-6 state cannot be chunked),
     then gemma3-1b -> jamba-v0.1-52b cut to 1 of its 4 periods (8
     layers: 7 Mamba and 1 attention, 4 MoE FFNs of 16 experts, top-2;
     53.2 GB of f32 weights) on the uniform path it picks by itself and
     on the dense arena (``--dense-kv``), each run with the counters set
     to 0 just before and read just after, its launches checked exactly;
  6. the workload once more, cut to 8 requests (phase 4's 8 slots
     full), inside ``torch.profiler``, with a virtual clock, under each
     executor (the uniform one included; the MoE, RWKV-6 and jamba
     cascades' profiles alone: ``scripts/torch_family_profiles.py``,
     phase 4b's four runs: ``scripts/torch_speculation_profiles.py``):
     device time by kernel
     kind (a kind's split-merge kernels counted with it) and the
     device's idle share; and the split MoE cascade
     served twice under a virtual clock, to record whether its streams
     are equal run to run;
  7. training, after phase 6's phi4 profiles, on phase 4's weights:
     (7a) one step of ``make_train_step`` on gemma3-1b, of
     ``make_ltc_train_step`` gemma3-1b -> phi4-mini-3.8b (smoke widths)
     and of ``make_train_step`` on granite at its published widths cut
     to 2 layers and on gemma3-1b at its published widths cut to one
     period, each on the card against the CPU (losses, lb and z losses,
     every gradient leaf; ``moe_route`` launches exact, remat's
     recomputation included), and 4 steps of the cut gemma3-1b at lr
     1e-2 on 7b's batches, card against CPU step by step; (7b) ``launch.train.run``: 8 LtC steps of
     the published gemma3-1b against phase 4's frozen phi4-mini-3.8b
     (losses per step, step ms, training tokens/s, peak memory; finite
     losses, ``l_org`` falling); (7c) the paper's classifier flow
     (``examples/quickstart.py``: CE and LtC arms, δ on val, test
     Acc^casc, MACs^casc, N^exp, ECE, temperature scaling and ConfNet);
     (7d) ``launch.serve.serve_cascade`` with phase 4's untrained and
     7b's trained gemma3-1b before phi4-mini-3.8b (exact gate and ragged
     launches, escalations at δ 0.5); (7e) the recurrent train mode and
     the exit heads: one step of ``make_train_step`` on rwkv6-3b at its
     published widths cut to 2 layers and on the narrow jamba period, of
     ``make_ltc_train_step`` gemma3-1b -> rwkv6-3b and -> jamba (smoke
     widths), and of ``make_train_step`` on the one-period gemma3-1b
     with an exit head (Eq 6), card against CPU (``rwkv6_scan``,
     ``mamba_scan`` and ``moe_route`` launches exact: two a layer a step
     under remat, one a frozen layer; the exit head's gradient zero); 8
     LtC steps of the published gemma3-1b against the frozen published
     rwkv6-3b; and that pair served untrained and trained on the uniform
     executor (exact flash, paged, scan and gate launches).  Alone:
     ``scripts/torch_recurrent_train_phase.py``;
  8. the rest of the registry, after phase 5's jamba (its weights freed:
     gemma3-1b beside one expensive tier at a time; alone:
     ``scripts/torch_configs_phase.py``): (8b) the steps on the card
     against the CPU — ``ragged_step``, ``mixed_step``,
     ``prefill_chunk`` + paged ``decode_step`` and ``prefill`` + dense
     ``decode_step`` — of kimi-k2-1t-a32b at its published widths cut to
     its dense first layer (all four attention kernels at head width
     112), of qwen2-vl-72b cut to 1 layer (``prefill`` and ``decode_step``
     only, with random frontend embeddings: M-RoPE and the frontend's
     projection) and of the five configs' smoke widths (the frontend
     ones uniform only); (8a) 16 requests at ``gen_len`` 8 through
     gemma3-1b -> starcoder2-7b under the ragged, padded and split
     executors, -> musicgen-large (uniform by itself: the audio
     frontend, 640-token prompts), -> qwen2-vl-72b cut to 8 of its 80
     layers (uniform by itself, 1152-token prompts: 1024 patch positions,
     then text) and -> moonshot-v1-16b-a3b cut to its dense first layer
     and 8 MoE layers (ragged), each with exact launch counts, finite
     confidences and block conservation, tokens/s, TTFT and peak memory;
  9. multi-device serving, after phase 4e on phase 4's weights
     (``check_multidevice``; alone: ``scripts/torch_multidevice_phase.py``):
     (9a) the workload (8 requests since PR 32) unsharded and with both
     tiers on ``2x1`` meshes
     over the first card twice (two data shards a tier: rows, KV blocks
     and prefix index per shard, each launch once per shard), in turns
     (unsharded, sharded, sharded, unsharded; traced: each tier's host
     ms in ``launch``) — same-tier streams equal, launches exactly D
     times the unsharded formula, blocks conserved in every shard, no
     second copy of the params —
     then two shards over 64 KV blocks of 32 tokens under ``youngest``
     (preemptions, every request drained); (9b, only with two cards or
     more) the tiers on ``cuda:0`` and ``cuda:1``, tier 1 on a ``2x1``
     mesh over both, and each kernel launched on ``cuda:1`` while
     ``cuda:0`` is current against its plain version (with one card, a
     line saying 9b did not run);
 10. the model axis, after phase 9 on phase 4's weights
     (``check_model_axis``; alone: ``scripts/torch_model_axis_phase.py``):
     (10a) teacher-forced full-bucket ragged steps of gemma3-1b and
     phi4-mini-3.8b on two model shards over the first card twice
     against unsharded (logits within 1e-4, argmax equal past that
     margin); the workload (8 requests since PR 32) unsharded and with
     both tiers on ``1x2``
     meshes over the first card twice with ``--shard-params``, in turns
     (traced) — same-tier streams equal, the attention kernels exactly
     twice the unsharded formula, the gate once; then
     moonshot-v1-16b-a3b cut to 1 + 8 layers teacher-forced on two model
     shards (experts split, ``moe_route`` once a shard a MoE layer);
     (10b, only with two cards or more) moonshot-v1-16b-a3b at its 48
     layers drawn a model shard a card on a ``1x2`` mesh over two cards,
     serving the workload (with one card, a line saying 10b did not
     run);
 11. the data axis (alone: ``scripts/torch_data_axis_phase.py``), both
     tiers on ``2x1`` over the first card twice against unsharded, 8
     requests a run, launches exact (:func:`data_axis_launches`),
     same-tier streams equal, peak memory without a second copy of the
     weights: (11a, after phase 10 on phase 4's weights) the uniform
     prefill path (640-token prompts), then the dense arena; (11b)
     speculation at k = 4, ``gen_len`` 8 (16 before PR 32); (11c,
     after phase 5's MoE cascade) granite-moe-3b-a800m cut to 2 layers
     teacher-forced on
     two data shards against unsharded over the JAX layout and against
     the CPU, then its cascade served (``moe_route`` once a MoE layer a
     tier launch; streams recorded, not held); (11d, after the RWKV-6 cascade)
     gemma3-1b -> rwkv6-3b on ``2x1``;
 12. the model axis under every executor and tier family (alone:
     ``scripts/torch_model_axis_executors_phase.py``), both tiers on
     ``1x2`` over the first card twice with ``--shard-params`` against
     unsharded (phase 11's unsharded runs where the workload and the
     weights are the same), 8 requests a run, launches exact (every
     kernel twice the unsharded formula, the gate once), same-tier
     streams equal, blocks conserved, peak memory without a second copy
     of the weights:
     (12a, after phase 11b on phase 4's weights) the uniform prefill,
     then the dense arena; (12b) speculation at k = 4; (12c, after 11d)
     gemma3-1b -> rwkv6-3b (RWKV-6 heads split); (12d, after phase 5's
     jamba) -> jamba-v0.1-52b cut to 1 period (Mamba channels, experts
     and heads split); (12e, after phase 8) -> qwen2-vl-72b cut to 8
     layers (the frontend's rows and M-RoPE heads split); 12c-e each also
     teacher-force a uniform prefill and one dense decode step of the
     tier cut to 2 layers (jamba: the narrow 8-layer period) on two
     model shards against unsharded, logits within 5e-5; (12b, only with
     five cards or more) qwen2-vl-72b at its 80 layers drawn a model
     shard a card on a ``1x4`` mesh behind gemma3-1b on a fifth card,
     its fit per card printed first, slots halved until it fits (with
     fewer cards, a line saying 12b did not run);
 13. sharded training, after phase 7 on phase 4's phi4-mini-3.8b
     (``check_sharded_training``; alone:
     ``scripts/torch_sharded_train_phase.py``): two steps of the train
     and LtC steps built with ``mesh=`` (params and adafactor state
     placed by their specs, the batch split by ``shard_batch``) on
     ``2x1`` and ``1x2`` over one card against the unsharded steps on
     phase 7b's batches (4 x 256 tokens): (13a) LtC of the published
     gemma3-1b against the frozen phi4-mini-3.8b (also ``2x1`` over two
     cards where two are visible), (13b) granite-moe-3b-a800m at its
     published widths cut to 2 layers, each MoE layer routed once over
     the global batch (``moe_route`` [1, 1024, 40]), (13c) rwkv6-3b cut
     to 2 layers on ``1x2``: per-step losses and, after each step, the
     gathered params and Adafactor state against unsharded's (every step
     before a routing near-tie), exact ``moe_route`` / ``rwkv6_scan``
     launches, step ms, tokens/s and peak memory.
 14. the dry-run's accounting against the card, after phase 13 on phase
     4's phi4-mini-3.8b (``check_dryrun``; alone:
     ``scripts/torch_dryrun_phase.py``): each step traced on a mesh of
     ``meta`` devices (``launch.dryrun.trace_cfg``), then run on the
     same mesh over the card under the same counting mode — (14a)
     phi4's prefill of 8 x 640 tokens on ``1x1`` and ``1x2``, (14b) its
     decode over a 640-token dense cache on ``1x1`` and ``2x1``, (14c)
     granite-moe-3b-a800m cut to 2 layers, a train step of 4 x 256
     tokens on ``2x1``: FLOPs, bytes, kernel calls and collectives equal,
     launches equal to the traced calls, argument bytes exact, the
     roofline's share of the step at most 1.05, the peak estimate beside
     ``max_memory_allocated``.
 15. the sequence-split decode, after phase 14 on phase 4's gemma3-1b
     (``check_seq_split``; alone: ``scripts/torch_seq_split_phase.py``):
     a batch of 1 over a dense f32 cache of ``long_500k``'s 524288
     positions (27.9 GB), the unsharded ``make_serve_step`` first, then
     ``make_serve_step(mesh=)`` on ``2x1`` (the keys split over the data
     shards) and on ``1x2`` and ``2x2`` with ``seq_over_model`` (over
     every device), each over the card on the same cache drawn again,
     4 steps from position 524280 and 2 from 200000: logits within 5e-5
     of unsharded, argmax equal past the top-2 margin, the written K/V
     rows on their owner, every other row unchanged, median step ms and
     peak memory; then the dry-run's trace of ``long_500k`` on ``2x1``
     against the card (phase 14's checks, the merges among the
     collectives).

The lines before the last are JSON records of the findings (one of them
the ``{"kernels": [...]}`` summary) and the card's ``name, power.limit``
line; the last line is ``{"ok": true, "device": {...}}``.  The script
imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import math
import os
import subprocess
import sys
import time
from argparse import Namespace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import Layer, get_config  # noqa: E402
from repro_torch.core import (calibration, cascade,  # noqa: E402
                              confidence, losses, thresholds)
from repro_torch.data import (Batches, bigram_lm, shard_batch,  # noqa: E402
                              teacher_task)
from repro_torch.kernels import confidence_gate as gate_mod  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import mamba_scan as mamba_mod  # noqa: E402
from repro_torch.kernels import mixed_attention as mixed_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import ragged_attention as ragged_mod  # noqa: E402
from repro_torch.kernels import router_gate as router_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rwkv_mod  # noqa: E402
from repro_torch.launch import serve as serve_mod  # noqa: E402
from repro_torch.launch import dryrun, serve_async, steps, train  # noqa: E402
from repro_torch.launch import shapes as shapes_lib  # noqa: E402
from repro_torch.launch.mesh import (HBM_BW, PEAK_FLOPS_F32,  # noqa: E402
                                     PEAK_FLOPS_TF32, make_tier_mesh)
from repro_torch.models import (blocks, classifier,  # noqa: E402
                                init_params, sharding, transformer)
from repro_torch.models import params as params_lib  # noqa: E402
from repro_torch.models.cache import (cache_specs,  # noqa: E402
                                     declare_cache, declare_paged_cache,
                                     init_paged_cache)
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import Optimizer  # noqa: E402
from repro_torch.serving.engine import (CascadeEngine,  # noqa: E402
                                        VirtualClock, _TierRuntime)
from repro_torch.serving.slots import (DenseTierSlotPool,  # noqa: E402
                                       TierSlotPool)



def emit(**record) -> None:
    print(json.dumps(record, default=float), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int, flush: torch.Tensor) -> float:
    """Mean milliseconds per call from CUDA events around each call,
    after a warm-up call, with L2 flushed before every call (the main
    path finds each layer's pools cold)."""
    fn()
    total = 0.0
    for _ in range(iters):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / iters


# --------------------------------------------------------------------------
# phase 2: kernels against plain versions
# --------------------------------------------------------------------------


def device_ms(fn, iters: int = 100) -> float:
    """Mean milliseconds per call of ``fn`` with its launches queued back
    to back on the device: the stream first spins for ~0.1 s
    (``torch.cuda._sleep``) while the host enqueues every call, so CUDA
    events around the calls time the device alone, without the gaps the
    host leaves between launches (which events around one call of a
    microsecond kernel also time)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def kernel_ms(fn, kind: str, flush: torch.Tensor, iters: int = 10) -> float:
    """Device milliseconds per call of the kernels of ``kind`` (its merge
    kernels included), L2 flushed before each call, from
    ``torch.profiler``: the kernels' own time, without the host's launch
    gaps that CUDA events around one call of a short kernel also time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for e in prof.key_averages():
        if any(n in e.key for n in KERNEL_NAMES[kind]):
            us += getattr(e, "self_device_time_total", None) or getattr(
                e, "self_cuda_time_total", 0.0)
    return us / 1e3 / iters


def paged_pool(gen, dev, *, KV, hd, kv_dtype, R, P, bs):
    """Random KV pools of N = R*P + 1 blocks (int8 with scales, or float)
    and a page table [R, P] of shuffled blocks (block 0 never mapped)."""
    N = R * P + 1
    if kv_dtype == torch.int8:
        kp = torch.randint(-127, 128, (N, bs, KV, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        vp = torch.randint(-127, 128, (N, bs, KV, hd), generator=gen,
                           device=dev, dtype=torch.int8)
        ks = torch.rand(N, bs, KV, generator=gen, device=dev) * 0.04 + 0.01
        vs = torch.rand(N, bs, KV, generator=gen, device=dev) * 0.04 + 0.01
    else:
        kp = torch.randn(N, bs, KV, hd, generator=gen, device=dev).to(
            kv_dtype)
        vp = torch.randn(N, bs, KV, hd, generator=gen, device=dev).to(
            kv_dtype)
        ks = vs = None
    perm = torch.randperm(N - 1, generator=gen, device=dev) + 1
    pt = perm[:R * P].reshape(R, P).to(torch.int32).contiguous()
    return kp, vp, ks, vs, pt


def ragged_case(gen, dev, *, KV, G, hd, qlens, q_start, window, dtype,
                kv_dtype, R=8, P=41, bs=16, W=None):
    """Inputs at main-path layout: R engine rows, P pages of bs tokens
    per row (prompt 640 + gen 8 -> 41 pages), N = R*P + 1 blocks; ``W``
    flat slots (by default the power-of-two bucket of the live
    tokens)."""
    qlen = torch.tensor(qlens, dtype=torch.int32)
    total = int(qlen.sum())
    if W is None:
        W = 8
        while W < max(total, 1):
            W *= 2
    q = torch.randn(W, KV, G, hd, generator=gen, device=dev).to(dtype)
    kp, vp, ks, vs, pt = paged_pool(gen, dev, KV=KV, hd=hd,
                                    kv_dtype=kv_dtype, R=R, P=P, bs=bs)
    args = (q, kp, vp, pt, torch.tensor(q_start, dtype=torch.int32,
                                        device=dev), qlen.to(dev))
    kw = dict(k_scale=ks, v_scale=vs, window=window)
    return args, kw


def bound(nbytes: float, nops: float):
    """The CUDA-core bound of a kernel's work (its ``*_work``): its bytes
    over HBM's rate against its operations at the f32 peak
    (``launch.mesh``'s H100 SXM data-sheet figures, 700 W)."""
    tb, to = nbytes / HBM_BW * 1e3, nops / PEAK_FLOPS_F32 * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def tc_bound_ms(nbytes: float, nops: float, kind: str) -> float:
    """Least time of a 3xTF32 tensor-core kernel: the bytes over HBM's
    rate against its TF32 products at the tensor cores' peak — 3 per f32
    operation (hi.hi + hi.lo + lo.hi), 1 for bf16 inputs."""
    terms = 3 if kind == "f32" else 1
    return max(nbytes / HBM_BW, terms * nops / PEAK_FLOPS_TF32) * 1e3


def ptxas_lines(name: str, instance: str = "") -> list:
    """The register and spill lines of the kernel's ``-Xptxas -v`` build
    log, each after the line that names its function (phase 1 records
    them for every kernel).  With ``instance``, a piece of one template
    instance's mangled name (``ragged_kernelIffLi128E``: float q, float
    pools, hd 128), only that instance's lines."""
    log = kernels.library_path(name).with_suffix(".log")
    if not log.is_file():
        return []
    out, keep = [], True
    for line in log.read_text().splitlines():
        if "Compiling entry" in line:
            keep = instance in line
        if keep and ("registers" in line or "spill" in line
                     or "Compiling entry" in line):
            out.append(line.strip())
    return out


def launched_splits(fn, kind: str, axis: int = 2):
    """The split count one call of ``fn`` launched: grid z (``axis``; y
    for the gate's vocab splits) of the kind's tile kernel (its first
    ``KERNEL_NAMES`` entry), read from the profiler's trace of that call,
    with the launches of its merge kernels beside it (none for one split,
    and none for the gate, whose last block merges).  None where the
    trace gives no grid."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    path = kernels.BUILD_DIR / f"{kind}-grid-trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text()).get("traceEvents", [])
    path.unlink()
    tile, *merge = KERNEL_NAMES[kind]
    kern = [e for e in events if e.get("cat") == "kernel"]
    grids = [e.get("args", {}).get("grid") for e in kern
             if tile in e.get("name", "")]
    merges = sum(any(m in e.get("name", "") for m in merge) for e in kern)
    if len(grids) != 1 or not grids[0]:
        return None, merges
    return int(grids[0][axis]), merges


def time_case(name, timed, kernel, plain, work, flush):
    """CUDA-event times of the kernel (20 calls) and its plain version (5
    calls), L2 flushed before each, beside the bound of this call's
    ``work`` (its kernel's ``*_work``: bytes, operations, rate kind)."""
    ms = time_ms(kernel, 20, flush)
    plain_ms = time_ms(plain, 5, flush)
    nbytes, nops = work[:2]
    b_ms, b_by = bound(nbytes, nops)
    timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, bytes=nbytes, ops=nops)
    return timed[name]


GEMMA = dict(KV=1, G=4, hd=256)
PHI4 = dict(KV=8, G=3, hd=128)
GRANITE = dict(KV=8, G=3, hd=64)
# the attention layers of phase 8's configs: starcoder2-7b's G 9 (7
# tokens a work item of the tile body), qwen2-vl-72b's, musicgen-large's
# (hd 64, no grouping), moonshot-v1-16b-a3b's and kimi-k2-1t-a32b's
# (head width 112)
REGISTRY_LAYERS = (("starcoder2", dict(KV=4, G=9, hd=128)),
                   ("qwen2-vl", dict(KV=8, G=8, hd=128)),
                   ("musicgen", dict(KV=32, G=1, hd=64)),
                   ("moonshot", dict(KV=16, G=1, hd=128)),
                   ("kimi", dict(KV=8, G=8, hd=112)))
KIMI = dict(REGISTRY_LAYERS)["kimi"]
NEAR600 = [590, 595, 600, 605, 610, 615, 620, 625]     # decode ticks
# a speculative verify launch's rows at the decode tick: a token and up
# to 4 drafts each (q_len 1-5)
VERIFY_QLENS = [5, 1, 3, 5, 2, 4, 5, 1]
# (W, q_len per row, q_start): flat widths that only a --flat-buckets
# override gives
FLAT_WIDTHS = ((48, [5, 1, 0, 12, 3, 1, 7, 2],
                [580, 600, 0, 560, 620, 625, 540, 610]),
               (160, [64, 20, 1, 0, 33, 1, 9, 2],
                [560, 600, 625, 0, 520, 610, 580, 590]))
# (atol, rtol) against the plain version by case kind; bf16 cases hold
# the kernel on bf16 inputs against the plain version in f32 on the same
# values, so only the output's rounding to bf16 (2^-9 relative) separates
# them
TOLS = {"f32": (1e-4, 1e-4), "bf16": (1e-3, 1e-2),
        "int8+scales": (1e-4, 1e-4)}
TOL_TEXT = ("atol=rtol=1e-4 (f32, int8+scales); atol 1e-3, rtol 1e-2 "
            "(bf16)")


def close(got, want, kind):
    """``got`` (any float dtype) within the kind's tolerance of ``want``
    (f32), and its max abs error."""
    atol, rtol = TOLS[kind]
    err = (got.float() - want).abs().max().item() if got.numel() else 0.0
    return err, bool(torch.allclose(got.float(), want, atol=atol, rtol=rtol))


def model_shard_layouts(m: int = 2):
    """(label, shape, window) of one model shard's attention at the
    layouts phase 10 serves: each config's heads as
    :func:`repro_torch.models.sharding.shard_config` gives them to a
    shard of an ``m``-wide model axis."""
    out = []
    for name, window in (("gemma3-1b", 512), ("phi4-mini-3.8b", None),
                         ("moonshot-v1-16b-a3b", None)):
        c = sharding.shard_config(get_config(name, ""), m)
        out.append((f"{name.split('-')[0]} m{m}",
                    dict(KV=c.num_kv_heads, G=c.num_heads // c.num_kv_heads,
                         hd=c.head_dim), window))
    return out


def check_ragged(dev, flush):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    gemma, phi4, near600 = GEMMA, PHI4, NEAR600
    mixed = [64, 0, 64, 1, 1, 37, 0, 64]       # 0-rows, padded tail
    late = [580, 0, 0, 580, 17, 600, 3, 520]   # positions past 512
    full = [64] * 8
    cases = [
        ("gemma window=512 f32", gemma, mixed, late, 512, "f32"),
        ("gemma global f32", gemma, mixed, late, None, "f32"),
        ("gemma window=512 full bucket f32", gemma, full,
         [0, 100, 200, 300, 400, 500, 560, 580], 512, "f32"),
        ("gemma window=512 decode f32", gemma, [1] * 8, near600, 512, "f32"),
        ("gemma all-idle f32", gemma, [0] * 8, late, 512, "f32"),
        ("phi4 f32", phi4, mixed, late, None, "f32"),
        ("phi4 full bucket f32", phi4, full,
         [0, 100, 200, 300, 400, 500, 560, 580], None, "f32"),
        ("phi4 decode f32", phi4, [1] * 8, near600, None, "f32"),
        # speculative verify windows: phi4's 5-token items take the tile
        # body's decode layout (15 query rows), gemma3's its prefill
        # layout (20), beside 1-4-token items in the same launch
        ("phi4 verify f32", phi4, VERIFY_QLENS, near600, None, "f32"),
        ("gemma window=512 verify f32", gemma, VERIFY_QLENS, near600, 512,
         "f32"),
        ("gemma window=512 bf16", gemma, mixed, late, 512, "bf16"),
        ("phi4 bf16", phi4, mixed, late, None, "bf16"),
        ("phi4 int8+scales", phi4, mixed, late, None, "int8+scales"),
        ("granite full bucket f32", GRANITE, full,
         [0, 100, 200, 300, 400, 500, 560, 580], None, "f32"),
        ("granite decode f32", GRANITE, [1] * 8, near600, None, "f32"),
    ]
    # phase 8's layers at the full bucket and the decode tick, and kimi's
    # head width 112 in bf16 and over int8 pools
    for label, shape in REGISTRY_LAYERS:
        cases += [(f"{label} full bucket f32", shape, full,
                   [0, 100, 200, 300, 400, 500, 560, 580], None, "f32"),
                  (f"{label} decode f32", shape, [1] * 8, near600, None,
                   "f32")]
    cases += [("kimi bf16", KIMI, mixed, late, None, "bf16"),
              ("kimi int8+scales", KIMI, mixed, late, None, "int8+scales")]
    # one model shard's heads at phase 10's 1x2 meshes, derived from the
    # configs by the KV-head rule (shard_config): gemma3-1b's one KV
    # head read by G 2 with its window, phi4-mini-3.8b's KV 4 x G 3,
    # moonshot-v1-16b-a3b's KV 8 x G 1
    for label, shape, window in model_shard_layouts():
        w = f" window={window}" if window else ""
        cases += [(f"{label}{w} f32", shape, mixed, late, window, "f32"),
                  (f"{label}{w} full bucket f32", shape, full,
                   [0, 100, 200, 300, 400, 500, 560, 580], window, "f32"),
                  (f"{label}{w} decode f32", shape, [1] * 8, near600,
                   window, "f32")]
    # flat widths off the powers of two (phase 4e's --flat-buckets 16 48
    # 160 512): partly filled rows late in their pages
    for W, qlens, qstart in FLAT_WIDTHS:
        cases += [(f"phi4 W={W} f32", dict(phi4, W=W), qlens, qstart, None,
                   "f32"),
                  (f"gemma window=512 W={W} f32", dict(gemma, W=W), qlens,
                   qstart, 512, "f32")]
    worst, timed = 0.0, {}
    for name, shape, qlens, qstart, window, kind in cases:
        dt, kvdt = dtypes_of(kind)
        args, kw = ragged_case(gen, dev, qlens=qlens, q_start=qstart,
                               window=window, dtype=dt, kv_dtype=kvdt,
                               **shape)
        got = ragged_mod.ragged_attention(*args, **kw)
        torch.cuda.synchronize()
        # bf16 inputs: the plain version computes in f32 on the same
        # (bf16-rounded) values
        fargs = (args[0].float(),) + args[1:]
        want = ragged_mod.ragged_attention_ref(*fargs, **kw)
        err, ok = close(got, want, kind)
        if sum(qlens) == 0 and got.abs().max().item() != 0.0:
            ok = False
        emit(check="ragged_attention", case=name, W=int(args[0].shape[0]),
             max_abs_err=err, atol_rtol=TOLS[kind], ok=ok)
        if not ok:
            raise AssertionError(f"ragged_attention {name}: max abs err "
                                 f"{err} past (atol, rtol) {TOLS[kind]}")
        if kind != "bf16":
            worst = max(worst, err)
        # timed: the full prefill bucket (8 rows x 64 tokens) and the
        # decode tick (one token per row), the two ends of a tick's load,
        # and the speculative verify windows
        if name.endswith(("full bucket f32", "decode f32", "verify f32")):
            t = time_case(
                name, timed,
                lambda: ragged_mod.ragged_attention(*args, **kw),
                lambda: ragged_mod.ragged_attention_ref(*args, **kw),
                ragged_mod.ragged_attention_work(*args, **kw, exact=True),
                flush)
            t["tc_bound_ms"] = tc_bound_ms(t["bytes"], t["ops"], kind)
            t["splits"], t["merge_launches"] = launched_splits(
                lambda: ragged_mod.ragged_attention(*args, **kw),
                "ragged_attention")
            t["kernel_ms"] = kernel_ms(
                lambda: ragged_mod.ragged_attention(*args, **kw),
                "ragged_attention", flush)
            emit(timing="ragged_attention", case=name,
                 ptxas=ptxas_lines(
                     "ragged_attention",
                     f"ragged_kernelIffLi{args[0].shape[-1]}E"), **t)
        del args, kw, got, want
    torch.cuda.empty_cache()
    return worst, timed


def dtypes_of(kind):
    """(q dtype, pool dtype) of a case kind: f32, bf16 or int8+scales."""
    return {"f32": (torch.float32, torch.float32),
            "bf16": (torch.bfloat16, torch.bfloat16),
            "int8+scales": (torch.float32, torch.int8)}[kind]


# (label, shape, window, kinds) of the attention layers on the main
# paths: gemma3's sliding-window layers, its global layers (1 in 6),
# phi4's layers and granite's (hd 64), and phase 8's (kimi's head width
# 112 in every kind)
LAYERS = (("gemma", GEMMA, 512, ("f32", "bf16", "int8+scales")),
          ("gemma", GEMMA, None, ("f32",)),
          ("phi4", PHI4, None, ("f32", "bf16", "int8+scales")),
          ("granite", GRANITE, None, ("f32",))) + tuple(
    (label, shape, None, ("f32", "bf16", "int8+scales") if shape is KIMI
     else ("f32",)) for label, shape in REGISTRY_LAYERS)


def check_paged(dev, flush):
    """paged_attention at the decode tick the ragged kernel is timed at
    (8 rows, one token each at positions 590-625) plus, in the checked
    cases, a ninth row masked to the null block as the split decode step
    masks a mid-prefill row (its output is not compared); and, per f32
    layer, the speculative draft loop's step with rows 1, 4 and 6 past
    their draft budget (an all-null page-table row at position 0)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    worst, timed = 0.0, {}
    for shape_name, shape, window, kinds in LAYERS:
        for kind in kinds:
            dt, kvdt = dtypes_of(kind)
            kp, vp, ks, vs, pt = paged_pool(gen, dev, kv_dtype=kvdt, R=9,
                                            P=41, bs=16, KV=shape["KV"],
                                            hd=shape["hd"])
            pt[8] = 0                                   # the masked row
            pos = torch.tensor(NEAR600 + [300], dtype=torch.int32,
                               device=dev)
            q = torch.randn(9, shape["KV"], shape["G"], shape["hd"],
                            generator=gen, device=dev).to(dt)
            kw = dict(k_scale=ks, v_scale=vs, window=window)
            got = paged_mod.paged_attention(q, kp, vp, pt, pos, **kw)
            torch.cuda.synchronize()
            want = paged_mod.paged_attention_ref(q.float(), kp, vp, pt, pos,
                                                 **kw)
            err, ok = close(got[:8], want[:8], kind)
            ok = ok and bool(torch.isfinite(got.float()).all())
            name = f"{shape_name} decode {kind}" + (
                f" window={window}" if window else
                " global" if shape is GEMMA else "")
            emit(check="paged_attention", case=name, rows=9, masked_rows=1,
                 max_abs_err=err, atol_rtol=TOLS[kind], ok=ok)
            if not ok:
                raise AssertionError(f"paged_attention {name}: max abs err "
                                     f"{err} past (atol, rtol) {TOLS[kind]}")
            if kind != "bf16":
                worst = max(worst, err)
            a8 = (q[:8].contiguous(), kp, vp, pt[:8].contiguous(),
                  pos[:8].contiguous())
            if kind == "f32":
                worst = max(worst, check_masked_rows(a8, kw, name))
                # timed on the 8 live rows: the ragged kernel's decode case
                t = time_case(
                    name, timed,
                    lambda: paged_mod.paged_attention(*a8, **kw),
                    lambda: paged_mod.paged_attention_ref(*a8, **kw),
                    paged_mod.paged_attention_work(*a8, **kw, exact=True),
                    flush)
                t["tc_bound_ms"] = tc_bound_ms(t["bytes"], t["ops"], kind)
                t["splits"], t["merge_launches"] = launched_splits(
                    lambda: paged_mod.paged_attention(*a8, **kw),
                    "paged_attention")
                t["kernel_ms"] = kernel_ms(
                    lambda: paged_mod.paged_attention(*a8, **kw),
                    "paged_attention", flush)
                emit(timing="paged_attention", case=name,
                     ptxas=ptxas_lines(
                         "paged_attention",
                         f"paged_decode_kernelIffLi{shape['hd']}E"), **t)
            del kp, vp, ks, vs, pt, q, got, want, a8
    torch.cuda.empty_cache()
    return worst, timed


DRAFT_MASKED = [1, 4, 6]


def check_masked_rows(args, kw, name) -> float:
    """The draft loop's decode step on ``args``' 8 rows with rows
    ``DRAFT_MASKED`` on the null block at position 0: the live rows
    bit-identical to the launch with no row masked and within the
    tolerance of the plain version on the same (masked) inputs, every
    row finite.  Returns the live rows' max abs error."""
    q, kp, vp, pt, pos = args
    mpt, mpos = pt.clone(), pos.clone()
    mpt[DRAFT_MASKED] = 0
    mpos[DRAFT_MASKED] = 0
    live = [b for b in range(pt.shape[0]) if b not in DRAFT_MASKED]
    full = paged_mod.paged_attention(*args, **kw)
    got = paged_mod.paged_attention(q, kp, vp, mpt, mpos, **kw)
    want = paged_mod.paged_attention_ref(q, kp, vp, mpt, mpos, **kw)
    torch.cuda.synchronize()
    err, ok = close(got[live], want[live], "f32")
    same = bool(torch.equal(got[live], full[live]))
    ok = ok and same and bool(torch.isfinite(got).all())
    emit(check="paged_attention", case=f"{name} draft step, rows "
         f"{DRAFT_MASKED} masked", rows=8, masked_rows=DRAFT_MASKED,
         max_abs_err=err, live_rows_equal_unmasked=same,
         atol_rtol=TOLS["f32"], ok=ok)
    if not ok:
        raise AssertionError(f"paged_attention {name} with rows "
                             f"{DRAFT_MASKED} masked: max abs err {err}, "
                             f"live rows equal unmasked {same}")
    return err


def check_mixed(dev, flush):
    """mixed_attention at the padded executor's [8, 64] bucket: a full
    prefill bucket, a mix of q_len in {0, 1, 64, tail} at positions past
    512, and the width-1 decode batch of a decode-only tick.  Live slots
    are compared; dead ones must be zero."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    full = ([64] * 8, [0, 100, 200, 300, 400, 500, 560, 580], 64)
    mixed = ([64, 0, 64, 1, 1, 37, 0, 64],
             [580, 0, 0, 580, 17, 600, 3, 520], 64)
    decode = ([1] * 8, NEAR600, 1)
    worst, timed = 0.0, {}
    for shape_name, shape, window, kinds in LAYERS:
        # the timed cases on the windowed and phi4 layers only
        cases = [("full bucket", full, "f32"), ("decode width 1", decode,
                                               "f32")] if len(kinds) > 1 \
            else []
        cases += [("mixed q_len", mixed, k) for k in kinds]
        for label, (qlens, starts, C), kind in cases:
            dt, kvdt = dtypes_of(kind)
            kp, vp, ks, vs, pt = paged_pool(gen, dev, kv_dtype=kvdt, R=8,
                                            P=41, bs=16, KV=shape["KV"],
                                            hd=shape["hd"])
            q = torch.randn(8, C, shape["KV"], shape["G"], shape["hd"],
                            generator=gen, device=dev).to(dt)
            qs = torch.tensor(starts, dtype=torch.int32, device=dev)
            ql = torch.tensor(qlens, dtype=torch.int32, device=dev)
            kw = dict(k_scale=ks, v_scale=vs, window=window)
            args = (q, kp, vp, pt, qs, ql)
            got = mixed_mod.mixed_attention(*args, **kw)
            torch.cuda.synchronize()
            want = mixed_mod.mixed_attention_ref(q.float(), *args[1:], **kw)
            live = (torch.arange(C, device=dev)[None, :] < ql[:, None])
            err, ok = close(got[live], want[live], kind)
            ok = ok and not got[~live].any().item()
            name = f"{shape_name} {label} [8, {C}] {kind}" + (
                f" window={window}" if window else
                " global" if shape is GEMMA else "")
            emit(check="mixed_attention", case=name, max_abs_err=err,
                 atol_rtol=TOLS[kind], ok=ok)
            if not ok:
                raise AssertionError(f"mixed_attention {name}: max abs err "
                                     f"{err} past (atol, rtol) {TOLS[kind]} "
                                     "(or dead slots not zero)")
            if kind != "bf16":
                worst = max(worst, err)
            if label in ("full bucket", "decode width 1"):
                t = time_case(
                    name, timed,
                    lambda: mixed_mod.mixed_attention(*args, **kw),
                    lambda: mixed_mod.mixed_attention_ref(*args, **kw),
                    mixed_mod.mixed_attention_work(*args, **kw, exact=True),
                    flush)
                t["tc_bound_ms"] = tc_bound_ms(t["bytes"], t["ops"], kind)
                t["splits"], t["merge_launches"] = launched_splits(
                    lambda: mixed_mod.mixed_attention(*args, **kw),
                    "mixed_attention")
                t["kernel_ms"] = kernel_ms(
                    lambda: mixed_mod.mixed_attention(*args, **kw),
                    "mixed_attention", flush)
                emit(timing="mixed_attention", case=name,
                     ptxas=ptxas_lines(
                         "mixed_attention",
                         f"mixed_kernelIffLi{shape['hd']}E"), **t)
            del kp, vp, ks, vs, pt, q, got, want, args
    torch.cuda.empty_cache()
    return worst, timed


def check_gate(dev, flush):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    worst, timed = {"conf": 0.0, "entropy": 0.0, "logz": 0.0}, {}
    # 8 rows: a tier launch's last slots; under speculation the gate
    # takes every flat slot of a spec launch, up to gemma3's [512,
    # 262144] (un-split: one split a row) and phi4's [W, 200064]
    for name, R, V in (("gemma3-1b", 8, 262144),
                       ("phi4-mini-3.8b", 8, 200064),
                       ("granite-moe-3b-a800m", 8, 49155),
                       ("rwkv6-3b / jamba-v0.1-52b", 8, 65536),
                       ("starcoder2-7b", 8, 49152),
                       ("musicgen-large", 8, 2048),
                       ("qwen2-vl-72b", 8, 152064),
                       ("moonshot-v1-16b-a3b / kimi-k2-1t-a32b", 8, 163840),
                       ("gemma3-1b spec", 512, 262144),
                       ("phi4-mini-3.8b spec", 64, 200064)):
        # random logits at a spread where the max is well separated
        x = torch.randn(R, V, generator=gen, device=dev) * 3.0
        got = gate_mod.confidence_gate(x)
        # the plain version in f64, rounded to f32: agreement does not
        # hang on the order of the f32 sums
        want = {k: v.float() if v.is_floating_point() else v
                for k, v in gate_mod.confidence_gate_ref(x.double()).items()}
        torch.cuda.synchronize()
        errs = {k: (got[k] - want[k]).abs().max().item()
                for k in ("conf", "entropy", "logz")}
        ok = (torch.allclose(got["conf"], want["conf"], rtol=1e-5, atol=0)
              and torch.allclose(got["logz"], want["logz"], rtol=1e-5,
                                 atol=0)
              and torch.allclose(got["entropy"], want["entropy"], atol=1e-4,
                                 rtol=0)
              and torch.equal(got["argmax"], want["argmax"]))
        emit(check="confidence_gate", case=f"{name} [{R}, {V}] f32",
             ok=bool(ok), **{f"max_abs_err_{k}": v for k, v in errs.items()},
             tol={"conf": "rtol 1e-5", "logz": "rtol 1e-5",
                  "entropy": "atol 1e-4", "argmax": "exact"})
        if not ok:
            raise AssertionError(f"confidence_gate {name}: {errs}")
        for k in worst:
            worst[k] = max(worst[k], errs[k])
        ms = time_ms(lambda: gate_mod.confidence_gate(x), 50, flush)
        plain_ms = time_ms(lambda: gate_mod.confidence_gate_ref(x), 20,
                           flush)
        nbytes, nops, _ = gate_mod.confidence_gate_work(x)
        b_ms, b_by = bound(nbytes, nops)
        timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, bytes=nbytes, ops=nops,
                           device_ms=device_ms(
                               lambda: gate_mod.confidence_gate(x)),
                           kernel_ms=kernel_ms(
                               lambda: gate_mod.confidence_gate(x),
                               "confidence_gate", flush))
        timed[name]["splits"], _ = launched_splits(
            lambda: gate_mod.confidence_gate(x), "confidence_gate", axis=1)
        emit(timing="confidence_gate", case=f"{name} [{R}, {V}] f32",
             **timed[name])
        del x, got, want
    # an exact tie: the first index must win
    x = torch.randn(4, 200064, generator=gen, device=dev)
    x[:, 1000] = 50.0
    x[:, 150000] = 50.0
    x[2, 7] = 50.0
    got = gate_mod.confidence_gate(x)
    want_idx = torch.tensor([1000, 1000, 7, 1000], dtype=torch.int32)
    tie_ok = torch.equal(got["argmax"].cpu(), want_idx) and torch.equal(
        gate_mod.confidence_gate_ref(x)["argmax"].cpu(), want_idx)
    emit(check="confidence_gate", case="exact tie, first index wins",
         ok=bool(tie_ok), argmax=got["argmax"].cpu().tolist())
    if not tie_ok:
        raise AssertionError("confidence_gate tie: first index must win")
    return worst, timed


def router_logits(rng, R, E, k, ties=False):
    """Router logits [R, E] whose k+1 largest values per row are at least
    1e-4 apart (the kernel ranks logits, the plain version f32
    probabilities: a closer pair could order differently).  ``ties``
    makes rows 0-2 exact ties: all equal, a three-way tie on the max, a
    tie for the k-th pick (lower index first)."""
    x = (rng.standard_normal((R, E)) * 2).astype(np.float32)
    for r in range(R):
        while (-np.diff(np.sort(x[r])[::-1][:k + 1])).min() < 1e-4:
            x[r] = (rng.standard_normal(E) * 2).astype(np.float32)
    if ties:
        x[0] = 0.5
        x[1, [E - 1, E // 2, 1]] = 30.0
        x[2, E - k + 1:] = 20.0 + np.arange(k - 1)
        x[2, [1, E - k]] = 15.0
    return torch.from_numpy(x)


ROUTER_TOL = "gates rtol 1e-5 (atol 0), indices exact"
ROUTE_TOL = ("gates and weights rtol 1e-5 (atol 0); idx, dest and keep "
             "exact")
# moe_route at the main paths' shapes: (name, G, gs, k, E, capacity
# factor, ties, dtype) — granite's full ragged/padded bucket, its decode
# width and phase 13's train route (4 x 256 tokens, one group), moonshot's (64 experts, top-6) and kimi's (384, top-8)
# full bucket, jamba's uniform prefill (5120 tokens: 5 groups of 1024),
# E at the kernel's 1024 limit, rows of exact ties, bf16 logits
ROUTE_CASES = (
    ("granite bucket [1, 512, 40]", 1, 512, 8, 40, 1.25, False, "f32"),
    ("granite decode [1, 8, 40]", 1, 8, 8, 40, 1.25, False, "f32"),
    ("granite train [1, 1024, 40]", 1, 1024, 8, 40, 1.25, False, "f32"),
    ("moonshot bucket [1, 512, 64]", 1, 512, 6, 64, 1.25, False, "f32"),
    ("kimi bucket [1, 512, 384]", 1, 512, 8, 384, 1.25, False, "f32"),
    ("jamba prefill [5, 1024, 16]", 5, 1024, 2, 16, 1.25, False, "f32"),
    ("[1, 64, 1024]", 1, 64, 8, 1024, 1.25, False, "f32"),
    ("granite ties [1, 512, 40]", 1, 512, 8, 40, 1.25, True, "f32"),
    ("granite bucket [1, 512, 40] bf16", 1, 512, 8, 40, 1.25, False,
     "bf16"),
    ("jamba ties [5, 1024, 16] bf16", 5, 1024, 2, 16, 1.25, True, "bf16"))


def route_cap(gs, k, E, cf):
    """``moe_ffn``'s capacity: min(gs, max(1, ceil(gs·k·cf / E)))."""
    return min(gs, max(1, int(np.ceil(gs * k * cf / E))))


def check_route(rng, dev, flush, timed):
    """moe_route (routing, queue ranks, dest and combine weight in one
    launch) against its plain version on the card at ``ROUTE_CASES``;
    the f32 cases without ties timed.  Work for the bound: the logits
    read, gates, idx, dest and weight written (4 + 4 + 8 + 4 bytes a
    pair), the routing's operations per row as ``router_gate``'s plus 4
    a pair for its rank and row (mask, count, compare, multiply-add)."""
    worst = 0.0
    for name, G, gs, k, E, cf, ties, kind in ROUTE_CASES:
        cap = route_cap(gs, k, E, cf)
        x = router_logits(rng, G * gs, E, k, ties).reshape(G, gs, E)
        if ties:    # equal rows around slot gs / 2: queues across blocks
            x[0, gs // 2 - 4:gs // 2 + 4] = 0.25
        x = x.to(torch.bfloat16 if kind == "bf16" else torch.float32).to(
            dev)
        got = router_mod.moe_route(x, k, cap)
        torch.cuda.synchronize()
        want = router_mod.moe_route_ref(x, k, cap)
        g, i, d, w = got
        wg, wi, wd, ww = want
        err = max((g - wg).abs().max().item(), (w - ww).abs().max().item())
        ok = (torch.equal(i, wi) and torch.equal(d, wd)
              and torch.equal(w == 0, ww == 0)
              and torch.allclose(g, wg, rtol=1e-5, atol=0.0)
              and torch.allclose(w, ww, rtol=1e-5, atol=0.0))
        dropped = int((wd == E * G * cap).sum())
        emit(check="moe_route", case=f"{name} k={k} cap={cap}",
             max_abs_err=err, tol=ROUTE_TOL, dropped_pairs=dropped,
             pairs=G * gs * k, ok=bool(ok))
        if not ok:
            raise AssertionError(f"moe_route {name}: max abs err {err} or "
                                 "idx/dest/keep differ")
        worst = max(worst, err)
        if not ties and kind == "f32":
            t = time_case(f"moe_route {name}", timed,
                          lambda: router_mod.moe_route(x, k, cap),
                          lambda: router_mod.moe_route_ref(x, k, cap),
                          router_mod.moe_route_work(x, k, cap), flush)
            t["device_ms"] = device_ms(
                lambda: router_mod.moe_route(x, k, cap))
            t["kernel_ms"] = kernel_ms(
                lambda: router_mod.moe_route(x, k, cap), "router_gate",
                flush)
            t["blocks_a_group"] = router_mod.route_blocks(gs)[1]
            emit(timing="moe_route", case=f"{name} k={k} cap={cap}", **t)
    return worst


def check_router(dev, flush):
    """router_gate against its plain version at granite's main-path
    shapes ([512, 40] padded/split chunk and the ragged full bucket,
    [8, 40] decode width), at E = 384 and E = 1024 (the kernel's limit),
    and on rows of exact ties, k = 8; and at jamba's uniform prefill
    (one group of 1024 of the 5120 tokens, E = 16, k = 2).  Work per row
    for the bound: E logits read and k (gate, index) pairs written; E
    subtractions, exponentials and additions, k rounds of E comparisons,
    2k divisions.  Then the fused ``moe_route``, which ``moe_ffn``
    launches, at its main-path shapes (:func:`check_route`)."""
    rng = np.random.default_rng(4)
    worst, timed = 0.0, {}
    cases = [("granite [512, 40]", 512, 40, False, 8),
             ("granite [8, 40]", 8, 40, False, 8),
             ("[64, 384]", 64, 384, False, 8),
             ("[16, 1024]", 16, 1024, False, 8),
             ("granite ties [8, 40]", 8, 40, True, 8),
             ("ties [16, 1024]", 16, 1024, True, 8),
             ("jamba [1024, 16]", 1024, 16, False, 2)]
    for name, R, E, ties, k in cases:
        x = router_logits(rng, R, E, k, ties).to(dev)
        gates, idx = router_mod.router_gate(x, k)
        torch.cuda.synchronize()
        want_g, want_i = router_mod.router_gate_ref(x, k)
        err = (gates - want_g).abs().max().item()
        ok = (torch.equal(idx, want_i)
              and torch.allclose(gates, want_g, rtol=1e-5, atol=0.0))
        if ties:
            top = sorted({1, E // 2, E - 1})
            i_h = idx.cpu()
            ok = ok and i_h[0].tolist() == list(range(k)) \
                and i_h[1, :3].tolist() == top \
                and int(i_h[2, k - 1]) == 1
        emit(check="router_gate", case=f"{name} k={k}", max_abs_err=err,
             tol=ROUTER_TOL, ok=bool(ok))
        if not ok:
            raise AssertionError(f"router_gate {name}: max abs err {err} "
                                 f"or indices differ")
        worst = max(worst, err)
        if not ties:
            t = time_case(name, timed, lambda: router_mod.router_gate(x, k),
                          lambda: router_mod.router_gate_ref(x, k),
                          router_mod.router_gate_work(x, k), flush)
            t["device_ms"] = device_ms(lambda: router_mod.router_gate(x, k))
            t["kernel_ms"] = kernel_ms(
                lambda: router_mod.router_gate(x, k), "router_gate", flush)
            emit(timing="router_gate", case=f"{name} k={k}", **t)
    worst = max(worst, check_route(rng, dev, flush, timed))
    worst = max(worst, check_route_shards(rng, dev, flush, timed))
    return worst, timed


ROUTE_SHARDS_TOL = "dest bit-equal, weights atol 1.2e-7"


def check_route_shards(rng, dev, flush, timed):
    """The route of a MoE layer on a data-sharded tier
    (``transformer.route_data_shards``, phase 11): granite's published
    route (40 experts, top-8, capacity factor 1.25) over a ragged launch
    of two data shards holding 200 and 240 live tokens, each packed at
    its own width 256, gathered into the tier's bucket of 512 (the JAX
    layout; slots 440-511 zero) and routed in one ``moe_route`` launch:
    each shard's ``dest`` bit-equal to the unsharded route's over the
    gathered logits on the card and to the plain version's, its weights
    within 1.2e-7 of both.  Timed against the plain route of the
    gathered batch; the bound is ``moe_route``'s at [1, 512, 40] plus the
    two shards' logits read once more and their picks written back."""
    spec = next(l.ffn for l in get_config(MOE_NAME, "").layers
                if l.ffn.kind == "moe")
    E, k, total = spec.num_experts, spec.top_k, 512
    live = (200, 240)
    x = router_logits(rng, sum(live), E, k)
    logits, slots, o = [], [], 0
    for n in live:
        lg = torch.zeros(256, E)
        lg[:n] = x[o:o + n]
        logits.append(lg.to(dev))
        slots.append(np.concatenate([o + np.arange(n), [total] * (256 - n)]))
        o += n
    layout = transformer.MoeLayout(slots, total)
    full = torch.zeros(1, total, E, device=dev)
    full[0, :o] = x.to(dev)
    cap = route_cap(total, k, E, spec.capacity_factor)
    got = transformer.route_data_shards(spec, logits, layout)
    torch.cuda.synchronize()
    _, _, dest, w = router_mod.moe_route(full, k, cap)
    _, _, ref_d, ref_w = router_mod.moe_route_ref(full, k, cap)
    err, ok, o = 0.0, True, 0
    for (d, ww, rows), n in zip(got, live):
        for want_d, want_w in ((dest, w), (ref_d, ref_w)):
            ok = ok and rows == cap and torch.equal(
                d[:n], want_d[0, o:o + n]) and bool(
                (d[n:] == E * cap).all())
            err = max(err, (ww[:n] - want_w[0, o:o + n]).abs().max().item())
        o += n
    ok = ok and err <= 1.2e-7
    name = "moe_route over 2 data shards (200 + 240 live) [1, 512, 40]"
    emit(check="moe_route", case=f"{name} k={k} cap={cap}",
         max_abs_err=err, tol=ROUTE_SHARDS_TOL,
         dropped_pairs=int((dest == E * cap).sum()), ok=bool(ok))
    if not ok:
        raise AssertionError(f"moe_route {name}: max abs err {err} or dest "
                             "differs")
    nbytes, nops, _ = router_mod.moe_route_work(
        full.view(1, total, E), k, cap)
    nbytes += 2 * o * E * 4 + o * k * 12
    t = time_case(name, timed,
                  lambda: transformer.route_data_shards(spec, logits, layout),
                  lambda: router_mod.moe_route_ref(full, k, cap),
                  (nbytes, nops), flush)
    emit(timing="moe_route", case=f"{name} k={k} cap={cap}", **t)
    return err


def check_flash(dev, flush):
    """flash_attention against its plain version at the uniform prefill's
    shapes — 8 prompts of 640 tokens: gemma3-1b's sliding (window 512)
    and global layers, q [8, 4, 640, 256] over k/v [8, 1, 640, 256], and
    phi4-mini-3.8b's, q [8, 24, 640, 128] over k/v [8, 8, 640, 128] —
    in f32 (the main path) and, untimed, bf16; and phase 8's:
    starcoder2-7b's, musicgen-large's, moonshot-v1-16b-a3b's and
    kimi-k2-1t-a32b's (head width 112; untimed also bf16) at 640 tokens,
    qwen2-vl-72b's at 1152.  The yardstick is one
    ``scaled_dot_product_attention(..., enable_gqa=True)`` call (causal,
    or a boolean window mask), which the port never calls.  Work for the
    bound: q, k, v read and out written once; 4·d f32 operations per
    visible (query, key) pair and query head.  Beside the CUDA-core bound
    (``bound_ms``, f32 at 67 TFLOP/s), each timing record carries the
    tensor-core bound of the kernel's 3xTF32 design (``tc_bound_ms``) and
    the kernel's ptxas register and spill lines."""
    import torch.nn.functional as F

    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    cases = [("gemma window=512", 8, 4, 1, 256, 512, "f32"),
             ("gemma global", 8, 4, 1, 256, None, "f32"),
             ("phi4", 8, 24, 8, 128, None, "f32"),
             ("phi4", 8, 24, 8, 128, None, "bf16"),
             ("gemma window=512", 8, 4, 1, 256, 512, "bf16")]
    cases = [c[:-1] + (640, c[-1]) for c in cases] + [
        # phase 11's uniform prefill on a 2x1 tier of 8 slots: each data
        # shard prefills its 4 rows
        ("phi4 data shard", 4, 24, 8, 128, None, 640, "f32"),
        ("gemma data shard window=512", 4, 4, 1, 256, 512, 640, "f32"),
        ("gemma data shard global", 4, 4, 1, 256, None, 640, "f32"),
        # phase 12's uniform prefill on 1x2 tiers: each model shard's
        # query and KV heads of 8 rows (phi4's 12 over 4, gemma3's 2 over
        # its one, qwen2-vl's 32 over 4 at 1152 tokens)
        ("phi4 model shard", 8, 12, 4, 128, None, 640, "f32"),
        ("gemma model shard window=512", 8, 2, 1, 256, 512, 640, "f32"),
        ("gemma model shard global", 8, 2, 1, 256, None, 640, "f32"),
        ("qwen2-vl model shard", 8, 32, 4, 128, None, 1152, "f32"),
        # phase 8's uniform prefills: qwen2-vl-72b's 1152-token prompts
        # (1024 patch positions, then 128 text), the others' 640; kimi's
        # head width 112
        ("starcoder2", 8, 36, 4, 128, None, 640, "f32"),
        ("musicgen", 8, 32, 32, 64, None, 640, "f32"),
        ("qwen2-vl", 8, 64, 8, 128, None, 1152, "f32"),
        ("moonshot", 8, 16, 16, 128, None, 640, "f32"),
        ("kimi", 8, 64, 8, 112, None, 640, "f32"),
        ("kimi", 8, 64, 8, 112, None, 640, "bf16")]
    worst, timed = 0.0, {}
    for label, B, H, KV, d, window, S, kind in cases:
        dt = dtypes_of(kind)[0]
        q, k, v = (torch.randn(B, n, S, d, generator=gen, device=dev).to(dt)
                   for n in (H, KV, KV))
        kw = dict(causal=True, window=window)
        got = flash_mod.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        want = flash_mod.flash_attention_ref(q.float(), k.float(), v.float(),
                                             **kw)
        err, ok = close(got, want, kind)
        name = f"{label} q [{B}, {H}, {S}, {d}] {kind}"
        emit(check="flash_attention", case=name, max_abs_err=err,
             atol_rtol=TOLS[kind], ok=ok)
        if not ok:
            raise AssertionError(f"flash_attention {name}: max abs err "
                                 f"{err} past (atol, rtol) {TOLS[kind]}")
        if kind == "bf16":
            continue
        worst = max(worst, err)
        mask = None
        if window:
            i = torch.arange(S, device=dev)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)

        def library():
            return F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, is_causal=mask is None,
                enable_gqa=True)
        lib_err = (library() - want).abs().max().item()
        nbytes, nops, _ = flash_mod.flash_attention_work(q, k, v, **kw)
        t = time_case(name, timed,
                      lambda: flash_mod.flash_attention(q, k, v, **kw),
                      lambda: flash_mod.flash_attention_ref(q, k, v, **kw),
                      (nbytes, nops), flush)
        t["library_ms"] = time_ms(library, 20, flush)
        t["library_max_abs_err"] = lib_err
        t["tc_bound_ms"] = tc_bound_ms(nbytes, nops, kind)
        emit(timing="flash_attention", case=name,
             ptxas=ptxas_lines("flash_attention", f"flash_kernelIfLi{d}E"),
             **t)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return worst, timed


RWKV_TOL = "y and final state atol=rtol=1e-4"


def check_rwkv(dev, flush):
    """rwkv6_scan against its plain version at rwkv6-3b's uniform prefill:
    r, k, v, w [8, 40, 640, 64] (w = exp(-exp(.)) in (0, 1)), u [40, 64],
    at one of phase 12's two model shards' heads, [8, 20, 640, 64], and
    at phase 13's train step on one of two model shards, [4, 20, 256,
    64], where the differentiable ``blocks._RWKV6Scan`` is also held to
    plain-torch autograd (:func:`check_rwkv_function`); both outputs (y
    and the final state) compared.  Work for the bound:
    the five inputs read and y and the state written once; per step and
    head 5·hd² f32 operations (2·hd² for r·S, 3·hd² for the decayed
    update w ⊙ S + k vᵀ) and 3·hd for the bonus term, folded into one
    scalar r·(u ⊙ k) times v.  No single PyTorch call computes the scan,
    so there is no yardstick."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    worst, timed = 0.0, {}
    for label, (B, H, T, hd) in (("rwkv6-3b", (8, 40, 640, 64)),
                                 ("rwkv6-3b model shard", (8, 20, 640, 64)),
                                 ("rwkv6-3b train model shard",
                                  (4, 20, 256, 64))):
        r, k, v = (torch.randn(B, H, T, hd, generator=gen, device=dev) * 0.5
                   for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(B, H, T, hd, generator=gen,
                                             device=dev) * 0.5 - 0.5))
        u = torch.randn(H, hd, generator=gen, device=dev) * 0.5
        y, s_T = rwkv_mod.rwkv6_scan(r, k, v, w, u)
        torch.cuda.synchronize()
        want_y, want_s = rwkv_mod.rwkv6_scan_ref(r, k, v, w, u)
        errs = {"y": (y - want_y).abs().max().item(),
                "state": (s_T - want_s).abs().max().item()}
        ok = bool(torch.allclose(y, want_y, atol=1e-4, rtol=1e-4)
                  and torch.allclose(s_T, want_s, atol=1e-4, rtol=1e-4))
        name = f"{label} [{B}, {H}, {T}, {hd}] f32"
        emit(check="rwkv6_scan", case=name, max_abs_err=errs, tol=RWKV_TOL,
             ok=ok)
        if not ok:
            raise AssertionError(f"rwkv6_scan {name}: {errs}")
        worst = max(worst, *errs.values())
        t = time_case(name, timed,
                      lambda: rwkv_mod.rwkv6_scan(r, k, v, w, u),
                      lambda: rwkv_mod.rwkv6_scan_ref(r, k, v, w, u),
                      rwkv_mod.rwkv6_scan_work(r, k, v, w, u), flush)
        t["kernel_ms"] = kernel_ms(
            lambda: rwkv_mod.rwkv6_scan(r, k, v, w, u), "rwkv6_scan", flush)
        emit(timing="rwkv6_scan", case=name,
             ptxas=ptxas_lines("rwkv6_scan", f"wkv_kernelILi{hd}E"), **t)
        if "train" in label:
            check_rwkv_function(name, (r, k, v, w, u))
        del r, k, v, w, u, y, s_T, want_y, want_s
    return worst, timed


def check_rwkv_function(name, inputs) -> None:
    """``blocks._RWKV6Scan`` (the kernel forward, the plain recurrence's
    backward) at the train step's shapes: y, the final state and the
    gradient of every input under random cotangents on both outputs,
    against plain-torch autograd through ``rwkv6_scan_ref`` on the same
    inputs, within ``RWKV_TOL``."""
    gen = torch.Generator(device=inputs[0].device)
    gen.manual_seed(7)
    ins = [[t.detach().clone().requires_grad_(True) for t in inputs]
           for _ in range(2)]
    got = blocks._RWKV6Scan.apply(*ins[0])
    want = rwkv_mod.rwkv6_scan_ref(*ins[1])
    cot = [torch.randn(o.shape, generator=gen, device=o.device)
           for o in want]
    for outs in (got, want):
        sum((o * c).sum() for o, c in zip(outs, cot)).backward()
    pairs = list(zip(got, want)) + [(a.grad, b.grad) for a, b in zip(*ins)]
    errs = {n: (a.detach() - b.detach()).abs().max().item()
            for n, (a, b) in zip(("y", "state", "dr", "dk", "dv", "dw", "du"),
                                 pairs)}
    ok = all(torch.allclose(a.detach(), b.detach(), atol=1e-4, rtol=1e-4)
             for a, b in pairs)
    emit(check="rwkv6_scan autograd.Function", case=name, max_abs_err=errs,
         tol=RWKV_TOL + "; every input's gradient atol=rtol=1e-4", ok=ok)
    if not ok:
        raise AssertionError(f"_RWKV6Scan {name}: {errs}")


MAMBA_TOL = "y and final state atol=rtol=1e-4"
# H100 SXM: 132 SMs, 16 exponentials per SM per clock in the special
# function units, at the 1.98 GHz boost clock
SFU_EXP_PER_S = 132 * 16 * 1.98e9


def mamba_inputs(gen, dev, B, T, d, n):
    """x [B, T, d], dt = 0.1·softplus(.) > 0, B_t and C_t [B, T, n], A =
    -exp(.) [d, n] < 0, f32, at the spreads the model gives them."""
    x = torch.randn(B, T, d, generator=gen, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn(B, T, d, generator=gen, device=dev)) * 0.1
    Bt, Ct = (torch.randn(B, T, n, generator=gen, device=dev)
              for _ in range(2))
    A = -torch.exp(torch.randn(d, n, generator=gen, device=dev) * 0.3)
    return x, dt, Bt, Ct, A


def check_mamba(dev, flush):
    """mamba_scan against its plain version at jamba-v0.1-52b's uniform
    prefill, x and dt [8, 640, 8192], B_t and C_t [8, 640, 16], A [8192,
    16], at one of phase 12's two model shards' channels, x [8, 640,
    4096], and at a small ragged case (T = 70 off the 64-step chunk, d =
    200 off the 128-channel block, n 8): y and the final state both
    compared.  Work for the bound: the five inputs read and y and the
    state written once; per (b, t, channel) 7n + 1 f32 operations (dt·x,
    and per state value dt·A, its exponential, the decayed state, the
    input term's multiply-add and the output's).  The n exponentials per
    (b, t, channel) also have their own bound at the SFU's rate
    (``sfu_bound_ms``).  No single PyTorch call computes the scan, so
    there is no yardstick."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    worst, timed = 0.0, {}
    for label, (B, T, d, n) in (("jamba-v0.1-52b", (8, 640, 8192, 16)),
                                ("jamba model shard", (8, 640, 4096, 16)),
                                ("ragged", (2, 70, 200, 8))):
        args = mamba_inputs(gen, dev, B, T, d, n)
        y, h_T = mamba_mod.mamba_scan(*args)
        torch.cuda.synchronize()
        want_y, want_h = mamba_mod.mamba_scan_ref(*args)
        errs = {"y": (y - want_y).abs().max().item(),
                "state": (h_T - want_h).abs().max().item()}
        ok = bool(torch.allclose(y, want_y, atol=1e-4, rtol=1e-4)
                  and torch.allclose(h_T, want_h, atol=1e-4, rtol=1e-4))
        name = f"{label} [{B}, {T}, {d}] n {n} f32"
        emit(check="mamba_scan", case=name, max_abs_err=errs, tol=MAMBA_TOL,
             ok=ok)
        if not ok:
            raise AssertionError(f"mamba_scan {name}: {errs}")
        worst = max(worst, *errs.values())
        if label == "ragged":
            continue
        t = time_case(name, timed, lambda: mamba_mod.mamba_scan(*args),
                      lambda: mamba_mod.mamba_scan_ref(*args),
                      mamba_mod.mamba_scan_work(*args), flush)
        t["exponentials"] = B * T * d * n
        t["sfu_bound_ms"] = B * T * d * n / SFU_EXP_PER_S * 1e3
        t["kernel_ms"] = kernel_ms(lambda: mamba_mod.mamba_scan(*args),
                                   "mamba_scan", flush)
        emit(timing="mamba_scan", case=name,
             ptxas=ptxas_lines("mamba_scan", f"mamba_kernelILi{n}E"), **t)
        del args, y, h_T, want_y, want_h
    torch.cuda.empty_cache()
    return worst, timed


# --------------------------------------------------------------------------
# phase 3: the ragged step on the card against the CPU
# --------------------------------------------------------------------------


def step_models():
    """(label, config) of the step checks: the smoke widths of the three
    served models, and granite at its published widths (d 1536, 40
    experts, top-8, vocab 49155) cut to 2 layers."""
    granite = get_config("granite-moe-3b-a800m", "")
    return [(f"{n}-smoke", get_config(n, "smoke"))
            for n in ("gemma3-1b", "phi4-mini-3.8b", "granite-moe-3b-a800m")
            ] + [("granite-moe-3b-a800m 2 layers",
                  dataclasses.replace(granite, num_periods=2))]


class RouterTap:
    """Records (router logits, picks) of every ``moe_route`` call the
    model makes while the tap is open: the model's blocks see the kernel
    wrappers through a stand-in whose ``moe_route`` records, and every
    other name is ``ops``'s own."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        def tapped(logits, k, cap):
            out = ops.moe_route(logits, k, cap)
            self.calls.append((logits.detach().cpu(), out[1].cpu()))
            return out

        class Ops:
            moe_route = staticmethod(tapped)

            def __getattr__(self, name):
                return getattr(ops, name)
        blocks.kernel_ops = Ops()
        return self

    def __exit__(self, *exc):
        blocks.kernel_ops = ops


def first_routing_difference(cpu_calls, card_calls):
    """The first router call whose picks on the card differ from the
    CPU's: (call, rows that differ, whether every such row is a near-tie
    — two of the CPU's k+1 largest router logits within 1e-4), or
    None."""
    for n, ((lc, ic), (_, idd)) in enumerate(zip(cpu_calls, card_calls)):
        diff = (ic != idd).any(-1).reshape(-1)
        if diff.any():
            top = lc.reshape(-1, lc.shape[-1])[diff].topk(
                ic.shape[-1] + 1, dim=-1).values
            gaps = (top[:, :-1] - top[:, 1:]).min(-1).values
            return n, int(diff.sum()), bool((gaps < 1e-4).all())
    return None


def compare_step(step, label, got, want, routing):
    """Live logits on the card within atol = rtol = 1e-4 of the CPU's —
    unless the router first picked differently on a near-tie: that is
    reported, and the logits, which then differ by design, are not
    compared."""
    err = (got - want).abs().max().item()
    ok = bool(torch.allclose(got, want, atol=1e-4, rtol=1e-4))
    rec = dict(check=f"{step} card vs cpu", model=label, max_abs_err=err,
               tol=1e-4)
    if routing is not None:
        call, rows, near = routing
        rec.update(routing_differs_at_call=call, routing_rows=rows,
                   near_tie=near, logits_compared=not near)
        ok = near
    emit(**rec, ok=ok)
    if not ok:
        raise AssertionError(f"{step} {label}: err {err}, routing "
                             f"{routing}")


def step_params(cfg, dev):
    """A step check's weights from seed 0, drawn on the card (kimi's
    dense first layer at full width is 11.3 GB) and copied to the CPU:
    (on the CPU, on the card)."""
    params_dev = init_params(cfg, 0, torch.float32, dev)
    return tree_map(lambda t: t.cpu(), params_dev), params_dev


def check_ragged_step(dev, models=None):
    """The ragged executor's ``ragged_step`` on the card against the CPU
    over ``models`` (default :func:`step_models`): live rows' logits
    within 1e-4."""
    rng = np.random.default_rng(0)
    for label, cfg in models or step_models():
        params_cpu, params_dev = step_params(cfg, dev)
        R, bs, P = 4, 4, 8
        N = R * P + 1
        cache_cpu = init_paged_cache(cfg, R, N, bs, torch.float32, "cpu")
        cache_cpu = tree_map(lambda t: torch.from_numpy(
            rng.standard_normal(tuple(t.shape)).astype(np.float32)),
            cache_cpu)
        cache_dev = tree_map(lambda t: t.to(dev), cache_cpu)
        pt = torch.from_numpy(rng.permutation(np.arange(1, N))[:R * P]
                              .reshape(R, P).astype(np.int32))
        qlen = torch.tensor([5, 0, 1, 9], dtype=torch.int32)
        qs = torch.tensor([0, 0, 20, 11], dtype=torch.int32)
        W = 16
        toks = torch.zeros(1, W, dtype=torch.int32)
        pos = torch.zeros(1, W, dtype=torch.int32)
        o = 0
        for b in range(R):
            n = int(qlen[b])
            toks[0, o:o + n] = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, n).astype(np.int32))
            pos[0, o:o + n] = int(qs[b]) + torch.arange(n)
            o += n
        pages_cpu = {"page_table": pt, "q_len": qlen, "q_start": qs}
        pages_dev = {k: v.to(dev) for k, v in pages_cpu.items()}
        with RouterTap() as tap_cpu:
            want, _ = transformer.ragged_step(params_cpu, cfg, toks,
                                              cache_cpu, pos, pages_cpu)
        with RouterTap() as tap_dev:
            got, _ = transformer.ragged_step(params_dev, cfg, toks.to(dev),
                                             cache_dev, pos.to(dev),
                                             pages_dev)
        live = qlen > 0
        compare_step("ragged_step", label, got.cpu()[live], want[live],
                     first_routing_difference(tap_cpu.calls, tap_dev.calls))
        del params_cpu, params_dev, cache_cpu, cache_dev
    torch.cuda.empty_cache()


def check_padded_steps(dev, models=None):
    """The padded executor's ``mixed_step`` and the split executor's
    ``prefill_chunk`` then ``decode_step(pages=)`` (one row masked to the
    null block) on the card against the CPU over ``models`` (default
    :func:`step_models`): live rows' logits within 1e-4."""
    rng = np.random.default_rng(1)
    for label, cfg in models or step_models():
        params_cpu, params_dev = step_params(cfg, dev)
        R, bs, P, C = 4, 4, 8, 7
        N = R * P + 1
        cache_cpu = tree_map(lambda t: torch.from_numpy(
            rng.standard_normal(tuple(t.shape)).astype(np.float32)),
            init_paged_cache(cfg, R, N, bs, torch.float32, "cpu"))
        pt = torch.from_numpy(rng.permutation(np.arange(1, N))[:R * P]
                              .reshape(R, P).astype(np.int32))
        qlen = torch.tensor([5, 0, 1, 7], dtype=torch.int32)
        qs = torch.tensor([0, 0, 20, 11], dtype=torch.int32)
        pos = qs[:, None] + torch.arange(C, dtype=torch.int32)[None, :]
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (R, C)).astype(np.int32))
        dec_pt = pt.clone()
        dec_pt[1] = 0                                   # masked row
        dec_pos = torch.tensor([[5], [3], [21], [18]], dtype=torch.int32)
        dec_tok = toks[:, :1].contiguous()
        results, taps = {}, {}
        for where, params in (("cpu", params_cpu), ("card", params_dev)):
            mv = (lambda t: t) if where == "cpu" else (lambda t: t.to(dev))
            cache = tree_map(lambda t: mv(t.clone()), cache_cpu)
            pages = {"page_table": mv(pt), "q_len": mv(qlen)}
            tap = [RouterTap() for _ in range(3)]
            with tap[0]:
                mixed, _ = transformer.mixed_step(
                    params, cfg, mv(toks), tree_map(lambda t: t.clone(),
                                                    cache), mv(pos), pages)
            with tap[1]:
                chunk, cache = transformer.prefill_chunk(
                    params, cfg, mv(toks), cache, mv(pos), pages)
            # the dead slots' duplicate writes leave the null block 0
            # unspecified, and the masked decode row attends it: MoE
            # layers route that row too (ahead of rows 2-3 in the expert
            # queues), so both sides get the same block 0
            tree_map(lambda t: t[:, 0].zero_(), cache)
            with tap[2]:
                dec, _ = transformer.decode_step(
                    params, cfg, mv(dec_tok), cache, mv(dec_pos),
                    pages={"page_table": mv(dec_pt)})
            results[where] = [t.cpu() for t in (mixed, chunk, dec)]
            taps[where] = [t.calls for t in tap]
        slots = torch.arange(C)[None, :] < qlen[:, None]
        live = {"mixed_step": qlen > 0, "prefill_chunk": slots,
                "decode_step": torch.tensor([True, False, True, True])}
        for i, step in enumerate(live):
            compare_step(step, label, results["card"][i][live[step]],
                         results["cpu"][i][live[step]],
                         first_routing_difference(taps["cpu"][i],
                                                  taps["card"][i]))
        del params_cpu, params_dev, cache_cpu
    torch.cuda.empty_cache()


def narrow_jamba_period(smoke):
    """One jamba-v0.1-52b period (attention at layer 4 among 7 Mamba
    layers, MoE FFNs on the odd layers) at d_model 64, with the smoke
    variant ``smoke``'s Mamba (d_state 8), experts and FFN widths."""
    mamba, dense, moe = (smoke.period[0].mixer, smoke.period[0].ffn,
                         smoke.period[1].ffn)
    period = tuple(Layer(l.mixer if l.mixer.kind == "attn" else mamba,
                         moe if l.ffn.kind == "moe" else dense)
                   for l in get_config(JAMBA_NAME, "").period)
    return dataclasses.replace(smoke, name="jamba-narrow-period",
                               d_model=64, num_heads=2, num_kv_heads=1,
                               head_dim=32, period=period)


def uniform_models():
    """(label, config) of the uniform-path checks: the smoke widths of
    gemma3-1b, phi4-mini-3.8b, rwkv6-3b and jamba-v0.1-52b (two Mamba
    layers, a dense and an MoE FFN), the narrow 8-layer jamba period,
    rwkv6-3b at its published widths (d 2560, 40 heads of 64, d_ff 8960,
    vocab 65536) cut to 2 layers, and jamba at its published widths (d
    4096, d_inner 8192, d_state 16, 32 heads, 8 KV heads of 128, d_ff
    14336, vocab 65536) cut to its layers 4 and 6: attention and Mamba,
    each with a dense FFN (its full-width MoE FFN runs in phase 5)."""
    rwkv = get_config("rwkv6-3b", "")
    jamba = get_config(JAMBA_NAME, "")
    return [(f"{n}-smoke", get_config(n, "smoke"))
            for n in ("gemma3-1b", "phi4-mini-3.8b", "rwkv6-3b",
                      JAMBA_NAME)] + [
        ("jamba narrow period", narrow_jamba_period(
            get_config(JAMBA_NAME, "smoke"))),
        ("rwkv6-3b 2 layers", dataclasses.replace(rwkv, num_periods=2)),
        ("jamba-v0.1-52b layers 4, 6", dataclasses.replace(
            jamba, period=(jamba.period[4], jamba.period[6]),
            num_periods=1))]


def check_uniform_steps(dev, models=None):
    """The uniform path's steps on the card against the CPU over
    ``models`` (default :func:`uniform_models`): ``prefill`` of 4
    prompts of 40 tokens (past the smoke window of 16 and the scan
    kernel's 32-step chunk; for a modality frontend, random frontend
    embeddings and 16 text tokens after its ``frontend_len`` positions,
    2 prompts past 64 of them) — last-position logits and every
    part-cache leaf — then the part cache written into a dense arena of
    8 more positions (``DenseTierSlotPool``) and one ``decode_step`` over
    it, rows at different positions: logits and the updated arena.  All
    within atol = rtol = 1e-4, unless an MoE router first picked
    differently on a near-tie (:func:`compare_step`)."""
    rng = np.random.default_rng(2)
    for label, cfg in models or uniform_models():
        B = 2 if cfg.frontend_len > 64 else 4
        S = max(40, cfg.frontend_len + 16)
        T = S + 8
        params_cpu, params_dev = step_params(cfg, dev)
        batch = {"tokens": torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
        if cfg.frontend:
            batch["frontend_embeds"] = torch.from_numpy(rng.standard_normal(
                (B, cfg.frontend_len, cfg.frontend_dim)).astype(np.float32))
        dec_tok = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32))
        dec_pos = torch.tensor([[S], [S - 5], [S + 3], [S]][:B],
                               dtype=torch.int32)
        out, taps = {}, {}
        for where, params in (("cpu", params_cpu), ("card", params_dev)):
            d = torch.device("cpu") if where == "cpu" else dev
            tap = [RouterTap() for _ in range(2)]
            with tap[0]:
                logits, part = transformer.prefill(
                    params, cfg, {k: v.to(d) for k, v in batch.items()})
            pool = DenseTierSlotPool(cfg, B, T, device=d)
            pool.write_prefill(list(range(B)), part)
            with tap[1]:
                dec, _ = transformer.decode_step(params, cfg, dec_tok.to(d),
                                                 pool.cache, dec_pos.to(d))
            out[where] = [t.cpu() for t in (logits, dec)] + [
                [t.cpu() for t in tree_leaves(part)],
                [t.cpu() for t in tree_leaves(pool.cache)]]
            taps[where] = [t.calls for t in tap]
            del part, pool
        routing = [first_routing_difference(c, g)
                   for c, g in zip(taps["cpu"], taps["card"])]
        for i, step in enumerate(("prefill", "dense decode_step")):
            compare_step(step, label, out["card"][i], out["cpu"][i],
                         routing[i])
        if any(r is not None for r in routing):
            continue            # the caches then differ by design
        for i, what in ((2, "prefill part cache"), (3, "dense arena after "
                                                       "decode")):
            errs = [(g.float() - w.float()).abs().max().item()
                    for g, w in zip(out["card"][i], out["cpu"][i])]
            ok = all(torch.allclose(g.float(), w.float(), atol=1e-4,
                                    rtol=1e-4)
                     for g, w in zip(out["card"][i], out["cpu"][i]))
            emit(check=f"{what} card vs cpu", model=label,
                 leaves=len(errs), max_abs_err=max(errs), tol=1e-4, ok=ok)
            if not ok:
                raise AssertionError(f"{what} {label}: {max(errs)}")
        del params_cpu, params_dev, out
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 4: the main path at full width
# --------------------------------------------------------------------------


PHI4_NAME, MOE_NAME = "phi4-mini-3.8b", "granite-moe-3b-a800m"
RWKV_NAME, JAMBA_NAME = "rwkv6-3b", "jamba-v0.1-52b"
STARCODER_NAME, MUSICGEN_NAME = "starcoder2-7b", "musicgen-large"
QWEN_NAME, MOONSHOT_NAME = "qwen2-vl-72b", "moonshot-v1-16b-a3b"
KIMI_NAME = "kimi-k2-1t-a32b"
# the expensive tiers the engine serves on the uniform prefill path by
# themselves: recurrent state, or a modality frontend
UNIFORM_ONLY = (RWKV_NAME, JAMBA_NAME, MUSICGEN_NAME, QWEN_NAME)


def main_path_args(expensive=PHI4_NAME, **flags) -> Namespace:
    """The phase-4 workload with ``expensive`` as the second tier;
    ``flags`` adds or overrides the CLI's flags: the executor's
    (``ragged_step=False``, ``split_step=True``,
    ``no_chunked_prefill=True`` or ``dense_kv=True``), speculation's
    (``speculate``, ``spec_delta``, with ``gen_len``), prefix
    caching's (``prefix_cache``, ``shared_prefix_frac``, ``delta``,
    ``kv_blocks``) or the overload layer's (``preemption``,
    ``deadline``, ``launch_retries``, ``retry_backoff``,
    ``inject_faults``) or multi-device serving's (``tier_mesh``, and
    ``mesh_devices``, the devices the meshes cover).  The chunked
    executors serve lognormal prompt lengths up to 640; the uniform
    prefill path (those two flags, the recurrent rwkv6-3b and
    jamba-v0.1-52b, or musicgen-large and qwen2-vl-72b with their
    frontends) serves every prompt at exactly ``prompt_len``."""
    uniform = (flags.get("no_chunked_prefill") or flags.get("dense_kv")
               or expensive in UNIFORM_ONLY)
    args = dict(
        fast="gemma3-1b", expensive=expensive, variant="",
        device="cuda", requests=16, rate=8.0, slots=8, prompt_len=640,
        min_prompt_len=1, length_dist="uniform" if uniform else "lognormal",
        gen_len=8, prefill_chunk=64, prefill_token_budget=None, delta=None,
        escalation_budget=0.25, kv_block_size=16, kv_blocks=None,
        seed=0, expensive_seed=None, speculate=0, spec_delta=None,
        prefix_cache=False, shared_prefix_frac=0.0, preemption="none",
        deadline=None, launch_retries=2, retry_backoff=0.02,
        inject_faults=None, tier_mesh=None, mesh_devices=None)
    args.update(flags)
    return Namespace(**args)


EXECUTORS = {"ragged": {}, "padded": {"ragged_step": False},
             "split": {"split_step": True}}
# the uniform one-shot prefill path (split decode): on the block-paged
# arena, on the dense one, and as the rwkv6-3b and jamba cascades pick it
# by themselves
UNIFORM = {"uniform": {"no_chunked_prefill": True},
           "dense": {"dense_kv": True}, "auto": {}}
ALL_EXECUTORS = {**EXECUTORS, **UNIFORM}
COUNTED = ("ragged_attention", "mixed_attention", "paged_attention",
           "flash_attention", "confidence_gate", "router_gate",
           "rwkv6_scan", "mamba_scan")


def layer_counts(cfg) -> dict:
    """Layers of a config by what they launch: attention mixers, MoE
    FFNs, RWKV-6 mixers and Mamba mixers."""
    layers = cfg.head + cfg.tail + cfg.period * cfg.num_periods
    return {"attn": sum(l.mixer.kind == "attn" for l in layers),
            "moe": sum(l.ffn.kind == "moe" for l in layers),
            "rwkv6": sum(l.mixer.kind == "rwkv6" for l in layers),
            "mamba": sum(l.mixer.kind == "mamba" for l in layers)}


def expected_launches(cfgs, kinds, warm=None, paged=True, draft_steps=None):
    """Launches each layer kernel must count over a run whose tier
    launches by kind are ``kinds``: every attention layer of a tier
    launch goes through the executor's attention kernel — ragged (ragged
    steps and, under speculation, ``spec`` launches), mixed (padded steps
    and chunks), paged decode (split decode steps over the block-paged
    arena — the dense arena's decode is plain torch — and each of a
    draft tier's ``draft_steps``) or flash (uniform prefills) — every
    MoE layer through ``router_gate``, every RWKV-6 layer of a prefill
    through ``rwkv6_scan`` and every Mamba layer of a prefill through
    ``mamba_scan`` (their decode is plain torch).  ``warm`` adds the
    warmup's launches per tier."""
    out = {c: 0 for c in COUNTED if c != "confidence_gate"}
    for t, cfg in enumerate(cfgs):
        n = layer_counts(cfg)
        k = dict(kinds[t])
        if warm is not None:
            for kind, w in warm[t].items():
                k[kind] = k.get(kind, 0) + w
        out["ragged_attention"] += n["attn"] * (k.get("ragged", 0)
                                                + k.get("spec", 0))
        out["mixed_attention"] += n["attn"] * (k.get("mixed", 0)
                                               + k.get("chunk", 0))
        out["paged_attention"] += n["attn"] * (
            k.get("step", 0) * paged + (draft_steps[t] if draft_steps
                                        else 0))
        out["flash_attention"] += n["attn"] * k.get("prefill", 0)
        out["router_gate"] += n["moe"] * sum(k.values())
        out["rwkv6_scan"] += n["rwkv6"] * k.get("prefill", 0)
        out["mamba_scan"] += n["mamba"] * k.get("prefill", 0)
    return out


class EngineTap:
    """Keeps the engine ``serve_async.run`` builds while the tap is open
    (its pools are audited after the run), and caps every engine's run
    at ``max_steps`` ticks: an arena too small for the workload raises
    instead of spinning.  Both patches sit on the module and the class,
    never on the engine, so no reference cycle keeps a served engine's
    arena alive once the tap is dropped."""

    def __init__(self, max_steps: int = 5000):
        self.max_steps = max_steps
        self.engine = None

    def __enter__(self):
        self.orig = build, run = serve_async.build_engine, CascadeEngine.run
        cap = self.max_steps

        def build_engine(*a, **kw):
            engine, vocab = build(*a, **kw)
            self.engine = engine
            return engine, vocab

        def capped(engine, max_steps=cap, **kw):
            return run(engine, min(max_steps, cap), **kw)
        serve_async.build_engine = build_engine
        CascadeEngine.run = capped
        return self

    def __exit__(self, *exc):
        serve_async.build_engine, CascadeEngine.run = self.orig


def pool_leaks(engine) -> list:
    """Block conservation after a drain, per paged tier pool: no row is
    bound, and every live block is held by the prefix index alone
    (refcount = index references; none without the cache), so free and
    index-held blocks make up the arena.  Returns the tiers that break
    it."""
    bad = []
    for rt in engine.runtimes:
        pool = rt.pool
        if not rt.paged:
            continue
        alloc = pool.blocks
        if pool.bound_rows() or alloc.num_used != len(pool._index_refs) \
                or any(alloc.refcount(b) != n
                       for b, n in pool._index_refs.items()) \
                or alloc.num_free + alloc.num_used != pool.num_blocks - 1:
            bad.append({"tier": rt.spec.name, "bound": pool.bound_rows(),
                        "used": alloc.num_used, "free": alloc.num_free,
                        "index_held": len(pool._index_refs)})
    return bad


def serve(card: str, params, executor: str, expensive=PHI4_NAME, cfgs=None,
          phase=None, clock=None, allow_lost=False, **flags):
    """Serve the phase-4 workload on ``params`` (the cascade to
    ``expensive``, whose configs are ``cfgs`` where given) under one
    executor (``flags`` adds CLI flags: speculation's, prefix caching's
    or the overload layer's) on ``clock`` (default: the wall clock),
    with every kernel counter set to 0 just before and read just after;
    check that every request completed (with ``allow_lost``, that every
    request not DONE was shed or failed), that every submitted request
    is accounted for (conservation), that the gate split them (at a
    fixed δ of 1, that every completed request escalated), and that the
    counters prove each tier launch — and under speculation each decode
    step of the draft loop — went through the executor's kernels (and
    through nothing else).  After the drain every paged pool must hold
    no bound row and no block but those its prefix index holds (block
    conservation).  Returns (counts, per-request records, summary)."""
    args = main_path_args(expensive, **ALL_EXECUTORS[executor], **flags)
    lens = serve_async.sample_lengths(args.length_dist, args.requests,
                                      args.prompt_len, args.min_prompt_len,
                                      args.seed)
    if lens.max() <= 512:
        raise AssertionError("workload must hold a prompt over 512 tokens "
                             "(past gemma3's 512-token window)")
    torch.cuda.reset_peak_memory_stats()
    for name in COUNTED:
        getattr(ops, name).launches = 0
    t0 = time.perf_counter()
    with EngineTap() as tap:
        s = serve_async.run(args, clock, params=params, cfgs=cfgs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: getattr(ops, name).launches for name in COUNTED}
    peak = torch.cuda.max_memory_allocated()
    s["max_memory_allocated_bytes"] = peak

    cfgs = serve_async.tier_configs(args, cfgs)
    tier_launches = s["launches"]
    kinds = s["launches_by_kind"]
    # the warmup's launches per tier: every bucket width (ragged), the
    # chunk width and width 1 (padded), one chunk and one decode (split),
    # one prefill and one decode (uniform)
    warm = [{"spec" if s["speculation_k"] else "ragged": len(b)}
            if b is not None else
            {"mixed": 2} if s["unified_step"] else
            {"chunk": 1, "step": 1} if s["chunked_prefill"] else
            {"prefill": 1, "step": 1}
            for b in s["flat_buckets"]]
    per_req = s["per_request"]
    problems = []
    if (s["unified_step"], s["ragged_step"], s["chunked_prefill"],
            s["paged_kv"]) != {
            "ragged": (True, True, True, True),
            "padded": (True, False, True, True),
            "split": (False, False, True, True),
            "uniform": (False, False, False, True),
            "dense": (False, False, False, False),
            "auto": (False, False, False, True)}[executor]:
        problems.append(f"engine ran the wrong executor: {s}")
    done = [r for r in per_req if r["state"] == "DONE"]
    if (len(done) < len(per_req) and not allow_lost) or not all(
            len(r["tokens"]) == args.gen_len for r in done):
        problems.append("a request is not DONE with gen_len tokens")
    if not s["conservation"]["ok"]:
        problems.append(f"requests not conserved: {s['conservation']}")
    tiers = [r["tier"] for r in done]
    if args.delta is not None and args.delta >= 1.0:
        if set(tiers) != {1}:
            problems.append(f"δ = {args.delta} must escalate every "
                            f"request: {tiers}")
    elif 1 not in tiers or 0 not in tiers:
        problems.append(f"need escalated and non-escalated requests: "
                        f"{tiers}")
    leaks = pool_leaks(tap.engine)
    if leaks:
        problems.append(f"blocks not conserved after the drain: {leaks}")
    if not all(np.isfinite(r.token_conf).all() for r in tap.engine.requests):
        problems.append("a token's confidence is not finite")
    del tap
    paged = s["paged_kv"]
    # under speculation: the draft loop's decode steps per tier (each a
    # paged_attention launch per attention layer and a gate launch)
    sp = s["speculation"]
    steps = sp["draft_steps_by_tier"]
    want = expected_launches(cfgs, kinds, paged=paged, draft_steps=steps)
    got = {k: s["kernel_launches"][k] for k in want}
    if got != want:
        problems.append(f"layer kernel launches after warmup {got} != "
                        f"{want}")
    if s["kernel_launches"]["confidence_gate"] != sum(tier_launches) + sum(
            steps):
        problems.append("gate launches != tier launches + draft steps")
    want_window = expected_launches(cfgs, kinds, warm, paged=paged,
                                    draft_steps=steps)
    if {k: counts[k] for k in want_window} != want_window:
        problems.append(f"launch counts {counts} != {want_window} "
                        "(warmup included)")
    if counts["confidence_gate"] != sum(tier_launches) + sum(steps) + sum(
            sum(w.values()) for w in warm):
        problems.append(f"gate launch count {counts} off")
    if args.speculate:
        if set().union(*kinds) != {"spec"}:
            problems.append(f"speculation ran launches {kinds}, not spec")
        if not (sp["drafted"] > 0 and sp["drafted"] == sp["accepted"]
                + sp["rolled_back"] and steps[0] > 0):
            problems.append(f"speculation counters {sp}")
    # one fetch per active tier per tick, plus the uniform path's own
    # fetch after each prefill launch
    prefills = [k.get("prefill", 0) for k in kinds]
    if any(h > a + p for h, a, p in zip(s["host_syncs"], s["active_ticks"],
                                        prefills)):
        problems.append(f"host syncs {s['host_syncs']} exceed one per "
                        f"active tier per tick {s['active_ticks']} plus one "
                        f"per prefill {prefills}")
    gen_tokens = sum(args.gen_len * (r["tier"] + 1) for r in per_req)
    record = dict(
        phase=phase or ("main path" if executor == "ragged"
                        else "executor"),
        executor=executor, card=card, configs=[args.fast, args.expensive],
        length_dist=args.length_dist,
        requests=args.requests, completed=s["completed"],
        tier_requests=s["tier_requests"], steps=s["steps"],
        tier_launches=tier_launches, launches_by_kind=kinds,
        active_ticks=s["active_ticks"], host_syncs=s["host_syncs"],
        kernel_launches_after_warmup=s["kernel_launches"],
        kernel_launches_window=counts, warmup_launches=warm,
        layers=[layer_counts(c) for c in cfgs],
        escalation_rate=s["escalation_rates"], delta=s["delta"],
        prompt_len_max=s["prompt_len_max"],
        makespan_s=s["elapsed"], generated_tokens=gen_tokens,
        generated_tokens_per_s=gen_tokens / s["elapsed"],
        live_tokens_per_s=s["step_live_tokens"] / s["elapsed"],
        wasted_slot_ratio=s["wasted_slot_ratio"],
        tick_p50_s=s["tick_duration_p50"], tick_p95_s=s["tick_duration_p95"],
        latency_p50_s=s["latency_p50"], ttft_p50_s=s["ttft_p50"],
        max_memory_allocated_bytes=peak, wall_s_incl_init=wall,
        stream_checksum=s["stream_checksum"], problems=problems)
    if args.prefix_cache or args.shared_prefix_frac:
        record.update(
            clock="virtual" if clock is not None else "wall",
            prefix_cache=args.prefix_cache,
            shared_prefix_frac=args.shared_prefix_frac,
            kv_blocks=args.kv_blocks, prefill_live_tokens=s[
                "prefill_live_tokens"],
            prefix_cache_summary=s["prefix_cache"],
            prefix_pools=[{k: m[k] for k in (
                "num_blocks", "kv_high_water_blocks",
                "kv_shared_high_water_blocks", "prefix_index_entries",
                "prefix_evictions", "prefix_cow_copies")}
                for m in s["kv_arena"]])
    if args.preemption != "none" or args.inject_faults \
            or args.deadline is not None:
        record.update(
            preemption=args.preemption, deadline=args.deadline,
            inject_faults=args.inject_faults,
            preemptions_by_tier=s["preemptions_by_tier"],
            replayed_tokens_by_tier=s["replayed_tokens_by_tier"],
            launch_retries_by_tier=s["launch_retries_by_tier"],
            shed_rids=[r["rid"] for r in per_req if r["state"] == "SHED"],
            failed_rids=[r["rid"] for r in per_req
                         if r["state"] == "FAILED"],
            fault_events=s.get("fault_events"),
            conservation=s["conservation"])
    if args.speculate or phase:
        record.update(
            gen_len=args.gen_len, speculate=args.speculate,
            spec_delta=args.spec_delta, speculation=sp,
            gate_calibration=[{k: g[k] for k in (
                "gate", "seen", "outcomes", "agreement_rate", "ece",
                "verify_outcomes", "verify_accept_rate")}
                for g in s["gate_calibration"]])
    emit(**record)
    if problems:
        raise AssertionError(f"{executor} -> {expensive}: "
                             + "; ".join(problems))
    return counts, per_req, s


def compare_streams(runs: dict, expensive=PHI4_NAME) -> None:
    """Record how the executors' token streams compare on the card
    (against the first run given, on the same prompts).  The budget
    gate's δ follows the confidences seen so far, so under a wall clock
    the executors may escalate different requests; a request that ends at
    the same tier under two executors was decoded by the same model from
    the same prompt, and its tokens are compared."""
    first = next(iter(runs))
    base = {r["rid"]: r for r in runs[first]}
    for ex, per_req in runs.items():
        same_tier = [r for r in per_req
                     if r["tier"] == base[r["rid"]]["tier"]]
        differ = [r["rid"] for r in same_tier
                  if r["tokens"] != base[r["rid"]]["tokens"]]
        emit(check=f"token streams against {first}", executor=ex,
             expensive=expensive,
             escalated=sorted(r["rid"] for r in per_req if r["tier"] > 0),
             same_tier_requests=len(same_tier), differing_rids=differ)


# --------------------------------------------------------------------------
# the speculation phase
# --------------------------------------------------------------------------

SPEC_K, SPEC_GEN_LEN = 4, 32


def verify_logit_error(dev, params, cfg) -> dict:
    """The logit error between the speculative verify window and the
    paths it stands in for, on the card at full width.  8 random
    contexts of 595-630 tokens: their first 590-625 are written to the
    paged pools by 64-token ``ragged_step`` chunks, and their last 5 (a
    token and 4 drafts) go through one ``ragged_verify`` launch (flat
    width 64), through 5 one-token ``ragged_step`` launches (the verifier
    at k = 0), through 5 paged ``decode_step`` launches (the draft loop)
    and, one prefix at a time, through the teacher-forced uniform
    ``prefill`` (:func:`next_token_logits`, which the stream check reads
    its gaps from).  Returns the largest |logit| difference of the window
    against each path; the margin rule below counts a token difference
    as a near-tie only within the largest of them."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    R, bs, P, n, C = 8, 16, 41, SPEC_K + 1, 64
    N = R * P + 1
    pool = init_paged_cache(cfg, R, N, bs, torch.float32, dev)
    pt = (torch.randperm(N - 1, generator=gen, device=dev)[:R * P] + 1
          ).reshape(R, P).to(torch.int32)
    ctx = torch.randint(0, cfg.vocab_size, (R, max(NEAR600) + n),
                        generator=gen, device=dev, dtype=torch.int32)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32,  # noqa: E731
                                 device=dev)
    for c in range(0, max(NEAR600), C):
        ql = [min(max(s - c, 0), C) for s in NEAR600]
        ft = torch.zeros(1, R * C, dtype=torch.int32, device=dev)
        fp = torch.zeros(1, R * C, dtype=torch.int32, device=dev)
        o = 0
        for b, q in enumerate(ql):
            ft[0, o:o + q] = ctx[b, c:c + q]
            fp[0, o:o + q] = torch.arange(c, c + q, dtype=torch.int32)
            o += q
        _, pool = transformer.ragged_step(
            params, cfg, ft, pool, fp,
            {"page_table": pt, "q_len": i32(ql),
             "q_start": i32([min(c, s) for s in NEAR600])})
    start = i32(NEAR600)
    pos = start[:, None] + torch.arange(n, dtype=torch.int32, device=dev)
    toks = torch.gather(ctx, 1, pos.long())
    W = 64
    flat_t = torch.zeros(1, W, dtype=torch.int32, device=dev)
    flat_p = torch.zeros(1, W, dtype=torch.int32, device=dev)
    flat_t[0, :R * n], flat_p[0, :R * n] = toks.reshape(-1), pos.reshape(-1)
    window, _ = transformer.ragged_verify(
        params, cfg, flat_t, tree_map(lambda t: t.clone(), pool), flat_p,
        {"page_table": pt, "q_len": i32([n] * R), "q_start": start})
    window = window[0, :R * n].reshape(R, n, -1)
    errs = {}
    for path in ("ragged_step", "decode_step"):
        cache = tree_map(lambda t: t.clone(), pool)
        for j in range(n):
            if path == "ragged_step":
                ft = torch.zeros(1, 8, dtype=torch.int32, device=dev)
                fp = torch.zeros(1, 8, dtype=torch.int32, device=dev)
                ft[0], fp[0] = toks[:, j], pos[:, j]
                got, cache = transformer.ragged_step(
                    params, cfg, ft, cache, fp,
                    {"page_table": pt, "q_len": i32([1] * R),
                     "q_start": pos[:, j].contiguous()})
            else:
                got, cache = transformer.decode_step(
                    params, cfg, toks[:, j:j + 1].contiguous(), cache,
                    pos[:, j:j + 1].contiguous(), pages={"page_table": pt})
                got = got[:, 0]
            errs[path] = max(errs.get(path, 0.0),
                             (got - window[:, j]).abs().max().item())
        del cache
    ctx_h = ctx.cpu().numpy()
    errs["prefill"] = max(
        (next_token_logits(params, cfg, dev, ctx_h[b, :s + j + 1])
         - window[b, j]).abs().max().item()
        for b, s in enumerate(NEAR600) for j in range(n))
    emit(check="verify window logits against one-token ragged and paged "
         "decode and the teacher-forced prefill", model=cfg.name, rows=R,
         tokens_a_row=n, context_lens=[s + n for s in NEAR600],
         max_abs_err=errs)
    del pool, window
    torch.cuda.empty_cache()
    return errs


def next_token_logits(params, cfg, dev, context) -> torch.Tensor:
    """The model's logits after ``context`` (teacher-forced: one uniform
    ``prefill`` of the whole context)."""
    t = torch.tensor(np.asarray(context, np.int32), device=dev)[None]
    logits, _ = transformer.prefill(params, cfg, {"tokens": t})
    return logits[0, -1]


class RejectionTap:
    """Records, at every rejected draft of a verify while the tap is
    open, the verifier's own logit gap between its token and the draft's,
    from the verify window's ``[W, V]`` logits: (verify tier, gap).  It
    wraps ``CascadeEngine._exec_unified`` (reading the requests before
    and after) and ``_TierRuntime.pick`` (keeping a reference to a
    launch's first logits, the window's, through the draft loop), so a
    run under the tap computes what the engine computes but is neither
    timed nor measured for memory."""

    def __init__(self):
        self.gaps = []

    def __enter__(self):
        self.orig = orig_exec, orig_pick = (CascadeEngine._exec_unified,
                                            _TierRuntime.pick)
        window = {}

        def pick(rt, logits2d):
            window.setdefault("logits", logits2d)
            return orig_pick(rt, logits2d)

        def exec_unified(engine, tier, rt, plan, *rest):
            before = {s: (rt.slot_req[s], len(rt.slot_req[s].tokens),
                          list(rt.slot_req[s].draft_tokens[:nd]))
                      for s, nd in plan.verify_rows}
            window.clear()
            out = orig_exec(engine, tier, rt, plan, *rest)
            logits = window.pop("logits", None)
            start = np.cumsum(plan.q_len) - plan.q_len
            for s, nd in plan.verify_rows:
                req, e, drafts = before[s]
                acc = len(req.tokens) - e - 1
                if acc == nd:
                    continue
                slot = int(start[s]) + acc
                v, d = req.tokens[e + acc], drafts[acc]
                self.gaps.append(
                    (tier, (logits[slot, v] - logits[slot, d]).item()))
            return out
        CascadeEngine._exec_unified = exec_unified
        _TierRuntime.pick = pick
        return self

    def __exit__(self, *exc):
        CascadeEngine._exec_unified, _TierRuntime.pick = self.orig


def workload_prompts(args, cfgs) -> list:
    """The prompts ``serve_async.run`` submits for ``args``: the bigram
    prompts, the shared prefix applied, cut to their sampled lengths."""
    vocab = min(cfgs[0].vocab_size, cfgs[1].vocab_size,
                serve_async.PROMPT_VOCAB)
    prompts = bigram_lm(num_seqs=args.requests, seq_len=args.prompt_len,
                        vocab=vocab, seed=args.seed)
    lens = serve_async.sample_lengths(args.length_dist, args.requests,
                                      args.prompt_len, args.min_prompt_len,
                                      args.seed)
    prompts = serve_async.apply_shared_prefix(
        prompts, lens, args.shared_prefix_frac, vocab, args.seed)
    return [p[:int(n)] for p, n in zip(prompts, lens)]


def stream_gaps(base, other, prompts, params, cfgs, dev) -> list:
    """Where two runs' per-request records disagree, for requests ending
    at the same tier: at each tier's first differing token, (tier, the
    gap between the two tokens' logits) from the teacher-forced logits
    of that tier's model (:func:`next_token_logits`) — what
    :func:`margin_check` reads."""
    gaps = []
    for a, b in zip(base, other):
        if a["tier"] != b["tier"]:
            continue
        for t, (x, y) in enumerate(zip(a["tokens_by_tier"],
                                       b["tokens_by_tier"])):
            if x == y:
                continue
            i = next(j for j, (u, v) in enumerate(zip(x, y)) if u != v)
            logits = next_token_logits(params[t], cfgs[t], dev,
                                       list(prompts[a["rid"]]) + x[:i])
            gaps.append((t, abs(logits[x[i]] - logits[y[i]]).item()))
    return gaps


def margin_check(what, gaps, bounds) -> None:
    """The margin rule: each (tier, gap) where two paths chose two
    tokens — the gap between the two tokens' logits — must be within
    that tier's measured logit error ``bounds[tier]``; a wider gap is a
    fault."""
    ok = all(g <= bounds[t] for t, g in gaps)
    emit(check=f"margin rule: {what}", cases=len(gaps), gaps=gaps,
         bound=bounds, ok=ok)
    if not ok:
        raise AssertionError(f"{what}: a gap past the bound {bounds}: "
                             f"{gaps}")


def rejections(s) -> int:
    """Rejected drafts of a speculative run, from its summary: every
    verified draft up to the first rejection is one verify outcome, so
    the outcomes that accepted nothing are the rejections."""
    return sum(g["verify_outcomes"] for g in s["gate_calibration"]) - \
        s["speculation"]["accepted"]


def check_speculation(card: str, params, keep=None) -> dict:
    """The speculation phase: the phase-4 workload at ``gen_len`` 32 on
    the ragged executor, each cascade served at k = 0 and k = 4 (every
    draft staged, ``spec_delta`` 0) with exact launch counts
    (:func:`serve`) — gemma3-1b drafting for phi4-mini-3.8b, and for
    itself (self-speculation, ``expensive_seed = seed``: both tiers on
    gemma3's weights).  Streams against k = 0 under the margin rule,
    each tier's bound its largest measured verify-window logit error;
    under self-speculation every rejection too (its draft and verify
    compute the same model), read in a third, untimed run under
    :class:`RejectionTap`.  Returns the timed runs' launch counts by
    path; a dict ``keep`` receives the gemma3-1b -> phi4-mini-3.8b
    margin bounds (``bounds``, phase 4e's)."""
    cascades = (("phi4", PHI4_NAME, params, {}),
                ("self", "gemma3-1b", (params[0], params[0]),
                 {"expensive_seed": 0}))
    counts = {}
    for label, expensive, pair, seed in cascades:
        args = main_path_args(expensive, **seed)
        cfgs = serve_async.tier_configs(args)
        dev = pair[0]["embed"].device
        errs = [verify_logit_error(dev, pair[0], cfgs[0])]
        errs.append(errs[0] if label == "self" else
                    verify_logit_error(dev, pair[1], cfgs[1]))
        bounds = [max(e.values()) for e in errs]
        if keep is not None and label == "phi4":
            keep["bounds"] = bounds
        runs = {}
        for k in (0, SPEC_K):
            flags = dict(speculate=k, spec_delta=0.0 if k else None,
                         gen_len=SPEC_GEN_LEN, **seed)
            c, per_req, s = serve(card, pair, "ragged", expensive,
                                  phase="speculation", **flags)
            counts[f"spec {label} k={k}"] = c
            runs[k] = (per_req, s)
        (base, _), (spec, s4) = runs[0], runs[SPEC_K]
        differ = stream_gaps(base, spec, workload_prompts(args, cfgs), pair,
                             cfgs, dev)
        margin_check(f"{label} k={SPEC_K} streams against k=0, "
                     "teacher-forced", differ, bounds)
        tapped = None
        if label == "self":
            with RejectionTap() as tap:
                _, _, st = serve(card, pair, "ragged", expensive,
                                 phase="speculation, rejection tap "
                                 "(untimed)", speculate=SPEC_K,
                                 spec_delta=0.0, gen_len=SPEC_GEN_LEN,
                                 **seed)
            if len(tap.gaps) != rejections(st):
                raise AssertionError(f"tap saw {len(tap.gaps)} rejections, "
                                     f"the summary {rejections(st)}")
            margin_check("self-speculation rejections, verify window's "
                         "own logits", tap.gaps, bounds)
            tapped = len(tap.gaps)
        tps = {k: SPEC_GEN_LEN * sum(r["tier"] + 1 for r in runs[k][0])
               / runs[k][1]["elapsed"] for k in runs}
        emit(phase="speculation summary", cascade=[args.fast, expensive],
             card=card, k=SPEC_K, gen_len=SPEC_GEN_LEN,
             generated_tokens_per_s={f"k={k}": v for k, v in tps.items()},
             same_tier_requests=sum(a["tier"] == b["tier"]
                                    for a, b in zip(base, spec)),
             differing_rids=[a["rid"] for a, b in zip(base, spec)
                             if a["tier"] == b["tier"]
                             and a["tokens"] != b["tokens"]],
             accept_rate=s4["speculation"]["accept_rate"],
             drafted=s4["speculation"]["drafted"],
             rejections=rejections(s4), rejections_tapped_run=tapped,
             logit_error=errs, margin_bound=bounds,
             draft_steps=s4["speculation"]["draft_steps_by_tier"],
             gate_ece={f"k={k}": [g["ece"] for g in runs[k][1][
                 "gate_calibration"]] for k in runs},
             gate_agreement={f"k={k}": [g["agreement_rate"] for g in runs[k][
                 1]["gate_calibration"]] for k in runs},
             verify_accept_rate=[g["verify_accept_rate"]
                                 for g in s4["gate_calibration"]])
        if label == "self" and s4["speculation"]["accepted"] == 0:
            raise AssertionError("self-speculation accepted no draft")
    return counts


# --------------------------------------------------------------------------
# the prefix-caching phase
# --------------------------------------------------------------------------

# the shared share of every prompt, and an arena small enough that the
# index is evicted under the virtual-clock workload (without preemption
# the oldest-first discipline stalls this workload at 64 blocks, cache on
# or off, in both packages; 80 drains; phase 4d preempts at 64)
PREFIX_FRAC, PREFIX_KV_BLOCKS = 0.75, 80


def ragged_chunks(pool, params, cfg, slot, prompt, start, chunk=64):
    """Prefill ``prompt`` from ``start`` on row ``slot`` of ``pool`` in
    ``chunk``-token ``ragged_step`` launches (growing the row's pages and
    publishing its boundaries after each, as the engine does); returns
    the last launch's logits of the row's last token."""
    dev = params["embed"].device
    i32 = lambda v: torch.tensor(np.asarray(v, np.int32),  # noqa: E731
                                 device=dev)
    R = pool.capacity
    for c in range(start, len(prompt), chunk):
        n = min(chunk, len(prompt) - c)
        if not pool.ensure_blocks(slot, c + n - 1):
            raise AssertionError(f"row {slot} denied a block at {c + n}")
        toks = np.zeros((1, chunk), np.int32)
        pos = np.zeros((1, chunk), np.int32)
        toks[0, :n] = prompt[c:c + n]
        pos[0, :n] = c + np.arange(n)
        q_len, q_start = np.zeros(R, np.int32), np.zeros(R, np.int32)
        q_len[slot], q_start[slot] = n, c
        logits, pool.cache = transformer.ragged_step(
            params, cfg, i32(toks), pool.cache, i32(pos),
            {"page_table": i32(pool.page_table), "q_len": i32(q_len),
             "q_start": i32(q_start)})
        pool.publish_prefix(slot, prompt, c + n)
    return logits[slot]


def prefix_logit_error(dev, params, cfg) -> dict:
    """A row admitted over a published prefix against the same prompt
    served uncached, on the card at full width: prompt A (600 tokens) is
    prefilled and published on row 0 in 64-token ``ragged_step`` chunks;
    prompt B shares A's first 460 tokens, matches the 448-token entry and
    resumes on row 1 over A's shared blocks; B again on row 2 from
    scratch; and B through the teacher-forced uniform ``prefill``.
    Returns the largest |logit| differences of the last token's logits;
    the cached row must be within 1e-4 of the uncached one."""
    rng = np.random.default_rng(11)
    V = min(cfg.vocab_size, serve_async.PROMPT_VOCAB)
    a = rng.integers(0, V, 600).astype(np.int32)
    b = a.copy()
    b[460:] = rng.integers(0, V, 140)
    pool = TierSlotPool(cfg, 3, 648, block_size=16, prefix_chunk=64,
                        device=dev)
    pool.bind(0, 64, row_tokens=608)
    ragged_chunks(pool, params, cfg, 0, a, 0)
    cached, blocks = pool.match_prefix(b)
    if cached != 448:
        raise AssertionError(f"B matched {cached} tokens, not 448")
    pool.bind(1, cached + 64, row_tokens=608, prefix=(cached, blocks))
    hit = ragged_chunks(pool, params, cfg, 1, b, cached)
    pool.bind(2, 64, row_tokens=608)
    miss = ragged_chunks(pool, params, cfg, 2, b, 0)
    tf = next_token_logits(params, cfg, dev, b)
    errs = {"cached_vs_uncached": (hit - miss).abs().max().item(),
            "cached_vs_prefill": (hit - tf).abs().max().item(),
            "uncached_vs_prefill": (miss - tf).abs().max().item()}
    emit(check="prefix-cache hit against the same prompt uncached and "
         "teacher-forced (last token's logits)", model=cfg.name,
         prompt_tokens=len(b), cached_tokens=cached,
         shared_pages=pool.shared_pages(1), max_abs_err=errs,
         argmax=[int(x.argmax()) for x in (hit, miss, tf)])
    if not errs["cached_vs_uncached"] <= 1e-4:
        raise AssertionError(f"cached row off the uncached one: {errs}")
    del pool
    torch.cuda.empty_cache()
    return errs


def check_copy_blocks(dev, cfg) -> None:
    """The copy-on-write primitive ``TierSlotPool._copy_blocks`` on the
    card: blocks copied bit for bit (``torch.equal``) in every paged leaf
    of a phi4-mini-3.8b f32 pool and of an int8 pool (its f32 scales
    included), and no other block touched."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    out = {}
    for kind, c in (("f32", cfg),
                    ("int8", dataclasses.replace(cfg, kv_quant="int8"))):
        pool = TierSlotPool(c, 2, 648, block_size=16, device=dev)
        paged = [(leaf, ax) for leaf, (k, ax) in
                 zip(tree_leaves(pool.cache), tree_leaves(pool._meta))
                 if k == "paged"]
        for leaf, _ in paged:
            if leaf.dtype == torch.int8:
                leaf.copy_(torch.randint(-127, 128, leaf.shape,
                                         generator=gen, device=dev,
                                         dtype=torch.int8))
            else:
                leaf.copy_(torch.randn(leaf.shape, generator=gen,
                                       device=dev))
        src, dst = [5, 17, 40, 63], [70, 3, 81, 22]
        before = [leaf.clone() for leaf, _ in paged]
        pool._copy_blocks(src, dst)
        torch.cuda.synchronize()
        s, d = (torch.tensor(x, device=dev) for x in (src, dst))
        keep = torch.tensor([i for i in range(pool.num_blocks)
                             if i not in dst], device=dev)
        ok = all(torch.equal(leaf.index_select(ax, d),
                             old.index_select(ax, s))
                 and torch.equal(leaf.index_select(ax, keep),
                                 old.index_select(ax, keep))
                 for (leaf, ax), old in zip(paged, before))
        out[kind] = {"leaves": len(paged), "bit_exact": ok,
                     "dtypes": sorted({str(l.dtype) for l, _ in paged})}
        del pool, paged, before
        if not ok:
            raise AssertionError(f"_copy_blocks not bit-exact ({kind})")
    torch.cuda.empty_cache()
    emit(check="prefix-cache copy-on-write _copy_blocks on the card",
         model=cfg.name, blocks=4, pools=out)


def wall_record(args, s) -> dict:
    """What a wall-clock run records: tokens/s, TTFT and tick p50, peak
    memory, the requests per tier, live prefill tokens, the prefix-cache
    and preemption counters."""
    gen = sum(args.gen_len * (r["tier"] + 1) for r in s["per_request"])
    return dict(
        generated_tokens_per_s=gen / s["elapsed"],
        ttft_p50_s=s["ttft_p50"], tick_p50_s=s["tick_duration_p50"],
        max_memory_allocated_bytes=s["max_memory_allocated_bytes"],
        tier_requests=s["tier_requests"],
        prefill_live_tokens=s["prefill_live_tokens"],
        prefix_cache=s["prefix_cache"],
        preemptions_by_tier=s["preemptions_by_tier"],
        replayed_tokens_by_tier=s["replayed_tokens_by_tier"])


def check_prefix_cache(card: str, params, keep=None) -> dict:
    """The prefix-caching phase, on phase 4's weights: the phase-4
    workload with 0.75 of every prompt shared, at a fixed δ of 1 (every
    request escalates, so both tiers' indices serve, and the escalation
    re-prefill hits the expensive tier's) under a virtual clock — the
    ragged executor with the cache off and on, the padded and split
    executors with it on, and the ragged one on an arena of 80 blocks,
    which evicts index entries — each with exact launch counts and block
    conservation (:func:`serve`).  Each cache-on run must hit on both
    tiers, prefill fewer live tokens (exactly the cached ones fewer) and
    keep the cache-off run's streams up to near-ties: the margin rule,
    each tier's bound twice its largest logit error of
    :func:`prefix_logit_error`.  Then the ragged executor on the wall
    clock at the escalation budget, cache off and on (a record: tokens/s,
    TTFT, peak memory).  Returns the runs' launch counts by path; a dict
    ``keep`` receives what phase 4d compares with: the cache-off
    virtual-clock run's records (``base``), the margin bounds
    (``bounds``) and the cache-off wall-clock record (``wall_off``)."""
    fixed = dict(shared_prefix_frac=PREFIX_FRAC, delta=1.0)
    args = main_path_args(**fixed)
    cfgs = serve_async.tier_configs(args)
    dev = params[0]["embed"].device
    errs = [prefix_logit_error(dev, params[t], cfgs[t]) for t in (0, 1)]
    check_copy_blocks(dev, cfgs[1])
    bounds = [2 * max(e.values()) for e in errs]
    prompts = workload_prompts(args, cfgs)
    counts, runs = {}, {}
    on = {"prefix_cache": True}
    for label, executor, flags in (
            ("ragged off", "ragged", {}), ("ragged on", "ragged", on),
            ("padded on", "padded", on), ("split on", "split", on),
            ("ragged on, 80 blocks", "ragged",
             dict(on, kv_blocks=PREFIX_KV_BLOCKS))):
        c, per_req, s = serve(card, params, executor,
                              phase=f"prefix caching, {label}",
                              clock=VirtualClock(), **fixed, **flags)
        counts[f"prefix {label}"] = c
        runs[label] = (per_req, s)
    base, s_off = runs["ragged off"]
    problems, table = [], {}
    for label, (per_req, s) in runs.items():
        pc, pools = s["prefix_cache"], s["kv_arena"]
        table[label] = dict(
            hit_rate_by_tier=[h / n for h, n in zip(pc["hits_by_tier"],
                                                    s["tier_requests"])],
            cached_tokens_by_tier=pc["cached_tokens_by_tier"],
            prefill_live_tokens=s["prefill_live_tokens"],
            index_entries=[m["prefix_index_entries"] for m in pools],
            evictions=[m["prefix_evictions"] for m in pools],
            cow_copies=[m["prefix_cow_copies"] for m in pools],
            shared_high_water_blocks=[m["kv_shared_high_water_blocks"]
                                      for m in pools], steps=s["steps"])
        if label == "ragged off":
            continue
        if min(pc["hits_by_tier"]) == 0:
            problems.append(f"{label}: no hit on a tier {pc}")
        if s["prefill_live_tokens"] != s_off["prefill_live_tokens"] \
                - pc["cached_tokens"] or not pc["cached_tokens"]:
            problems.append(f"{label}: live prefill tokens "
                            f"{s['prefill_live_tokens']}, cache off "
                            f"{s_off['prefill_live_tokens']}, cached "
                            f"{pc['cached_tokens']}")
        margin_check(f"prefix cache {label} streams against ragged off, "
                     "teacher-forced", stream_gaps(base, per_req, prompts,
                                                   params, cfgs, dev),
                     bounds)
    if not sum(table["ragged on, 80 blocks"]["evictions"]):
        problems.append("the 80-block arena evicted no index entry")
    wall = {}
    for cache in (False, True):
        c, _, s = serve(card, params, "ragged",
                        phase="prefix caching, wall clock",
                        shared_prefix_frac=PREFIX_FRAC, prefix_cache=cache)
        counts[f"prefix wall {'on' if cache else 'off'}"] = c
        wall["on" if cache else "off"] = wall_record(args, s)
    emit(phase="prefix caching summary", card=card,
         cascade=[args.fast, args.expensive], shared_prefix_frac=PREFIX_FRAC,
         virtual_clock_delta_1=table, logit_error=errs, margin_bound=bounds,
         wall_clock_budget=wall, problems=problems)
    if problems:
        raise AssertionError("prefix caching: " + "; ".join(problems))
    if keep is not None:
        keep.update(base=base, bounds=bounds, wall_off=wall["off"])
    return counts


# --------------------------------------------------------------------------
# the overload phase
# --------------------------------------------------------------------------

# phase 4c's workload on 64 KV blocks a tier, where the oldest-first
# discipline alone stalls for good; each policy's counts are the CPU
# rehearsal's, which equal the JAX engine's on the same settings:
# label -> (executor, flags, preemptions by tier, replayed tokens by
# tier, ticks)
OVERLOAD_KV_BLOCKS = 64
OVERLOAD_RUNS = {
    "ragged youngest": ("ragged", {"preemption": "youngest"},
                        [29, 3], [1891, 128], 58),
    "ragged fewest-tokens": ("ragged", {"preemption": "fewest-tokens"},
                             [28, 8], [1904, 425], 62),
    "ragged youngest prefix": ("ragged", {"preemption": "youngest",
                                          "prefix_cache": True},
                               [20, 2], [1407, 192], 47),
    "split youngest": ("split", {"preemption": "youngest"},
                       [27, 3], [1786, 128], 55),
}
# one seeded fault plan: tier 0 shrunk by 12 blocks at tick 8 and given
# them back at 30, a storm on gate 0 over ticks 5-25, every launch and
# fetch failing once with probability 0.05, and tier 1's launches at
# tick 33 (one live row there) failing past the two retries; and the
# rehearsal's outcome
OVERLOAD_FAULTS = ("seed=7,shrink=8:0:12:30,storm=5-25:0,launch=0.05,"
                   "launchat=33:1:3")
OVERLOAD_FAULT_COUNTS = dict(
    failed_rids=[6], launch_retries_by_tier=[6, 8],
    preemptions_by_tier=[32, 2], replayed_tokens_by_tier=[2180, 128],
    steps=55, fault_events=17)
# a deadline (virtual-clock ticks after arrival) that sheds 4 of the 16
OVERLOAD_DEADLINE = 50.0
OVERLOAD_SHED_COUNTS = dict(shed_rids=[10, 11, 13, 14],
                            preemptions_by_tier=[29, 3], steps=50)


def overload_counts(s, keys) -> dict:
    """The overload counters of a run's summary named by ``keys``."""
    per_req = s["per_request"]
    got = dict(
        failed_rids=[r["rid"] for r in per_req if r["state"] == "FAILED"],
        shed_rids=[r["rid"] for r in per_req if r["state"] == "SHED"],
        fault_events=s.get("fault_events"))
    return {k: got[k] if k in got else s[k] for k in keys}


def check_overload(card: str, params, ctx=None) -> dict:
    """The overload phase, on phase 4's weights: phase 4c's workload (0.75
    of every prompt shared, δ = 1, virtual clock) on 64 KV blocks a
    tier, where admission alone stalls for good.  (a) The ragged
    executor under ``youngest`` and ``fewest-tokens`` preemption, with
    ``youngest`` and the prefix cache, and the split executor under
    ``youngest``: each drains with its requests conserved, exact launch
    counts and block conservation (:func:`serve`), the rehearsal's
    preemptions, replayed tokens and ticks, and the streams of 4c's
    fully provisioned cache-off run under the margin rule with 4c's
    bounds.  (b) One seeded fault plan on the ragged executor (shrink,
    storm, transient launch and fetch faults, one launch past its
    retries): exactly the rehearsal's failed request, retries,
    preemptions and ticks, survivors' streams under the margin rule.
    (c) A deadline that sheds the rehearsal's requests.  (d) A record:
    ``youngest`` on 64 blocks on the wall clock at the escalation
    budget, beside 4c's fully provisioned cache-off run.  ``ctx`` is
    what :func:`check_prefix_cache` keeps; without it (the phase alone)
    the base run, the bounds and the wall-clock run are made here.
    Returns the runs' launch counts by path."""
    fixed = dict(shared_prefix_frac=PREFIX_FRAC, delta=1.0)
    args = main_path_args(**fixed)
    cfgs = serve_async.tier_configs(args)
    dev = params[0]["embed"].device
    counts = {}
    if ctx is None:
        errs = [prefix_logit_error(dev, params[t], cfgs[t]) for t in (0, 1)]
        _, base, _ = serve(card, params, "ragged",
                           phase="overload, fully provisioned",
                           clock=VirtualClock(), **fixed)
        _, _, s = serve(card, params, "ragged",
                        phase="overload, fully provisioned wall clock",
                        shared_prefix_frac=PREFIX_FRAC)
        ctx = dict(base=base, bounds=[2 * max(e.values()) for e in errs],
                   wall_off=wall_record(args, s))
    prompts = workload_prompts(args, cfgs)
    small = dict(fixed, kv_blocks=OVERLOAD_KV_BLOCKS)
    problems, table = [], {}

    def gaps(what, per_req):
        margin_check(f"overload {what} streams against the fully "
                     "provisioned cache-off run, teacher-forced",
                     stream_gaps(ctx["base"], per_req, prompts, params,
                                 cfgs, dev), ctx["bounds"])

    keys = ("preemptions_by_tier", "replayed_tokens_by_tier", "steps")
    for label, (executor, flags, pre, rep, ticks) in OVERLOAD_RUNS.items():
        c, per_req, s = serve(card, params, executor,
                              phase=f"overload, {label}",
                              clock=VirtualClock(), **small, **flags)
        counts[f"overload {label}"] = c
        table[label] = got = overload_counts(s, keys)
        want = dict(zip(keys, (pre, rep, ticks)))
        if got != want:
            problems.append(f"{label}: {got} != the rehearsal's {want}")
        gaps(label, per_req)
    c, per_req, s = serve(card, params, "ragged", phase="overload, faults",
                          clock=VirtualClock(), allow_lost=True,
                          preemption="youngest",
                          inject_faults=OVERLOAD_FAULTS, **small)
    counts["overload faults"] = c
    table["faults"] = got = overload_counts(s, OVERLOAD_FAULT_COUNTS)
    if got != OVERLOAD_FAULT_COUNTS:
        problems.append(f"faults: {got} != the rehearsal's "
                        f"{OVERLOAD_FAULT_COUNTS}")
    gaps("faults (survivors)", per_req)
    c, per_req, s = serve(card, params, "ragged", phase="overload, shedding",
                          clock=VirtualClock(), allow_lost=True,
                          preemption="youngest", deadline=OVERLOAD_DEADLINE,
                          **small)
    counts["overload shedding"] = c
    table["shedding"] = got = overload_counts(s, OVERLOAD_SHED_COUNTS)
    if got != OVERLOAD_SHED_COUNTS:
        problems.append(f"shedding: {got} != the rehearsal's "
                        f"{OVERLOAD_SHED_COUNTS}")
    gaps("shedding (survivors)", per_req)
    c, _, s = serve(card, params, "ragged", phase="overload, wall clock",
                    shared_prefix_frac=PREFIX_FRAC, preemption="youngest",
                    kv_blocks=OVERLOAD_KV_BLOCKS)
    counts["overload wall"] = c
    wall = {"64 blocks youngest": wall_record(args, s),
            "fully provisioned (4c)": ctx["wall_off"]}
    emit(phase="overload summary", card=card,
         cascade=[args.fast, args.expensive], shared_prefix_frac=PREFIX_FRAC,
         kv_blocks=OVERLOAD_KV_BLOCKS, virtual_clock_delta_1=table,
         fault_plan=OVERLOAD_FAULTS, deadline=OVERLOAD_DEADLINE,
         margin_bound=ctx["bounds"], wall_clock_budget=wall,
         problems=problems)
    if problems:
        raise AssertionError("overload: " + "; ".join(problems))
    return counts


# --------------------------------------------------------------------------
# the observability phase
# --------------------------------------------------------------------------

# --metrics-interval of the traced run (virtual-clock ticks), and the
# --flat-buckets override: 512 = 8 slots x 64-token chunks, the worst tick
OBS_INTERVAL = 3.0
OBS_BUCKETS = [16, 48, 160, 512]
HOST_PHASES = ("admit", "plan", "launch", "device_get", "finish")


def host_phase_split(trace: dict, names) -> dict:
    """Host milliseconds per engine phase from a tracer's trace: for each
    tier (``names``), each phase's sum over the run and its per-tick p50
    (a tick's events of one phase summed first, over the ticks that have
    one); the whole tick's the same way, with the tick time no phase
    covers (shedding, counters, the loop between phases)."""
    per = {}
    for e in trace["traceEvents"]:
        if e["ph"] != "X" or e["pid"] != 0:
            continue
        key = (e["tid"], e["name"])
        tick = e["args"]["tick"]
        per.setdefault(key, {})
        per[key][tick] = per[key].get(tick, 0.0) + e["dur"] / 1e3

    def stats(d):
        v = list(d.values())
        return {"sum_ms": float(np.sum(v)) if v else 0.0,
                "p50_ms": float(np.median(v)) if v else None,
                "ticks": len(v)}
    out = {name: {ph: stats(per.get((t, ph), {})) for ph in HOST_PHASES}
           for t, name in enumerate(names)}
    tick = stats(per.get((len(names), "tick"), {}))
    phases = sum(out[n][ph]["sum_ms"] for n in names for ph in HOST_PHASES)
    out["tick"] = dict(tick, outside_phases_ms=tick["sum_ms"] - phases)
    return out


def profile_ranges(trace: dict, counts: dict) -> dict:
    """From the profiler's Chrome trace of a run with
    ``profile_annotations``: the ``run_ragged/<tier>`` ranges per tier,
    the ragged kernels each range launched (a kernel is in a range when
    the host call that launched it, matched by correlation id, lies
    inside the range) against ``counts[tier]`` (its attention layers),
    and the device's idle share of the ticks: 1 − (kernel time, overlaps
    merged) / (first ``tick/<id>`` start to last end)."""
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    ranges = {}
    for e in evs:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith("run_ragged/"):
            ranges.setdefault(e["name"].split("/", 1)[1], []).append(e)
    ticks = [e for e in evs if e.get("cat") == "user_annotation"
             and e["name"].startswith("tick/")]
    kern = [e for e in evs if e.get("cat") == "kernel"]
    ragged = KERNEL_NAMES["ragged_attention"][0]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in evs
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    per_range = {}
    for tier, rs in ranges.items():
        starts = sorted(launch_ts[k["args"]["correlation"]] for k in kern
                        if ragged in k["name"] and k.get("args", {}).get(
                            "correlation") in launch_ts)
        per_range[tier] = sorted(
            sum(r["ts"] <= t <= r["ts"] + r["dur"] for t in starts)
            for r in rs)
    t0 = min(e["ts"] for e in ticks)
    t1 = max(e["ts"] + e["dur"] for e in ticks)
    busy, end = 0.0, t0
    for a, b in sorted((max(k["ts"], t0), min(k["ts"] + k["dur"], t1))
                       for k in kern):
        if b > max(a, end):
            busy += b - max(a, end)
            end = b
    return {"ranges": {t: len(r) for t, r in ranges.items()},
            "ragged_kernels_per_range": {
                t: sorted(set(v)) for t, v in per_range.items()},
            "ranges_with_expected_kernels": {
                t: sum(n == counts[t] for n in v)
                for t, v in per_range.items()},
            "tick_ranges": len(ticks), "ticks_ms": (t1 - t0) / 1e3,
            "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / (t1 - t0)}


def check_observability(card: str, params, bounds=None) -> dict:
    """The observability phase, on phase 4's weights: the phase-4
    workload on the ragged executor under a virtual clock, (a) untraced;
    (b) with ``--trace-out``, ``--profile`` and ``--metrics-interval``:
    streams, launches and host syncs equal to (a)'s, the trace valid
    under ``scripts/check_trace.py``, one snapshot line a window, and in
    the profiler's trace one ``run_ragged/<tier>`` range a ragged launch
    with that tier's attention layers' ragged kernels inside; (c) with
    ``--trace-out`` alone, equal to (a) again — the host milliseconds
    per phase (admit, plan, launch, device_get, finish, tick) a tier, (c)
    without the profiler's overhead and (b) with it, beside (b)'s device
    idle share; (d) with ``--flat-buckets 16 48 160 512``: exact launch
    counts (:func:`serve`) and (a)'s streams under phase 4b's margin
    rule, each tier's bound its largest verify-window logit error
    (``bounds``, measured here when None).  Returns the runs' launch
    counts by path."""
    sys.path.insert(0, str(Path(__file__).resolve().parent / "scripts"))
    import check_trace

    args = main_path_args()
    cfgs = serve_async.tier_configs(args)
    names = [args.fast, args.expensive]
    dev = params[0]["embed"].device
    work = kernels.BUILD_DIR / "observability"
    work.mkdir(parents=True, exist_ok=True)
    trace_path, prof_dir = work / "trace.json", work / "profile"
    counts, problems = {}, []

    def served(label, **flags):
        """One run (:func:`serve`) with its printed output held back: its
        JSON records are printed again, its snapshot lines returned."""
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                c, per, s = serve(card, params, "ragged",
                                  clock=VirtualClock(),
                                  phase=f"observability, {label}", **flags)
        finally:
            lines = out.getvalue().splitlines()
            for line in lines:
                if line.startswith("{"):
                    print(line, flush=True)
        counts[f"obs {label}"] = c
        return per, s, [line for line in lines if line.startswith("[t=")]

    base, s_a, _ = served("untraced")
    per_b, s_b, snaps = served(
        "traced and profiled", trace_out=str(trace_path),
        trace_ring=1 << 20, profile=str(prof_dir),
        metrics_interval=OBS_INTERVAL)
    trace_b = json.loads(trace_path.read_text())
    prof = json.loads((prof_dir / "torch_trace.json").read_text())
    per_c, s_c, _ = served("traced", trace_out=str(trace_path),
                           trace_ring=1 << 20)
    trace_c = json.loads(trace_path.read_text())
    keys = ("launches", "launches_by_kind", "host_syncs",
            "host_syncs_per_tick", "steps", "stream_checksum")
    for label, per, s in (("traced and profiled", per_b, s_b),
                          ("traced", per_c, s_c)):
        if per != base or any(s[k] != s_a[k] for k in keys):
            problems.append(f"{label} run differs from the untraced one")
    for label, tr, s in (("traced and profiled", trace_b, s_b),
                         ("traced", trace_c, s_c)):
        errs = check_trace.validate_trace(tr)
        if errs or s["trace_dropped"] or s["trace_events"] != len(
                tr["traceEvents"]):
            problems.append(f"{label} trace: {errs[:3]}, dropped "
                            f"{s['trace_dropped']}")
    if not snaps:
        problems.append("--metrics-interval printed no snapshot")
    attn = {n: layer_counts(cfg)["attn"] for n, cfg in zip(names, cfgs)}
    ranges = profile_ranges(prof, attn)
    ragged = {n: k.get("ragged", 0)
              for n, k in zip(names, s_b["launches_by_kind"])}
    if ranges["ranges"] != ragged or \
            ranges["ranges_with_expected_kernels"] != ragged or \
            ranges["tick_ranges"] != s_b["steps"]:
        problems.append(f"profiler ranges {ranges} against ragged launches "
                        f"{ragged} and {s_b['steps']} ticks")
    split = {"tracer alone": host_phase_split(trace_c, names),
             "tracer and profiler": host_phase_split(trace_b, names)}
    emit(phase="observability host phases", card=card, cascade=names,
         executor="ragged", clock="virtual", ticks=s_c["steps"],
         tier_launches=s_c["launches"], host_ms=split,
         profiler=ranges, trace_events=s_b["trace_events"],
         snapshot_lines=len(snaps), snapshot_first=snaps[:1],
         snapshot_last=snaps[-1:])
    for p in (trace_path, prof_dir / "torch_trace.json"):
        p.unlink()
    if bounds is None:
        bounds = [max(verify_logit_error(dev, params[t], cfgs[t]).values())
                  for t in (0, 1)]
    per_d, s_d, _ = served("flat buckets", flat_buckets=OBS_BUCKETS)
    if s_d["flat_buckets"] != [OBS_BUCKETS] * 2:
        problems.append(f"flat buckets {s_d['flat_buckets']}")
    widths = sorted({e["args"]["width"] for e in trace_c["traceEvents"]
                     if e["name"] == "launch"})
    margin_check("flat buckets 16 48 160 512 streams against the default "
                 "buckets, teacher-forced",
                 stream_gaps(base, per_d, workload_prompts(args, cfgs),
                             params, cfgs, dev), bounds)
    emit(phase="observability summary", card=card, cascade=names,
         default_bucket_widths_launched=widths,
         flat_bucket_steps=s_d["steps"], default_steps=s_a["steps"],
         flat_bucket_live_tokens=s_d["step_live_tokens"],
         flat_bucket_processed_tokens=s_d["step_processed_tokens"],
         default_processed_tokens=s_a["step_processed_tokens"],
         margin_bound=bounds, problems=problems)
    if problems:
        raise AssertionError("observability: " + "; ".join(problems))
    return counts


# --------------------------------------------------------------------------
# phase 7: training on the card
# --------------------------------------------------------------------------

TRAIN_TOL = ("losses, lb_loss and z_loss rtol 1e-4; every gradient leaf "
             "atol 1e-4, rtol 1e-3")
TRAIN_LR = 1e-2
# the kernels a train step launches: moe_route (counted in router_gate)
# in each MoE layer, the scans in each recurrent layer
TRAIN_COUNTED = ("router_gate", "rwkv6_scan", "mamba_scan")


class GradTap:
    """Records the gradients each train step hands its optimizer (the
    step's own forward and backward), through the optimizer that
    ``steps.make_optimizer`` builds while the tap is open."""

    def __enter__(self):
        self.orig = steps.make_optimizer
        self.grads = []

        def make(cfg):
            opt = self.orig(cfg)

            def update(p, g, s, lr):
                self.grads.append(g)
                return opt.update(p, g, s, lr)
            return Optimizer(opt.init, update, opt.name)
        steps.make_optimizer = make
        return self

    def __exit__(self, *exc):
        steps.make_optimizer = self.orig


def train_launches() -> dict:
    """Reads the train kernels' counters and sets them to 0."""
    out = {}
    for name in TRAIN_COUNTED:
        out[name] = getattr(ops, name).launches
        getattr(ops, name).launches = 0
    return out


def one_train_step(cfg, params, batch, exp=None):
    """One step of ``make_train_step`` on ``params`` — or of
    ``make_ltc_train_step`` against ``exp = (config, params)`` — and, on
    the same batch, the train forward's aux losses (for a config with
    early exits also Eq 6, ``ltc_chain_loss`` over the exits' and the
    final logits, as ``chain_loss``): (the step's metrics and the aux
    losses as floats, the step's gradients, the step's router calls, and
    the ``TRAIN_COUNTED`` launches of the step and of the aux
    forward)."""
    with GradTap() as grads, RouterTap() as tap:
        if exp is None:
            step, opt = steps.make_train_step(cfg, lr=TRAIN_LR)
            extra = ()
        else:
            step, opt = steps.make_ltc_train_step(cfg, exp[0], lr=TRAIN_LR)
            extra = (exp[1],)
        train_launches()
        _, _, m = step(params, opt.init(params), *extra, batch)
        metrics = {k: float(v) for k, v in m.items()}
        step_launches = train_launches()
        step_calls = list(tap.calls)
        with torch.no_grad():
            logits, aux = transformer.train_logits(params, cfg, batch)
            exits = aux.pop("exit_logits", ())
            if exits:
                chain = [e[:, :-1] for e in exits] + [logits[:, :-1]]
                metrics["chain_loss"] = float(losses.ltc_chain_loss(
                    chain, batch["tokens"][:, 1:])[0])
            del logits, exits
        metrics.update({k: float(v) for k, v in aux.items()})
        aux_launches = train_launches()
    return (metrics, grads.grads[0], step_calls,
            (step_launches, aux_launches))


def gemma3_one_period():
    """gemma3-1b at its published widths (d 1152, the tied 262144-id
    head) cut to one period: 5 windowed layers and 1 global, no tail."""
    return dataclasses.replace(get_config("gemma3-1b", ""), num_periods=1,
                               tail=())


def train_step_models():
    """(label, config, the expensive (label, config) or None) of phase
    7a: ``make_train_step`` on gemma3-1b and ``make_ltc_train_step``
    gemma3-1b -> phi4-mini-3.8b at the smoke widths, ``make_train_step``
    on granite at its published widths cut to 2 layers (phase 3's cut)
    and on gemma3-1b at its published widths cut to one period (phase
    7b's widths)."""
    models = dict(step_models())
    gemma = models["gemma3-1b-smoke"]
    return [("gemma3-1b-smoke", gemma, None),
            ("gemma3-1b-smoke", gemma,
             ("phi4-mini-3.8b-smoke", models["phi4-mini-3.8b-smoke"])),
            ("granite-moe-3b-a800m 2 layers",
             models["granite-moe-3b-a800m 2 layers"], None),
            ("gemma3-1b 1 period", gemma3_one_period(), None)]


def _named_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k, v in tree.items()
                for kv in _named_leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def expected_train_launches(cfg, exp_cfg, remat: bool) -> tuple:
    """The ``TRAIN_COUNTED`` launches of one train step and of its aux
    forward: each MoE, RWKV-6 or Mamba layer of the trained model
    launches its kernel once in the forward and, its period checkpointed,
    once more in backward (the scans' backward is plain torch); the
    frozen expensive model's forward, under ``no_grad``, once a layer;
    the aux forward once a layer of the trained model."""
    kinds = dict(router_gate="moe", rwkv6_scan="rwkv6", mamba_scan="mamba")
    n = layer_counts(cfg)
    n_exp = layer_counts(exp_cfg) if exp_cfg is not None else {}
    return ({k: n[v] * (1 + remat) + n_exp.get(v, 0)
             for k, v in kinds.items()},
            {k: n[v] for k, v in kinds.items()})


def check_train_steps(dev, models=None) -> dict:
    """Phase 7a (7e: ``models``, the recurrent ones): one train step of
    each of :func:`train_step_models` on the card against the same step
    on the CPU (plain versions), from the same weights and batch: the
    loss (``l_org`` and ``l_casc`` under LtC), the train forward's
    ``lb_loss`` and ``z_loss`` (and Eq 6 for a config with early exits),
    and every gradient leaf — unless the router first picked differently
    on a near-tie, which is reported, as phase 3 does.  The exit heads'
    gradient must be exactly zero: the LM loss reads only the final
    logits.  The ``TRAIN_COUNTED`` launches of the step and of the aux
    forward must be :func:`expected_train_launches`' exactly (remat
    forced on).  Returns the card's launches by kernel."""
    rng = np.random.default_rng(7)
    launched = dict.fromkeys(TRAIN_COUNTED, 0)
    for label, cfg, exp in models or train_step_models():
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (2, 64)).astype(np.int32))
        cpu_p = init_params(cfg, 0, torch.float32, "cpu")
        card_p = tree_map(lambda t: t.to(dev), cpu_p)
        exp_cpu = exp_card = None
        if exp is not None:
            ep = init_params(exp[1], 1, torch.float32, "cpu")
            exp_cpu = (exp[1], ep)
            exp_card = (exp[1], tree_map(lambda t: t.to(dev), ep))
        want, want_g, cpu_calls, _ = one_train_step(
            cfg, cpu_p, {"tokens": toks}, exp_cpu)
        t0 = time.perf_counter()
        got, got_g, card_calls, (n_step, n_aux) = one_train_step(
            cfg, card_p, {"tokens": toks.to(dev)}, exp_card)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        remat = bool(cfg.num_periods)
        want_n = expected_train_launches(cfg, exp and exp[1], remat)
        routing = first_routing_difference(cpu_calls, card_calls)
        problems = []
        if (n_step, n_aux) != want_n:
            problems.append(f"launches step {n_step}, aux {n_aux} != "
                            f"{want_n[0]}, {want_n[1]}")
        exit_grads = [g for k, g in _named_leaves(got_g)
                      if k.startswith("exit_heads/")]
        if any(bool(g.any()) for g in exit_grads):
            problems.append("an exit head's gradient is not zero")
        rel = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
               for k in want}
        grad_err, grad_bad = 0.0, []
        if routing is None:
            for (k, g), w in zip(_named_leaves(got_g), tree_leaves(want_g)):
                g = g.float().cpu()
                grad_err = max(grad_err, (g - w).abs().max().item())
                if not torch.allclose(g, w, atol=1e-4, rtol=1e-3):
                    grad_bad.append(k)
            bad = [k for k, e in rel.items() if e > 1e-4]
            if bad or grad_bad:
                problems.append(f"card vs cpu: {bad} {grad_bad[:5]}")
        elif not routing[2]:
            problems.append(f"routing differs off a near-tie: {routing}")
        emit(check="train step card vs cpu", model=label,
             step="make_ltc_train_step" if exp else "make_train_step",
             expensive=exp[0] if exp else None, card_metrics=got,
             cpu_metrics=want, rel_err=rel, grad_max_abs_err=grad_err,
             grads_compared=routing is None, routing=routing,
             tol=TRAIN_TOL, remat=remat,
             launches={"step": n_step, "aux": n_aux},
             exit_head_leaves_zero=len(exit_grads), card_ms_incl_aux=ms,
             problems=problems)
        if problems:
            raise AssertionError(f"train step {label}: {problems}")
        for k in launched:
            launched[k] += n_step[k] + n_aux[k]
        del cpu_p, card_p, exp_cpu, exp_card
    torch.cuda.empty_cache()
    return launched


# lr 1e-3 (make_train_step's default): at the run's smoke-scale default
# of 1e-2, adafactor drives the published gemma3-1b's l_org up, on the
# card and on the CPU alike (check_lr_witness)
LTC_TRAIN = dict(steps=8, batch=4, seq=256, vocab=4096, lr=1e-3)
LR_WITNESS = dict(steps=4, lr=1e-2, rtol=1e-3)


def check_lr_witness(card: str, dev) -> None:
    """Phase 7a, the witness for phase 7b's learning rate: ``steps``
    steps of ``make_train_step`` at ``run``'s default lr 1e-2 on
    :func:`gemma3_one_period` (adafactor, remat), from the same weights
    and on phase 7b's batches (``run``'s ``bigram_lm`` data over 4096
    ids and its ``Batches`` order), once on the card and once on the CPU
    (plain versions).  Asserts the losses agree step by step within
    ``rtol`` (later steps amplify the devices' different summation
    orders); records whether the loss rose on both.  A rise on the CPU
    too says a divergence at this lr is the optimizer's, not a card
    fault."""
    cfg = gemma3_one_period()
    n, B, S = LR_WITNESS["steps"], LTC_TRAIN["batch"], LTC_TRAIN["seq"]
    data = bigram_lm(num_seqs=max(B * 16, 256), seq_len=S,
                     vocab=LTC_TRAIN["vocab"], seed=0, trigram_frac=0.3)
    it = iter(Batches({"tokens": data}, B, seed=0))
    batches = [torch.as_tensor(next(it)["tokens"]) for _ in range(n)]
    cpu_p = init_params(cfg, 0, torch.float32, "cpu")
    losses, ms = {}, {}
    for where in ("cpu", "card"):
        d = torch.device("cpu") if where == "cpu" else dev
        p = tree_map(lambda t: t.to(d), cpu_p)
        step, opt = steps.make_train_step(cfg, lr=LR_WITNESS["lr"])
        state = opt.init(p)
        losses[where], ms[where] = [], []
        for b in batches:
            t0 = time.perf_counter()
            p, state, m = step(p, state, {"tokens": b.to(d)})
            losses[where].append(float(m["loss"]))
            ms[where].append((time.perf_counter() - t0) * 1e3)
        del p, state
    rel = [abs(g - w) / abs(w) for g, w in zip(losses["card"], losses["cpu"])]
    problems = []
    if not np.isfinite(losses["card"] + losses["cpu"]).all():
        problems.append("a loss is not finite")
    if max(rel) > LR_WITNESS["rtol"]:
        problems.append(f"card vs cpu losses rel err {max(rel)}")
    emit(check="lr witness, card vs cpu", card=card,
         model="gemma3-1b 1 period", step="make_train_step",
         optimizer="adafactor", remat=True, batch=B, seq=S,
         vocab=LTC_TRAIN["vocab"], **LR_WITNESS, card_loss=losses["card"],
         cpu_loss=losses["cpu"], rel_err=rel,
         rose={k: v[-1] > v[0] for k, v in losses.items()},
         card_step_ms=ms["card"], cpu_step_ms=ms["cpu"], problems=problems)
    if problems:
        raise AssertionError("lr witness: " + "; ".join(problems))
    del cpu_p
    torch.cuda.empty_cache()


def check_ltc_training(card: str, exp_params, variant: str = "",
                       expensive: str = PHI4_NAME):
    """Phase 7b (7e: ``expensive`` rwkv6-3b): ``launch.train.run`` — LtC
    training of gemma3-1b at its published widths (random f32 weights
    from seed 0, adafactor, its periods checkpointed) against phase 4's
    frozen phi4-mini-3.8b: 8 steps of 4 x 256 tokens of ``bigram_lm``
    over 4096 ids (its trigram table is ``vocab x vocab``, so the
    published 262144 cannot seed it) at lr 1e-3.
    Records ``l_org`` and ``l_casc`` per step, the step's ms (p50 after
    the first), training tokens/s over steps 2..8 and peak device
    memory; asserts finite losses, ``l_org`` at step 8 below step 1, and
    the ``TRAIN_COUNTED`` launches (the counters set to 0 just before
    and read just after): the frozen model's forward, once a layer a
    step.  Returns (the trained weights, the launches)."""
    fast_cfg = get_config("gemma3-1b", variant)
    exp_cfg = get_config(expensive, variant)
    want_n = {k: v * LTC_TRAIN["steps"] for k, v in expected_train_launches(
        fast_cfg, exp_cfg, True)[0].items()}
    torch.cuda.reset_peak_memory_stats()
    history = []
    train_launches()
    t0 = time.perf_counter()
    params = train.run("gemma3-1b", variant=variant, expensive=expensive,
                       exp_params=exp_params, log_every=0, device="cuda",
                       history=history, **LTC_TRAIN)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = train_launches()
    peak = torch.cuda.max_memory_allocated()
    l_org = [h["l_org"] for h in history]
    l_casc = [h["l_casc"] for h in history]
    ms = [h["ms"] for h in history]
    tokens = LTC_TRAIN["batch"] * LTC_TRAIN["seq"]
    problems = []
    if not np.isfinite(l_org + l_casc).all():
        problems.append("a loss is not finite")
    if not l_org[-1] < l_org[0]:
        problems.append(f"l_org did not fall: {l_org[0]} -> {l_org[-1]}")
    if launched != want_n:
        problems.append(f"launches {launched} != {want_n}")
    emit(phase="LtC training", card=card,
         configs=["gemma3-1b", expensive], variant=variant or "published",
         optimizer="adafactor", remat=True, **LTC_TRAIN,
         l_org=l_org, l_casc=l_casc, step_ms=ms,
         step_ms_p50_after_first=float(np.median(ms[1:])),
         train_tokens_per_s=tokens * (len(ms) - 1) / (sum(ms[1:]) / 1e3),
         max_memory_allocated_bytes=peak, wall_s_incl_init=wall,
         launches=launched, problems=problems)
    if problems:
        raise AssertionError("LtC training: " + "; ".join(problems))
    return params, launched


CLF = dict(epochs=6, lr=0.03, batch_size=512)


def check_classifier_flow(card: str, dev) -> None:
    """Phase 7c: the paper's classifier flow (``examples/quickstart.py``)
    through the port on the card: ``teacher_task(60000)`` split 8:1:1;
    the zoo's resnet18 (expensive, CE) and mobilenetv2 (fast) trained
    for 6 epochs, the fast one twice, CE baseline and LtC (w = 1, C =
    0.5, against the expensive model's training logits); δ from
    ``best_accuracy_delta`` on val; on test each arm's Acc^casc,
    MACs^casc, N^exp and the fast model's ECE; and the baselines'
    calibration of the CE fast model: ``fit_temperature``'s T with its
    test ECE, and the ConfNet head's test ECE.  Asserts only what must
    hold: the cost in ``[macs_fast, macs_fast + macs_exp]``, δ in [0, 1],
    Acc^casc at δ = 0 the fast member's accuracy and at δ = 1 the
    expensive member's, and N^exp / N = frac_used[1]."""
    t0 = time.perf_counter()
    ds = teacher_task(num_samples=60000, seed=0)
    tr, va, te = ds.split((0.8, 0.1, 0.1))
    nc = int(tr.y.max()) + 1
    zoo = classifier.zoo(tr.x.shape[1], nc)
    fast_cfg, exp_cfg = zoo["mobilenetv2"], zoo["resnet18"]
    kw = dict(CLF, device=dev)
    exp_p = classifier.train_classifier(exp_cfg, tr.x, tr.y, **kw)
    exp_logits, _ = classifier.predict(exp_p, torch.from_numpy(tr.x).to(dev))
    arms = {"baseline": classifier.train_classifier(fast_cfg, tr.x, tr.y,
                                                    **kw),
            "ltc": classifier.train_classifier(
                fast_cfg, tr.x, tr.y, exp_logits=exp_logits, ltc_w=1.0,
                cost_c=0.5, **kw)}
    costs = [fast_cfg.macs, exp_cfg.macs]

    def stats(fp, split):
        x = torch.from_numpy(split.x).to(dev)
        y = torch.from_numpy(split.y).long().to(dev)
        fl, _ = classifier.predict(fp, x)
        el, _ = classifier.predict(exp_p, x)
        return (confidence.max_prob(fl), losses.correct(fl, y),
                losses.correct(el, y), fl, y, x)

    problems, out = [], {}
    for name, fp in arms.items():
        cv, fv, ev, *_ = stats(fp, va)
        delta, _, _ = thresholds.best_accuracy_delta(cv, fv, ev, costs)
        ct, ft, et, *_ = stats(fp, te)
        n = ct.shape[0]
        res = cascade.evaluate_cascade(ct[None], torch.stack([ft, et]),
                                       costs, [[0.0], [delta], [1.0]])
        acc, cost = res["acc"].tolist(), res["cost"].tolist()
        n_exp = res["n_exp"][:, 0]
        fast_acc, exp_acc = float(ft.mean()), float(et.mean())
        if not costs[0] <= cost[1] <= costs[0] + costs[1]:
            problems.append(f"{name}: MACs^casc {cost[1]} outside "
                            f"[{costs[0]}, {sum(costs)}]")
        if not 0.0 <= delta <= 1.0:
            problems.append(f"{name}: δ {delta}")
        if abs(acc[0] - fast_acc) > 1e-6 or abs(acc[2] - exp_acc) > 1e-6:
            problems.append(f"{name}: Acc^casc at δ 0 / 1 {acc[0]} / "
                            f"{acc[2]} != members' {fast_acc} / {exp_acc}")
        # a mean is the sum times f32(1/N), as evaluate_cascade takes it
        inv_n = torch.tensor(1.0 / n, device=n_exp.device)
        if not torch.equal(n_exp * inv_n, res["frac_used"][:, 1]):
            problems.append(f"{name}: N^exp / N != frac_used[1]")
        out[name] = dict(delta=delta, acc_casc=acc[1], macs_casc=cost[1],
                         n_exp=int(n_exp[1]), n_test=n, fast_acc=fast_acc,
                         exp_acc=exp_acc, fast_ece=calibration.ece(ct, ft))
    # the baselines' calibration of the CE fast model, fit on val
    _, _, _, fl_va, y_va, x_va = stats(arms["baseline"], va)
    ct, ft, _, fl_te, _, x_te = stats(arms["baseline"], te)
    temp = calibration.fit_temperature(fl_va, y_va)
    with torch.no_grad():
        feats_va = classifier.mlp_apply(arms["baseline"], x_va,
                                        with_features=True)[1]
        feats_te = classifier.mlp_apply(arms["baseline"], x_te,
                                        with_features=True)[1]
    head = calibration.fit_conf_head(torch.Generator().manual_seed(0),
                                     feats_va, fl_va, y_va, kind="confnet")
    with torch.no_grad():
        head_conf = calibration.conf_head_apply(head, feats_te)
    emit(phase="classifier flow", card=card,
         members=[fast_cfg.name, exp_cfg.name], macs=costs,
         train_val_test=[len(tr.y), len(va.y), len(te.y)], **CLF,
         arms=out, temperature=temp,
         temperature_ece=calibration.ece(
             confidence.max_prob(fl_te / temp), ft),
         confnet_ece=calibration.ece(head_conf, ft),
         wall_s=time.perf_counter() - t0, problems=problems)
    if problems:
        raise AssertionError("classifier flow: " + "; ".join(problems))


class CascadeTap:
    """Keeps the engine ``launch.serve.serve_cascade`` builds while the
    tap is open (a module attribute, restored on exit)."""

    def __enter__(self):
        self.orig = serve_mod.CascadeEngine
        self.engine = None

        def build(*a, **kw):
            self.engine = self.orig(*a, **kw)
            return self.engine
        serve_mod.CascadeEngine = build
        return self

    def __exit__(self, *exc):
        serve_mod.CascadeEngine = self.orig


SERVE_TRAINED = dict(batch=8, prompt_len=32, gen_len=16, delta=0.5)


def check_serve_trained(card: str, fast: dict, exp_params,
                        variant: str = "", expensive: str = PHI4_NAME,
                        prefix: str = "") -> dict:
    """Phase 7d (7e: ``expensive`` rwkv6-3b, on the uniform executor the
    engine picks for a recurrent tier): ``launch.serve.serve_cascade`` at
    the published widths (``SERVE_TRAINED``: every request at 0, virtual
    clock, the default ragged executor) with phase 4's phi4-mini-3.8b
    behind each of the gemma3-1b weights in ``fast`` (label -> params:
    phase 4's untrained ones, 7b's trained ones), the counters set to 0
    just before and read just after: gate and layer-kernel launches
    exactly those of the engine's tier launches, every token in the
    vocabulary, every sequence confidence in (0, 1].  Records the
    escalation counts at the same δ.  Returns the counts by run, each
    key ``prefix`` + ``serve_cascade <label>``."""
    cfgs = [get_config("gemma3-1b", variant), get_config(expensive, variant)]
    counts, escalated = {}, {}
    for label, fast_params in fast.items():
        for name in COUNTED:
            getattr(ops, name).launches = 0
        t0 = time.perf_counter()
        with CascadeTap() as tap:
            toks, conf, st = serve_mod.serve_cascade(
                "gemma3-1b", expensive, variant=variant,
                fast_params=fast_params, exp_params=exp_params,
                verbose=False, device="cuda", **SERVE_TRAINED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        c = {name: getattr(ops, name).launches for name in COUNTED}
        s = tap.engine.metrics.summary()
        del tap
        want = expected_launches(cfgs, s["launches_by_kind"])
        problems = []
        if c["confidence_gate"] != sum(s["launches"]):
            problems.append(f"gate launches {c['confidence_gate']} != tier "
                            f"launches {s['launches']}")
        if {k: c[k] for k in want} != want:
            problems.append(f"launches {c} != {want}")
        if toks.shape != (SERVE_TRAINED["batch"], SERVE_TRAINED["gen_len"]) \
                or int(toks.min()) < 0 \
                or int(toks.max()) >= max(cfg.vocab_size for cfg in cfgs):
            problems.append(f"tokens {tuple(toks.shape)} out of range")
        if not bool(((conf > 0) & (conf <= 1)).all()):
            problems.append(f"sequence confidences {conf.tolist()}")
        escalated[label] = st.n_exp
        counts[f"{prefix}serve_cascade {label}"] = c
        emit(phase="serve trained pair", card=card, fast_weights=label,
             configs=["gemma3-1b", expensive], **SERVE_TRAINED,
             escalated=st.n_exp, seq_conf=conf.tolist(),
             tier_launches=s["launches"],
             launches_by_kind=s["launches_by_kind"], kernel_launches=c,
             flops_cascade_per_token=st.flops_cascade
             / SERVE_TRAINED["gen_len"], wall_s=wall, problems=problems)
        if problems:
            raise AssertionError(f"serve_cascade {label}: {problems}")
    emit(check="escalations at the same δ", delta=SERVE_TRAINED["delta"],
         configs=["gemma3-1b", expensive], escalated=escalated,
         requests=SERVE_TRAINED["batch"])
    return counts


def recurrent_train_models():
    """(label, config, the expensive (label, config) or None) of phase
    7e: ``make_train_step`` on rwkv6-3b at its published widths cut to 2
    layers and on the narrow jamba period (7 Mamba layers, 1 attention,
    4 MoE FFNs), ``make_ltc_train_step`` gemma3-1b -> rwkv6-3b and ->
    jamba-v0.1-52b at the smoke widths, and ``make_train_step`` on
    gemma3-1b at its published widths cut to one period with an exit
    head after it (Eq 6 over the exit's and the final logits)."""
    models = dict(uniform_models())
    gemma = models["gemma3-1b-smoke"]
    return [("rwkv6-3b 2 layers", models["rwkv6-3b 2 layers"], None),
            ("jamba narrow period", models["jamba narrow period"], None),
            ("gemma3-1b-smoke", gemma,
             ("rwkv6-3b-smoke", models["rwkv6-3b-smoke"])),
            ("gemma3-1b-smoke", gemma,
             ("jamba-v0.1-52b-smoke", models["jamba-v0.1-52b-smoke"])),
            ("gemma3-1b 1 period, exit 0", dataclasses.replace(
                gemma3_one_period(), early_exit_periods=(0,)), None)]


# Why 7e(b) trains against rwkv6-3b and not the published jamba: 7e(b)
# peaks at 46.04 GB with phase 4's gemma3-1b and phi4-mini-3.8b (19.4 GB)
# and rwkv6-3b (12.3 GB) resident, so gemma3-1b's LtC training takes
# ~14.3 GB.  jamba's 1-period cut (53.2 GB) in rwkv6-3b's place comes to
# ~87 GB, past the card's 80 GB; with phi4 freed (phase 7 runs on it,
# and the phases after need the card for granite) ~72 GB, a margin of
# ~8 GB for jamba's forward transients and the allocator.  jamba is the
# frozen member in 7e(a), at the smoke widths.


def check_recurrent_training(card: str, dev, params) -> dict:
    """Phase 7e, the recurrent layers' train mode and the exit heads:
    (a) :func:`check_train_steps` over :func:`recurrent_train_models`,
    card against CPU, with exact ``rwkv6_scan``, ``mamba_scan`` and
    ``moe_route`` launches (two a recurrent layer a step under remat,
    one a layer of a frozen member); (b) :func:`check_ltc_training` of
    the published gemma3-1b against the frozen published rwkv6-3b (its
    weights drawn from the rwkv6 cascade's seed; ``rwkv6_scan`` 32 a
    step); (c) :func:`check_serve_trained` of gemma3-1b -> rwkv6-3b,
    untrained (phase 4's gemma3-1b) and trained, on the uniform
    executor.  Returns the counts of the runs whose launches are
    read."""
    t0 = time.perf_counter()
    counts = {"recurrent train steps": dict.fromkeys(COUNTED, 0)}
    counts["recurrent train steps"].update(
        check_train_steps(dev, recurrent_train_models()))
    args = main_path_args(RWKV_NAME)
    rwkv = init_params(get_config(RWKV_NAME, args.variant), args.seed + 1,
                       torch.float32, dev)
    trained, launched = check_ltc_training(card, rwkv, args.variant,
                                           RWKV_NAME)
    counts["LtC rwkv6"] = {**dict.fromkeys(COUNTED, 0), **launched}
    counts.update(check_serve_trained(
        card, {"untrained": params[0], "trained": trained}, rwkv,
        args.variant, RWKV_NAME, prefix="rwkv6 "))
    del trained, rwkv
    torch.cuda.empty_cache()
    emit(phase="recurrent training summary", card=card,
         wall_s=time.perf_counter() - t0)
    return counts


def check_training(card: str, dev, params) -> dict:
    """Phase 7, on phase 4's weights (``params``: gemma3-1b's, untrained,
    and phi4-mini-3.8b's, the frozen expensive model): 7a to 7e.
    Returns the counts of the runs whose launches are read: the train
    steps' launches, 7d's and 7e's serving runs and 7e's LtC run."""
    t0 = time.perf_counter()
    counts = {"train steps": dict.fromkeys(COUNTED, 0)}
    counts["train steps"].update(check_train_steps(dev))
    check_lr_witness(card, dev)
    trained, _ = check_ltc_training(card, params[1])
    check_classifier_flow(card, dev)
    counts.update(check_serve_trained(
        card, {"untrained": params[0], "trained": trained}, params[1]))
    del trained
    torch.cuda.empty_cache()
    counts.update(check_recurrent_training(card, dev, params))
    emit(phase="training summary", card=card,
         wall_s=time.perf_counter() - t0)
    return counts


# --------------------------------------------------------------------------
# phase 8: the rest of the registry
# --------------------------------------------------------------------------

REGISTRY_NAMES = (STARCODER_NAME, MUSICGEN_NAME, QWEN_NAME, MOONSHOT_NAME,
                  KIMI_NAME)
# qwen2-vl-72b's prompts: its 1024 patch positions (frontend_len), then
# 128 text tokens
QWEN_PROMPT_LEN = 1152


def registry_step_models():
    """(label, config) of phase 8b's step checks: kimi-k2-1t-a32b at its
    published widths cut to its dense first layer (d 7168, 64 heads of
    112, 8 KV heads, d_ff 16384, vocab 163840; 11.3 GB), qwen2-vl-72b at
    its published widths cut to 1 of its 80 layers (M-RoPE at head width
    128, the vision frontend's 1024 positions), and the five configs'
    smoke widths."""
    return [("kimi-k2-1t-a32b dense first layer", dataclasses.replace(
                get_config(KIMI_NAME, ""), num_periods=0)),
            ("qwen2-vl-72b 1 layer", dataclasses.replace(
                get_config(QWEN_NAME, ""), num_periods=1))] + [
        (f"{n}-smoke", get_config(n, "smoke")) for n in REGISTRY_NAMES]


def registry_cascades(variant=""):
    """(label, expensive, its config, executors, flags) of phase 8a's
    cascades behind gemma3-1b, at the published widths: starcoder2-7b
    (32 layers, 29.6 GB) under the three chunked executors;
    musicgen-large (48 layers, 9.7 GB; the audio frontend) and
    qwen2-vl-72b cut to 8 of its 80 layers (38.1 GB; M-RoPE and the
    vision frontend, 1152-token prompts) on the uniform prefill they
    take by themselves; moonshot-v1-16b-a3b cut to its dense first layer
    and 8 of its 47 MoE layers (21.3 GB; 64 experts, top-6) on the
    ragged executor."""
    qwen = get_config(QWEN_NAME, variant)
    moonshot = get_config(MOONSHOT_NAME, variant)
    return (("starcoder2", STARCODER_NAME, get_config(STARCODER_NAME,
                                                      variant),
             tuple(EXECUTORS), {}),
            ("musicgen", MUSICGEN_NAME, get_config(MUSICGEN_NAME, variant),
             ("auto",), {}),
            ("qwen2-vl 8 layers", QWEN_NAME,
             dataclasses.replace(qwen, num_periods=8), ("auto",),
             {"prompt_len": QWEN_PROMPT_LEN}),
            ("moonshot 1 + 8 layers", MOONSHOT_NAME,
             dataclasses.replace(moonshot, num_periods=8), ("ragged",), {}))


def check_configs(card: str, dev, fast_params) -> dict:
    """Phase 8, the rest of the registry, beside phase 4's gemma3-1b
    (``fast_params``), the only other weights on the card.  (b) the
    steps of :func:`registry_step_models` on the card against the CPU:
    ``ragged_step``, ``mixed_step`` and ``prefill_chunk`` + paged
    ``decode_step`` where the config has no frontend (the chunked modes
    raise there), ``prefill`` + dense ``decode_step`` for all — kimi's
    layer runs all four attention kernels at head width 112.  (a) each
    cascade of :func:`registry_cascades` served by
    ``serve_async.run`` (its weights drawn from the expensive tier's
    seed, freed after), with exact launch counts, finite confidences and
    block conservation.  Returns the counts of the serving runs."""
    t0 = time.perf_counter()
    models = registry_step_models()
    chunked = [(label, cfg) for label, cfg in models if not cfg.frontend]
    check_ragged_step(dev, chunked)
    check_padded_steps(dev, chunked)
    check_uniform_steps(dev, models)
    steps_s = time.perf_counter() - t0
    counts = {}
    for label, name, cfg, executors, flags in registry_cascades():
        args = main_path_args(name)
        torch.cuda.empty_cache()
        params = (fast_params, init_params(cfg, args.seed + 1,
                                           torch.float32, dev))
        cfgs = (get_config(args.fast, args.variant), cfg)
        runs = {ex: serve(card, params, ex, name, cfgs,
                          phase=f"registry {label}", **flags)
                for ex in executors}
        if len(runs) > 1:
            compare_streams({ex: r for ex, (_, r, _) in runs.items()}, name)
        counts.update({f"{label} {ex}": c for ex, (c, _, _) in runs.items()})
        del params, runs
    torch.cuda.empty_cache()
    emit(phase="registry summary", card=card, steps_s=steps_s,
         wall_s=time.perf_counter() - t0)
    return counts


# profiler kernel names of each kernel kind (any of them, by substring):
# the ragged, paged and mixed kinds count their split-merge kernels too
KERNEL_NAMES = {"ragged_attention": ("ragged_kernel", "ragged_merge_kernel"),
                "mixed_attention": ("mixed_kernel", "mixed_merge_kernel"),
                "paged_attention": ("paged_decode_kernel",
                                    "paged_merge_kernel"),
                "flash_attention": ("flash_kernel",),
                "confidence_gate": ("gate_kernel",),
                "router_gate": ("router_kernel", "moe_route_kernel"),
                "rwkv6_scan": ("wkv_kernel",),
                "mamba_scan": ("mamba_kernel",)}


# each profile's requests: phase 4's 8 slots full at the start (reading a
# trace costs ~0.25 ms a launch, and the whole script must end within
# 1200 s)
PROFILE_REQUESTS = 8


def profile_ticks(card: str, params, executor: str, expensive=PHI4_NAME,
                  cfgs=None, **flags):
    """Where a tick's device time goes under one executor: the phase-4
    workload cut to :data:`PROFILE_REQUESTS` requests (the cascade to
    ``expensive``; ``flags`` adds CLI flags: speculation's) served again
    under a VirtualClock (no waiting for arrivals) inside
    ``torch.profiler``; kernel time summed by kind, and the device's idle
    share of the serving loop's wall time.  The top kernels list shows
    the MoE cascade's expert products among the matrix products.  Reading
    the trace costs about 0.25 ms a kernel launch, several times the
    serving loop, hence the cut."""
    from torch.profiler import ProfilerActivity, profile

    args = main_path_args(expensive, requests=PROFILE_REQUESTS,
                          **ALL_EXECUTORS[executor], **flags)
    engine, vocab = serve_async.build_engine(args, VirtualClock(), params,
                                             cfgs)
    prompts = bigram_lm(
        num_seqs=args.requests, seq_len=args.prompt_len,
        vocab=min(vocab, serve_async.PROMPT_VOCAB), seed=args.seed)
    lens = serve_async.sample_lengths(args.length_dist, args.requests,
                                      args.prompt_len, args.min_prompt_len,
                                      args.seed)
    engine.warmup()
    for p, n in zip(prompts, lens):
        engine.submit(p[:int(n)], arrival_time=0.0)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s = engine.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kinds = dict.fromkeys(list(KERNEL_NAMES) + ["matrix products",
                                                "other"], 0.0)
    counts = dict.fromkeys(kinds, 0)
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us:
            continue
        name = e.key
        rows.append((us, e.count, name))
        kind = next((k for k, ns in KERNEL_NAMES.items()
                     if any(n in name for n in ns)), None)
        if kind is None:
            kind = ("matrix products" if any(
                k in name.lower() for k in ("gemm", "gemv", "cutlass",
                                            "xmma")) else "other")
        kinds[kind] += us / 1e3
        counts[kind] += e.count
    rows.sort(reverse=True)
    busy = sum(kinds.values())
    emit(phase="profile", executor=executor, expensive=expensive,
         card=card, clock="virtual", speculate=args.speculate,
         gen_len=args.gen_len,
         ticks=s["steps"], tier_launches=s["launches"],
         stream_checksum=serve_async.stream_checksum(engine),
         serving_wall_ms=wall_ms, device_kernel_ms=busy,
         device_idle_share=(1.0 - busy / wall_ms) if busy else None,
         kernel_ms_by_kind=kinds, kernel_launches_by_kind=counts,
         share_by_kind={k: v / busy for k, v in kinds.items()} if busy
         else None,
         top_kernels=[[round(us / 1e3, 3), n, name[:80]]
                      for us, n, name in rows[:12]])


def profile_speculation(card: str, params) -> None:
    """Phase 4b's runs profiled (:func:`profile_ticks`), k = 0 against
    k = 4, both cascades, at phase 4's ``gen_len`` 8 (a trace of phase
    4b's ``gen_len`` 32 holds ~1M launches, and reading it costs
    minutes).  Run by ``scripts/torch_speculation_profiles.py``, not by
    ``main``: reading the four traces took ~100 s of the script's 1200."""
    for expensive, pair, seed in ((PHI4_NAME, params, {}),
                                  ("gemma3-1b", (params[0], params[0]),
                                   {"expensive_seed": 0})):
        for k in (0, SPEC_K):
            profile_ticks(card, pair, "ragged", expensive, speculate=k,
                          spec_delta=0.0 if k else None, **seed)


def profile_families(card: str, fast) -> None:
    """Phase 6's profiles (:func:`profile_ticks`) of the other cascades,
    gemma3-1b's weights ``fast`` beside each expensive tier's drawn in
    turn as ``main`` draws them: granite-moe-3b-a800m under the ragged
    executor, rwkv6-3b and jamba-v0.1-52b cut to 1 of its 4 periods on
    the uniform path they take by themselves.  Run by
    ``scripts/torch_family_profiles.py``, not by ``main``: the three
    took ~40 s of the script's 1200 at 4 requests."""
    args = main_path_args(MOE_NAME)
    dev = fast["embed"].device
    jamba = dataclasses.replace(get_config(JAMBA_NAME, args.variant),
                                num_periods=1)
    for name, executor, cfgs in (
            (MOE_NAME, "ragged", None), (RWKV_NAME, "auto", None),
            (JAMBA_NAME, "auto", (get_config("gemma3-1b", args.variant),
                                  jamba))):
        cfg = cfgs[1] if cfgs else get_config(name, args.variant)
        params = (fast, init_params(cfg, args.seed + 1, torch.float32, dev))
        profile_ticks(card, params, executor, name, cfgs)
        del params
        torch.cuda.empty_cache()


def check_split_moe_determinism(card: str, params) -> None:
    """Is the split MoE tier deterministic on the card?  In split decode
    a masked row attends the null block 0, whose contents are written by
    racing duplicate ``index_put_`` writes; its hidden state then routes
    through ``router_gate`` and takes expert capacity.  The split
    granite cascade is served twice under a VirtualClock (the same
    arrivals and ticks) on the same weights, and whether the two runs'
    streams are equal is recorded, not asserted."""
    args = main_path_args(MOE_NAME, **ALL_EXECUTORS["split"])
    runs = []
    for _ in range(2):
        s = serve_async.run(args, VirtualClock(), params)
        torch.cuda.synchronize()
        runs.append(s)
    a, b = ({r["rid"]: (r["tier"], r["state"], r["tokens"])
             for r in s["per_request"]} for s in runs)
    differ = sorted(rid for rid in a if a[rid] != b.get(rid))
    emit(check="split MoE determinism", executor="split",
         expensive=MOE_NAME, card=card, clock="virtual", runs=2,
         stream_checksums=[s["stream_checksum"] for s in runs],
         equal=not differ and len(a) == len(b), differing_rids=differ,
         tier_requests=[s["tier_requests"] for s in runs])


# --------------------------------------------------------------------------
# phase 9: multi-device serving
# --------------------------------------------------------------------------

# 9a's over-subscribed run: phase 4d's workload on 64 KV blocks a tier,
# two data shards.  Blocks of 32 tokens: a row of 648 tokens takes 21, so
# 32 a shard hold one full request and the null block (64 blocks of 16
# would leave 32 a shard, under one request's 41 pages + 1)
MULTI_OVER = dict(kv_blocks=64, kv_block_size=32, preemption="youngest",
                  delta=1.0, shared_prefix_frac=0.75)


# requests a run of 9a's and 10a's turns (phase 4's workload has 16): cut
# to keep chip_smoke.py inside its time once phase 12 joined
SHARD_TURN_REQUESTS = 8


def card_devices() -> list:
    """``cuda:0 … cuda:{n-1}``: the cards phase 9 may place tiers on."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def shard_conservation(engine) -> list:
    """Per data shard of every paged pool: free + live + withheld blocks
    make up the shard's usable range (shard 0 less its null block).
    Returns the shards that break it."""
    bad = []
    for rt in engine.runtimes:
        alloc = rt.pool.blocks
        for s in range(alloc.shards):
            usable = alloc._span - (s == 0)
            got = alloc.free_in(s) + alloc.used_in(s) + alloc.reserved_in(s)
            if got != usable:
                bad.append({"tier": rt.spec.name, "shard": s, "blocks": got,
                            "usable": usable})
    return bad


def serve_meshed(card: str, params, label: str, tier_mesh=None,
                 devices=None, clock=None, traced=False, expensive=PHI4_NAME,
                 cfgs=None, **flags) -> dict:
    """Serve phase 4's workload on ``params`` (ragged, gemma3-1b ->
    ``expensive``, phi4-mini-3.8b unless said; ``cfgs`` the tiers'
    configs where they are not the registry's) under ``--tier-mesh``
    over ``devices`` (None: the visible cards), every kernel counter set
    to 0 just before and read just after.  Checks: every request DONE
    (conservation), blocks conserved after the drain in every pool and
    every data shard, confidences finite, one fetch at most per active
    tier per tick, each meshed tier holding one replica of its params per
    distinct device (phase 4's tensors themselves on the device they
    were drawn on) or, with ``--shard-params`` over a model axis, one
    set of slices per (device, model shard), and the launches: a tier of
    D data shards of M model shards launches each layer kernel D × M
    times and the gate D times per tier launch and per warmup width, so
    the layer kernels count ``sum_t D_t * M_t * expected_launches(tier
    t)`` and the gate ``sum_t D_t * (tier launches + warmup widths)``.
    ``traced`` records
    the run with ``--trace-out`` and adds each tier's host ms in its
    ``launch`` and ``device_get`` phases (:func:`host_phase_split`).
    Returns the run's counts, per-request records, summary, peak memory
    by card and KV high water by shard."""
    trace_path = kernels.BUILD_DIR / "multidevice" / "trace.json"
    if traced:
        trace_path.parent.mkdir(parents=True, exist_ok=True)
        flags["trace_out"] = str(trace_path)
    args = main_path_args(expensive, tier_mesh=tier_mesh,
                          mesh_devices=devices, **flags)
    cards = card_devices()
    for d in cards:
        torch.cuda.reset_peak_memory_stats(d)
    for name in COUNTED:
        getattr(ops, name).launches = 0
    with EngineTap() as tap:
        s = serve_async.run(args, clock, params=params, cfgs=cfgs)
    for d in cards:
        torch.cuda.synchronize(d)
    counts = {name: getattr(ops, name).launches for name in COUNTED}
    peak = [torch.cuda.max_memory_allocated(d) for d in cards]
    eng = tap.engine
    cfgs = serve_async.tier_configs(args, cfgs)
    shards = [rt.data_shards for rt in eng.runtimes]
    models = [rt.model_shards for rt in eng.runtimes]
    kinds = s["launches_by_kind"]
    warm = [{"ragged": len(b)} for b in s["flat_buckets"]]
    want = {k: 0 for k in COUNTED if k != "confidence_gate"}
    for t, (d, m) in enumerate(zip(shards, models)):
        for k, v in expected_launches([cfgs[t]], [kinds[t]],
                                      [warm[t]]).items():
            want[k] += d * m * v
    want["confidence_gate"] = sum(
        d * (n + w["ragged"]) for d, n, w in zip(shards, s["launches"],
                                                 warm))
    problems = []
    if counts != want:
        problems.append(f"launches {counts} != {want} (D x M x per tier, "
                        "the gate D x)")
    per_req = s["per_request"]
    if s["completed"] != args.requests or not s["conservation"]["ok"] \
            or not all(len(r["tokens"]) == args.gen_len for r in per_req):
        problems.append(f"not every request DONE: {s['conservation']}")
    leaks = pool_leaks(eng) + shard_conservation(eng)
    if leaks:
        problems.append(f"blocks not conserved: {leaks}")
    if not all(np.isfinite(r.token_conf).all() for r in eng.requests):
        problems.append("a token's confidence is not finite")
    if any(h > a for h, a in zip(s["host_syncs"], s["active_ticks"])):
        problems.append(f"host syncs {s['host_syncs']} over active ticks "
                        f"{s['active_ticks']}")
    views = [0] * len(eng.runtimes)
    for t, rt in enumerate(eng.runtimes):
        if rt.mesh is None:
            continue
        if rt.spec.shard_params and rt.model_shards > 1:
            placed = {(dev, j) for d in range(rt.data_shards)
                      for j, dev in enumerate(rt.mesh.model_devices(d))}
        else:
            placed = set(rt.mesh.devices.flat)
        if len(rt.replicas) != len(placed):
            problems.append(f"tier {t}: params placed {list(rt.replicas)}")
        # no copy of the weights: every tree placed on the card that holds
        # the given tensors (a full replica, or a model shard's slices)
        # views their storage leaf for leaf
        if isinstance(params[t], dict):
            leaves = tree_leaves(params[t])
            home = leaves[0].device
            for key, tree in rt.replicas.items():
                if (key[0] if isinstance(key, tuple) else key) != home:
                    continue
                views[t] += 1
                if [x.untyped_storage().data_ptr() for x in tree_leaves(tree)] \
                        != [x.untyped_storage().data_ptr() for x in leaves]:
                    problems.append(f"tier {t}: the weights placed for "
                                    f"{key} are a copy")
    by_shard = [m["kv_high_water_blocks_by_shard"] for m in s["kv_arena"]]
    host_ms = None
    if traced:
        split = host_phase_split(json.loads(trace_path.read_text()),
                                 [args.fast, args.expensive])
        host_ms = {n: {f"{ph} {k}": split[n][ph][k]
                       for ph in ("launch", "device_get")
                       for k in ("p50_ms", "sum_ms")}
                   for n in (args.fast, args.expensive)}
        host_ms["tick p50_ms"] = split["tick"]["p50_ms"]
    gen_tokens = sum(args.gen_len * (r["tier"] + 1) for r in per_req)
    record = dict(
        phase="multidevice", run=label, card=card,
        tier_meshes=s["tier_meshes"], clock="virtual" if clock else "wall",
        data_shards=shards, model_shards=models, requests=args.requests,
        steps=s["steps"],
        tier_launches=s["launches"], launches_by_kind=kinds,
        warmup_widths=warm, kernel_launches_window=counts,
        active_ticks=s["active_ticks"], host_syncs=s["host_syncs"],
        escalation_rate=s["escalation_rates"],
        generated_tokens_per_s=gen_tokens / s["elapsed"],
        makespan_s=s["elapsed"], tick_p50_s=s["tick_duration_p50"],
        tick_p95_s=s["tick_duration_p95"], ttft_p50_s=s["ttft_p50"],
        max_memory_allocated_bytes_by_card=peak,
        kv_high_water_blocks=[m["kv_high_water_blocks"]
                              for m in s["kv_arena"]],
        kv_high_water_blocks_by_shard=by_shard,
        preemptions_by_tier=s["preemptions_by_tier"], host_ms=host_ms,
        weight_trees_checked_as_views=views,
        stream_checksum=s["stream_checksum"], problems=problems)
    emit(**record)
    del tap, eng
    if problems:
        raise AssertionError(f"multidevice {label}: " + "; ".join(problems))
    return dict(counts=counts, per_req=per_req, summary=s, peak=peak,
                by_shard=by_shard, shards=shards, host_ms=host_ms)


def same_tier_differences(base: list, other: list) -> list:
    """Rids that end at the same tier in both runs with different
    tokens."""
    want = {r["rid"]: r for r in base}
    return [r["rid"] for r in other if r["tier"] == want[r["rid"]]["tier"]
            and r["tokens"] != want[r["rid"]]["tokens"]]


def check_multidevice(card: str, params) -> dict:
    """Phase 9, on phase 4's weights (alone:
    ``scripts/torch_multidevice_phase.py``).  (9a, any card count) the
    workload unsharded and with both tiers on a ``2x1`` mesh over the
    first card twice (two data shards a tier, each shard's launches on
    the same card), in turns (unsharded, sharded, sharded, unsharded),
    traced for each tier's host ms in ``launch``: same-tier streams
    equal, launches D times the unsharded formula, blocks conserved in
    every shard, both shards of each tier used, and peak memory within
    half of gemma3-1b's weights of the unsharded run's (a second copy of
    either tier's params would add 4–15 GB); then the over-subscribed run (``MULTI_OVER``, two shards,
    virtual clock): preemptions and every request drained.  (9b, two
    cards or more) tier 0 on ``cuda:0`` and tier 1 on ``cuda:1``
    (``--tier-mesh 1 1``), tier 1 on a ``2x1`` mesh over ``cuda:0..1``,
    and the card tests that launch each kernel on ``cuda:1`` while
    ``cuda:0`` is current; with one card, one line saying 9b did not
    run.  Returns the runs' launch counts by path."""
    t0 = time.perf_counter()
    one = card_devices()[:1] * 2
    turns = [serve_meshed(card, params, f"{label}, turn {i}", mesh, one,
                          traced=True, requests=SHARD_TURN_REQUESTS)
             for i, (label, mesh) in enumerate((
                 ("unsharded", None), ("2x1 on one card", ["2x1"]),
                 ("2x1 on one card", ["2x1"]), ("unsharded", None)))]
    base = turns[0]
    over = serve_meshed(card, params, "2x1 over-subscribed youngest",
                        ["2x1"], one, clock=VirtualClock(), **MULTI_OVER)
    problems = []
    differ = [same_tier_differences(base["per_req"], x["per_req"])
              for x in turns[1:]]
    if any(differ):
        problems.append(f"same-tier streams differ: {differ}")
    for x in turns[1:3]:
        if not all(all(h > 0 for h in t) for t in x["by_shard"]):
            problems.append(f"a shard stayed empty: {x['by_shard']}")
    fast_bytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params[0]))
    grew = max(x["peak"][0] for x in turns[1:3]) - min(
        x["peak"][0] for x in (turns[0], turns[3]))
    if grew > fast_bytes / 2:
        problems.append(f"peak memory grew {grew} bytes (gemma3-1b's "
                        f"weights are {fast_bytes})")
    if sum(over["summary"]["preemptions_by_tier"]) == 0:
        problems.append("the over-subscribed run preempted nothing")
    tokens_per_s = [sum(x["summary"]["gen_len"] * (r["tier"] + 1)
                        for r in x["per_req"]) / x["summary"]["elapsed"]
                    for x in turns]
    emit(check="multidevice 9a: 2 data shards a tier on one card against "
               "unsharded, in turns (unsharded, sharded, sharded, "
               "unsharded)", card=card, tokens_per_s=tokens_per_s,
         sharded_over_unsharded=[tokens_per_s[1] / tokens_per_s[0],
                                 tokens_per_s[2] / tokens_per_s[3]],
         tick_p50_s=[x["summary"]["tick_duration_p50"] for x in turns],
         host_ms=[x["host_ms"] for x in turns],
         peak_bytes=[x["peak"][0] for x in turns],
         peak_growth_bytes=grew, fast_params_bytes=fast_bytes,
         launches=[x["counts"] for x in turns],
         same_tier_differing_rids=differ,
         over_preemptions_by_tier=over["summary"]["preemptions_by_tier"],
         over_by_shard=over["by_shard"], problems=problems)
    if problems:
        raise AssertionError("multidevice 9a: " + "; ".join(problems))
    out = {f"multidevice {label}": x["counts"] for label, x in (
        ("unsharded", turns[0]), ("2x1", turns[1]), ("2x1 again", turns[2]),
        ("unsharded again", turns[3]), ("2x1 youngest", over))}
    cards = card_devices()
    if len(cards) < 2:
        emit(check="multidevice 9b", ran=False, card=card,
             reason=f"torch.cuda.device_count() is {len(cards)}: placing "
                    "tiers on distinct cards and launching on cuda:1 "
                    "while cuda:0 is current need two cards")
    else:
        two = cards[:2]
        split = serve_meshed(card, params, "tiers on cuda:0 and cuda:1",
                             ["1", "1"], two)
        wide = serve_meshed(card, params, "tier 1 on 2x1 over cuda:0..1",
                            ["1", "2x1"], two)
        differ = {label: same_tier_differences(base["per_req"],
                                               x["per_req"])
                  for label, x in (("1 1", split), ("1 2x1", wide))}
        env = dict(os.environ,
                   PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
        tests = subprocess.run(
            [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "-p",
             "no:cacheprovider", "-k", "second_card",
             str(Path(__file__).resolve().parent / "tests"
                 / "test_torch_kernels_cuda.py")],
            capture_output=True, text=True, env=env, timeout=600)
        last = (tests.stdout.strip().splitlines() or [""])[-1]
        emit(check="multidevice 9b", ran=True, card=card,
             devices=len(cards), same_tier_differing_rids=differ,
             peak_bytes_by_card=[split["peak"], wide["peak"]],
             kernel_tests_rc=tests.returncode, kernel_tests=last)
        # every second-card test must run and pass: none may skip
        if any(differ.values()) or tests.returncode != 0 \
                or "passed" not in last or "skipped" in last:
            raise AssertionError(f"multidevice 9b: {differ}\n"
                                 f"{tests.stdout[-4000:]}")
        out.update({"multidevice 1 1": split["counts"],
                    "multidevice 1 2x1": wide["counts"]})
    emit(phase="multidevice", phase_s=time.perf_counter() - t0)
    return out


# phase 10: the model axis -- tensor-parallel tiers on 1x2 meshes
MODEL_MESH = "1x2"
# a teacher-forced full bucket: 8 rows of 64 tokens at positions 0-63
TF_ROWS, TF_TOKENS, TF_BLOCK = 8, 64, 16
TF_TOL = 1e-4


def teacher_forced_logits(cfg, weights, devices, seed: int = 0):
    """One full-bucket ``ragged_step`` (:data:`TF_ROWS` rows of
    :data:`TF_TOKENS` seeded token ids, fresh pages) of ``cfg`` over a
    fresh paged pool: unsharded (``weights`` a tree, ``devices`` one
    device) or over ``len(devices)`` model shards (``weights`` one tree a
    model shard, each its slices).  Returns the last-slot logits [8, V]
    on the first device."""
    m, dev = len(devices), devices[0]
    pages_per_row = TF_TOKENS // TF_BLOCK
    gen = torch.Generator().manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (1, TF_ROWS * TF_TOKENS),
                           generator=gen, dtype=torch.int32)
    pos = torch.arange(TF_TOKENS, dtype=torch.int32).repeat(TF_ROWS)[None]
    pages = {"page_table": (1 + torch.arange(
                 TF_ROWS * pages_per_row, dtype=torch.int32)).view(
                 TF_ROWS, pages_per_row),
             "q_len": torch.full((TF_ROWS,), TF_TOKENS, dtype=torch.int32),
             "q_start": torch.zeros(TF_ROWS, dtype=torch.int32)}
    pages = {k: v.to(dev) for k, v in pages.items()}
    blocks_n = TF_ROWS * pages_per_row + 1
    if m == 1:
        cache = init_paged_cache(cfg, TF_ROWS, blocks_n, TF_BLOCK,
                                 device=dev)
        group = None
    else:
        shard_cfg = sharding.shard_config(cfg, m)
        cache = [init_paged_cache(shard_cfg, TF_ROWS, blocks_n, TF_BLOCK,
                                  device=d) for d in devices]
        group = sharding.ModelShards(devices)
    with torch.no_grad():
        logits, _ = transformer.ragged_step(
            weights, cfg, tokens.to(dev), cache, pos.to(dev), pages,
            group=group)
    return logits


def model_shard_weights(params, cfg, devices):
    """``params``' model shard slices for a ``1 x len(devices)`` mesh over
    ``devices`` (views where a shard's device holds the tree)."""
    mesh = make_tier_mesh(1, len(devices), devices)
    specs = params_lib.param_specs(cfg, mesh)
    return [tree_map(lambda t, d=d: t.to(d), sharding.model_shard_params(
        params, cfg, specs, j, len(devices))) for j, d in enumerate(devices)]


def compare_teacher_forced(card: str, label: str, cfg, params, devices):
    """:func:`teacher_forced_logits` sharded over ``devices`` against
    unsharded on ``devices[0]``, the kernel counters set to 0 just
    before the sharded step and read after: logits within ``TF_TOL``
    absolute, argmax equal on every row whose unsharded top-1/top-2
    margin exceeds it, and the sharded step's launches exactly M times
    the layers' (ragged attention per attention layer, ``moe_route`` per
    MoE layer), the gate none (the caller gates).  Returns the sharded
    step's counts."""
    want = teacher_forced_logits(cfg, params, devices[:1])
    shards = model_shard_weights(params, cfg, devices)
    for name in COUNTED:
        getattr(ops, name).launches = 0
    got = teacher_forced_logits(cfg, shards, devices)
    torch.cuda.synchronize()
    counts = {name: getattr(ops, name).launches for name in COUNTED}
    m, n = len(devices), layer_counts(cfg)
    expect = {name: 0 for name in COUNTED}
    expect["ragged_attention"] = m * n["attn"]
    expect["router_gate"] = m * n["moe"]
    err = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    sure = (top2[:, 0] - top2[:, 1]) > TF_TOL
    flips = int((got.argmax(-1) != want.argmax(-1))[sure].sum())
    problems = []
    if not err <= TF_TOL:
        problems.append(f"logits {err} off unsharded (tolerance {TF_TOL})")
    if flips:
        problems.append(f"{flips} argmax flips past the margin")
    if counts != expect:
        problems.append(f"launches {counts} != {expect}")
    emit(check=f"model axis 10a teacher-forced {label}", card=card,
         model_shards=m, rows=TF_ROWS, tokens_per_row=TF_TOKENS,
         max_abs_err=err, tolerance=TF_TOL, rows_past_margin=int(sure.sum()),
         argmax_flips=flips, launches=counts, problems=problems)
    del shards
    if problems:
        raise AssertionError(f"model axis {label}: " + "; ".join(problems))
    return counts


def draw_model_shard(cfg, seed: int, devices, j: int):
    """Model shard ``j``'s slices of random weights of ``cfg`` for a
    ``1 x len(devices)`` mesh, drawn directly on ``devices[j]`` (weights
    too large to draw whole on one card): each leaf at the shape
    :func:`repro_torch.models.sharding.model_shard_params` slices for
    the shard (the specs, and the KV-head rule for ``wk``/``wv``), by the
    leaf's init rule at its whole shape's scale, from a generator seeded
    with ``seed`` and ``j``."""
    m, dev = len(devices), devices[j]
    specs = params_lib.param_specs(cfg, make_tier_mesh(1, m, devices))
    shapes = sharding.model_shard_params(
        params_lib.param_shapes(cfg, torch.float32), cfg, specs, j, m)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed * 1009 + j)

    def fan_in(shape, axes):
        n = shape[0] if len(shape) == 1 else math.prod(shape[:-1])
        return n // shape[0] if "stack" in axes else n

    def leaf(p, like):
        shape = tuple(like.shape)
        t = params_lib._init_leaf(p._replace(shape=shape), gen,
                                  torch.float32, dev)
        if p.init == "fan_in":
            t.mul_(math.sqrt(fan_in(shape, p.axes) / fan_in(p.shape, p.axes)))
        return t
    return tree_map(leaf, params_lib.declare_model(cfg), shapes)


def check_model_axis(card: str, params) -> dict:
    """Phase 10, on phase 4's weights (alone:
    ``scripts/torch_model_axis_phase.py``).  (10a, any card count)
    teacher-forced full-bucket ragged steps of gemma3-1b and
    phi4-mini-3.8b on two model shards over the first card twice
    against unsharded (:func:`compare_teacher_forced`); the workload
    (:data:`SHARD_TURN_REQUESTS` requests) unsharded and with both tiers
    on ``1x2`` meshes over the first card
    twice with ``--shard-params``, in turns (unsharded, sharded,
    sharded, unsharded; traced): same-tier streams equal, the attention
    kernels exactly twice the unsharded formula and the gate once,
    blocks conserved, no copy of the weights (the slices are views on
    the card that holds them); then moonshot-v1-16b-a3b cut as phase 8
    (its dense first layer + 8 MoE layers, 21.3 GB) teacher-forced on
    two model shards, its experts split (``moe_route`` once a shard a MoE
    layer).  (10b, two cards or more) moonshot-v1-16b-a3b at its 48
    layers (110 GB in f32) drawn a model shard a card on a ``1x2`` mesh
    over two cards, gemma3-1b on a card of its own where there are three,
    serving the workload (:func:`check_model_axis_cards`); with one card,
    one line saying 10b did not run.  Returns the runs' launch counts by
    path."""
    t0 = time.perf_counter()
    cards = card_devices()
    one = cards[:1] * 2
    fast_cfg = get_config("gemma3-1b", "")
    phi4_cfg = get_config(PHI4_NAME, "")
    out = {}
    for label, cfg, p in (("gemma3-1b", fast_cfg, params[0]),
                          ("phi4-mini-3.8b", phi4_cfg, params[1])):
        out[f"model axis {label} step"] = compare_teacher_forced(
            card, label, cfg, p, one)
    turns = [serve_meshed(card, params, f"model axis {label}, turn {i}",
                          mesh, one, traced=True, shard_params=True,
                          requests=SHARD_TURN_REQUESTS)
             for i, (label, mesh) in enumerate((
                 ("unsharded", None), ("1x2 on one card", [MODEL_MESH]),
                 ("1x2 on one card", [MODEL_MESH]), ("unsharded", None)))]
    base = turns[0]
    problems = []
    differ = [same_tier_differences(base["per_req"], x["per_req"])
              for x in turns[1:]]
    if any(differ):
        problems.append(f"same-tier streams differ: {differ}")
    tokens_per_s = [sum(x["summary"]["gen_len"] * (r["tier"] + 1)
                        for r in x["per_req"]) / x["summary"]["elapsed"]
                    for x in turns]
    emit(check="model axis 10a: both tiers on 1x2 over one card "
               "(--shard-params) against unsharded, in turns (unsharded, "
               "sharded, sharded, unsharded)", card=card,
         tokens_per_s=tokens_per_s,
         sharded_over_unsharded=[tokens_per_s[1] / tokens_per_s[0],
                                 tokens_per_s[2] / tokens_per_s[3]],
         tick_p50_s=[x["summary"]["tick_duration_p50"] for x in turns],
         host_ms=[x["host_ms"] for x in turns],
         peak_bytes=[x["peak"][0] for x in turns],
         host_syncs=[x["summary"]["host_syncs"] for x in turns],
         active_ticks=[x["summary"]["active_ticks"] for x in turns],
         launches=[x["counts"] for x in turns],
         same_tier_differing_rids=differ, problems=problems)
    if problems:
        raise AssertionError("model axis 10a: " + "; ".join(problems))
    out.update({f"model axis {label}": x["counts"] for label, x in (
        ("unsharded", turns[0]), ("1x2", turns[1]), ("1x2 again", turns[2]),
        ("unsharded again", turns[3]))})
    del turns, base
    moon_cfg = dataclasses.replace(get_config(MOONSHOT_NAME, ""),
                                   num_periods=8)
    torch.cuda.empty_cache()
    moon = init_params(moon_cfg, 1, torch.float32, one[0])
    out["model axis moonshot 1 + 8 step"] = compare_teacher_forced(
        card, "moonshot-v1-16b-a3b 1 + 8 layers", moon_cfg, moon, one)
    del moon
    torch.cuda.empty_cache()
    out.update(check_model_axis_cards(card, params))
    emit(phase="model axis", phase_s=time.perf_counter() - t0)
    return out


def check_model_axis_cards(card: str, params) -> dict:
    """Phase 10b: moonshot-v1-16b-a3b at its 48 layers (110 GB in f32),
    drawn a model shard a card (:func:`draw_model_shard`) on a ``1x2``
    mesh over two cards, behind phase 4's gemma3-1b on a card of its own
    where there are three (else beside shard 0), serving the workload
    with exact launches; with one card, one line saying it did not run.
    Returns the run's launch counts."""
    cards = card_devices()
    out = {}
    fast_cfg = get_config("gemma3-1b", "")
    if len(cards) < 2:
        emit(check="model axis 10b", ran=False, card=card,
             reason=f"torch.cuda.device_count() is {len(cards)}: "
                    "moonshot-v1-16b-a3b at 48 layers (110 GB in f32) needs "
                    "its two model shards on two cards")
    else:
        moon_cfg = get_config(MOONSHOT_NAME, "")
        devs = cards[1:3] if len(cards) >= 3 else cards[:2]
        shards = [draw_model_shard(moon_cfg, 1, devs, j)
                  for j in range(len(devs))]
        run = serve_meshed(
            card, (params[0], shards), "model axis 10b: moonshot 48 layers "
            f"on 1x2 over {[str(d) for d in devs]}", ["1", MODEL_MESH],
            cards[:1] + devs if len(cards) >= 3 else cards[:2],
            expensive=MOONSHOT_NAME, cfgs=(fast_cfg, moon_cfg),
            shard_params=True)
        emit(check="model axis 10b", ran=True, card=card,
             devices=len(cards), peak_bytes_by_card=run["peak"],
             tier_meshes=run["summary"]["tier_meshes"])
        out["model axis moonshot 48 layers"] = run["counts"]
        del shards, run
        torch.cuda.empty_cache()
    return out


# phase 11: the data axis -- data-sharded tiers under uniform prefill,
# the dense arena and speculation, and on MoE and RWKV-6 tiers
DATA_MESH = "2x1"
DATA_REQUESTS = 8
# speculation's gen_len in phases 11b and 12b (16 until phase 12 joined)
DATA_SPEC_GEN_LEN = 8


class PrefillTap:
    """While open, records each uniform prefill launch's data shards that
    hold an admitted row, by tier name (warmup included): the shards
    that launch (a class-level patch of ``_TierRuntime.run_prefill``,
    restored on exit)."""

    def __enter__(self):
        self.shards = {}
        self.orig = run = _TierRuntime.run_prefill
        seen = self.shards

        def recorded(rt, slot_ids, prompts):
            span = rt.rows[0].stop
            seen.setdefault(rt.spec.name, []).append(
                len({s // span for s in slot_ids}))
            return run(rt, slot_ids, prompts)
        _TierRuntime.run_prefill = recorded
        return self

    def __exit__(self, *exc):
        _TierRuntime.run_prefill = self.orig


def data_axis_launches(cfgs, shards, kinds, warm, prefills, steps,
                       paged=True, models=None) -> dict:
    """Launches a run over data-sharded tiers must count (the engine's
    docstring formula): a tier of D shards launches each attention
    kernel and the gate D times a tier launch; a uniform prefill's
    ``flash_attention``, scans and gate once per shard holding an
    admitted row (``prefills[t]``, warmup included); each draft-loop step
    of a shard (``steps``, summed over shards) one ``paged_attention`` a
    layer and one gate; ``moe_route`` once per MoE layer a tier launch,
    however many shards.  ``warm`` adds the warmup's other launches.  A
    model axis of ``models[t]`` multiplies every kernel but the gate by
    it (each model shard launches its share; the gate runs once on the
    gathered logits)."""
    out = dict.fromkeys(COUNTED, 0)
    for t, cfg in enumerate(cfgs):
        n, d = layer_counts(cfg), shards[t]
        m = 1 if models is None else models[t]
        n = {k: v * m for k, v in n.items()}
        k = dict(kinds[t])
        for kind, w in warm[t].items():
            k[kind] = k.get(kind, 0) + w
        k.pop("prefill", None)
        ps, p = sum(prefills[t]), len(prefills[t])
        out["ragged_attention"] += n["attn"] * d * (k.get("ragged", 0)
                                                    + k.get("spec", 0))
        out["mixed_attention"] += n["attn"] * d * (k.get("mixed", 0)
                                                   + k.get("chunk", 0))
        out["paged_attention"] += n["attn"] * (d * k.get("step", 0) * paged
                                               + steps[t])
        out["flash_attention"] += n["attn"] * ps
        out["rwkv6_scan"] += n["rwkv6"] * ps
        out["mamba_scan"] += n["mamba"] * ps
        out["router_gate"] += n["moe"] * (sum(k.values()) + p)
        out["confidence_gate"] += d * sum(k.values()) + ps + steps[t]
    return out


def serve_data_axis(card: str, params, label: str, tier_mesh=None,
                    expensive=PHI4_NAME, cfgs=None, phase="data axis",
                    devices=None, **flags) -> dict:
    """Serve :data:`DATA_REQUESTS` requests of phase 4's workload on
    ``params`` (gemma3-1b -> ``expensive``; ``cfgs`` the tiers' configs
    where they are cut) under ``--tier-mesh`` over ``devices`` (default:
    the first card twice), every counter set to 0 just before and read
    just after.  Checks:
    launches exactly :func:`data_axis_launches` (with the tiers' model
    axes), every request DONE (conservation), blocks conserved in every
    pool and shard, confidences finite, host syncs at most one per
    active tier a tick plus one per uniform prefill.  Returns the counts,
    per-request records, summary and peak memory."""
    args = main_path_args(expensive, requests=DATA_REQUESTS,
                          tier_mesh=tier_mesh,
                          mesh_devices=devices or card_devices()[:1] * 2,
                          **flags)
    torch.cuda.reset_peak_memory_stats()
    for name in COUNTED:
        getattr(ops, name).launches = 0
    with EngineTap() as tap, PrefillTap() as pre:
        s = serve_async.run(args, None, params=params, cfgs=cfgs)
    torch.cuda.synchronize()
    counts = {name: getattr(ops, name).launches for name in COUNTED}
    peak = torch.cuda.max_memory_allocated()
    eng = tap.engine
    cfgs = serve_async.tier_configs(args, cfgs)
    shards = [rt.data_shards for rt in eng.runtimes]
    models = [rt.model_shards for rt in eng.runtimes]
    kinds = s["launches_by_kind"]
    warm = [{"spec" if s["speculation_k"] else "ragged": len(b)}
            if b is not None else
            {"mixed": 2} if s["unified_step"] else
            {"chunk": 1, "step": 1} if s["chunked_prefill"] else
            {"step": 1} for b in s["flat_buckets"]]
    steps = s["speculation"]["draft_steps_by_tier"]
    prefills = [pre.shards.get(rt.spec.name, []) for rt in eng.runtimes]
    want = data_axis_launches(cfgs, shards, kinds, warm, prefills, steps,
                              s["paged_kv"], models)
    problems = []
    if counts != want:
        problems.append(f"launches {counts} != {want}")
    per_req = s["per_request"]
    if s["completed"] != args.requests or not s["conservation"]["ok"] \
            or not all(len(r["tokens"]) == args.gen_len for r in per_req):
        problems.append(f"not every request DONE: {s['conservation']}")
    leaks = pool_leaks(eng) + (shard_conservation(eng) if s["paged_kv"]
                               else [])
    if leaks:
        problems.append(f"blocks not conserved: {leaks}")
    if not all(np.isfinite(r.token_conf).all() for r in eng.requests):
        problems.append("a token's confidence is not finite")
    npre = [len(x) for x in prefills]
    if any(h > a + p for h, a, p in zip(s["host_syncs"], s["active_ticks"],
                                        npre)):
        problems.append(f"host syncs {s['host_syncs']} over active ticks "
                        f"{s['active_ticks']} + prefills {npre}")
    if args.speculate and not steps[0]:
        problems.append("the draft tier ran no draft step")
    gen_tokens = sum(args.gen_len * (r["tier"] + 1) for r in per_req)
    emit(phase=phase, run=label, card=card,
         tier_meshes=s["tier_meshes"], data_shards=shards,
         model_shards=models,
         configs=[args.fast, args.expensive], requests=args.requests,
         gen_len=args.gen_len, steps=s["steps"],
         tier_launches=s["launches"], launches_by_kind=kinds,
         prefill_shards=prefills, draft_steps_by_tier=steps,
         kernel_launches_window=counts, active_ticks=s["active_ticks"],
         host_syncs=s["host_syncs"],
         escalation_rate=s["escalation_rates"],
         generated_tokens_per_s=gen_tokens / s["elapsed"],
         makespan_s=s["elapsed"], tick_p50_s=s["tick_duration_p50"],
         ttft_p50_s=s["ttft_p50"], max_memory_allocated_bytes=peak,
         kv_arena=[{k: m[k] for k in ("kv_arena_bytes", "data_shards")}
                   for m in s["kv_arena"]],
         speculation=s["speculation"] if args.speculate else None,
         stream_checksum=s["stream_checksum"], problems=problems)
    del tap, eng
    if problems:
        raise AssertionError(f"{phase} {label}: " + "; ".join(problems))
    return dict(counts=counts, per_req=per_req, summary=s, peak=peak)


# unsharded runs by (run name, expensive tier, its weights, flags): phase
# 12 holds its 1x2 runs against phase 11's unsharded ones where the
# workload and the weights are the same, instead of serving them again
_UNSHARDED = {}


def data_axis_turns(card, params, name, flags, expensive=PHI4_NAME,
                    order=("unsharded", DATA_MESH),
                    same_streams=True, cfgs=None,
                    phase="data axis") -> dict:
    """Runs of :func:`serve_data_axis` in ``order`` (unsharded, or both
    tiers on the mesh named, ``2x1`` or phase 12's ``1x2``), held to the
    first: same-tier streams equal (with ``same_streams``; a MoE tier
    whose capacity binds routes a sharded tier's batch in another order,
    so its streams are only recorded), and no run's peak memory more
    than half of gemma3-1b's weights above the lowest unsharded one (a
    second copy of either tier's weights would add 4-15 GB).  An
    unsharded run this call made before on the same weights and flags
    (``--shard-params`` changes nothing without a mesh) is taken from
    :data:`_UNSHARDED`, not served again, and its counts are not
    returned twice.  Emits the comparison; returns the counts of the
    runs served."""
    key = (name, expensive, id(params[1]), tuple(sorted(
        (k, repr(v)) for k, v in flags.items() if k != "shard_params")))
    runs, reused = [], set()
    for i, m in enumerate(order):
        if m == "unsharded" and key in _UNSHARDED:
            runs.append(_UNSHARDED[key])
            reused.add(i)
            continue
        runs.append(serve_data_axis(card, params, f"{name} {m}, turn {i}",
                                    None if m == "unsharded" else [m],
                                    expensive, cfgs, phase, **flags))
        if m == "unsharded":
            _UNSHARDED[key] = runs[-1]
    differ = [same_tier_differences(runs[0]["per_req"], x["per_req"])
              for x in runs[1:]]
    fast_bytes = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params[0]))
    low = min(x["peak"] for x, m in zip(runs, order) if m == "unsharded")
    grew = max(x["peak"] for x in runs) - low
    problems = []
    if same_streams and any(differ):
        problems.append(f"same-tier streams differ: {differ}")
    if grew > fast_bytes / 2:
        problems.append(f"peak memory grew {grew} bytes")
    tps = [sum(x["summary"]["gen_len"] * (r["tier"] + 1)
               for r in x["per_req"]) / x["summary"]["elapsed"]
           for x in runs]
    emit(check=f"{phase} {name}: {list(order)}", card=card,
         tokens_per_s=tps, tick_p50_s=[x["summary"]["tick_duration_p50"]
                                       for x in runs],
         same_streams_required=same_streams,
         peak_bytes=[x["peak"] for x in runs], peak_growth_bytes=grew,
         host_syncs=[x["summary"]["host_syncs"] for x in runs],
         unsharded_run_reused=bool(reused),
         same_tier_differing_rids=differ, problems=problems)
    if problems:
        raise AssertionError(f"{phase} {name}: " + "; ".join(problems))
    return {f"{phase} {name} {m} {i}": x["counts"]
            for i, (m, x) in enumerate(zip(order, runs)) if i not in reused}


def check_data_axis(card: str, params) -> dict:
    """Phase 11a-b, on phase 4's weights (alone:
    ``scripts/torch_data_axis_phase.py``): (11a) the uniform prefill path
    (8 prompts of exactly 640 tokens) unsharded and with both tiers on
    ``2x1`` over the first card twice, and the dense arena
    (``--dense-kv``) sharded and unsharded; (11b) speculation at k = 4,
    ``gen_len`` 8, on ``2x1`` against unsharded.  Each run's launches exact
    (:func:`data_axis_launches`), same-tier streams equal, peak memory
    without a second copy of the weights.  Returns the launch counts by
    run."""
    t0 = time.perf_counter()
    out = data_axis_turns(card, params, "uniform",
                          {"no_chunked_prefill": True})
    out.update(data_axis_turns(card, params, "dense", {"dense_kv": True},
                               order=(DATA_MESH, "unsharded")))
    out.update(data_axis_turns(
        card, params, "speculation k=4",
        {"speculate": SPEC_K, "spec_delta": 0.0,
         "gen_len": DATA_SPEC_GEN_LEN}))
    emit(phase="data axis 11a-b", phase_s=time.perf_counter() - t0)
    return out


DATA_TF_QLENS = [64, 40, 64, 17, 64, 64, 30, 64]


def moe_shard_logits(cfg, params, dev, sharded: bool):
    """A teacher-forced ragged step of ``cfg`` over rows of
    :data:`DATA_TF_QLENS` seeded tokens at positions 0.. on fresh pages
    of 16 tokens, on ``dev``: unsharded (one flat batch at the tier's
    bucket, the JAX layout) or on two data shards of 4 rows, each packed
    at its own width (``transformer.forward_data_shards``; ``sharded``
    "alone": each shard's own ``ragged_step``, routed over its own
    tokens).  Returns every row's last-position logits [8, V] on the CPU
    and the ``moe_route`` launches."""
    rng = np.random.default_rng(11)
    qlen = np.asarray(DATA_TF_QLENS, np.int32)
    toks = [rng.integers(0, cfg.vocab_size, n) for n in qlen]
    bs, P = TF_BLOCK, -(-max(qlen) // TF_BLOCK)

    def launch(rows, width):
        t = np.zeros((1, width), np.int32)
        pos = np.zeros((1, width), np.int32)
        o = 0
        for b in rows:
            t[0, o:o + qlen[b]] = toks[b]
            pos[0, o:o + qlen[b]] = np.arange(qlen[b])
            o += qlen[b]
        pt = np.arange(1, len(rows) * P + 1, dtype=np.int32).reshape(-1, P)
        pages = {"page_table": pt, "q_len": qlen[list(rows)],
                 "q_start": np.zeros(len(rows), np.int32)}
        return ({"tokens": torch.from_numpy(t).to(dev)},
                torch.from_numpy(pos).to(dev),
                {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                 for k, v in pages.items()},
                init_paged_cache(cfg, len(rows), len(rows) * P + 1, bs,
                                 torch.float32, dev), int(o))
    ops.router_gate.launches = 0
    halves = [range(0, 4), range(4, 8)]
    if not sharded:
        b, pos, pages, cache, _ = launch(range(8), 512)
        logits, _ = transformer.ragged_step(params, cfg, b["tokens"], cache,
                                            pos, pages)
        out = [logits]
    elif sharded == "alone":
        out = []
        for rows in halves:
            b, pos, pages, cache, _ = launch(rows, 256)
            out.append(transformer.ragged_step(params, cfg, b["tokens"],
                                               cache, pos, pages)[0])
    else:
        ins = [launch(rows, 256) for rows in halves]
        total = sum(i[4] for i in ins)
        slots, o = [], 0
        for i in ins:
            slots.append(np.concatenate([o + np.arange(i[4]),
                                         [512] * (256 - i[4])]))
            o += i[4]
        res = transformer.forward_data_shards(
            [params, params], cfg, [i[0] for i in ins],
            mode="ragged_step", caches=[i[3] for i in ins],
            pos=[i[1] for i in ins], pages=[i[2] for i in ins],
            groups=[None, None], layout=transformer.MoeLayout(slots, 512))
        assert total <= 512
        out = [transformer.last_slot_gather(lg, i[2]["q_len"], flat=True)
               for (lg, _), i in zip(res, ins)]
    torch.cuda.synchronize()
    return torch.cat([o.cpu() for o in out]), ops.router_gate.launches


def check_data_axis_moe(card: str, params) -> dict:
    """Phase 11c, on phase 5's gemma3-1b -> granite-moe-3b-a800m weights:
    granite at its published widths cut to 2 layers, teacher-forced
    (:func:`moe_shard_logits`) on two data shards on the card against the
    same on the CPU and against the unsharded step over the JAX layout
    (logits within 1e-4, one ``moe_route`` launch a MoE layer; routing
    each shard alone recorded beside it); then the granite cascade served
    unsharded and on ``2x1`` over the first card twice, launches exact
    (``moe_route`` once a MoE layer a tier launch), tokens/s of each (each
    shard's experts run over the capacity buffer of the routing groups
    its tokens fall in).  Returns the served runs' counts."""
    t0 = time.perf_counter()
    dev = card_devices()[0]
    cfg = dataclasses.replace(get_config(MOE_NAME, ""), num_periods=2)
    p_dev = init_params(cfg, 1, torch.float32, dev)
    p_cpu = tree_map(lambda t: t.cpu(), p_dev)
    base, n_base = moe_shard_logits(cfg, p_dev, dev, False)
    got, n_got = moe_shard_logits(cfg, p_dev, dev, True)
    cpu, _ = moe_shard_logits(cfg, p_cpu, torch.device("cpu"), True)
    alone, _ = moe_shard_logits(cfg, p_dev, dev, "alone")
    del p_dev, p_cpu
    torch.cuda.empty_cache()
    err_base = (got - base).abs().max().item()
    err_cpu = (got - cpu).abs().max().item()
    problems = []
    if err_base > TF_TOL or err_cpu > TF_TOL:
        problems.append(f"logits off by {err_base} (unsharded), {err_cpu} "
                        f"(CPU), past {TF_TOL}")
    n_moe = layer_counts(cfg)["moe"]
    if n_got != n_moe or n_base != n_moe:
        problems.append(f"moe_route launches {n_got} sharded, {n_base} "
                        f"unsharded (one a MoE layer: {n_moe})")
    emit(check="data axis 11c: granite-moe-3b-a800m 2 layers teacher-"
               "forced on two data shards", card=card,
         q_len=DATA_TF_QLENS, max_abs_err_vs_unsharded=err_base,
         max_abs_err_vs_cpu=err_cpu, tol=TF_TOL,
         argmax_equal=bool(torch.equal(got.argmax(-1), base.argmax(-1))),
         moe_route_launches=n_got,
         each_shard_alone_max_abs_err=(alone - base).abs().max().item(),
         problems=problems)
    if problems:
        raise AssertionError("data axis 11c: " + "; ".join(problems))
    out = data_axis_turns(card, params, "granite", {}, MOE_NAME,
                          same_streams=False)
    emit(phase="data axis 11c", phase_s=time.perf_counter() - t0)
    return out


def check_data_axis_rwkv(card: str, params) -> dict:
    """Phase 11d, on phase 5's gemma3-1b -> rwkv6-3b weights: the cascade
    (uniform by itself) on ``2x1`` over the first card twice against
    unsharded: launches exact (``rwkv6_scan`` once a layer a shard
    holding an admitted row), same-tier streams equal."""
    t0 = time.perf_counter()
    out = data_axis_turns(card, params, "rwkv6", {}, RWKV_NAME)
    emit(phase="data axis 11d", phase_s=time.perf_counter() - t0)
    return out


# phase 12: the model axis under every executor and tier family -- both
# tiers on 1x2 meshes over the one card, --shard-params, against
# unsharded
MODEL_EXEC = dict(shard_params=True)
MODEL_ORDER = ("unsharded", MODEL_MESH)
# a teacher-forced uniform prefill and one dense decode step: 8 rows of
# 640 tokens (qwen2-vl's 1152: its 1024 patch positions, then 128 text)
TF_PREFILL_ROWS, TF_PREFILL_TOL = 8, 5e-5


def prefill_teacher_forced(cfg, weights, devices, tokens: int, seed=0):
    """A uniform ``prefill`` of :data:`TF_PREFILL_ROWS` seeded prompts of
    ``tokens`` ids (a frontend model's ``frontend_embeds`` seeded too),
    its part cache written into a dense arena (``DenseTierSlotPool``),
    then one dense ``decode_step`` of a seeded token at position
    ``tokens``: unsharded (``weights`` a tree, ``devices`` one device) or
    over ``len(devices)`` model shards (``weights`` one tree a model
    shard; the arena one tree a model shard).  Returns the prefill's
    last-position logits and the decode step's, each [rows, V], on the
    first device."""
    m, dev, rows = len(devices), devices[0], TF_PREFILL_ROWS
    gen = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (rows, tokens),
                                     generator=gen, dtype=torch.int32)}
    if cfg.frontend:
        batch["frontend_embeds"] = torch.randn(
            rows, cfg.frontend_len, cfg.frontend_dim, generator=gen)
    nxt = torch.randint(0, cfg.vocab_size, (rows, 1), generator=gen,
                        dtype=torch.int32).to(dev)
    batch = {k: v.to(dev) for k, v in batch.items()}
    group = None if m == 1 else sharding.ModelShards(devices)
    pool = DenseTierSlotPool(cfg, rows, tokens + 1, device=dev,
                             mesh=None if m == 1
                             else make_tier_mesh(1, m, devices))
    with torch.no_grad():
        logits, part = transformer.prefill(weights, cfg, batch, group=group)
        pool.write_prefill(list(range(rows)), part)
        pos = torch.full((rows, 1), tokens, dtype=torch.int32, device=dev)
        step, _ = transformer.decode_step(weights, cfg, nxt, pool.caches[0],
                                          pos, group=group)
    return logits[:, 0], step[:, 0]


def compare_prefill_teacher_forced(card: str, label: str, cfg, params,
                                   devices, tokens: int) -> dict:
    """:func:`prefill_teacher_forced` over ``devices`` (model shards of
    ``params``, :func:`model_shard_weights`) against unsharded on
    ``devices[0]``, the counters set to 0 just before the sharded run
    and read after: both logits within :data:`TF_PREFILL_TOL` absolute,
    no argmax flip past that margin, and launches exactly M times the
    layers' (``flash_attention`` a prefill's attention layer, each scan
    a recurrent layer, ``moe_route`` a MoE layer in the prefill and the
    decode step; the dense decode attends in plain torch, and the caller
    gates).  Returns the sharded run's counts."""
    want = prefill_teacher_forced(cfg, params, devices[:1], tokens)
    shards = model_shard_weights(params, cfg, devices)
    for name in COUNTED:
        getattr(ops, name).launches = 0
    got = prefill_teacher_forced(cfg, shards, devices, tokens)
    torch.cuda.synchronize()
    counts = {name: getattr(ops, name).launches for name in COUNTED}
    m, n = len(devices), layer_counts(cfg)
    expect = dict.fromkeys(COUNTED, 0)
    expect.update(flash_attention=m * n["attn"], rwkv6_scan=m * n["rwkv6"],
                  mamba_scan=m * n["mamba"], router_gate=2 * m * n["moe"])
    errs, flips, problems = [], 0, []
    for g, w in zip(got, want):
        errs.append(float((g - w).abs().max()))
        top2 = w.topk(2, dim=-1).values
        sure = (top2[:, 0] - top2[:, 1]) > TF_PREFILL_TOL
        flips += int((g.argmax(-1) != w.argmax(-1))[sure].sum())
    if not max(errs) <= TF_PREFILL_TOL:
        problems.append(f"logits {errs} off unsharded (tolerance "
                        f"{TF_PREFILL_TOL})")
    if flips:
        problems.append(f"{flips} argmax flips past the margin")
    if counts != expect:
        problems.append(f"launches {counts} != {expect}")
    emit(check=f"model axis 12 teacher-forced {label}", card=card,
         model_shards=m, rows=TF_PREFILL_ROWS, tokens_per_row=tokens,
         max_abs_err_prefill=errs[0], max_abs_err_decode=errs[1],
         tolerance=TF_PREFILL_TOL, argmax_flips=flips, launches=counts,
         problems=problems)
    del shards
    if problems:
        raise AssertionError(f"model axis 12 {label}: " + "; ".join(problems))
    return counts


def check_model_axis_executors(card: str, params) -> dict:
    """Phase 12a-b, on phase 4's weights (alone:
    ``scripts/torch_model_axis_executors_phase.py``): the phi4 cascade
    with both tiers on ``1x2`` over the first card twice
    (``--shard-params``) against unsharded, in turns, under (12a) the
    uniform prefill (8 prompts of exactly 640 tokens) and the dense
    arena, and (12b) speculation at k = 4, ``gen_len`` 8.  Each run's
    launches exact (:func:`data_axis_launches` with M = 2: every kernel
    twice, the gate once), same-tier streams equal, blocks conserved,
    peak memory without a second copy of the weights.  Returns the
    launch counts by run."""
    t0 = time.perf_counter()
    out = data_axis_turns(card, params, "uniform",
                          {"no_chunked_prefill": True, **MODEL_EXEC},
                          order=MODEL_ORDER, phase="model axis")
    out.update(data_axis_turns(card, params, "dense",
                               {"dense_kv": True, **MODEL_EXEC},
                               order=MODEL_ORDER, phase="model axis"))
    out.update(data_axis_turns(
        card, params, "speculation k=4",
        {"speculate": SPEC_K, "spec_delta": 0.0,
         "gen_len": DATA_SPEC_GEN_LEN, **MODEL_EXEC}, order=MODEL_ORDER,
        phase="model axis"))
    emit(phase="model axis 12a-b", phase_s=time.perf_counter() - t0)
    return out


def check_model_axis_family(card: str, params, label: str, expensive,
                            cfgs, tf_label: str, tf_cfg, tf_params,
                            tokens: int, **flags) -> dict:
    """Phase 12c-e, on the weights of the cascade gemma3-1b ->
    ``expensive`` (its configs ``cfgs``, cut as phase 5 or 8 cuts them):
    the cascade, uniform by itself, with both tiers on ``1x2`` over the
    first card twice (``--shard-params``) against unsharded, in turns
    (launches exact: each scan, ``flash_attention`` and ``moe_route``
    twice, the gate once; same-tier streams equal; blocks conserved);
    then ``tf_cfg`` (``tf_label``: the tier cut to 2 layers, or the
    narrow jamba period) on ``tf_params`` teacher-forced on two model
    shards against
    unsharded (:func:`compare_prefill_teacher_forced`, prompts of
    ``tokens``).  Returns the counts by run."""
    t0 = time.perf_counter()
    out = data_axis_turns(card, params, label, {**MODEL_EXEC, **flags},
                          expensive, order=MODEL_ORDER, cfgs=cfgs,
                          phase="model axis")
    one = card_devices()[:1] * 2
    out[f"model axis {tf_label} step"] = compare_prefill_teacher_forced(
        card, tf_label, tf_cfg, tf_params, one, tokens)
    emit(phase=f"model axis 12 {label}", phase_s=time.perf_counter() - t0)
    return out


# phase 12b: qwen2-vl-72b at its 80 layers over four cards (290.9 GB in
# f32), gemma3-1b on a fifth; an 80 GB card, less a margin for the
# allocator and the CUDA context
QWEN_CARDS, CARD_BYTES = 4, 76e9


def qwen_fit(cfg, m: int, slots: int, prompt_len: int, gen_len: int) -> dict:
    """Bytes one of ``m`` model shards of ``cfg`` needs on its card with
    ``slots`` rows: its weights (:func:`draw_model_shard`'s shapes), its
    fully provisioned KV arena (its KV heads) and the uniform prefill's
    transient — ``slots × prompt_len`` tokens of a shard's swiglu hidden
    units (two products and their product, ``3·d_ff / m``) and six
    residual-wide f32 buffers (residual, norm, q/k/v and attention
    output), and the last position's logits."""
    specs = params_lib.param_specs(cfg, make_tier_mesh(
        1, m, [torch.device("meta")] * m))
    weights = 4 * sum(t.numel() for t in tree_leaves(
        sharding.model_shard_params(params_lib.param_shapes(
            cfg, torch.float32), cfg, specs, 0, m)))
    bs = 16
    blocks_n = slots * -(-(prompt_len + gen_len) // bs) + 1
    arena = sum(math.prod(c.shape) * 4 for c in tree_leaves(
        declare_paged_cache(sharding.shard_config(cfg, m), slots, blocks_n,
                            bs)))
    d_ff = cfg.period[0].ffn.d_ff
    tokens = slots * prompt_len
    transient = 4 * (tokens * (3 * d_ff // m + 6 * cfg.d_model)
                     + slots * cfg.vocab_size)
    return {"slots": slots, "weights": weights, "kv_arena": arena,
            "prefill_transient": transient,
            "total": weights + arena + transient}


def check_qwen_cards(card: str, fast_params) -> None:
    """Phase 12b, only where five cards or more are visible:
    qwen2-vl-72b at its 80 layers (290.9 GB in f32) drawn a model shard a
    card (:func:`draw_model_shard`) on a ``1x4`` mesh over cards 1-4 with
    ``--shard-params``, behind phase 4's gemma3-1b on card 0, serving the
    workload (1152-token prompts) with exact launches.  It first prints
    each card's fit (:func:`qwen_fit`: weights, KV arena, prefill
    transient) and halves the slots until it fits, never the widths or
    the depth.  With fewer cards, one line saying why it did not run."""
    cards = card_devices()
    if len(cards) < QWEN_CARDS + 1:
        emit(check="model axis 12b", ran=False, card=card,
             reason=f"torch.cuda.device_count() is {len(cards)}: "
                    "qwen2-vl-72b at 80 layers (290.9 GB in f32) needs its "
                    f"{QWEN_CARDS} model shards on {QWEN_CARDS} cards and "
                    "gemma3-1b on a fifth")
        return
    t0 = time.perf_counter()
    cfg = get_config(QWEN_NAME, "")
    args = main_path_args(QWEN_NAME)
    slots = args.slots
    fit = qwen_fit(cfg, QWEN_CARDS, slots, QWEN_PROMPT_LEN, args.gen_len)
    while fit["total"] > CARD_BYTES and slots > 1:
        slots //= 2
        fit = qwen_fit(cfg, QWEN_CARDS, slots, QWEN_PROMPT_LEN,
                       args.gen_len)
    emit(check="model axis 12b fit per card", card=card,
         card_bytes=CARD_BYTES, **fit)
    devs = cards[1:QWEN_CARDS + 1]
    shards = [draw_model_shard(cfg, args.seed + 1, devs, j)
              for j in range(QWEN_CARDS)]
    mesh = f"1x{QWEN_CARDS}"
    run = serve_data_axis(
        card, (fast_params, shards), f"qwen2-vl-72b 80 layers on {mesh}",
        ["1", mesh], QWEN_NAME, (get_config("gemma3-1b", ""), cfg),
        "model axis 12b", cards[:QWEN_CARDS + 1], shard_params=True,
        prompt_len=QWEN_PROMPT_LEN, slots=slots)
    emit(check="model axis 12b", ran=True, card=card, devices=len(cards),
         slots=slots, tier_meshes=run["summary"]["tier_meshes"],
         phase_s=time.perf_counter() - t0)
    del shards, run
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 13: sharded training
# --------------------------------------------------------------------------

# phase 7b's batches (4 x 256 tokens of bigram_lm over 4096 ids, the
# Batches order of launch.train.run), 2 steps, adafactor at lr 1e-3
SHARDED_TRAIN = dict(steps=2, batch=4, seq=256, vocab=4096, lr=1e-3)
SHARDED_MESHES = ((2, 1), (1, 2))
SHARDED_TOL = ("per step, up to the first step whose routing differs from "
               "unsharded's at a near-tie (reported; every step without "
               "MoE): losses rtol 1e-5 (l_casc also within two flipped "
               "argmax indicators, 2 / tokens), every parameter after the "
               "step atol 1e-5, every optimizer-state leaf (Adafactor's "
               "vr, vc and v, gathered) within 1e-4 of its largest "
               "magnitude (rwkv6-3b: 5e-5 and 5e-3), the step count "
               "equal")
# (param atol, state error relative to the leaf's largest magnitude);
# rwkv6-3b's gradients pass through the plain scan backward's 256 steps,
# which carry the shards' other rounding further (its smoke widths on the
# CPU: 1.06e-5 and 9.6e-4 after step 2)
SHARDED_PARAM_STATE_TOL = (1e-5, 1e-4)
SHARDED_DEEP_TOL = (5e-5, 5e-3)


def sharded_train_batches() -> list:
    """Phase 7b's first ``SHARDED_TRAIN["steps"]`` batches."""
    B, S = SHARDED_TRAIN["batch"], SHARDED_TRAIN["seq"]
    data = bigram_lm(num_seqs=max(B * 16, 256), seq_len=S,
                     vocab=SHARDED_TRAIN["vocab"], seed=0,
                     trigram_frac=0.3)
    it = iter(Batches({"tokens": data}, B, seed=0))
    return [torch.as_tensor(next(it)["tokens"])
            for _ in range(SHARDED_TRAIN["steps"])]


def tree_errors(got, want) -> dict:
    """``got`` against ``want`` (trees of one structure; ``want`` may
    lie on the host), leaf by leaf on ``got``'s device: the largest
    absolute error of the floating leaves (``abs``), the largest error
    of a leaf relative to that leaf's largest magnitude (``rel``), and
    whether the other leaves (a step count) are equal."""
    errs = {"abs": 0.0, "rel": 0.0, "equal": True}
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        b = b.to(a.device)
        if not a.is_floating_point():
            errs["equal"] &= bool(torch.equal(a, b))
            continue
        e = (a.float() - b.float()).abs().max().item()
        errs["abs"] = max(errs["abs"], e)
        errs["rel"] = max(errs["rel"],
                          e / max(b.float().abs().max().item(), 1e-30))
    return errs


def sharded_train_run(cfg, params, batches, dev, mesh=None, exp=None,
                      ref=None):
    """``SHARDED_TRAIN["steps"]`` steps of ``make_train_step`` (or of
    ``make_ltc_train_step`` against ``exp = (config, params)``, frozen)
    from ``params``, unsharded or built with ``mesh=`` on the params and
    optimizer state placed by their specs (``steps.place``).  After each
    step, outside its time and its peak: unsharded (``ref`` None), the
    params and optimizer state copied to the host; on a mesh, the
    gathered params' and state's :func:`tree_errors` against ``ref``'s
    host copies of that step.  Returns (per-step metrics, per-step ms,
    peak device bytes above the resident ones, the ``TRAIN_COUNTED``
    launches of the steps — the counters set to 0 just before and read
    just after —, the router calls, per-step host copies or errors)."""
    lr = SHARDED_TRAIN["lr"]
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    if exp is None:
        step, opt = steps.make_train_step(cfg, lr=lr, mesh=mesh)
        extra = ()
    else:
        step, opt = steps.make_ltc_train_step(cfg, exp[0], lr=lr, mesh=mesh)
        extra = (exp[1] if mesh is None else steps.place(
            exp[1], params_lib.param_specs(exp[0], mesh), mesh),)
    if mesh is None:
        p, s = params, opt.init(params)
    else:
        specs = params_lib.param_specs(cfg, mesh)
        ospecs = steps.opt_state_specs(opt.name, cfg, mesh)
        p = steps.place(params, specs, mesh)
        s = steps.place(opt.init(params), ospecs, mesh)
    metrics, ms, after, peak = [], [], [], base
    launched = dict.fromkeys(TRAIN_COUNTED, 0)
    with RouterTap() as tap:
        for i, b in enumerate(batches):
            torch.cuda.synchronize()
            train_launches()
            t0 = time.perf_counter()
            p, s, m = step(p, s, *extra, {"tokens": b.to(dev)})
            metrics.append({k: float(v) for k, v in m.items()})
            ms.append((time.perf_counter() - t0) * 1e3)
            for k, n in train_launches().items():
                launched[k] += n
            peak = max(peak, torch.cuda.max_memory_allocated())
            if ref is None:
                after.append(tuple(tree_map(lambda t: t.detach().cpu(), x)
                                   for x in (p, s)))
            else:
                after.append(tuple(tree_errors(
                    steps.gather(x, sp), want) for x, sp, want in zip(
                        (p, s), (specs, ospecs), ref[i])))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
    del p, s, extra
    return metrics, ms, peak - base, launched, tap.calls, after


def sharded_train_launches(cfg, mesh_shape) -> dict:
    """The ``TRAIN_COUNTED`` launches of ``SHARDED_TRAIN["steps"]``
    sharded steps (remat on): ``moe_route`` twice a MoE layer a step,
    once over the global batch whatever the mesh; each scan twice a
    recurrent layer a step on each of the ``D x M`` devices (a data
    shard's rows, a model shard's heads or channels)."""
    D, M = mesh_shape
    n = layer_counts(cfg)
    k = 2 * SHARDED_TRAIN["steps"]
    return {"router_gate": k * n["moe"], "rwkv6_scan": k * n["rwkv6"] * D * M,
            "mamba_scan": k * n["mamba"] * D * M}


def check_sharded_case(card: str, dev, label: str, cfg, params, exp=None,
                       meshes=SHARDED_MESHES, devices=None,
                       tol=SHARDED_PARAM_STATE_TOL) -> dict:
    """Phase 13's case ``label``: the steps unsharded, then on each of
    ``meshes`` (over ``devices``, default the one card repeated), from
    the same weights on the same batches.  Each step before the first
    whose routing differs from unsharded's (all of them without MoE) is
    compared with unsharded's: its losses, and the params and optimizer
    state after it (gathered), within :data:`SHARDED_TOL` (``tol``: the
    params' and the state's); a routing
    difference off a near-tie fails.  Also the launches (exact:
    :func:`sharded_train_launches`), step ms, training tokens/s (of the
    last step) and peak memory above the resident weights.  Returns
    each mesh run's launches by path."""
    batches = sharded_train_batches()
    if cfg.vocab_size < SHARDED_TRAIN["vocab"]:
        batches = [b % cfg.vocab_size for b in batches]
    tokens = SHARDED_TRAIN["batch"] * SHARDED_TRAIN["seq"]
    want, want_ms, want_peak, _, want_calls, ref = sharded_train_run(
        cfg, params, batches, dev, exp=exp)
    per_step = len(want_calls) // len(batches)
    counts = {}
    for shape in meshes:
        devs = devices or [dev] * (shape[0] * shape[1])
        mesh = make_tier_mesh(*shape, devs)
        name = "%dx%d" % shape
        got, ms, peak, launched, calls, errs = sharded_train_run(
            cfg, params, batches, dev, mesh, exp, ref)
        routing = first_routing_difference(want_calls, calls)
        compared = len(batches) if routing is None else routing[0] // per_step
        rel = [{k: abs(g[k] - w[k]) / max(abs(w[k]), 1e-30) for k in w}
               for g, w in zip(got, want)]
        problems = []
        if launched != sharded_train_launches(cfg, shape):
            problems.append(f"launches {launched} != "
                            f"{sharded_train_launches(cfg, shape)}")
        if not np.isfinite([v for m in got for v in m.values()]).all():
            problems.append("a loss is not finite")
        if routing is not None and not routing[2]:
            problems.append(f"routing differs off a near-tie: {routing}")
        for i in range(compared):
            for k, e in rel[i].items():
                flips = (k == "l_casc" and abs(got[i][k] - want[i][k])
                         <= 2 / (tokens - SHARDED_TRAIN["batch"]))
                if e > 1e-5 and not flips:
                    problems.append(f"step {i + 1} {k} rel err {e}")
            pe, se = errs[i]
            if pe["abs"] > tol[0]:
                problems.append(f"step {i + 1} param err {pe['abs']}")
            if se["rel"] > tol[1] or not se["equal"]:
                problems.append(f"step {i + 1} optimizer state {se}")
        rec = dict(check="sharded training", card=card, model=label,
                   mesh=name, devices=[str(d) for d in devs],
                   step="make_ltc_train_step" if exp else "make_train_step",
                   expensive=exp and exp[0].name, optimizer="adafactor",
                   remat=True, **SHARDED_TRAIN,
                   metrics=got, unsharded_metrics=want, rel_err=rel,
                   param_err=[e[0]["abs"] for e in errs],
                   state_err=[e[1] for e in errs],
                   max_param_err=max(e[0]["abs"] for e in errs),
                   steps_compared=compared, routing=routing, tol=SHARDED_TOL,
                   launches=launched, step_ms=ms, unsharded_step_ms=want_ms,
                   train_tokens_per_s=tokens / (ms[-1] / 1e3),
                   unsharded_train_tokens_per_s=tokens / (want_ms[-1] / 1e3),
                   peak_bytes_above_resident=peak,
                   unsharded_peak_bytes_above_resident=want_peak,
                   problems=problems)
        emit(**rec)
        if problems:
            raise AssertionError(f"sharded training {label} {name}: "
                                 f"{problems}")
        counts[f"sharded train {label} {name}"] = {
            **dict.fromkeys(COUNTED, 0), **launched}
    del ref
    torch.cuda.empty_cache()
    return counts


def check_sharded_training(card: str, dev, exp_params) -> dict:
    """Phase 13, sharded training on meshes over one card (the train and
    LtC steps built with ``mesh=``; :func:`check_sharded_case` each):
    (a) LtC of the published gemma3-1b against the frozen phi4-mini-3.8b
    (``exp_params``: phase 4's weights) on ``2x1`` and ``1x2``, and on
    ``2x1`` over two cards where two are visible; (b) granite-moe-3b-a800m
    at its published widths (40 experts, top-8; cut to 2 layers)
    next-token training on ``2x1`` and ``1x2``, each MoE layer routed
    once a forward over the global batch, ``moe_route`` on [1, 1024,
    40]; (c) rwkv6-3b at its published widths cut to 2 layers on
    ``1x2`` (20 heads a model shard).  Returns the mesh runs' launches
    by path."""
    t0 = time.perf_counter()
    gemma = get_config("gemma3-1b", "")
    fast = init_params(gemma, 0, torch.float32, dev)
    exp = (get_config(PHI4_NAME, ""), exp_params)
    counts = check_sharded_case(card, dev, "gemma3-1b LtC", gemma, fast, exp)
    cards = card_devices()
    if len(cards) >= 2:
        counts.update(check_sharded_case(
            card, dev, "gemma3-1b LtC two cards", gemma, fast, exp,
            meshes=((2, 1),), devices=cards[:2]))
    else:
        emit(check="sharded training", card=card,
             model="gemma3-1b LtC two cards", ran=False,
             reason=f"{len(cards)} card visible")
    del fast
    granite = dataclasses.replace(get_config(MOE_NAME, ""), num_periods=2)
    counts.update(check_sharded_case(
        card, dev, "granite-moe-3b-a800m 2 layers", granite,
        init_params(granite, 2, torch.float32, dev)))
    rwkv = dataclasses.replace(get_config(RWKV_NAME, ""), num_periods=2)
    counts.update(check_sharded_case(
        card, dev, "rwkv6-3b 2 layers", rwkv,
        init_params(rwkv, 3, torch.float32, dev), meshes=((1, 2),),
        tol=SHARDED_DEEP_TOL))
    torch.cuda.empty_cache()
    emit(phase="sharded training summary", card=card,
         wall_s=time.perf_counter() - t0)
    return counts


# --------------------------------------------------------------------------
# phase 14: the dry-run's accounting against the card
# --------------------------------------------------------------------------

# the dry-run's step kinds at card sizes, registered here (not in the
# package) as tests/test_dryrun_small.py registers its tiny shape: phase
# 4's 8 prompts of 640 tokens, a decode over a 640-token dense cache, and
# phase 7b's train batches (4 x 256 tokens)
DRYRUN_SHAPES = (shapes_lib.InputShape("card_prefill", 640, 8, "prefill"),
                 shapes_lib.InputShape("card_decode", 640, 8, "decode"),
                 shapes_lib.InputShape("card_train", 256, 4, "train"))
# (case, model label, shape, meshes)
DRYRUN_CASES = (("14a", PHI4_NAME, "card_prefill", ((1, 1), (1, 2))),
                ("14b", PHI4_NAME, "card_decode", ((1, 1), (2, 1))),
                ("14c", "granite-moe-3b-a800m 2 layers", "card_train",
                 ((2, 1),)))
# the largest share of the step the roofline may claim: above it the
# count or a rate is wrong
DRYRUN_SHARE_MAX = 1.05


def dryrun_inputs(cfg, shape_name: str, dev) -> dict:
    """A step's global inputs on the card: prompt tokens (phase 7b's
    batch to train), or a decode's token, its position in the cache's
    second half and a random dense cache."""
    s = shapes_lib.SHAPES[shape_name]
    gen = torch.Generator(device=dev)
    gen.manual_seed(14)
    out = {}
    for k, (shp, dt) in shapes_lib.global_inputs(cfg, shape_name,
                                                 torch.float32).items():
        if k == "tokens" and s.kind == "train":
            out[k] = (sharded_train_batches()[0]
                      % cfg.vocab_size).to(dev, torch.int32)
        elif k in ("tokens", "token"):
            out[k] = torch.randint(0, cfg.vocab_size, shp, generator=gen,
                                   device=dev, dtype=dt)
        elif k == "pos":
            out[k] = torch.randint(s.seq_len // 2, s.seq_len, shp,
                                   generator=gen, device=dev, dtype=dt)
        else:
            out[k] = torch.randn(shp, generator=gen, device=dev)
    if s.kind == "decode":
        out["cache"] = tree_map(lambda c: torch.randn(
            c.shape, generator=gen, device=dev).to(c.dtype),
            declare_cache(cfg, s.global_batch, s.seq_len))
    return out


def device00_bytes(cfg, args, inputs, mesh) -> int:
    """Device ``(0, 0)``'s bytes of a step's arguments on the card: its
    placed params, optimizer state and cache, and its rows of the batch
    (``shard_batch``; the whole batch where the data shards do not divide
    it, as each runs all of it; an attention-free model's ``pos`` never
    read)."""
    grids = [a for a in args if isinstance(a, list)]
    batch = {k: v for k, v in inputs.items()
             if k != "cache" and not (k == "pos" and cfg.attn_free)}
    rows = next(iter(batch.values())).shape[0]
    own = (shard_batch(batch, mesh)[0]
           if rows % sharding.data_axis_size(mesh) == 0 else batch)
    return sum(t.numel() * t.element_size() for t in tree_leaves(
        [g[0][0] for g in grids] + [own]))


def check_dryrun_case(card: str, dev, case: str, label: str, cfg, params,
                      shape_name: str, mesh_shape) -> dict:
    """One phase-14 case: ``dryrun.trace_cfg`` of the step on a mesh of
    ``meta`` devices, then the same step on a mesh of ``mesh_shape``
    over ``dev`` (``params`` placed by their specs, :func:`dryrun_inputs`)
    once under the same counting mode after a warm-up, its kernel
    counters set to 0 just before and read just after, and timed.  The
    counts (FLOPs by rate, bytes, kernel calls and their work,
    collectives) must be equal, the launches equal the traced kernel
    calls, the argument bytes per device equal device ``(0, 0)``'s on
    the card, and the roofline's share of the step at most
    :data:`DRYRUN_SHARE_MAX`: the mesh's total work on the one card
    (every device's compute and memory terms; its collectives are
    copies on that card) over the step's median of 3 CUDA-event times.
    The peak estimate stands beside ``max_memory_allocated`` above the
    resident arguments (not gated).  Returns the card run's launches."""
    d, m = mesh_shape
    n = d * m
    t0 = time.perf_counter()
    meta = dryrun.trace_cfg(cfg, shape_name,
                            make_tier_mesh(d, m, ["meta"] * n),
                            dtype=torch.float32)
    trace_s = time.perf_counter() - t0
    mesh = make_tier_mesh(d, m, [dev] * n)
    inputs = dryrun_inputs(cfg, shape_name, dev)
    step, args = dryrun.step_call(cfg, shape_name, mesh, params, inputs)
    arg_bytes = device00_bytes(cfg, args, inputs, mesh)
    step(*args)                                 # warm-up
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for name in COUNTED:
        getattr(ops, name).launches = 0
    on_card = dryrun.run_counted(step, args, n, arg_bytes)
    torch.cuda.synchronize()
    launches = {name: getattr(ops, name).launches for name in COUNTED}
    peak = torch.cuda.max_memory_allocated() - base
    times = []
    for _ in range(3):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        step(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    step_ms = float(np.median(times))
    rl = dryrun.record(label, shape_name, "%dx%d" % mesh_shape, cfg, meta)
    card_bound_ms = n * max(rl.t_compute, rl.t_memory) * 1e3
    share = card_bound_ms / step_ms
    counts = {k: dryrun_counts(t.count) for k, t in (("meta", meta),
                                                     ("card", on_card))}
    calls = {k: v["calls"] for k, v in meta.count.kernels.items()}
    problems = []
    if counts["meta"] != counts["card"]:
        problems.append("meta and card counts differ: "
                        f"{dryrun_count_diff(*counts.values())}")
    if {k: v for k, v in launches.items() if v} != calls:
        problems.append(f"launches {launches} != traced calls {calls}")
    if arg_bytes != meta.argument_bytes:
        problems.append(f"argument bytes {meta.argument_bytes} != device "
                        f"(0, 0)'s {arg_bytes}")
    if share > DRYRUN_SHARE_MAX:
        problems.append(f"roofline share {share} > {DRYRUN_SHARE_MAX}")
    emit(check="dry-run accounting", card=card, case=case, model=label,
         shape=dataclasses.asdict(shapes_lib.SHAPES[shape_name]),
         mesh="%dx%d" % mesh_shape, devices=[str(dev)] * n, dtype="f32",
         flops=counts["meta"]["flops"], bytes=counts["meta"]["bytes"],
         kernel_calls=calls, collectives=dryrun_collectives(meta.count),
         counts_equal=counts["meta"] == counts["card"], launches=launches,
         argument_bytes=meta.argument_bytes,
         card_argument_bytes=arg_bytes, step_ms=step_ms, step_ms_runs=times,
         roofline=dataclasses.asdict(rl), card_bound_ms=card_bound_ms,
         roofline_share=share,
         peak_estimate_bytes_above_arguments=meta.count.peak_live_bytes,
         max_memory_allocated_above_arguments=peak,
         peak_estimate_error=(meta.count.peak_live_bytes - peak)
         / max(peak, 1), trace_s=trace_s, card_counted_s=on_card.seconds,
         problems=problems)
    if problems:
        raise AssertionError(f"dry-run {case} {label} "
                             f"{'%dx%d' % mesh_shape}: {problems}")
    return launches


def dryrun_counts(c) -> dict:
    """What must be equal between a meta trace and a card run."""
    return {"flops": dict(c.flops), "bytes": c.bytes,
            "kernels": {k: dict(v) for k, v in c.kernels.items()},
            "collectives": dryrun_collectives(c)}


def dryrun_collectives(c) -> dict:
    """A count's collectives: events and bytes by op kind."""
    out = {}
    for op, nbytes, parts in c.collectives:
        e = out.setdefault(op, {"events": 0, "bytes": 0, "deliveries": 0})
        e["events"] += 1
        e["bytes"] += nbytes
        e["deliveries"] += parts
    return out


def dryrun_count_diff(a: dict, b: dict) -> dict:
    return {k: (a[k], b[k]) for k in a if a[k] != b[k]}


def check_dryrun(card: str, dev, phi4_params) -> dict:
    """Phase 14, the dry-run's accounting against the card (f32, TF32
    off; :func:`check_dryrun_case` each): (14a) phi4-mini-3.8b's prefill
    of 8 x 640 tokens on ``1x1`` and ``1x2`` (``flash_attention`` at [8,
    24, 640, 128] and [8, 12, 640, 128] a shard), (14b) its decode over a
    640-token dense cache on ``1x1`` and ``2x1`` (``phi4_params``: phase
    4's weights), (14c) granite-moe-3b-a800m at its published widths cut
    to 2 layers, a train step of 4 x 256 tokens on ``2x1`` (Adafactor,
    ``moe_route`` [1, 1024, 40]).  Returns the launches by path."""
    t0 = time.perf_counter()
    for shp in DRYRUN_SHAPES:
        shapes_lib.SHAPES[shp.name] = shp
    phi4 = get_config(PHI4_NAME, "")
    granite = dataclasses.replace(get_config(MOE_NAME, ""), num_periods=2)
    models = {PHI4_NAME: (phi4, phi4_params)}
    counts = {}
    for case, label, shape_name, meshes in DRYRUN_CASES:
        if label not in models:
            models = {label: (granite, init_params(granite, 2, torch.float32,
                                                   dev))}
        cfg, params = models[label]
        for shape in meshes:
            counts[f"dry-run {case} %dx%d" % shape] = check_dryrun_case(
                card, dev, case, label, cfg, params, shape_name, shape)
    del models
    torch.cuda.empty_cache()
    emit(phase="dry-run summary", card=card, wall_s=time.perf_counter() - t0)
    return counts


# --------------------------------------------------------------------------
# phase 15: the sequence-split decode
# --------------------------------------------------------------------------

# phase 15's decode positions: 4 steps at the end of the cache (the
# local layers see only the last key shard, the global ones all), then 2
# in an early shard (every later shard fully masked on every layer)
SEQ_POSITIONS = (524280, 524281, 524282, 524283, 200000, 200001)
# (mesh, seq_over_model) of phase 15's split runs over the card
SEQ_MESHES = (((2, 1), False), ((1, 2), True), ((2, 2), True))
# logits against unsharded: phase 12's teacher-forced bound
SEQ_TOL = 5e-5


def seq_cache(cfg, dev, seed: int = 15) -> dict:
    """Phase 15's dense cache on the card: one row of ``long_500k``'s
    524288 positions, every leaf a standard normal draw from a seeded
    generator (the same cache for each run)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    return tree_map(lambda c: torch.randn(c.shape, generator=gen,
                                          device=dev),
                    declare_cache(cfg, 1, shapes_lib.SHAPES["long_500k"]
                                  .seq_len))


def attn_leaves(cfg, tree) -> list:
    """``(name, [layers, 1, T, KV, hd] view)`` of each attention k/v leaf
    of a dense cache, a period's stack flattened into its layers."""
    out = []
    for section, sub in declare_cache(cfg, 1, 1).items():
        for key in sub:
            for name in ("k", "v"):
                t = tree[section][key]["mixer"][name]
                out.append((f"{section}/{key}/{name}",
                            t if section == "period" else t[None]))
    return out


def seq_checksums(cfg, tree, skip) -> dict:
    """Each attention leaf's int64 sum of its f32 bit patterns, the rows
    at the local positions ``skip`` left out: equal before and after a
    step that writes only there."""
    out = {}
    for name, t in attn_leaves(cfg, tree):
        bits = t.view(torch.int32)
        total = bits.sum(dtype=torch.int64)
        for p in skip:
            total = total - bits[:, :, p].sum(dtype=torch.int64)
        out[name] = int(total)
    return out


def seq_run(cfg, params, dev, mesh_shape=None, seq_over_model=False):
    """One phase-15 run over :func:`seq_cache`: the unsharded
    ``make_serve_step`` (``mesh_shape`` None) or the split one on a mesh
    of ``mesh_shape`` over the card (params and cache placed by their
    specs: views), through :data:`SEQ_POSITIONS`.  Returns each step's
    logits and ``conf`` on the host, every written row, each device's
    checksums before and after (owner rows left out), the step ms by
    CUDA events and the peak memory above the resident arguments."""
    T = shapes_lib.SHAPES["long_500k"].seq_len
    cache = seq_cache(cfg, dev)
    if mesh_shape is None:
        step = steps.make_serve_step(cfg)
        args, grid, offsets = params, [[cache]], [[0]]
    else:
        d, m = mesh_shape
        mesh = make_tier_mesh(d, m, [dev] * (d * m))
        args = steps.place(params, params_lib.param_specs(cfg, mesh), mesh)
        specs = cache_specs(cfg, 1, T, mesh, shard_seq=1 % d != 0,
                            seq_over_model=seq_over_model)
        grid = steps.place(cache, specs, mesh)
        step = steps.make_serve_step(cfg, mesh=mesh,
                                     seq_over_model=seq_over_model,
                                     seq_len=T)
        # each device's first key: its view's offset into the cache
        first = attn_leaves(cfg, cache)[0][1]
        offsets = [[(attn_leaves(cfg, t)[0][1].storage_offset()
                     - first.storage_offset()) // first.stride(2)
                    for t in row] for row in grid]
    L = attn_leaves(cfg, grid[0][0])[0][1].shape[2]

    def local(e, j):
        return [p - offsets[e][j] for p in SEQ_POSITIONS
                if 0 <= p - offsets[e][j] < L]
    before = [[seq_checksums(cfg, t, local(e, j)) for j, t in enumerate(row)]
              for e, row in enumerate(grid)]
    gen = torch.Generator().manual_seed(15)
    tokens = torch.randint(0, cfg.vocab_size, (len(SEQ_POSITIONS),),
                           generator=gen, dtype=torch.int32)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    logits, confs, times = [], [], []
    for i, p in enumerate(SEQ_POSITIONS):
        tok = torch.full((1, 1), int(tokens[i]), dtype=torch.int32,
                         device=dev)
        pos = torch.full((1, 1), p, dtype=torch.int32, device=dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        lg, conf, _ = step(args, tok, pos, grid if mesh_shape else cache)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        logits.append(lg[0, 0].float().cpu())
        confs.append(float(conf[0, 0]))
    peak = torch.cuda.max_memory_allocated() - base
    after = [[seq_checksums(cfg, t, local(e, j)) for j, t in enumerate(row)]
             for e, row in enumerate(grid)]
    # every written row through its owner's view (all views of one cache
    # on the card)
    rows = {}
    for e, row in enumerate(grid):
        for j, t in enumerate(row):
            for p in local(e, j):
                for name, leaf in attn_leaves(cfg, t):
                    rows[name, p + offsets[e][j]] = leaf[:, 0, p].cpu()
    del cache, grid
    torch.cuda.empty_cache()
    return {"logits": logits, "conf": confs, "rows": rows,
            "unchanged": before == after, "step_ms": times,
            "peak_bytes": peak}


def check_seq_split(card: str, dev, params, meshes=SEQ_MESHES) -> dict:
    """Phase 15, the sequence-split decode (f32, TF32 off): gemma3-1b at
    its published widths (26 attention layers, 1 KV head of 256; 4 of 6
    layers windowed at 512) over a dense cache of ``long_500k``'s 524288
    positions, batch 1 (27.9 GB, :func:`seq_cache`): the unsharded step
    first (its logits, ``conf`` and written rows to the host, its cache
    freed), then the split step on each of ``meshes`` over the card, each
    on the same cache drawn again, through :data:`SEQ_POSITIONS`.  Each
    run's logits within :data:`SEQ_TOL` of unsharded, the argmax equal
    wherever the unsharded top-1/top-2 margin exceeds the error, the
    written K/V rows on their owner within it, every device's other rows
    bit for bit unchanged (checksums); the median step ms and the peak
    memory above the arguments.  Then ``dryrun.trace_cfg`` of
    ``long_500k`` on ``2x1`` against the card (:func:`check_dryrun_case`:
    counts equal, the merges among the collectives, roofline share at
    most :data:`DRYRUN_SHARE_MAX`).  Returns the dry-run case's
    launches."""
    t0 = time.perf_counter()
    cfg = get_config("gemma3-1b", "")
    torch.cuda.empty_cache()
    whole = seq_run(cfg, params, dev)
    emit(check="sequence split", card=card, mesh="1x1",
         positions=SEQ_POSITIONS, conf=whole["conf"],
         step_ms=float(np.median(whole["step_ms"])),
         step_ms_runs=whole["step_ms"], peak_bytes=whole["peak_bytes"])
    problems = []
    for shape, som in meshes:
        run = seq_run(cfg, params, dev, shape, som)
        errs = [float((a - b).abs().max())
                for a, b in zip(run["logits"], whole["logits"])]
        margins, argmax_ok = [], True
        for a, b, err in zip(run["logits"], whole["logits"], errs):
            top = torch.topk(b, 2).values
            margins.append(float(top[0] - top[1]))
            if margins[-1] > err and int(a.argmax()) != int(b.argmax()):
                argmax_ok = False
        row_err = max(float((run["rows"][k] - whole["rows"][k]).abs().max())
                      for k in whole["rows"])
        missing = sorted(set(whole["rows"]) ^ set(run["rows"]))
        conf_err = max(abs(a - b) for a, b in zip(run["conf"],
                                                  whole["conf"]))
        label = "%dx%d" % shape
        emit(check="sequence split", card=card, mesh=label,
             seq_over_model=som, positions=SEQ_POSITIONS,
             logits_max_abs_err=errs, tolerance=SEQ_TOL,
             conf_max_abs_err=conf_err, top2_margin=margins,
             argmax_equal_past_margin=argmax_ok,
             written_rows_max_abs_err=row_err, rows_missing=missing,
             other_rows_unchanged=run["unchanged"],
             step_ms=float(np.median(run["step_ms"])),
             step_ms_runs=run["step_ms"], peak_bytes=run["peak_bytes"])
        if max(errs) > SEQ_TOL or conf_err > SEQ_TOL or row_err > SEQ_TOL \
                or missing or not argmax_ok or not run["unchanged"]:
            problems.append(label)
    del whole
    torch.cuda.empty_cache()
    if problems:
        raise AssertionError(f"sequence split on {problems}")
    launches = check_dryrun_case(card, dev, "15", "gemma3-1b", cfg, params,
                                 "long_500k", (2, 1))
    torch.cuda.empty_cache()
    emit(phase="sequence split summary", card=card,
         meshes=["%dx%d" % s for s, _ in meshes],
         wall_s=time.perf_counter() - t0)
    return {"sequence split 15 2x1": launches}


def first_periods(params, n: int):
    """``params`` cut to its first ``n`` periods (views of the stacked
    leaves)."""
    return {**params, "period": tree_map(lambda a: a[:n], params["period"])}


def timed_cases(timed: dict) -> list:
    """Every timed case of one kernel, for the ``kernels`` line."""
    keys = ("ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
            "tc_bound_ms", "device_ms", "splits")
    return [dict(case=name, library_ms=t.get("library_ms"),
                 **{k: t[k] for k in keys if k in t})
            for name, t in timed.items()]


def kernel_entry(name, launches, err, tol, timed, key, shape):
    """One kernel's entry of the ``kernels`` line: its main-path launches,
    its worst error against the plain version, and the timed cases, the
    one named by ``key`` at the top level."""
    t = timed[key]
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": launches,
            "max_abs_err": err, "tolerance": tol, "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t.get("library_ms"),
            "device_ms": t.get("device_ms"),
            "shape": shape, "cases": timed_cases(timed)}


REPLACES = {
    "ragged_attention": "src/repro/kernels/ragged_attention.py:180",
    "confidence_gate": "src/repro/kernels/confidence_gate.py:83",
    "paged_attention": "src/repro/kernels/paged_attention.py:93",
    "mixed_attention": "src/repro/kernels/mixed_attention.py:118",
    "router_gate": "src/repro/kernels/router_gate.py:51",
    "flash_attention": "src/repro/kernels/flash_attention.py:75",
    "rwkv6_scan": "src/repro/kernels/rwkv6_scan.py:54",
    "mamba_scan": "src/repro/kernels/mamba_scan.py:51",
}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs an NVIDIA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    t0 = time.perf_counter()
    built = kernels.build(kernels.KERNELS)
    build_s = time.perf_counter() - t0
    emit(phase="environment", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         build_s=build_s, built=built,
         ptxas={n: ptxas_lines(n) for n in kernels.KERNELS})
    emit(phase="environment", card=card, ptxas_head_width_112={
        n: ptxas_lines(n, "Li112E") for n in (
            "ragged_attention", "paged_attention", "mixed_attention",
            "flash_attention")})

    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)   # > 50 MB L2
    r_err, r_time = check_ragged(dev, flush)
    g_err, g_time = check_gate(dev, flush)
    p_err, p_time = check_paged(dev, flush)
    m_err, m_time = check_mixed(dev, flush)
    q_err, q_time = check_router(dev, flush)
    f_err, f_time = check_flash(dev, flush)
    w_err, w_time = check_rwkv(dev, flush)
    s_err, s_time = check_mamba(dev, flush)
    del flush
    torch.cuda.empty_cache()
    check_ragged_step(dev)
    check_padded_steps(dev)
    check_uniform_steps(dev)
    # both tiers' f32 weights (19.4 GB) are drawn once and serve every
    # executor and the profiles
    params = serve_async.build_params(main_path_args())
    runs = {ex: serve(card, params, ex) for ex in EXECUTORS}
    compare_streams({ex: r for ex, (_, r, _) in runs.items()})
    # the speculation phase, on the same weights: gemma3 drafting for
    # phi4, and for itself
    spec_ctx = {}
    spec_runs = check_speculation(card, params, keep=spec_ctx)
    # the prefix-caching phase, on the same weights, then the overload
    # phase on its workload
    ctx = {}
    prefix_runs = check_prefix_cache(card, params, keep=ctx)
    overload_runs = check_overload(card, params, ctx)
    del ctx
    # the observability phase: tracer, profiler ranges and metrics
    # snapshots, then the flat-bucket override, under 4b's margin rule
    obs_runs = check_observability(card, params, spec_ctx["bounds"])
    # phase 9, multi-device serving, on the same weights: data shards on
    # one card (9a), tiers on distinct cards where there are two (9b)
    multi_runs = check_multidevice(card, params)
    # phase 10, the model axis, on the same weights: tensor-parallel
    # tiers on 1x2 meshes over one card (10a), moonshot at 48 layers
    # over two cards where there are two (10b)
    model_runs = check_model_axis(card, params)
    # phase 11a-b, the data axis, on the same weights: uniform prefill,
    # the dense arena and speculation on 2x1 meshes over one card
    data_runs = check_data_axis(card, params)
    # phase 12a-b, the model axis under the uniform prefill, the dense
    # arena and speculation: both tiers on 1x2 over one card
    model_exec_runs = check_model_axis_executors(card, params)
    uniform_runs = {ex: serve(card, params, ex) for ex in ("uniform",
                                                           "dense")}
    compare_streams({ex: r for ex, (_, r, _) in uniform_runs.items()})
    torch.cuda.empty_cache()
    for ex in list(EXECUTORS) + ["uniform"]:
        profile_ticks(card, params, ex)
    # the speculation phase's profiles: scripts/torch_speculation_profiles.py
    # phase 7, training, on the same weights (phi4-mini-3.8b the frozen
    # expensive model), the serving runs' KV pools freed
    torch.cuda.empty_cache()
    train_counts = check_training(card, dev, params)
    # phase 13, sharded training: LtC against the same phi4-mini-3.8b,
    # granite and rwkv6-3b cut to 2 layers, on 2x1 and 1x2 over one card
    sharded_counts = check_sharded_training(card, dev, params[1])
    # phase 14, the dry-run's accounting against the card: phi4's prefill
    # and decode on the same weights, granite cut to 2 layers training
    dryrun_runs = check_dryrun(card, dev, params[1])
    # phase 15, the sequence-split decode: phase 4's gemma3-1b over a
    # 524288-position dense cache, unsharded, then split on 2x1, 1x2 and
    # 2x2 over the card; the dry-run's count of 2x1 against the card
    check_seq_split(card, dev, params[0])
    # the MoE cascade: the same gemma3 weights, granite's (13.2 GB) drawn
    # from the expensive tier's seed in place of phi4's
    moe_args = main_path_args(MOE_NAME)
    params = (params[0], None)
    torch.cuda.empty_cache()
    params = (params[0], init_params(
        get_config(MOE_NAME, moe_args.variant), moe_args.seed + 1,
        torch.float32, dev))
    moe_runs = {ex: serve(card, params, ex, MOE_NAME) for ex in EXECUTORS}
    compare_streams({ex: r for ex, (_, r, _) in moe_runs.items()},
                    MOE_NAME)
    torch.cuda.empty_cache()
    # the MoE, RWKV-6 and jamba cascades' profiles:
    # scripts/torch_family_profiles.py
    check_split_moe_determinism(card, params)
    # phase 11c: the MoE tier on two data shards, routed over its batch
    data_runs.update(check_data_axis_moe(card, params))
    # the RWKV-6 cascade: rwkv6-3b's weights (12.3 GB) in place of
    # granite's; the engine serves it on the uniform prefill path
    params = (params[0], None)
    torch.cuda.empty_cache()
    params = (params[0], init_params(
        get_config(RWKV_NAME, moe_args.variant), moe_args.seed + 1,
        torch.float32, dev))
    rwkv_counts, _, _ = serve(card, params, "auto", RWKV_NAME)
    # phase 11d: the RWKV-6 tier on two data shards
    data_runs.update(check_data_axis_rwkv(card, params))
    # phase 12c: the RWKV-6 tier on two model shards, its first 2 layers
    # teacher-forced
    rwkv_cfg = get_config(RWKV_NAME, moe_args.variant)
    model_exec_runs.update(check_model_axis_family(
        card, params, "rwkv6", RWKV_NAME, None, "rwkv6-3b 2 layers",
        dataclasses.replace(rwkv_cfg, num_periods=2),
        first_periods(params[1], 2), moe_args.prompt_len))
    torch.cuda.empty_cache()
    # the hybrid cascade: jamba-v0.1-52b cut to 1 of its 4 periods (its 4
    # periods, 206 GB in f32, do not fit the card), 53.2 GB of weights in
    # place of rwkv6-3b's; the engine serves it on the uniform path
    jamba_cfgs = (get_config("gemma3-1b", moe_args.variant),
                  dataclasses.replace(get_config(JAMBA_NAME,
                                                 moe_args.variant),
                                      num_periods=1))
    params = (params[0], None)
    torch.cuda.empty_cache()
    params = (params[0], init_params(jamba_cfgs[1], moe_args.seed + 1,
                                     torch.float32, dev))
    jamba_runs = {ex: serve(card, params, ex, JAMBA_NAME, jamba_cfgs)
                  for ex in ("auto", "dense")}
    compare_streams({ex: r for ex, (_, r, _) in jamba_runs.items()},
                    JAMBA_NAME)
    torch.cuda.empty_cache()
    # phase 12d: the jamba tier on two model shards (Mamba channels,
    # experts, heads), the narrow 8-layer period teacher-forced
    narrow = narrow_jamba_period(get_config(JAMBA_NAME, "smoke"))
    model_exec_runs.update(check_model_axis_family(
        card, params, "jamba 1 period", JAMBA_NAME, jamba_cfgs,
        "jamba narrow period", narrow,
        init_params(narrow, moe_args.seed + 1, torch.float32, dev),
        moe_args.prompt_len))
    # phase 8, the rest of the registry: jamba's weights freed, gemma3-1b
    # beside one expensive tier at a time
    params = (params[0], None)
    torch.cuda.empty_cache()
    registry_runs = check_configs(card, dev, params[0])
    # phase 12e: qwen2-vl-72b cut to 8 layers (as phase 8 cuts it) on two
    # model shards, its first 2 layers teacher-forced
    qwen_cfgs = (get_config("gemma3-1b", moe_args.variant),
                 dataclasses.replace(get_config(QWEN_NAME, moe_args.variant),
                                     num_periods=8))
    params = (params[0], init_params(qwen_cfgs[1], moe_args.seed + 1,
                                     torch.float32, dev))
    model_exec_runs.update(check_model_axis_family(
        card, params, "qwen2-vl 8 layers", QWEN_NAME, qwen_cfgs,
        "qwen2-vl-72b 2 layers",
        dataclasses.replace(qwen_cfgs[1], num_periods=2),
        first_periods(params[1], 2), QWEN_PROMPT_LEN,
        prompt_len=QWEN_PROMPT_LEN))
    params = (params[0], None)
    torch.cuda.empty_cache()
    # phase 12b: qwen2-vl-72b at its 80 layers over four cards, where
    # five are visible
    check_qwen_cards(card, params[0])
    counts = {ex: c for ex, (c, _, _) in runs.items()}
    counts.update({ex: c for ex, (c, _, _) in uniform_runs.items()})
    counts.update(spec_runs)
    counts.update(prefix_runs)
    counts.update(overload_runs)
    counts.update(obs_runs)
    counts.update(multi_runs)
    counts.update(model_runs)
    counts.update(data_runs)
    counts.update(model_exec_runs)
    counts.update({f"moe {ex}": c for ex, (c, _, _) in moe_runs.items()})
    counts["rwkv"] = rwkv_counts
    counts.update(train_counts)
    counts.update(sharded_counts)
    counts.update(dryrun_runs)
    counts.update({f"jamba {ex}": c for ex, (c, _, _) in
                   jamba_runs.items()})
    counts.update(registry_runs)
    moe_paths = tuple(f"moe {ex}" for ex in EXECUTORS)
    jamba_paths = ("jamba auto", "jamba dense")
    spec_paths = tuple(spec_runs)
    prefix_ragged = tuple(p for p in prefix_runs if "ragged" in p
                          or "wall" in p)
    overload_ragged = tuple(p for p in overload_runs if "split" not in p)
    obs_paths = tuple(obs_runs)
    served = ("serve_cascade untrained", "serve_cascade trained")
    rwkv_served = tuple(f"rwkv6 {p}" for p in served)
    sharded_train = tuple(sharded_counts)
    trained_only = ("train steps", "recurrent train steps",
                    "LtC rwkv6") + sharded_train
    data_uniform = tuple(p for p in data_runs if "uniform" in p
                         or "rwkv6" in p)
    data_spec = tuple(p for p in data_runs if "speculation" in p)
    data_moe = tuple(p for p in data_runs if "granite" in p)
    # phase 12's served runs (unsharded and 1x2) and teacher-forced steps
    me_served = tuple(p for p in model_exec_runs if not p.endswith(" step"))
    me_spec = tuple(p for p in me_served if "speculation" in p)
    me_prefill = tuple(p for p in me_served if p not in me_spec)
    me_steps = tuple(p for p in model_exec_runs if p.endswith(" step"))
    for name, ex in (("ragged_attention", ("ragged", "moe ragged")
                      + spec_paths + prefix_ragged + overload_ragged
                      + obs_paths + tuple(multi_runs) + tuple(model_runs)
                      + data_spec + data_moe + served + me_spec
                      + ("starcoder2 ragged", "moonshot 1 + 8 layers "
                                              "ragged")),
                     ("mixed_attention", ("padded", "split", "moe padded",
                                          "moe split", "prefix padded on",
                                          "prefix split on",
                                          "overload split youngest",
                                          "starcoder2 padded",
                                          "starcoder2 split")),
                     ("paged_attention", ("split", "moe split",
                                          "prefix split on",
                                          "overload split youngest",
                                          "uniform", "rwkv", "jamba auto",
                                          "starcoder2 split",
                                          "musicgen auto",
                                          "qwen2-vl 8 layers auto")
                      + rwkv_served + data_uniform + data_spec
                      + tuple(p for p in spec_paths if "k=0" not in p)
                      + me_spec + tuple(p for p in me_prefill
                                        if "dense" not in p)),
                     ("flash_attention", ("uniform", "dense", "rwkv")
                      + jamba_paths + rwkv_served + data_uniform
                      + tuple(p for p in data_runs if "dense" in p)
                      + ("musicgen auto", "qwen2-vl 8 layers auto")
                      + me_prefill + tuple(p for p in me_steps
                                           if "rwkv6" not in p)
                      + tuple(p for p in dryrun_runs if "14a" in p)),
                     ("confidence_gate", tuple(
                         p for p in counts if p not in trained_only
                         and not p.endswith(" step")
                         and p not in dryrun_runs)),
                     ("router_gate", moe_paths + jamba_paths + data_moe
                      + tuple(p for p in model_exec_runs if "jamba" in p)
                      + ("train steps", "recurrent train steps",
                         "moonshot 1 + 8 layers ragged",
                         "model axis moonshot 1 + 8 step")
                      + tuple(p for p in sharded_train if "granite" in p)
                      + tuple(p for p in dryrun_runs if "14c" in p)),
                     ("rwkv6_scan", ("rwkv", "recurrent train steps",
                                     "LtC rwkv6") + rwkv_served
                      + tuple(p for p in sharded_train if "rwkv6" in p)
                      + tuple(p for p in data_runs if "rwkv6" in p)
                      + tuple(p for p in model_exec_runs if "rwkv6" in p)),
                     ("mamba_scan", jamba_paths
                      + ("recurrent train steps",)
                      + tuple(p for p in model_exec_runs if "jamba" in p))):
        if not all(counts[e][name] > 0 for e in ex):
            raise AssertionError(f"{name} was not launched on {ex}: "
                                 f"{counts}")

    by_path = {name: {ex: c[name] for ex, c in counts.items() if c[name]}
               for name in COUNTED}
    total = {name: sum(by_path[name].values()) for name in COUNTED}
    entries = [
        kernel_entry("ragged_attention", total["ragged_attention"],
                     r_err, TOL_TEXT, r_time, "phi4 full bucket f32",
                     "phi4-mini-3.8b: q [512, 8, 3, 128] f32, 8 rows x 64 "
                     "tokens, pools [329, 16, 8, 128]"),
        kernel_entry("confidence_gate", total["confidence_gate"],
                     max(g_err.values()),
                     "conf/logz rtol 1e-5, entropy atol 1e-4, argmax exact",
                     g_time, "gemma3-1b", "gemma3-1b: logits [8, 262144] f32"),
        kernel_entry("paged_attention", total["paged_attention"],
                     p_err, TOL_TEXT, p_time, "phi4 decode f32",
                     "phi4-mini-3.8b: q [8, 8, 3, 128] f32, positions "
                     "590-625, pools [329, 16, 8, 128]"),
        kernel_entry("mixed_attention", total["mixed_attention"], m_err,
                     TOL_TEXT, m_time, "phi4 full bucket [8, 64] f32",
                     "phi4-mini-3.8b: q [8, 64, 8, 3, 128] f32, pools "
                     "[329, 16, 8, 128]"),
        kernel_entry("router_gate", total["router_gate"], q_err,
                     f"{ROUTER_TOL}; moe_route: {ROUTE_TOL}", q_time,
                     "moe_route granite bucket [1, 512, 40]",
                     "granite-moe-3b-a800m: moe_route logits [1, 512, 40] "
                     "f32, k 8, cap 128 (the full ragged bucket)"),
        kernel_entry("flash_attention", total["flash_attention"], f_err,
                     TOL_TEXT, f_time, "phi4 q [8, 24, 640, 128] f32",
                     "phi4-mini-3.8b: q [8, 24, 640, 128], k/v "
                     "[8, 8, 640, 128] f32, causal"),
        kernel_entry("rwkv6_scan", total["rwkv6_scan"], w_err, RWKV_TOL,
                     w_time, "rwkv6-3b [8, 40, 640, 64] f32",
                     "rwkv6-3b: r/k/v/w [8, 40, 640, 64], u [40, 64] f32"),
        kernel_entry("mamba_scan", total["mamba_scan"], s_err, MAMBA_TOL,
                     s_time, "jamba-v0.1-52b [8, 640, 8192] n 16 f32",
                     "jamba-v0.1-52b: x/dt [8, 640, 8192], B_t/C_t "
                     "[8, 640, 16], A [8192, 16] f32"),
    ]
    for e in entries:
        e["launches_by_path"] = by_path[e["name"]]
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
