"""On-card smoke test of the torch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero
without printing a result):

  1. environment: card name and power limit (``nvidia-smi``), torch and
     CUDA versions, and the build of the eight CUDA kernels from
     ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it (gemma3-1b, phi4-mini-3.8b,
     granite-moe-3b-a800m, rwkv6-3b and jamba-v0.1-52b, whose Mamba
     layers run ``mamba_scan``), with CUDA-event times for the
     kernel and the plain version (for the gate and the router also back
     to back, :func:`device_ms`; for ``flash_attention`` also PyTorch's
     ``scaled_dot_product_attention`` as a yardstick; for the three
     tensor-core attention kernels, ``flash_attention``,
     ``ragged_attention`` and ``paged_attention``, their bound on the
     tensor cores beside the one on the CUDA cores; for the ragged and
     paged kernels also their device time from the profiler,
     :func:`kernel_ms`, since the host's launch takes longer than a
     decode kernel);
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
  6. the workload once more inside ``torch.profiler``, with a virtual
     clock, under each executor (the uniform one included), for the MoE
     cascade under the ragged one and for the RWKV-6 and jamba cascades:
     device time by kernel kind (a kind's split-merge kernels counted
     with it) and the device's idle share; and the split MoE cascade
     served twice under a virtual clock, to record whether its streams
     are equal run to run.

The lines before the last are JSON records of the findings (one of them
the ``{"kernels": [...]}`` summary) and the card's ``name, power.limit``
line; the last line is ``{"ok": true, "device": {...}}``.  The script
imports neither JAX nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
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
from repro_torch.data import bigram_lm  # noqa: E402
from repro_torch.kernels import confidence_gate as gate_mod  # noqa: E402
from repro_torch.kernels import flash_attention as flash_mod  # noqa: E402
from repro_torch.kernels import mamba_scan as mamba_mod  # noqa: E402
from repro_torch.kernels import mixed_attention as mixed_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as paged_mod  # noqa: E402
from repro_torch.kernels import ragged_attention as ragged_mod  # noqa: E402
from repro_torch.kernels import router_gate as router_mod  # noqa: E402
from repro_torch.kernels import rwkv6_scan as rwkv_mod  # noqa: E402
from repro_torch.launch import serve_async  # noqa: E402
from repro_torch.models import blocks, init_params, transformer  # noqa: E402
from repro_torch.models.cache import init_paged_cache  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.serving.engine import VirtualClock  # noqa: E402
from repro_torch.serving.slots import DenseTierSlotPool  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# (non-tensor-core) operations/s, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
# dense TF32 on the tensor cores (NVIDIA data sheet), for the tensor-core
# bound of flash_attention, whose f32 products take 3 TF32 products each
TF32_OPS_PER_S = 495e12


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
                kv_dtype, R=8, P=41, bs=16):
    """Inputs at main-path layout: R engine rows, P pages of bs tokens
    per row (prompt 640 + gen 8 -> 41 pages), N = R*P + 1 blocks."""
    qlen = torch.tensor(qlens, dtype=torch.int32)
    total = int(qlen.sum())
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


def attention_work(q, kp, pt, queries, kw):
    """(bytes, f32 ops) one paged attention call's data needs: q read
    and out written once, every K/V page some live query of a row can
    see read once (with its scales), the page table and per-row scalars
    once, and per live (query, visible key) pair 2*hd multiply-adds for
    q.k and for p.v per query head.  ``queries`` lists (page-table row,
    position) of every live query."""
    KV, G, hd = q.shape[-3:]
    bs = kp.shape[1]
    window = kw["window"]
    pt_h = pt.cpu().numpy()
    pages, pairs = set(), 0
    for b, pos in queries:
        lo = max(0, pos - window + 1) if window else 0
        pairs += pos - lo + 1
        for j in range(lo // bs, pos // bs + 1):
            pages.add(int(pt_h[b, j]))
    kv_bytes = len(pages) * bs * KV * hd * kp.element_size() * 2
    if kw["k_scale"] is not None:
        kv_bytes += len(pages) * bs * KV * 4 * 2
    nbytes = 2 * q.numel() * q.element_size() + kv_bytes + \
        4 * (pt.numel() + 2 * pt.shape[0])
    return nbytes, pairs * KV * G * 4 * hd


def ragged_work(args, kw):
    """The ragged call's work: every live flat token of a row."""
    q, kp, vp, pt, qs, ql = args
    ql_h, qs_h = ql.cpu().numpy(), qs.cpu().numpy()
    queries = [(b, int(qs_h[b]) + i) for b in range(len(ql_h))
               for i in range(int(ql_h[b]))]
    return attention_work(q, kp, pt, queries, kw)


def bound(nbytes: float, nops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def tc_bound_ms(nbytes: float, nops: float, kind: str) -> float:
    """Least time of a 3xTF32 tensor-core kernel: the bytes over HBM's
    rate against its TF32 products at the tensor cores' peak — 3 per f32
    operation (hi.hi + hi.lo + lo.hi), 1 for bf16 inputs."""
    terms = 3 if kind == "f32" else 1
    return max(nbytes / HBM_BYTES_PER_S, terms * nops / TF32_OPS_PER_S) * 1e3


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


def launched_splits(fn, kind: str):
    """The page-split count one call of ``fn`` launched: grid z of the
    kind's tile kernel (its first ``KERNEL_NAMES`` entry), read from the
    profiler's trace of that call, with the merge launches beside it
    (none for one split).  None where the trace gives no grid."""
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
    tile, merge = KERNEL_NAMES[kind]
    kern = [e for e in events if e.get("cat") == "kernel"]
    grids = [e.get("args", {}).get("grid") for e in kern
             if tile in e.get("name", "")]
    merges = sum(merge in e.get("name", "") for e in kern)
    if len(grids) != 1 or not grids[0]:
        return None, merges
    return int(grids[0][2]), merges


def time_case(name, timed, kernel, plain, work, flush):
    """CUDA-event times of the kernel (20 calls) and its plain version (5
    calls), L2 flushed before each, beside the bound of this call's
    work."""
    ms = time_ms(kernel, 20, flush)
    plain_ms = time_ms(plain, 5, flush)
    nbytes, nops = work
    b_ms, b_by = bound(nbytes, nops)
    timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                       bound_by=b_by, bytes=nbytes, ops=nops)
    return timed[name]


GEMMA = dict(KV=1, G=4, hd=256)
PHI4 = dict(KV=8, G=3, hd=128)
GRANITE = dict(KV=8, G=3, hd=64)
NEAR600 = [590, 595, 600, 605, 610, 615, 620, 625]     # decode ticks
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
        ("gemma window=512 bf16", gemma, mixed, late, 512, "bf16"),
        ("phi4 bf16", phi4, mixed, late, None, "bf16"),
        ("phi4 int8+scales", phi4, mixed, late, None, "int8+scales"),
        ("granite full bucket f32", GRANITE, full,
         [0, 100, 200, 300, 400, 500, 560, 580], None, "f32"),
        ("granite decode f32", GRANITE, [1] * 8, near600, None, "f32"),
    ]
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
        # decode tick (one token per row), the two ends of a tick's load
        if name.endswith(("full bucket f32", "decode f32")):
            t = time_case(
                name, timed,
                lambda: ragged_mod.ragged_attention(*args, **kw),
                lambda: ragged_mod.ragged_attention_ref(*args, **kw),
                ragged_work(args, kw), flush)
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
# phi4's layers and granite's (hd 64)
LAYERS = (("gemma", GEMMA, 512, ("f32", "bf16", "int8+scales")),
          ("gemma", GEMMA, None, ("f32",)),
          ("phi4", PHI4, None, ("f32", "bf16", "int8+scales")),
          ("granite", GRANITE, None, ("f32",)))


def check_paged(dev, flush):
    """paged_attention at the decode tick the ragged kernel is timed at
    (8 rows, one token each at positions 590-625) plus, in the checked
    cases, a ninth row masked to the null block as the split decode step
    masks a mid-prefill row (its output is not compared)."""
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
            if kind == "f32":
                # timed on the 8 live rows: the ragged kernel's decode case
                a8 = (q[:8].contiguous(), kp, vp, pt[:8].contiguous(),
                      pos[:8].contiguous())
                t = time_case(
                    name, timed,
                    lambda: paged_mod.paged_attention(*a8, **kw),
                    lambda: paged_mod.paged_attention_ref(*a8, **kw),
                    attention_work(a8[0], kp, a8[3],
                                   list(enumerate(NEAR600)), kw), flush)
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
            del kp, vp, ks, vs, pt, q, got, want
    torch.cuda.empty_cache()
    return worst, timed


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
                queries = [(b, starts[b] + i) for b in range(8)
                           for i in range(qlens[b])]
                t = time_case(
                    name, timed,
                    lambda: mixed_mod.mixed_attention(*args, **kw),
                    lambda: mixed_mod.mixed_attention_ref(*args, **kw),
                    attention_work(q, kp, pt, queries, kw), flush)
                emit(timing="mixed_attention", case=name, **t)
            del kp, vp, ks, vs, pt, q, got, want, args
    torch.cuda.empty_cache()
    return worst, timed


def check_gate(dev, flush):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    worst, timed = {"conf": 0.0, "entropy": 0.0, "logz": 0.0}, {}
    for name, V in (("gemma3-1b", 262144), ("phi4-mini-3.8b", 200064),
                    ("granite-moe-3b-a800m", 49155)):
        # random logits at a spread where the max is well separated
        x = torch.randn(8, V, generator=gen, device=dev) * 3.0
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
        emit(check="confidence_gate", case=f"{name} [8, {V}] f32",
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
        nbytes = x.numel() * 4 + 8 * 4 * 4
        b_ms, b_by = bound(nbytes, x.numel() * 5)
        timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                           bound_by=b_by, bytes=nbytes, ops=x.numel() * 5,
                           device_ms=device_ms(
                               lambda: gate_mod.confidence_gate(x)))
        emit(timing="confidence_gate", case=f"{name} [8, {V}] f32",
             **timed[name])
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


def check_router(dev, flush):
    """router_gate against its plain version at granite's main-path
    shapes ([512, 40] padded/split chunk and the ragged full bucket,
    [8, 40] decode width), at E = 384 and E = 1024 (the kernel's limit),
    and on rows of exact ties, k = 8; and at jamba's uniform prefill
    (one group of 1024 of the 5120 tokens, E = 16, k = 2).  Work per row
    for the bound: E logits read and k (gate, index) pairs written; E
    subtractions, exponentials and additions, k rounds of E comparisons,
    2k divisions."""
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
            nbytes = x.numel() * 4 + R * k * 8
            nops = R * (3 * E + k * E + 2 * k)
            t = time_case(name, timed, lambda: router_mod.router_gate(x, k),
                          lambda: router_mod.router_gate_ref(x, k),
                          (nbytes, nops), flush)
            t["device_ms"] = device_ms(lambda: router_mod.router_gate(x, k))
            emit(timing="router_gate", case=f"{name} k={k}", **t)
    return worst, timed


def visible_pairs(S, window):
    """(query, key) pairs a causal, optionally windowed, prefill of S
    tokens computes."""
    i = np.arange(S)
    return int(np.minimum(i + 1, window if window else S).sum())


def check_flash(dev, flush):
    """flash_attention against its plain version at the uniform prefill's
    shapes — 8 prompts of 640 tokens: gemma3-1b's sliding (window 512)
    and global layers, q [8, 4, 640, 256] over k/v [8, 1, 640, 256], and
    phi4-mini-3.8b's, q [8, 24, 640, 128] over k/v [8, 8, 640, 128] —
    in f32 (the main path) and, untimed, bf16.  The yardstick is one
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
    S = 640
    worst, timed = 0.0, {}
    for label, B, H, KV, d, window, kind in cases:
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
        nbytes = 4 * (2 * q.numel() + 2 * k.numel())
        nops = visible_pairs(S, window) * B * H * 4 * d
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
    both outputs (y and the final state) compared.  Work for the bound:
    the five inputs read and y and the state written once; per step and
    head 5·hd² f32 operations (2·hd² for r·S, 3·hd² for the decayed
    update w ⊙ S + k vᵀ) and 3·hd for the bonus term, folded into one
    scalar r·(u ⊙ k) times v.  No single PyTorch call computes the scan,
    so there is no yardstick."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    B, H, T, hd = 8, 40, 640, 64
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
    name = f"rwkv6-3b [{B}, {H}, {T}, {hd}] f32"
    emit(check="rwkv6_scan", case=name, max_abs_err=errs, tol=RWKV_TOL,
         ok=ok)
    if not ok:
        raise AssertionError(f"rwkv6_scan {name}: {errs}")
    nbytes = 4 * (5 * r.numel() + u.numel() + s_T.numel())
    nops = (5 * hd * hd + 3 * hd) * T * B * H
    timed = {}
    t = time_case(name, timed, lambda: rwkv_mod.rwkv6_scan(r, k, v, w, u),
                  lambda: rwkv_mod.rwkv6_scan_ref(r, k, v, w, u),
                  (nbytes, nops), flush)
    emit(timing="rwkv6_scan", case=name, **t)
    return max(errs.values()), timed


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
    16], and at a small ragged case (T = 70 off the 64-step chunk, d =
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
        nbytes = 4 * (sum(a.numel() for a in args) + y.numel()
                      + h_T.numel())
        nops = (7 * n + 1) * B * T * d
        t = time_case(name, timed, lambda: mamba_mod.mamba_scan(*args),
                      lambda: mamba_mod.mamba_scan_ref(*args),
                      (nbytes, nops), flush)
        t["exponentials"] = B * T * d * n
        t["sfu_bound_ms"] = B * T * d * n / SFU_EXP_PER_S * 1e3
        emit(timing="mamba_scan", case=name, **t)
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
    """Records (router logits, picks) of every ``router_gate`` call the
    model makes while the tap is open: the model's blocks see the kernel
    wrappers through a stand-in whose ``router_gate`` records, and every
    other name is ``ops``'s own."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        def tapped(logits, k):
            gates, idx = ops.router_gate(logits, k)
            self.calls.append((logits.detach().cpu(), idx.cpu()))
            return gates, idx

        class Ops:
            router_gate = staticmethod(tapped)

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


def check_ragged_step(dev):
    rng = np.random.default_rng(0)
    for label, cfg in step_models():
        params_cpu = init_params(cfg, 0, torch.float32, "cpu")
        params_dev = tree_map(lambda t: t.to(dev), params_cpu)
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


def check_padded_steps(dev):
    """The padded executor's ``mixed_step`` and the split executor's
    ``prefill_chunk`` then ``decode_step(pages=)`` (one row masked to the
    null block) on the card against the CPU: live rows' logits within
    1e-4."""
    rng = np.random.default_rng(1)
    for label, cfg in step_models():
        params_cpu = init_params(cfg, 0, torch.float32, "cpu")
        params_dev = tree_map(lambda t: t.to(dev), params_cpu)
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


def check_uniform_steps(dev):
    """The uniform path's steps on the card against the CPU: ``prefill``
    of 4 prompts of 40 tokens (past the smoke window of 16 and the scan
    kernel's 32-step chunk) — last-position logits and every part-cache
    leaf — then the part cache written into a dense arena of 48
    positions (``DenseTierSlotPool``) and one ``decode_step`` over it,
    rows at different positions: logits and the updated arena.  All
    within atol = rtol = 1e-4, unless an MoE router first picked
    differently on a near-tie (:func:`compare_step`)."""
    rng = np.random.default_rng(2)
    B, S, T = 4, 40, 48
    for label, cfg in uniform_models():
        params_cpu = init_params(cfg, 0, torch.float32, "cpu")
        params_dev = tree_map(lambda t: t.to(dev), params_cpu)
        toks = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
        dec_tok = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32))
        dec_pos = torch.tensor([[S], [S - 5], [S + 3], [S]],
                               dtype=torch.int32)
        out, taps = {}, {}
        for where, params in (("cpu", params_cpu), ("card", params_dev)):
            d = torch.device("cpu") if where == "cpu" else dev
            tap = [RouterTap() for _ in range(2)]
            with tap[0]:
                logits, part = transformer.prefill(params, cfg,
                                                   {"tokens": toks.to(d)})
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


def main_path_args(expensive=PHI4_NAME, **executor) -> Namespace:
    """The phase-4 workload with ``expensive`` as the second tier;
    ``executor`` adds the CLI's executor flags (``ragged_step=False``,
    ``split_step=True``, ``no_chunked_prefill=True`` or
    ``dense_kv=True``).  The chunked executors serve lognormal prompt
    lengths up to 640; the uniform prefill path (those two flags, or the
    recurrent rwkv6-3b and jamba-v0.1-52b) serves every prompt at exactly
    640."""
    uniform = (executor.get("no_chunked_prefill") or executor.get("dense_kv")
               or expensive in (RWKV_NAME, JAMBA_NAME))
    return Namespace(
        fast="gemma3-1b", expensive=expensive, variant="",
        device="cuda", requests=16, rate=8.0, slots=8, prompt_len=640,
        min_prompt_len=1, length_dist="uniform" if uniform else "lognormal",
        gen_len=8, prefill_chunk=64, prefill_token_budget=None, delta=None,
        escalation_budget=0.25, kv_block_size=16, kv_blocks=None,
        seed=0, expensive_seed=None, **executor)


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


def expected_launches(cfgs, kinds, warm=None, paged=True):
    """Launches each layer kernel must count over a run whose tier
    launches by kind are ``kinds``: every attention layer of a tier
    launch goes through the executor's attention kernel — ragged, mixed
    (padded steps and chunks), paged decode (split decode steps over the
    block-paged arena; the dense arena's decode is plain torch) or flash
    (uniform prefills) — every MoE layer through ``router_gate``, every
    RWKV-6 layer of a prefill through ``rwkv6_scan`` and every Mamba
    layer of a prefill through ``mamba_scan`` (their decode is plain
    torch).  ``warm`` adds the warmup's launches per tier."""
    out = {c: 0 for c in COUNTED if c != "confidence_gate"}
    for t, cfg in enumerate(cfgs):
        n = layer_counts(cfg)
        k = dict(kinds[t])
        if warm is not None:
            for kind, w in warm[t].items():
                k[kind] = k.get(kind, 0) + w
        out["ragged_attention"] += n["attn"] * k.get("ragged", 0)
        out["mixed_attention"] += n["attn"] * (k.get("mixed", 0)
                                               + k.get("chunk", 0))
        out["paged_attention"] += n["attn"] * k.get("step", 0) * paged
        out["flash_attention"] += n["attn"] * k.get("prefill", 0)
        out["router_gate"] += n["moe"] * sum(k.values())
        out["rwkv6_scan"] += n["rwkv6"] * k.get("prefill", 0)
        out["mamba_scan"] += n["mamba"] * k.get("prefill", 0)
    return out


def serve(card: str, params, executor: str, expensive=PHI4_NAME, cfgs=None):
    """Serve the phase-4 workload on ``params`` (the cascade to
    ``expensive``, whose configs are ``cfgs`` where given) under one
    executor, with every kernel counter set to 0 just before and read
    just after; check that every request completed, that the gate split
    them, and that the counters prove each tier launch went through the
    executor's kernels (and through nothing else)."""
    args = main_path_args(expensive, **ALL_EXECUTORS[executor])
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
    s = serve_async.run(args, params=params, cfgs=cfgs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {name: getattr(ops, name).launches for name in COUNTED}
    peak = torch.cuda.max_memory_allocated()

    cfgs = serve_async.tier_configs(args, cfgs)
    tier_launches = s["launches"]
    kinds = s["launches_by_kind"]
    # the warmup's launches per tier: every bucket width (ragged), the
    # chunk width and width 1 (padded), one chunk and one decode (split),
    # one prefill and one decode (uniform)
    warm = [{"ragged": len(b)} if b is not None else
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
    if not all(r["state"] == "DONE" and len(r["tokens"]) == args.gen_len
               for r in per_req):
        problems.append("a request is not DONE with gen_len tokens")
    tiers = [r["tier"] for r in per_req]
    if 1 not in tiers or 0 not in tiers:
        problems.append(f"need escalated and non-escalated requests: "
                        f"{tiers}")
    paged = s["paged_kv"]
    want = expected_launches(cfgs, kinds, paged=paged)
    got = {k: s["kernel_launches"][k] for k in want}
    if got != want:
        problems.append(f"layer kernel launches after warmup {got} != "
                        f"{want}")
    if s["kernel_launches"]["confidence_gate"] != sum(tier_launches):
        problems.append("gate launches != tier launches")
    want_window = expected_launches(cfgs, kinds, warm, paged=paged)
    if {k: counts[k] for k in want_window} != want_window:
        problems.append(f"launch counts {counts} != {want_window} "
                        "(warmup included)")
    if counts["confidence_gate"] != sum(tier_launches) + sum(
            sum(w.values()) for w in warm):
        problems.append(f"gate launch count {counts} off")
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
        phase="main path" if executor == "ragged" else "executor",
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
    emit(**record)
    if problems:
        raise AssertionError(f"{executor} -> {expensive}: "
                             + "; ".join(problems))
    return counts, per_req


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


# profiler kernel names of each kernel kind (any of them, by substring):
# the ragged and paged kinds count their split-merge kernels too
KERNEL_NAMES = {"ragged_attention": ("ragged_kernel", "ragged_merge_kernel"),
                "mixed_attention": ("mixed_kernel",),
                "paged_attention": ("paged_decode_kernel",
                                    "paged_merge_kernel"),
                "flash_attention": ("flash_kernel",),
                "confidence_gate": ("gate_kernel",),
                "router_gate": ("router_kernel",),
                "rwkv6_scan": ("wkv_kernel",),
                "mamba_scan": ("mamba_kernel",)}


def profile_ticks(card: str, params, executor: str, expensive=PHI4_NAME,
                  cfgs=None):
    """Where a tick's device time goes under one executor: the phase-4
    workload (the cascade to ``expensive``) served again under a
    VirtualClock (no waiting for arrivals) inside ``torch.profiler``;
    kernel time summed by kind, and the device's idle share of the
    serving loop's wall time.  The top kernels list shows the MoE
    cascade's expert products among the matrix products."""
    from torch.profiler import ProfilerActivity, profile

    args = main_path_args(expensive, **ALL_EXECUTORS[executor])
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
         card=card, clock="virtual",
         ticks=s["steps"], tier_launches=s["launches"],
         stream_checksum=serve_async.stream_checksum(engine),
         serving_wall_ms=wall_ms, device_kernel_ms=busy,
         device_idle_share=(1.0 - busy / wall_ms) if busy else None,
         kernel_ms_by_kind=kinds, kernel_launches_by_kind=counts,
         share_by_kind={k: v / busy for k, v in kinds.items()} if busy
         else None,
         top_kernels=[[round(us / 1e3, 3), n, name[:80]]
                      for us, n, name in rows[:12]])


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
    compare_streams({ex: r for ex, (_, r) in runs.items()})
    uniform_runs = {ex: serve(card, params, ex) for ex in ("uniform",
                                                           "dense")}
    compare_streams({ex: r for ex, (_, r) in uniform_runs.items()})
    torch.cuda.empty_cache()
    for ex in list(EXECUTORS) + ["uniform"]:
        profile_ticks(card, params, ex)
    # the MoE cascade: the same gemma3 weights, granite's (13.2 GB) drawn
    # from the expensive tier's seed in place of phi4's
    moe_args = main_path_args(MOE_NAME)
    params = (params[0], None)
    torch.cuda.empty_cache()
    params = (params[0], init_params(
        get_config(MOE_NAME, moe_args.variant), moe_args.seed + 1,
        torch.float32, dev))
    moe_runs = {ex: serve(card, params, ex, MOE_NAME) for ex in EXECUTORS}
    compare_streams({ex: r for ex, (_, r) in moe_runs.items()}, MOE_NAME)
    torch.cuda.empty_cache()
    profile_ticks(card, params, "ragged", MOE_NAME)
    check_split_moe_determinism(card, params)
    # the RWKV-6 cascade: rwkv6-3b's weights (12.3 GB) in place of
    # granite's; the engine serves it on the uniform prefill path
    params = (params[0], None)
    torch.cuda.empty_cache()
    params = (params[0], init_params(
        get_config(RWKV_NAME, moe_args.variant), moe_args.seed + 1,
        torch.float32, dev))
    rwkv_counts, _ = serve(card, params, "auto", RWKV_NAME)
    torch.cuda.empty_cache()
    profile_ticks(card, params, "auto", RWKV_NAME)
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
    compare_streams({ex: r for ex, (_, r) in jamba_runs.items()},
                    JAMBA_NAME)
    torch.cuda.empty_cache()
    profile_ticks(card, params, "auto", JAMBA_NAME, jamba_cfgs)
    counts = {ex: c for ex, (c, _) in runs.items()}
    counts.update({ex: c for ex, (c, _) in uniform_runs.items()})
    counts.update({f"moe {ex}": c for ex, (c, _) in moe_runs.items()})
    counts["rwkv"] = rwkv_counts
    counts.update({f"jamba {ex}": c for ex, (c, _) in jamba_runs.items()})
    moe_paths = tuple(f"moe {ex}" for ex in EXECUTORS)
    jamba_paths = ("jamba auto", "jamba dense")
    for name, ex in (("ragged_attention", ("ragged", "moe ragged")),
                     ("mixed_attention", ("padded", "split", "moe padded",
                                          "moe split")),
                     ("paged_attention", ("split", "moe split", "uniform",
                                          "rwkv", "jamba auto")),
                     ("flash_attention", ("uniform", "dense", "rwkv")
                      + jamba_paths),
                     ("confidence_gate", tuple(counts)),
                     ("router_gate", moe_paths + jamba_paths),
                     ("rwkv6_scan", ("rwkv",)),
                     ("mamba_scan", jamba_paths)):
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
                     ROUTER_TOL, q_time, "granite [512, 40]",
                     "granite-moe-3b-a800m: logits [512, 40] f32, k 8"),
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
