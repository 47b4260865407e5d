"""Device time of the ``mixed_attention``, ``rwkv6_scan``,
``confidence_gate`` and ``mamba_scan`` kernels at the shapes
``chip_smoke.py`` times them, for comparing two checkouts of the port on
one card in one call.

It imports only the port's package, from whichever ``src`` is first on
``PYTHONPATH``, so the same script times another checkout (one unpacked
with ``git archive`` into a git-ignored directory, its kernels built
under that checkout's own ``build/``).  Run the two in turns (A, B, B, A)
and compare within the call:

    PYTHONPATH=build/parent/src python3 scripts/torch_kernel_ab.py --label parent
    PYTHONPATH=src python3 scripts/torch_kernel_ab.py --label change

(``--only confidence_gate mamba_scan`` times, and builds, those two
alone.)

Prints one JSON object per case: the card (``nvidia-smi`` name and power
limit), the case, and the profiler's device milliseconds per call of the
kind's kernels (merge kernels included), L2 flushed before each call,
mean of ``--iters`` calls; for the gate also ``event_ms``, CUDA events
around one call (50 calls), which also time the host's launch work.
Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import confidence_gate as gate_mod
from repro_torch.kernels import mamba_scan as mamba_mod
from repro_torch.kernels import mixed_attention as mixed_mod
from repro_torch.kernels import rwkv6_scan as rwkv_mod

KERNELS = ("mixed_attention", "rwkv6_scan", "confidence_gate", "mamba_scan")

# (label, KV, G, hd, window): the attention layers chip_smoke.py times
LAYERS = (("phi4", 8, 3, 128, None), ("gemma3 window=512", 1, 4, 256, 512))
# (label, q_len per row, q_start per row, C)
BATCHES = (("full bucket [8, 64]", [64] * 8,
            [0, 100, 200, 300, 400, 500, 560, 580], 64),
           ("decode [8, 1]", [1] * 8,
            [590, 595, 600, 605, 610, 615, 620, 625], 1))
# the served vocabularies: gemma3-1b, phi4-mini-3.8b, granite-moe-3b-a800m,
# and rwkv6-3b and jamba-v0.1-52b (both 65536)
VOCABS = (262144, 200064, 49155, 65536)


def device_ms(fn, names, flush, iters):
    """Profiler device ms per call of the kernels whose names contain one
    of ``names``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0.0)
             for e in prof.key_averages()
             if any(n in e.key for n in names))
    return us / 1e3 / iters


def event_ms(fn, flush, iters):
    """CUDA-event ms around one call, L2 flushed before it, mean of
    ``iters``: the device time plus what the host's launch leaves
    exposed."""
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


def mixed_case(gen, dev, KV, G, hd, qlens, starts, C, P=41, bs=16):
    R = len(qlens)
    N = R * P + 1
    kp, vp = (torch.randn(N, bs, KV, hd, generator=gen, device=dev)
              for _ in range(2))
    pt = (torch.randperm(N - 1, generator=gen, device=dev) + 1)[:R * P]
    q = torch.randn(R, C, KV, G, hd, generator=gen, device=dev)
    return (q, kp, vp, pt.reshape(R, P).to(torch.int32).contiguous(),
            torch.tensor(starts, dtype=torch.int32, device=dev),
            torch.tensor(qlens, dtype=torch.int32, device=dev))


def emit(label, card, kernel, case, ms, **extra):
    print(json.dumps({"label": label, "card": card, "kernel": kernel,
                      "case": case, "device_ms": ms, **extra}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=KERNELS,
                    help="time these kernels (and build only them)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_ab: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)   # > 50 MB L2
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    if "mixed_attention" in args.only:
        for layer, KV, G, hd, window in LAYERS:
            for batch, qlens, starts, C in BATCHES:
                a = mixed_case(gen, dev, KV, G, hd, qlens, starts, C)
                ms = device_ms(lambda: mixed_mod.mixed_attention(
                    *a, window=window), ("mixed_",), flush, args.iters)
                emit(args.label, card, "mixed_attention",
                     f"{layer} {batch} f32", ms)
    if "rwkv6_scan" in args.only:
        B, H, T, hd = 8, 40, 640, 64
        gen.manual_seed(6)
        r, k, v = (torch.randn(B, H, T, hd, generator=gen, device=dev)
                   * 0.5 for _ in range(3))
        w = torch.exp(-torch.exp(torch.randn(B, H, T, hd, generator=gen,
                                             device=dev) * 0.5 - 0.5))
        u = torch.randn(H, hd, generator=gen, device=dev) * 0.5
        ms = device_ms(lambda: rwkv_mod.rwkv6_scan(r, k, v, w, u),
                       ("wkv_kernel",), flush, args.iters)
        emit(args.label, card, "rwkv6_scan",
             f"rwkv6-3b [{B}, {H}, {T}, {hd}] f32", ms)
        del r, k, v, w, u
    if "confidence_gate" in args.only:
        gen.manual_seed(1)
        for V in VOCABS:
            x = torch.randn(8, V, generator=gen, device=dev) * 3.0
            ms = device_ms(lambda: gate_mod.confidence_gate(x),
                           ("gate_kernel",), flush, args.iters)
            emit(args.label, card, "confidence_gate", f"[8, {V}] f32", ms,
                 event_ms=event_ms(lambda: gate_mod.confidence_gate(x),
                                   flush, 50))
    if "mamba_scan" in args.only:
        B, T, d, n = 8, 640, 8192, 16
        gen.manual_seed(7)
        x = torch.randn(B, T, d, generator=gen, device=dev)
        dt = torch.nn.functional.softplus(
            torch.randn(B, T, d, generator=gen, device=dev)) * 0.1
        Bt, Ct = (torch.randn(B, T, n, generator=gen, device=dev)
                  for _ in range(2))
        A = -torch.exp(torch.randn(d, n, generator=gen, device=dev) * 0.3)
        ms = device_ms(lambda: mamba_mod.mamba_scan(x, dt, Bt, Ct, A),
                       ("mamba_kernel",), flush, args.iters)
        emit(args.label, card, "mamba_scan",
             f"jamba-v0.1-52b [{B}, {T}, {d}] n {n} f32", ms)


if __name__ == "__main__":
    main()
