"""Device time of the ``mixed_attention`` and ``rwkv6_scan`` kernels at the
shapes ``chip_smoke.py`` times them, for comparing two checkouts of the
port on one card in one call.

It imports only the port's package, from whichever ``src`` is first on
``PYTHONPATH``, so the same script times another checkout (one unpacked
with ``git archive`` into a git-ignored directory, its kernels built
under that checkout's own ``build/``).  Run the two in turns (A, B, B, A)
and compare within the call:

    PYTHONPATH=build/parent/src python3 scripts/torch_kernel_ab.py --label parent
    PYTHONPATH=src python3 scripts/torch_kernel_ab.py --label change

Prints one JSON object per case: the card (``nvidia-smi`` name and power
limit), the case, and the profiler's device milliseconds per call of the
kind's kernels (merge kernels included), L2 flushed before each call,
mean of ``--iters`` calls.  Needs a card.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.kernels import mixed_attention as mixed_mod
from repro_torch.kernels import rwkv6_scan as rwkv_mod

# (label, KV, G, hd, window): the attention layers chip_smoke.py times
LAYERS = (("phi4", 8, 3, 128, None), ("gemma3 window=512", 1, 4, 256, 512))
# (label, q_len per row, q_start per row, C)
BATCHES = (("full bucket [8, 64]", [64] * 8,
            [0, 100, 200, 300, 400, 500, 560, 580], 64),
           ("decode [8, 1]", [1] * 8,
            [590, 595, 600, 605, 610, 615, 620, 625], 1))


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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", choices=("mixed_attention", "rwkv6_scan"),
                    help="time one kernel (and build only it)")
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
    for layer, KV, G, hd, window in LAYERS:
        for batch, qlens, starts, C in BATCHES:
            if args.only == "rwkv6_scan":
                break
            a = mixed_case(gen, dev, KV, G, hd, qlens, starts, C)
            ms = device_ms(lambda: mixed_mod.mixed_attention(
                *a, window=window), ("mixed_",), flush, args.iters)
            print(json.dumps({"label": args.label, "card": card,
                              "kernel": "mixed_attention",
                              "case": f"{layer} {batch} f32",
                              "device_ms": ms}), flush=True)
    if args.only == "mixed_attention":
        return
    B, H, T, hd = 8, 40, 640, 64
    gen.manual_seed(6)
    r, k, v = (torch.randn(B, H, T, hd, generator=gen, device=dev) * 0.5
               for _ in range(3))
    w = torch.exp(-torch.exp(torch.randn(B, H, T, hd, generator=gen,
                                         device=dev) * 0.5 - 0.5))
    u = torch.randn(H, hd, generator=gen, device=dev) * 0.5
    ms = device_ms(lambda: rwkv_mod.rwkv6_scan(r, k, v, w, u),
                   ("wkv_kernel",), flush, args.iters)
    print(json.dumps({"label": args.label, "card": card,
                      "kernel": "rwkv6_scan",
                      "case": f"rwkv6-3b [{B}, {H}, {T}, {hd}] f32",
                      "device_ms": ms}), flush=True)


if __name__ == "__main__":
    main()
