"""Device time of the ``mixed_attention``, ``rwkv6_scan``,
``confidence_gate`` and ``mamba_scan`` kernels at the shapes
``chip_smoke.py`` times them, and of ``moe_ffn``'s sections, for
comparing two checkouts of the port on one card in one call.

It imports only the port's package, from whichever ``src`` is first on
``PYTHONPATH``, so the same script times another checkout (one unpacked
with ``git archive`` into a git-ignored directory, its kernels built
under that checkout's own ``build/``).  Run the two in turns (A, B, B, A)
and compare within the call:

    PYTHONPATH=build/parent/src python3 scripts/torch_kernel_ab.py --label parent
    PYTHONPATH=src python3 scripts/torch_kernel_ab.py --label change

(``--only confidence_gate mamba_scan`` times, and builds, those two
alone.)

``--only moe_ffn`` times ``blocks.moe_ffn`` itself, one MoE layer at
the published widths with random weights, at granite-moe-3b-a800m's
full ragged bucket (x [1, 512, 1536]) and decode width ([8, 1, 1536])
and jamba-v0.1-52b's uniform prefill ([8, 640, 4096]: 5 groups of
1024).  Each statement of ``moe_ffn`` is wrapped in a profiler range
while it runs (a line tracer), and each device kernel is charged to the
statement whose host call launched it: the matrix products (the router
product and the expert products with their activation), the scatter into
the capacity buffer (statements on ``buf``), the combine (statements on
``eout[...]`` or the final sum, but their ``where`` kernels) and the
routing section (everything else: routing, queue ranks, keep, dest and
the combine's weights).  Per section: device ms and launches per call,
the aten operators it ran, and its host microseconds per call under the
tracer; beside them ``moe_ffn``'s own host microseconds per call, timed
without the tracer while the device is kept busy.  ``--only moe_route``
times the fused routing kernel, where the checkout has it, at those
shapes for each ``--route-rows`` block size, and ``--only router_gate``
the router alone at ``chip_smoke.py``'s shapes.

Prints one JSON object per case: the card (``nvidia-smi`` name and power
limit), the case, and the profiler's device milliseconds per call of the
kind's kernels (merge kernels included), L2 flushed before each call,
mean of ``--iters`` calls; for the gate also ``event_ms``, CUDA events
around one call (50 calls), which also time the host's launch work.
Needs a card.
"""
from __future__ import annotations

import argparse
import ast
import inspect
import json
import math
import os
import subprocess
import sys
import tempfile
import textwrap
import time
from collections import Counter, defaultdict

import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch.configs import get_config
from repro_torch.kernels import confidence_gate as gate_mod
from repro_torch.kernels import mamba_scan as mamba_mod
from repro_torch.kernels import mixed_attention as mixed_mod
from repro_torch.kernels import router_gate as router_mod
from repro_torch.kernels import rwkv6_scan as rwkv_mod
from repro_torch.models import blocks

KERNELS = ("mixed_attention", "rwkv6_scan", "confidence_gate", "mamba_scan",
           "moe_ffn", "moe_route", "router_gate")

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
# (label, config, x [B, S]): one MoE layer of each served MoE model at the
# main paths' shapes
MOE_SHAPES = (("granite bucket [1, 512]", "granite-moe-3b-a800m", (1, 512)),
              ("granite decode [8, 1]", "granite-moe-3b-a800m", (8, 1)),
              ("jamba prefill [8, 640]", "jamba-v0.1-52b", (8, 640)))
SECTIONS = ("routing", "matrix products", "scatter", "combine")
# router_gate's rows [R, E] and k as chip_smoke.py times them
ROUTER_SHAPES = ((512, 40, 8), (8, 40, 8), (64, 384, 8), (16, 1024, 8),
                 (1024, 16, 2))


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


def statement_sections(fn):
    """{source line: (first line of its statement, section)} over the
    simple statements of ``fn``; see the module's doc for the sections."""
    lines, first = inspect.getsourcelines(fn)
    src = textwrap.dedent("".join(lines))
    out = {}
    for node in ast.walk(ast.parse(src)):
        if not isinstance(node, ast.stmt) or hasattr(node, "body"):
            continue
        text = ast.get_source_segment(src, node)
        if "bmm" in text or "@ p[" in text:
            section = "matrix products"
        elif "buf" in text:
            section = "scatter"
        elif "eout[" in text or ".sum(2)" in text:
            section = "combine"
        else:
            section = "routing"
        for ln in range(node.lineno, node.end_lineno + 1):
            out[first + ln - 1] = (first + node.lineno - 1, section)
    return out


class StatementRanges:
    """While open, every statement of ``fn`` runs inside a profiler
    range ``moe_ffn:<section>:<line>`` (a line tracer on its frames)."""

    def __init__(self, fn):
        self.code = fn.__code__
        self.lines = statement_sections(fn)
        self.open = None

    def _close(self):
        if self.open is not None:
            self.open.__exit__(None, None, None)
            self.open = None

    def _local(self, frame, event, arg):
        if event == "line":
            stmt, section = self.lines.get(frame.f_lineno,
                                           (frame.f_lineno, "routing"))
            name = f"moe_ffn:{section}:{stmt}"
            if self.open is None or self.open.name != name:
                self._close()
                self.open = record_function(name)
                self.open.__enter__()
        elif event == "return":
            self._close()
        return self._local

    def _global(self, frame, event, arg):
        return self._local if frame.f_code is self.code else None

    def __enter__(self):
        sys.settrace(self._global)
        return self

    def __exit__(self, *exc):
        sys.settrace(None)
        self._close()


def moe_layer(name, shape, gen, dev):
    """One MoE layer of config ``name`` at its published widths: the
    FFN spec, random weights and an input x of ``shape`` + (d_model,)."""
    cfg = get_config(name, "")
    spec = next(l.ffn for l in cfg.period if l.ffn.kind == "moe")
    d, f, E = cfg.d_model, spec.d_ff, spec.num_experts

    def rand(*s, scale):
        return torch.randn(*s, generator=gen, device=dev) * scale
    p = {"router": rand(d, E, scale=0.02), "wi0": rand(E, d, f, scale=d ** -0.5),
         "wi1": rand(E, d, f, scale=d ** -0.5),
         "wo": rand(E, f, d, scale=f ** -0.5)}
    return cfg, spec, p, rand(*shape, d, scale=1.0)


def moe_sections(fn, iters):
    """Device ms, launches and aten operators per call of each section of
    ``moe_ffn`` over ``iters`` calls of ``fn``, and each section's host
    microseconds per call under the line tracer."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with StatementRanges(blocks.moe_ffn):
            for _ in range(iters):
                fn()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    prof.export_chrome_trace(path)
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    os.unlink(path)
    ranges = sorted((e["ts"], e["ts"] + e.get("dur", 0),
                     e["name"].split(":")[1])
                    for e in events if e.get("cat") == "user_annotation"
                    and e.get("name", "").startswith("moe_ffn:"))

    def section_at(ts):
        for lo, hi, sec in ranges:
            if lo <= ts <= hi:
                return sec
        return None
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    out = {sec: {"device_ms": 0.0, "launches": 0, "kernels": Counter(),
                 "aten_ops": Counter(), "host_us_traced": 0.0}
           for sec in SECTIONS}
    for lo, hi, sec in ranges:
        out[sec]["host_us_traced"] += (hi - lo) / iters
    unplaced = 0
    for e in events:
        cat = e.get("cat")
        if cat == "cpu_op" and e.get("name", "").startswith("aten::"):
            sec = section_at(e["ts"])
            if sec is not None:
                out[sec]["aten_ops"][e["name"]] += 1
        if cat not in ("kernel", "gpu_memset", "gpu_memcpy"):
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        sec = section_at(ts) if ts is not None else None
        if sec is None:
            unplaced += 1
            continue
        if sec == "combine" and "where" in e.get("name", ""):
            sec = "routing"         # the combine's keep masks
        out[sec]["device_ms"] += e.get("dur", 0.0) / 1e3 / iters
        out[sec]["launches"] += 1
        out[sec]["kernels"][e.get("name", "")[:70]] += 1
    for sec in SECTIONS:
        o = out[sec]
        o["launches"] /= iters
        o["kernels"] = {k: v / iters for k, v in o["kernels"].items()}
        o["aten_ops"] = {k: v / iters for k, v in o["aten_ops"].items()}
    return out, unplaced


def host_us(fn, iters):
    """Host microseconds per call of ``fn`` (no tracer), the device held
    busy by a spin queued first so that no call waits on it."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(1_000_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def emit(label, card, kernel, case, ms, **extra):
    print(json.dumps({"label": label, "card": card, "kernel": kernel,
                      "case": case, "device_ms": ms, **extra}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--label", required=True)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--only", nargs="+", choices=KERNELS, default=KERNELS,
                    help="time these kernels (and build only them)")
    ap.add_argument("--route-rows", nargs="+", type=int,
                    default=[4, 8, 16, 32],
                    help="moe_route block sizes (rows a block) to time")
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

    if "moe_ffn" in args.only:
        gen.manual_seed(8)
        for case, name, shape in MOE_SHAPES:
            cfg, spec, p, x = moe_layer(name, shape, gen, dev)
            iters = 3 if name.startswith("jamba") else args.iters
            sections, unplaced = moe_sections(
                lambda: blocks.moe_ffn(p, cfg, spec, x), iters)
            total = dict(
                device_ms=sum(v["device_ms"] for v in sections.values()),
                launches=sum(v["launches"] for v in sections.values()),
                host_us=host_us(lambda: blocks.moe_ffn(p, cfg, spec, x),
                                iters))
            emit(args.label, card, "moe_ffn", f"{name} {case}",
                 sections["routing"]["device_ms"], moe_ffn=total,
                 sections=sections, unplaced_launches=unplaced)
            del p, x
            torch.cuda.empty_cache()
    if "moe_route" in args.only and hasattr(router_mod, "moe_route"):
        gen.manual_seed(9)
        for case, name, shape in MOE_SHAPES:
            cfg = get_config(name, "")
            spec = next(l.ffn for l in cfg.period if l.ffn.kind == "moe")
            E, k = spec.num_experts, spec.top_k
            N = shape[0] * shape[1]
            gs = min(blocks.MOE_GROUP_SIZE, N)
            cap = min(gs, max(1, math.ceil(gs * k * spec.capacity_factor
                                           / E)))
            x = torch.randn(N // gs, gs, E, generator=gen, device=dev) * 2
            for rows in args.route_rows:
                ms = device_ms(lambda: router_mod.moe_route(
                    x, k, cap, rows_per_block=rows), ("moe_route_kernel",),
                    flush, args.iters)
                emit(args.label, card, "moe_route",
                     f"{name} {case} G {N // gs} gs {gs} k {k} E {E}", ms,
                     rows_per_block=rows,
                     blocks_a_group=router_mod.route_blocks(gs, rows)[1])
    if "router_gate" in args.only:
        gen.manual_seed(10)
        for R, E, k in ROUTER_SHAPES:
            x = torch.randn(R, E, generator=gen, device=dev) * 2
            ms = device_ms(lambda: router_mod.router_gate(x, k),
                           ("router_kernel",), flush, args.iters)
            emit(args.label, card, "router_gate", f"[{R}, {E}] k {k}", ms)


if __name__ == "__main__":
    main()
