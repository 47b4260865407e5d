"""On-card smoke test of the torch port (``src/repro_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure, and the script then exits non-zero
without printing a result):

  1. environment: card name and power limit (``nvidia-smi``), torch and
     CUDA versions, and the build of both CUDA kernels from
     ``src/repro_torch/csrc`` (one ``nvcc`` per source, in parallel);
  2. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it (gemma3-1b and phi4-mini-3.8b), with
     CUDA-event times for the kernel and the plain version;
  3. the port's ragged step end to end on the card against the same step
     on the CPU (plain versions), at the smoke widths;
  4. the main path at full width: ``repro_torch.launch.serve_async.run``
     serving 16 requests through the published gemma3-1b ->
     phi4-mini-3.8b cascade (random f32 weights from a seed), with the
     kernels' launch counters set to 0 just before and read just after;
  5. the same workload once more under ``torch.profiler`` with a virtual
     clock: device time by kernel kind and the device's idle share.

The lines before the last are JSON records of the findings (one of them
the ``{"kernels": [...]}`` summary) and the card's ``name, power.limit``
line; the last line is ``{"ok": true, "device": {...}}``.  The script
imports neither JAX nor the JAX package.
"""
from __future__ import annotations

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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import bigram_lm  # noqa: E402
from repro_torch.kernels import confidence_gate as gate_mod  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ragged_attention as ragged_mod  # noqa: E402
from repro_torch.launch import serve_async  # noqa: E402
from repro_torch.models import init_params, transformer  # noqa: E402
from repro_torch.models.cache import init_paged_cache  # noqa: E402
from repro_torch.models.params import tree_map  # noqa: E402
from repro_torch.serving.engine import VirtualClock  # noqa: E402

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and f32
# (non-tensor-core) operations/s, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


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


def ragged_case(gen, dev, *, KV, G, hd, qlens, q_start, window, dtype,
                kv_dtype, R=8, P=41, bs=16):
    """Inputs at main-path layout: R engine rows, P pages of bs tokens
    per row (prompt 640 + gen 8 -> 41 pages), N = R*P + 1 blocks."""
    N = R * P + 1
    qlen = torch.tensor(qlens, dtype=torch.int32)
    total = int(qlen.sum())
    W = 8
    while W < max(total, 1):
        W *= 2
    q = torch.randn(W, KV, G, hd, generator=gen, device=dev).to(dtype)
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
    args = (q, kp, vp, pt, torch.tensor(q_start, dtype=torch.int32,
                                        device=dev), qlen.to(dev))
    kw = dict(k_scale=ks, v_scale=vs, window=window)
    return args, kw


def ragged_work(args, kw):
    """(bytes, f32 ops) this call's data needs: q read and out written
    for the W slots, every K/V page some live token of a row can see
    read once (with its scales), and per live (token, visible key) pair
    2*hd multiply-adds for q.k and for p.v per query head."""
    q, kp, vp, pt, qs, ql = args
    W, KV, G, hd = q.shape
    bs = kp.shape[1]
    window = kw["window"]
    ql_h, qs_h, pt_h = ql.cpu().numpy(), qs.cpu().numpy(), pt.cpu().numpy()
    pages, pairs = set(), 0
    for b in range(len(ql_h)):
        for i in range(int(ql_h[b])):
            pos = int(qs_h[b]) + i
            lo = max(0, pos - window + 1) if window else 0
            pairs += pos - lo + 1
            for j in range(lo // bs, pos // bs + 1):
                pages.add(int(pt_h[b, j]))
    kv_bytes = len(pages) * bs * KV * hd * kp.element_size() * 2
    if kw["k_scale"] is not None:
        kv_bytes += len(pages) * bs * KV * 4 * 2
    nbytes = 2 * q.numel() * q.element_size() + kv_bytes + \
        4 * (pt.numel() + qs.numel() + ql.numel())
    ops_ = pairs * KV * G * 4 * hd
    return nbytes, ops_


def bound(nbytes: float, nops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, nops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def check_ragged(dev, flush):
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    f32, bf16, i8 = torch.float32, torch.bfloat16, torch.int8
    gemma = dict(KV=1, G=4, hd=256)
    phi4 = dict(KV=8, G=3, hd=128)
    mixed = [64, 0, 64, 1, 1, 37, 0, 64]       # 0-rows, padded tail
    late = [580, 0, 0, 580, 17, 600, 3, 520]   # positions past 512
    full = [64] * 8
    near600 = [590, 595, 600, 605, 610, 615, 620, 625]   # decode ticks
    cases = [
        ("gemma window=512 f32", gemma, mixed, late, 512, f32, f32, 1e-4),
        ("gemma global f32", gemma, mixed, late, None, f32, f32, 1e-4),
        ("gemma window=512 full bucket f32", gemma, full,
         [0, 100, 200, 300, 400, 500, 560, 580], 512, f32, f32, 1e-4),
        ("gemma window=512 decode f32", gemma, [1] * 8, near600, 512, f32,
         f32, 1e-4),
        ("gemma all-idle f32", gemma, [0] * 8, late, 512, f32, f32, 1e-4),
        ("phi4 f32", phi4, mixed, late, None, f32, f32, 1e-4),
        ("phi4 full bucket f32", phi4, full,
         [0, 100, 200, 300, 400, 500, 560, 580], None, f32, f32, 1e-4),
        ("phi4 decode f32", phi4, [1] * 8, near600, None, f32, f32, 1e-4),
        ("gemma window=512 bf16", gemma, mixed, late, 512, bf16, bf16, 2e-2),
        ("phi4 bf16", phi4, mixed, late, None, bf16, bf16, 2e-2),
        ("phi4 int8+scales", phi4, mixed, late, None, f32, i8, 1e-4),
    ]
    worst, timed = 0.0, {}
    for name, shape, qlens, qstart, window, dt, kvdt, tol in cases:
        args, kw = ragged_case(gen, dev, qlens=qlens, q_start=qstart,
                               window=window, dtype=dt, kv_dtype=kvdt,
                               **shape)
        got = ragged_mod.ragged_attention(*args, **kw)
        torch.cuda.synchronize()
        # bf16 inputs: the plain version computes in f32 on the same
        # (bf16-rounded) values
        fargs = (args[0].float(),) + args[1:]
        want = ragged_mod.ragged_attention_ref(*fargs, **kw)
        err = (got.float() - want).abs().max().item()
        ok = torch.allclose(got.float(), want, atol=tol, rtol=tol)
        if sum(qlens) == 0 and got.abs().max().item() != 0.0:
            ok = False
        emit(check="ragged_attention", case=name, W=int(args[0].shape[0]),
             max_abs_err=err, tol=tol, ok=bool(ok))
        if not ok:
            raise AssertionError(f"ragged_attention {name}: max abs err "
                                 f"{err} > tol {tol}")
        if tol == 1e-4:
            worst = max(worst, err)
        # timed: the full prefill bucket (8 rows x 64 tokens) and the
        # decode tick (one token per row), the two ends of a tick's load
        if name.endswith(("full bucket f32", "decode f32")):
            ms = time_ms(lambda: ragged_mod.ragged_attention(*args, **kw),
                         20, flush)
            plain_ms = time_ms(
                lambda: ragged_mod.ragged_attention_ref(*args, **kw), 5,
                flush)
            nbytes, nops = ragged_work(args, kw)
            b_ms, b_by = bound(nbytes, nops)
            timed[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                               bound_by=b_by, bytes=nbytes, ops=nops)
            emit(timing="ragged_attention", case=name, **timed[name])
        del args, kw, got, want
    torch.cuda.empty_cache()
    return worst, timed


def check_gate(dev, flush):
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    worst, timed = {"conf": 0.0, "entropy": 0.0, "logz": 0.0}, {}
    for name, V in (("gemma3-1b", 262144), ("phi4-mini-3.8b", 200064)):
        # random logits at a spread where the max is well separated
        x = torch.randn(8, V, generator=gen, device=dev) * 3.0
        got = gate_mod.confidence_gate(x)
        want = gate_mod.confidence_gate_ref(x)
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
                           bound_by=b_by, bytes=nbytes, ops=x.numel() * 5)
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


# --------------------------------------------------------------------------
# phase 3: the ragged step on the card against the CPU
# --------------------------------------------------------------------------


def check_ragged_step(dev):
    rng = np.random.default_rng(0)
    for name in ("gemma3-1b", "phi4-mini-3.8b"):
        cfg = get_config(name, "smoke")
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
        want, _ = transformer.ragged_step(params_cpu, cfg, toks, cache_cpu,
                                          pos, pages_cpu)
        got, _ = transformer.ragged_step(params_dev, cfg, toks.to(dev),
                                         cache_dev, pos.to(dev), pages_dev)
        live = qlen > 0
        err = (got.cpu()[live] - want[live]).abs().max().item()
        ok = torch.allclose(got.cpu()[live], want[live], atol=1e-4,
                            rtol=1e-4)
        emit(check="ragged_step card vs cpu", model=f"{name}-smoke",
             max_abs_err=err, tol=1e-4, ok=bool(ok))
        if not ok:
            raise AssertionError(f"ragged_step {name}: err {err}")


# --------------------------------------------------------------------------
# phase 4: the main path at full width
# --------------------------------------------------------------------------


def main_path_args() -> Namespace:
    return Namespace(
        fast="gemma3-1b", expensive="phi4-mini-3.8b", variant="",
        device="cuda", requests=16, rate=8.0, slots=8, prompt_len=640,
        min_prompt_len=1, length_dist="lognormal", gen_len=8,
        prefill_chunk=64, prefill_token_budget=None, delta=None,
        escalation_budget=0.25, kv_block_size=16, kv_blocks=None,
        seed=0, expensive_seed=None)


def main_path(card: str):
    args = main_path_args()
    lens = serve_async.sample_lengths(args.length_dist, args.requests,
                                      args.prompt_len, args.min_prompt_len,
                                      args.seed)
    if lens.max() <= 512:
        raise AssertionError("workload must hold a prompt over 512 tokens "
                             "(past gemma3's 512-token window)")
    torch.cuda.reset_peak_memory_stats()
    ops.ragged_attention.launches = 0
    ops.confidence_gate.launches = 0
    t0 = time.perf_counter()
    s = serve_async.run(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"ragged_attention": ops.ragged_attention.launches,
              "confidence_gate": ops.confidence_gate.launches}
    peak = torch.cuda.max_memory_allocated()

    layers = [get_config(args.fast).num_layers,
              get_config(args.expensive).num_layers]
    tier_launches = s["launches"]
    warm = [len(b) for b in s["flat_buckets"]]
    per_req = s["per_request"]
    problems = []
    if not all(r["state"] == "DONE" and len(r["tokens"]) == args.gen_len
               for r in per_req):
        problems.append("a request is not DONE with gen_len tokens")
    tiers = [r["tier"] for r in per_req]
    if 1 not in tiers or 0 not in tiers:
        problems.append(f"need escalated and non-escalated requests: "
                        f"{tiers}")
    want_ragged = sum(n * l for n, l in zip(layers, tier_launches))
    if s["kernel_launches"]["ragged_attention"] != want_ragged:
        problems.append(f"ragged launches after warmup "
                        f"{s['kernel_launches']['ragged_attention']} != "
                        f"{want_ragged}")
    if s["kernel_launches"]["confidence_gate"] != sum(tier_launches):
        problems.append("gate launches != tier launches")
    # the whole window: the warmup runs every bucket width once per tier
    if counts["ragged_attention"] != want_ragged + sum(
            n * w for n, w in zip(layers, warm)):
        problems.append(f"ragged launch count {counts} off")
    if counts["confidence_gate"] != sum(tier_launches) + sum(warm):
        problems.append(f"gate launch count {counts} off")
    if any(h > l for h, l in zip(s["host_syncs"], tier_launches)):
        problems.append(f"host syncs {s['host_syncs']} exceed one per "
                        f"active tier per tick {tier_launches}")
    gen_tokens = sum(args.gen_len * (r["tier"] + 1) for r in per_req)
    record = dict(
        phase="main path", card=card, configs=[args.fast, args.expensive],
        requests=args.requests, completed=s["completed"],
        tier_requests=s["tier_requests"], steps=s["steps"],
        tier_launches=tier_launches, host_syncs=s["host_syncs"],
        kernel_launches_after_warmup=s["kernel_launches"],
        kernel_launches_window=counts, warmup_widths=s["flat_buckets"],
        escalation_rate=s["escalation_rates"], delta=s["delta"],
        prompt_len_max=s["prompt_len_max"],
        makespan_s=s["elapsed"], generated_tokens=gen_tokens,
        generated_tokens_per_s=gen_tokens / s["elapsed"],
        live_tokens_per_s=s["step_live_tokens"] / s["elapsed"],
        tick_p50_s=s["tick_duration_p50"], tick_p95_s=s["tick_duration_p95"],
        latency_p50_s=s["latency_p50"], ttft_p50_s=s["ttft_p50"],
        max_memory_allocated_bytes=peak, wall_s_incl_init=wall,
        stream_checksum=s["stream_checksum"], problems=problems)
    emit(**record)
    if problems:
        raise AssertionError("; ".join(problems))
    return counts


def profile_ticks(card: str, args: Namespace):
    """Where a tick's device time goes: the same workload served again
    under a VirtualClock (no waiting for arrivals) inside
    ``torch.profiler``; kernel time summed by kind, and the device's idle
    share of the serving loop's wall time."""
    from torch.profiler import ProfilerActivity, profile

    engine, vocab = serve_async.build_engine(args, VirtualClock())
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
    kinds = {"ragged_attention": 0.0, "confidence_gate": 0.0,
             "matrix products": 0.0, "other": 0.0}
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        if not us:
            continue
        name = e.key
        rows.append((us, e.count, name))
        if "ragged_kernel" in name:
            kinds["ragged_attention"] += us / 1e3
        elif "gate_kernel" in name:
            kinds["confidence_gate"] += us / 1e3
        elif any(k in name.lower() for k in ("gemm", "gemv", "cutlass",
                                             "xmma")):
            kinds["matrix products"] += us / 1e3
        else:
            kinds["other"] += us / 1e3
    rows.sort(reverse=True)
    busy = sum(kinds.values())
    emit(phase="profile", card=card, clock="virtual",
         ticks=s["steps"], tier_launches=s["launches"],
         serving_wall_ms=wall_ms, device_kernel_ms=busy,
         device_idle_share=(1.0 - busy / wall_ms) if busy else None,
         kernel_ms_by_kind=kinds,
         share_by_kind={k: v / busy for k, v in kinds.items()} if busy
         else None,
         top_kernels=[[round(us / 1e3, 3), n, name[:80]]
                      for us, n, name in rows[:12]])


def timed_cases(timed: dict) -> list:
    """Every timed case of one kernel, for the ``kernels`` line."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by")
    return [dict(case=name, library_ms=None, **{k: t[k] for k in keys})
            for name, t in timed.items()]


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
    ptxas = {n: kernels.library_path(n).with_suffix(".log").read_text()
             for n in kernels.KERNELS
             if kernels.library_path(n).with_suffix(".log").is_file()}
    emit(phase="environment", card=card, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         build_s=build_s, built=built,
         ptxas={n: [l for l in t.splitlines() if "registers" in l
                    or "spill" in l] for n, t in ptxas.items()})

    flush = torch.empty(128 * 2 ** 20 // 4, device=dev)   # > 50 MB L2
    r_err, r_time = check_ragged(dev, flush)
    g_err, g_time = check_gate(dev, flush)
    del flush
    torch.cuda.empty_cache()
    check_ragged_step(dev)
    counts = main_path(card)
    torch.cuda.empty_cache()
    profile_ticks(card, main_path_args())

    rt = r_time["phi4 full bucket f32"]
    gt = g_time["gemma3-1b"]
    here = "src/repro_torch/csrc"
    print(json.dumps({"kernels": [
        {"name": "ragged_attention", "route": "cuda",
         "source": f"{here}/ragged_attention.cu",
         "replaces": "src/repro/kernels/ragged_attention.py:180",
         "launches": counts["ragged_attention"], "max_abs_err": r_err,
         "tolerance": "atol=rtol=1e-4 (f32)",
         "ms": rt["ms"], "plain_ms": rt["plain_ms"],
         "bound_ms": rt["bound_ms"], "bound_by": rt["bound_by"],
         "library_ms": None,
         "shape": "phi4-mini-3.8b: q [512, 8, 3, 128] f32, 8 rows x 64 "
                  "tokens, pools [329, 16, 8, 128]",
         "cases": timed_cases(r_time)},
        {"name": "confidence_gate", "route": "cuda",
         "source": f"{here}/confidence_gate.cu",
         "replaces": "src/repro/kernels/confidence_gate.py:83",
         "launches": counts["confidence_gate"],
         "max_abs_err": max(g_err.values()),
         "tolerance": "conf/logz rtol 1e-5, entropy atol 1e-4, argmax "
                      "exact",
         "ms": gt["ms"], "plain_ms": gt["plain_ms"],
         "bound_ms": gt["bound_ms"], "bound_by": gt["bound_by"],
         "library_ms": None,
         "shape": "gemma3-1b: logits [8, 262144] f32",
         "cases": timed_cases(g_time)},
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
