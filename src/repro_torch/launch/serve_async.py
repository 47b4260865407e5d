"""Asynchronous cascade serving under Poisson traffic (the torch port's
entry point; the JAX package's ``repro/launch/serve_async.py`` is the
reference).

Drives :class:`repro_torch.serving.CascadeEngine` with open-loop
arrivals: requests arrive at rate ``--rate`` req/s (exponential
inter-arrival times), are admitted into ``--slots`` KV rows per tier as
they free up (continuous batching), and low-confidence sequences are
escalated to the expensive tier.  ``--length-dist
{uniform,lognormal,bimodal}`` samples per-request prompt lengths in
``[--min-prompt-len, --prompt-len]``; chunked paged prefill advances
``--prefill-chunk`` tokens per row per tick, and each tick runs as ONE
ragged flat token-batch step per tier through the hand-written CUDA
kernels (``--flat-buckets`` overrides the ragged step's bucket widths) —
or, with ``--no-ragged-step``, one padded mixed step per tier,
or, with ``--split-step``, a chunk launch plus a paged decode launch per
tier (one fetch either way).  ``--no-chunked-prefill`` prefills each
admission in one uniform launch (the flash attention kernel in every
attention layer) and decodes on the split path; ``--dense-kv`` does the
same over the dense one-row-per-request arena; a tier with recurrent
state (``--expensive rwkv6-3b``, the RWKV-6 scan kernel, or the
hybrid ``--expensive jamba-v0.1-52b``, the Mamba scan kernel in its
Mamba layers) or a modality frontend (``--expensive musicgen-large``,
``--expensive qwen2-vl-72b``: zero frontend embeddings over the first
``frontend_len`` positions) takes the uniform path by itself.  The uniform path needs
``--length-dist uniform``.  The gate threshold comes from an escalation
budget by default (δ = the budget-quantile of recent sequence
confidences); ``--delta`` fixes it instead.  ``--speculate K`` turns on
speculative cascade decoding on the ragged executor: the cheap tier keeps
an escalated request's row, drafts up to K tokens ahead of the expensive
tier, and the expensive tier verifies them in its own ragged launch
(``--expensive-seed`` equal to ``--seed``, with ``--expensive`` the fast
model, gives self-speculation, where every draft is accepted).

``--prefix-cache`` turns on refcounted KV prefix sharing (chunked paged
prefill only): each tier's pool indexes finished prompt chunks at block
boundaries, later requests with the same leading tokens map those blocks
read-only and start prefill at the first uncached chunk (cached tokens
cost 0 admission budget).  ``--shared-prefix-frac F`` makes the
synthetic workload exercise it: every request's first ``F``·length
tokens come from one shared base prompt (system-prompt traffic), the
rest stay unique.  Token streams are the same with the cache on or off
under a fixed ``--delta``; the summary records the hit rate, the
cached-token fraction and the stream checksum.

Overload and failure: ``--preemption {none,youngest,fewest-tokens}``
evicts and replays a victim row instead of stalling when an
over-subscribed KV arena (``--kv-blocks``) runs dry; ``--deadline T``
gives every request a completion deadline ``T`` after its arrival
(engine-clock units: seconds, or ticks under ``--virtual-clock``) and
turns on load shedding; ``--launch-retries`` and ``--retry-backoff``
bound the retry of a launch that fails transiently; ``--inject-faults
SPEC`` attaches a deterministic
:class:`repro_torch.serving.faults.FaultPlan` (pool shrinkage,
escalation storms, launch failures, slow ticks; see that module for the
grammar).  Ctrl-C prints the partial summary and still writes
``--trace-out``.

Multi-device serving: ``--tier-mesh DATAxMODEL ...`` gives each tier
its own mesh (one shape for both tiers, or one per tier) over a
contiguous slice of the visible cards, wrapping to the first card when
the tiers overrun them (``--device cpu``: over the CPU device repeated).
``--tier-mesh 1 1`` on two cards serves the fast tier on ``cuda:0`` and
the expensive one on ``cuda:1``; ``--tier-mesh 2x1 2x1`` splits each
tier's rows and KV arena into two data shards, each launch running
once per shard on its card, under every executor (``--no-chunked-prefill``,
``--dense-kv`` and ``--speculate`` too) and for every tier family (a MoE
tier's shards advance layer by layer, each MoE layer routed once over the
tier's whole batch).  ``--tier-mesh 1x2`` adds tensor
parallelism: each launch splits over two model shards (attention and KV
heads, RWKV-6 heads or Mamba channels, FFN hidden units or experts, a
frontend's projection rows, the vocabulary), all-reducing between
layers, and ``--shard-params`` places each model shard's slices of the
weights on its card instead of a full replica on each, under every
executor (``--no-chunked-prefill``, ``--dense-kv`` and ``--speculate``
too) and for every tier family; ``2x2`` combines both axes.  A model
axis the layers do not allow (one that cuts a head, or does not divide
Mamba's channels or a frontend's rows) raises ValueError naming the
shapes.

Observability: ``--trace-out trace.json`` records every request's
lifecycle (QUEUED -> PREFILL -> DECODE -> ESCALATED -> DONE) and every
tick's engine phases (admit / plan / launch / device_get / finish) as a
Chrome-trace timeline that Perfetto loads (``--trace-ring`` events at
most; ``scripts/check_trace.py`` validates it); ``--metrics-interval 5``
prints a snapshot line every 5 engine-clock units; ``--profile DIR``
writes a ``torch.profiler`` trace of the serving loop (the card's kernels
too on a CUDA device) to ``DIR/torch_trace.json``, each launch in a
``run_ragged/<tier>`` (etc.) range and each tick in ``tick/<id>``.

    PYTHONPATH=src python -m repro_torch.launch.serve_async \\
        --requests 64 --rate 8 --slots 8 --length-dist lognormal

runs the smoke variants on the card; ``--variant ''`` serves the
published widths, ``--expensive granite-moe-3b-a800m`` the MoE cascade
(its MoE layers route and rank their expert queues through the
router kernel's ``moe_route``, counted as ``router_gate``),
``--expensive rwkv6-3b`` the RWKV-6 cascade, ``--expensive
jamba-v0.1-52b`` the Mamba + attention + MoE hybrid (and
``starcoder2-7b``, ``musicgen-large``, ``qwen2-vl-72b``,
``moonshot-v1-16b-a3b`` and ``kimi-k2-1t-a32b`` the rest of the
registry), and
``--device cpu`` runs on the CPU with the kernels' plain versions.
Reports latency/TTFT percentiles, throughput, per-tier utilization,
launches and host syncs per tick, the escalation rate, the speculation
and prefix-cache counters, the per-gate calibration (ECE and agreement
against the escalation and verify outcomes) and Eq 7 FLOPs/request.
"""
from __future__ import annotations

import argparse
import hashlib
import json

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import bigram_lm
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.mesh import make_tier_meshes, visible_devices
from repro_torch.models import init_params
from repro_torch.serving import CascadeEngine, FaultPlan, TierSpec, Tracer
from repro_torch.serving.engine import VirtualClock, WallClock, resolve_device
from repro_torch.serving.observability import profile_window

# Prompt tokens are drawn from the first PROMPT_VOCAB ids: bigram_lm's
# trigram table is vocab x vocab int64 (320 GB at phi4-mini's 200064), so
# the published vocabularies cannot seed it.  Smoke vocabs (512) are
# below the cap and give the JAX package's prompts exactly.
PROMPT_VOCAB = 4096


def tier_configs(args, cfgs=None):
    """(fast, expensive) ``ModelConfig``: ``cfgs`` where given (a
    configuration cut from a registered one, such as jamba-v0.1-52b at
    1 of its 4 periods), else ``--fast``/``--expensive`` at
    ``--variant``."""
    if cfgs is not None:
        return tuple(cfgs)
    return (get_config(args.fast, args.variant),
            get_config(args.expensive, args.variant))


def build_params(args, cfgs=None):
    """Both tiers' random f32 weights (configs from
    :func:`tier_configs`), drawn on the device from the seeds: (fast
    tier's, expensive tier's)."""
    device = resolve_device(args.device)
    exp_seed = args.seed + 1 if args.expensive_seed is None \
        else args.expensive_seed
    fast_cfg, exp_cfg = tier_configs(args, cfgs)
    return (init_params(fast_cfg, args.seed, torch.float32, device),
            init_params(exp_cfg, exp_seed, torch.float32, device))


def parse_mesh_shape(s: str):
    """'4x2' -> (data=4, model=2); bare '4' means data-only."""
    data, _, model = s.lower().partition("x")
    return int(data), int(model or 1)


def tier_meshes(args, num_tiers: int):
    """Per-tier meshes from ``--tier-mesh`` (None: unmeshed tiers).  One
    shape is broadcast to every tier; otherwise one per tier.  The meshes
    cover ``args.mesh_devices`` where a caller sets it (a list of
    devices, which may repeat one: several shards on one card), else the
    visible cards, or with ``--device cpu`` the CPU device repeated as
    often as the largest mesh needs."""
    if not getattr(args, "tier_mesh", None):
        return [None] * num_tiers
    shapes = [parse_mesh_shape(s) for s in args.tier_mesh]
    if len(shapes) == 1:
        shapes = shapes * num_tiers
    if len(shapes) != num_tiers:
        raise ValueError(f"--tier-mesh takes 1 or {num_tiers} shapes, "
                         f"got {len(shapes)}")
    devices = getattr(args, "mesh_devices", None)
    if devices is None:
        devices = (
            [torch.device("cpu")] * max(d * m for d, m in shapes)
            if resolve_device(args.device).type == "cpu"
            else visible_devices())
    return make_tier_meshes(shapes, devices)


def build_engine(args, clock=None, params=None, cfgs=None, tracer=None):
    """Both tiers' configs (:func:`tier_configs`) and weights (``params``
    from :func:`build_params`, drawn here when None), and the engine
    (recording into ``tracer`` where given); returns (engine, vocab
    shared by both tiers)."""
    device = resolve_device(args.device)
    if device.type == "cuda":
        # f32 end to end: no TF32 in the matrix products
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    fast_cfg, exp_cfg = tier_configs(args, cfgs)
    fast_params, exp_params = (build_params(args, cfgs) if params is None
                               else params)
    gate_kw = ({"deltas": [args.delta]} if args.delta is not None
               else {"escalation_budget": args.escalation_budget})
    dense = getattr(args, "dense_kv", False)
    meshes = tier_meshes(args, 2)
    shard_params = bool(getattr(args, "shard_params", False))
    engine = CascadeEngine(
        [TierSpec(args.fast, fast_cfg, fast_params, mesh=meshes[0],
                  shard_params=shard_params),
         TierSpec(args.expensive, exp_cfg, exp_params, mesh=meshes[1],
                  shard_params=shard_params)],
        slots=args.slots, prompt_len=args.prompt_len, gen_len=args.gen_len,
        kv_block_size=args.kv_block_size, kv_blocks=args.kv_blocks,
        use_paged_kv=not dense,
        use_chunked_prefill=False if (
            dense or getattr(args, "no_chunked_prefill", False)) else None,
        prefill_chunk=args.prefill_chunk,
        prefill_token_budget=args.prefill_token_budget,
        use_unified_step=False if getattr(args, "split_step", False)
        else None,
        use_ragged_step=getattr(args, "ragged_step", None),
        flat_buckets=getattr(args, "flat_buckets", None),
        prefix_cache=bool(getattr(args, "prefix_cache", False)),
        speculation_k=getattr(args, "speculate", 0),
        spec_delta=getattr(args, "spec_delta", None),
        tracer=tracer,
        profile_annotations=bool(getattr(args, "profile", None)),
        clock=clock if clock is not None else WallClock(),
        preemption_policy=getattr(args, "preemption", "none"),
        launch_retries=getattr(args, "launch_retries", 2),
        retry_backoff=getattr(args, "retry_backoff", 0.02),
        faults=(FaultPlan.parse(args.inject_faults)
                if getattr(args, "inject_faults", None) else None),
        device=device, **gate_kw)
    return engine, min(fast_cfg.vocab_size, exp_cfg.vocab_size)


def poisson_arrivals(n: int, rate: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=n))


def sample_lengths(dist: str, n: int, max_len: int, min_len: int,
                   seed: int) -> np.ndarray:
    """Per-request prompt lengths in [min_len, max_len].

    uniform   — every prompt at max_len
    lognormal — median ~ max_len/4, σ=0.8: the heavy right tail of chat /
                search traffic (most prompts short, a few near the cap)
    bimodal   — half short (~max_len/8), half long (~0.8·max_len)
    """
    if dist == "uniform":
        return np.full(n, max_len, np.int64)
    rng = np.random.default_rng(seed + 1_000_003)
    if dist == "lognormal":
        lens = rng.lognormal(mean=np.log(max(max_len / 4.0, 1.0)),
                             sigma=0.8, size=n)
    elif dist == "bimodal":
        short = rng.normal(max_len / 8.0, max_len / 16.0, size=n)
        long = rng.normal(0.8 * max_len, max_len / 10.0, size=n)
        lens = np.where(rng.random(n) < 0.5, short, long)
    else:
        raise ValueError(f"unknown length distribution {dist!r}")
    return np.clip(np.rint(lens), min_len, max_len).astype(np.int64)


def apply_shared_prefix(prompts: np.ndarray, lengths: np.ndarray,
                        frac: float, vocab: int, seed: int) -> np.ndarray:
    """Overwrite the first ``frac``·length tokens of every prompt with one
    shared base sequence (system-prompt traffic); the tail stays unique.
    ``frac=0`` is the identity, ``frac=1`` makes prompts pure prefixes of
    each other (maximal sharing)."""
    if not frac:
        return prompts
    if not 0.0 <= frac <= 1.0:
        raise ValueError(f"--shared-prefix-frac must be in [0, 1], "
                         f"got {frac}")
    base = bigram_lm(num_seqs=1, seq_len=prompts.shape[1], vocab=vocab,
                     seed=seed + 7_777_777)[0]
    out = prompts.copy()
    for i, n in enumerate(lengths):
        k = int(frac * int(n))
        out[i, :k] = base[:k]
    return out


def stream_checksum(engine) -> str:
    """Order-independent digest of every request's final (tier, state,
    token stream) — two runs serving the same workload identically
    agree on it, whichever package served it."""
    h = hashlib.sha256()
    for req in sorted(engine.requests, key=lambda r: r.rid):
        h.update(f"{req.rid}:{req.tier}:{req.state.name}:".encode())
        h.update(np.asarray(req.tokens, np.int64).tobytes())
        h.update(b"|")
    return h.hexdigest()


def snapshot_line(snap: dict) -> str:
    """One-line progress record of :meth:`ServingMetrics.snapshot`."""
    esc = "/".join(f"{r:.2f}" for r in snap["escalation_rates"])
    ece = "/".join("-" if np.isnan(e) else f"{e:.3f}"
                   for e in snap["gate_ece"])
    return (f"[t={snap['t']:.1f}] completed {snap['completed']}"
            f"/{snap['requests']}  steps {snap['steps']}  "
            f"esc [{esc}]  gate ece [{ece}]  "
            f"tick p50 {snap['tick_duration_p50']:.4f}")


def _launch_counts() -> dict:
    return {name: getattr(kernel_ops, name).launches
            for name in ("ragged_attention", "mixed_attention",
                         "paged_attention", "flash_attention",
                         "confidence_gate", "router_gate", "rwkv6_scan",
                         "mamba_scan")}


def run(args, clock=None, params=None, cfgs=None) -> dict:
    """Build (on ``params`` from :func:`build_params` and the configs
    ``cfgs`` where given), warm up, serve the synthetic workload, and
    summarise.
    ``kernel_launches`` counts the kernel launches after warmup;
    ``per_request`` lists each request's final tier, state and tokens,
    and the tokens each tier it reached decoded.  A KeyboardInterrupt
    stops the run and returns the partial summary (``interrupted``); the
    trace is written either way (``trace_events``, ``trace_dropped``)."""
    tracer = (Tracer(capacity=getattr(args, "trace_ring", 1 << 18))
              if getattr(args, "trace_out", None) else None)
    engine, vocab = build_engine(args, clock, params, cfgs, tracer)
    # catches the flags and the engine's own choice of uniform prefill
    # (a tier with recurrent state or a modality frontend)
    if args.length_dist != "uniform" and not engine.chunked_prefill:
        raise ValueError(
            "mixed prompt lengths require chunked paged prefill, but the "
            "engine runs the uniform path (--no-chunked-prefill/--dense-kv "
            "given, or a tier carries recurrent state or a modality "
            "frontend) — use --length-dist uniform")
    prompts = bigram_lm(num_seqs=args.requests, seq_len=args.prompt_len,
                        vocab=min(vocab, PROMPT_VOCAB), seed=args.seed)
    lengths = sample_lengths(args.length_dist, args.requests,
                             args.prompt_len, args.min_prompt_len,
                             args.seed)
    prompts = apply_shared_prefix(
        prompts, lengths, getattr(args, "shared_prefix_frac", 0.0),
        min(vocab, PROMPT_VOCAB), args.seed)
    arrivals = poisson_arrivals(args.requests, args.rate, args.seed)
    # warmup runs every bucket width and then resets the clock, so
    # arrival timestamps are relative to the start of serving
    engine.warmup()
    warm = _launch_counts()
    ddl = getattr(args, "deadline", None)
    for p, n, t in zip(prompts, lengths, arrivals):
        engine.submit(p[:int(n)], arrival_time=float(t),
                      deadline=None if ddl is None else float(t) + ddl)
    interval = getattr(args, "metrics_interval", None)
    on_snap = ((lambda s: print(snapshot_line(s)))
               if interval is not None else None)
    interrupted = False
    with profile_window(getattr(args, "profile", None), engine.device):
        try:
            summary = engine.run(metrics_interval=interval,
                                 on_snapshot=on_snap)
        except KeyboardInterrupt:
            # a graceful stop: report what completed and still write the
            # trace below, instead of a traceback
            interrupted = True
            summary = engine.metrics.summary()
            print(f"\ninterrupted at t={engine.clock.now():.2f} — partial "
                  f"summary ({summary['completed']}/{summary['requests']} "
                  "completed)")
    summary["interrupted"] = interrupted
    trace_out = getattr(args, "trace_out", None)
    if trace_out:
        n_events = tracer.export(trace_out)
        summary["trace_events"] = n_events
        summary["trace_dropped"] = tracer.dropped
        print(f"wrote {n_events} trace events to {trace_out}"
              + (f" ({tracer.dropped} dropped)" if tracer.dropped else ""))
    summary["kernel_launches"] = {k: v - warm[k]
                                  for k, v in _launch_counts().items()}
    summary["host_syncs_total"] = engine.host_syncs
    summary["rate"] = args.rate
    summary["offered_rate"] = (
        args.requests / float(arrivals[-1] - arrivals[0])
        if args.requests > 1 and arrivals[-1] > arrivals[0]
        else float("nan"))
    summary["slots"] = args.slots
    summary["gen_len"] = args.gen_len
    summary["length_dist"] = args.length_dist
    summary["max_prompt_len"] = args.prompt_len
    summary["prefill_chunk"] = engine.prefill_chunk
    summary["chunked_prefill"] = engine.chunked_prefill
    summary["paged_kv"] = engine.paged_kv
    summary["unified_step"] = engine.unified_step
    summary["ragged_step"] = engine.ragged_step
    summary["flat_buckets"] = [rt.flat_buckets if rt.ragged else None
                               for rt in engine.runtimes]
    summary["speculation_k"] = engine.speculation_k
    summary["spec_delta"] = engine.spec_delta
    # the overload layer's knobs, and what the fault plan injected
    summary["preemption_policy"] = engine.preemption_policy
    summary["deadline"] = ddl
    if engine.faults is not None:
        summary["faults"] = engine.faults.describe()
        summary["fault_events"] = len(engine.faults.log)
    summary["snapshot"] = engine.metrics.snapshot(engine.clock.now())
    summary["escalation_budget"] = (None if args.delta is not None
                                    else args.escalation_budget)
    summary["delta"] = [engine.scheduler.delta(g)
                        for g in range(len(engine.scheduler.gates))]
    summary["kv_arena"] = engine.memory_stats()
    summary["prefix_cache_enabled"] = engine.prefix_cache
    summary["shared_prefix_frac"] = float(
        getattr(args, "shared_prefix_frac", 0.0) or 0.0)
    summary["stream_checksum"] = stream_checksum(engine)
    # multi-device serving: per-tier mesh layout (None: unmeshed tiers)
    summary["tier_meshes"] = engine.mesh_topology()
    summary["device_count"] = (torch.cuda.device_count()
                               if engine.device.type == "cuda" else 1)
    summary["device"] = str(engine.device)
    summary["device_name"] = (torch.cuda.get_device_name(engine.device)
                              if engine.device.type == "cuda" else "cpu")
    summary["per_request"] = [
        {"rid": r.rid, "tier": r.tier, "state": r.state.name,
         "tokens": list(r.tokens),
         "tokens_by_tier": [list(t) for t in r.tokens_by_tier]}
        for r in engine.requests]
    return summary


def report(s: dict) -> None:
    print(f"served {s['completed']}/{s['requests']} requests "
          f"in {s['elapsed']:.2f}s over {s['steps']} engine steps "
          f"(rate {s['rate']}/s, {s['slots']} slots/tier, "
          f"{s['device_name']})")
    if any(t["mesh"] for t in s.get("tier_meshes", [])):
        print("  meshes " + "  ".join(
            f"{t['tier']}={t['mesh']}" for t in s["tier_meshes"]))
    print(f"  latency  p50 {s['latency_p50']:.3f}s  "
          f"p95 {s['latency_p95']:.3f}s   "
          f"ttft p50 {s['ttft_p50']:.3f}s  p95 {s['ttft_p95']:.3f}s")
    print(f"  prompts {s['length_dist']} (mean {s['prompt_len_mean']:.1f}"
          f"/{s['max_prompt_len']} tok, chunk {s['prefill_chunk']})  "
          f"tick p50 {s['tick_duration_p50']:.4f}s  "
          f"p95 {s['tick_duration_p95']:.4f}s")
    print(f"  throughput {s['throughput']:.2f} req/s   tier utilization "
          + "  ".join(f"{n}={u:.2f}" for n, u in
                      zip(s['tier_names'], s['tier_utilization'])))
    mode = ("ragged" if s.get("ragged_step")
            else "unified" if s.get("unified_step")
            else "split" if s.get("chunked_prefill", True)
            else "uniform+split" if s.get("paged_kv", True)
            else "uniform+split dense")
    if s.get("speculation_k"):
        mode += f", speculate {s['speculation_k']}"
    print(f"  launches/tick [{mode}] "
          + "  ".join(f"{n}={l:.2f}" for n, l in
                      zip(s["tier_names"], s["launches_per_tick"]))
          + "   host-syncs/tick "
          + "  ".join(f"{n}={h:.2f}" for n, h in
                      zip(s["tier_names"], s["host_syncs_per_tick"]))
          + "   kernel launches "
          + "  ".join(f"{k}={v}" for k, v in s["kernel_launches"].items()))
    print(f"  token slots  live {s['step_live_tokens']}"
          f"/{s['step_processed_tokens']} processed "
          f"(wasted-slot ratio {s['wasted_slot_ratio']:.3f})")
    overloaded = (s.get("shed") or s.get("failed") or s.get("preemptions")
                  or s.get("launch_retries")
                  or s.get("preemption_policy", "none") != "none"
                  or s.get("interrupted"))
    if overloaded:
        cons = s.get("conservation", {})
        print(f"  overload [{s.get('preemption_policy', 'none')}]  "
              f"shed {s.get('shed', 0)} "
              f"(rate {s.get('shed_rate', 0.0):.3f})  "
              f"preempted {s.get('preemptions', 0)} "
              f"(replayed {s.get('replayed_tokens', 0)} tok)  "
              f"failed {s.get('failed', 0)}  "
              f"launch retries {s.get('launch_retries', 0)}  "
              "conservation "
              + ("ok" if cons.get("ok")
                 else ("interrupted" if s.get("interrupted")
                       else f"VIOLATED ({cons})")))
    rates = ", ".join(f"{r:.3f}" for r in s["escalation_rates"])
    deltas = ", ".join(f"{d:.4f}" for d in s["delta"])
    target = ("" if s.get("escalation_budget") is None
              else f" (budget target {s['escalation_budget']:.3f})")
    sp = s.get("speculation") or {}
    if s.get("speculation_k") and sp.get("drafted"):
        print(f"  speculation k={s['speculation_k']}  "
              f"accept rate {sp['accept_rate']:.2f} "
              f"({sp['accepted']}/{sp['drafted']} drafts, "
              f"{sp['rolled_back']} rolled back)  draft steps "
              + "  ".join(f"{n}={d}" for n, d in
                          zip(s["tier_names"], sp["draft_steps_by_tier"])))
    print(f"  escalation rate [{rates}] at δ=[{deltas}]{target}")
    pc = s.get("prefix_cache") or {}
    if s.get("prefix_cache_enabled") and pc.get("lookups"):
        shared_hw = sum(t.get("kv_shared_high_water_blocks", 0)
                        for t in s.get("kv_arena", []))
        print(f"  prefix cache  hit rate {pc['hit_rate']:.2f} "
              f"({pc['hits']}/{pc['lookups']} admissions)  "
              f"cached tokens {pc['cached_tokens']} "
              f"({pc['cached_token_frac']:.2f} of prompt tokens)  "
              f"shared-block hw {shared_hw}")

    def _f(x, spec=".3f"):
        return "-" if x is None or np.isnan(x) else format(x, spec)
    # streaming calibration against the escalation outcomes (cheap vs
    # expensive agreement on escalated traffic) and the verify outcomes
    print("  gate calibration "
          + "  ".join(f"g{g['gate']}: ece {_f(g['ece'])} "
                      f"agree {_f(g['agreement_rate'], '.2f')} "
                      f"({g['outcomes']} outcomes, "
                      f"{g['verify_outcomes']} verified, accept "
                      f"{_f(g['verify_accept_rate'], '.2f')})"
                      for g in s["gate_calibration"]))
    print("  snapshot " + snapshot_line(s["snapshot"]))
    print(f"  Eq7 FLOPs/request: cascade {s['flops_per_request_cascade']:.3e} "
          f"(always-fast {s['flops_per_request_always_fast']:.3e}, "
          f"always-expensive {s['flops_per_request_always_expensive']:.3e})")


def make_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--fast", default="gemma3-1b")
    ap.add_argument("--expensive", default="phi4-mini-3.8b")
    ap.add_argument("--variant", default="smoke",
                    help="'smoke' (the default), 'long', or '' for the "
                         "published config")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cuda' raises without a card")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="Poisson arrival rate, requests/s")
    ap.add_argument("--slots", type=int, default=8,
                    help="KV rows per tier")
    ap.add_argument("--prompt-len", type=int, default=32,
                    help="maximum prompt length")
    ap.add_argument("--min-prompt-len", type=int, default=1)
    ap.add_argument("--length-dist", default="uniform",
                    choices=("uniform", "lognormal", "bimodal"),
                    help="per-request prompt length distribution over "
                         "[min-prompt-len, prompt-len]")
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="prompt tokens a row advances per tick")
    ap.add_argument("--prefill-token-budget", type=int, default=None,
                    help="tokens admitted per tier per tick "
                         "(default slots * prefill-chunk)")
    ap.add_argument("--no-chunked-prefill", action="store_true",
                    help="uniform one-shot prefill of each admission "
                         "(exact-length prompts; decode on the split path)")
    ap.add_argument("--dense-kv", action="store_true",
                    help="dense one-row-per-request KV arena instead of the "
                         "block-paged one (implies --no-chunked-prefill)")
    ap.add_argument("--tier-mesh", nargs="*", default=None,
                    metavar="DATAxMODEL",
                    help="per-tier mesh shapes, e.g. --tier-mesh 2x1 2x1: "
                         "each tier gets its own mesh over a contiguous "
                         "slice of the visible cards (wrapping when tiers "
                         "overrun them; the CPU device repeated under "
                         "--device cpu); rows + KV block pool shard over "
                         "the data axis, heads, FFN units, experts and "
                         "vocabulary over the model axis.  One shape is "
                         "broadcast to both tiers; default: no mesh (the "
                         "--device)")
    ap.add_argument("--shard-params", action="store_true",
                    help="tensor-shard tier params over the mesh 'model' "
                         "axis (default: replicate params per tier)")
    ap.add_argument("--split-step", action="store_true",
                    help="split chunk + decode launches instead of the "
                         "unified one launch per tier per tick")
    ap.add_argument("--ragged-step", default=None,
                    action=argparse.BooleanOptionalAction,
                    help="ragged flat [1, W] token batch inside unified "
                         "execution; --no-ragged-step keeps the padded "
                         "[slots, width] mixed step.  Default: ragged "
                         "whenever unified execution is on")
    ap.add_argument("--flat-buckets", type=int, nargs="*", default=None,
                    metavar="W",
                    help="flat widths of the ragged step (default powers "
                         "of two from 8 up to slots*prefill-chunk; widths "
                         "> 16 must be multiples of 16, and the largest "
                         "must cover slots*prefill-chunk)")
    ap.add_argument("--speculate", type=int, default=0, metavar="K",
                    help="speculative cascade decoding: the cheap tier "
                         "drafts up to K tokens per escalated request per "
                         "tick and the expensive tier scores them in its "
                         "one ragged launch (streams equal K=0's).  Needs "
                         "the ragged step; 0 (the default) disables")
    ap.add_argument("--spec-delta", type=float, default=None,
                    metavar="CONF",
                    help="confidence a drafted token needs to be staged "
                         "(the draft truncates at its first token below "
                         "it); default: the draft tier's gate δ")
    ap.add_argument("--delta", type=float, default=None,
                    help="fixed gate threshold (overrides the budget)")
    ap.add_argument("--escalation-budget", type=float, default=0.25,
                    help="target escalation rate; δ is calibrated online")
    ap.add_argument("--kv-block-size", type=int, default=16,
                    help="tokens per KV block")
    ap.add_argument("--kv-blocks", type=int, default=None,
                    help="KV arena size in blocks per tier (default: fully "
                         "provisioned; smaller over-subscribes)")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="refcounted KV prefix sharing: index finished "
                         "prompt chunks, admit later requests with "
                         "matching leading tokens straight past them "
                         "(needs chunked paged prefill)")
    ap.add_argument("--shared-prefix-frac", type=float, default=0.0,
                    metavar="F",
                    help="overwrite the first F·length tokens of every "
                         "prompt with one shared base sequence (synthetic "
                         "system-prompt traffic for exercising "
                         "--prefix-cache); 0 leaves prompts unique")
    ap.add_argument("--preemption", default="none",
                    choices=("none", "youngest", "fewest-tokens"),
                    help="evict-and-replay policy when an over-subscribed "
                         "KV arena (--kv-blocks) runs dry: youngest evicts "
                         "the newest row, fewest-tokens the "
                         "least-progressed; none keeps the stall "
                         "behaviour.  Replayed streams are the same "
                         "(greedy decode)")
    ap.add_argument("--deadline", type=float, default=None, metavar="T",
                    help="per-request completion deadline, relative to "
                         "arrival (engine-clock units: seconds, or ticks "
                         "under --virtual-clock); queued requests past — "
                         "or provably unable to meet — it are shed")
    ap.add_argument("--launch-retries", type=int, default=2,
                    help="bounded retries per launch or fetch on a "
                         "transient error before one request is failed")
    ap.add_argument("--retry-backoff", type=float, default=0.02,
                    metavar="SEC", help="initial retry backoff (doubles "
                         "per attempt)")
    ap.add_argument("--inject-faults", default=None, metavar="SPEC",
                    help="deterministic fault plan, e.g. "
                         "'seed=7,shrink=5:0:8:40,storm=10-14:0,"
                         "launch=0.05' (see repro_torch/serving/faults.py "
                         "for the grammar)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--expensive-seed", type=int, default=None,
                    help="weight seed of the expensive tier "
                         "(default --seed + 1)")
    ap.add_argument("--json", default=None,
                    help="also write the summary dict to this path")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome-trace/Perfetto JSON timeline of "
                         "the run: per-request lifecycle spans and "
                         "per-tick engine phases (load at ui.perfetto.dev)")
    ap.add_argument("--trace-ring", type=int, default=1 << 18,
                    help="trace ring-buffer capacity in events; oldest "
                         "events drop first (dropped count is reported)")
    ap.add_argument("--metrics-interval", type=float, default=None,
                    metavar="SEC",
                    help="print a streaming metrics snapshot (completions, "
                         "escalation, gate ECE, tick p50) every SEC "
                         "engine-clock seconds")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the serving loop "
                         "to DIR/torch_trace.json (CPU activity, and the "
                         "card's kernels on a CUDA device), each launch in "
                         "a run_ragged/run_mixed/... range and each tick "
                         "in tick/<id>")
    ap.add_argument("--virtual-clock", action="store_true",
                    help="deterministic 1-tick-per-step clock (arrival "
                         "times are then in ticks, not seconds)")
    return ap


def main() -> None:
    args = make_parser().parse_args()
    clock = VirtualClock() if args.virtual_clock else None
    summary = run(args, clock)
    report(summary)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(summary, f, indent=2, default=float)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
