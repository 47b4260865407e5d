"""Cascade serving, batch wrapper (the torch twin of
``repro/launch/serve.py``): batched requests through a fast LLM, and
the low-confidence sequences escalated to an expensive LLM (the paper's
system, Fig 1, with LLMs as the members).

:func:`serve_cascade` drives :class:`repro_torch.serving.CascadeEngine`
(continuous batching over KV slot pools, per-request gates, packed
escalation) with every request arriving at 0 under a virtual clock:

  1. fast tier: prefill the prompt, then greedy decode ``gen_len``
     tokens, each token's confidence from the confidence gate kernel
     (max softmax probability — the paper's conf);
  2. the sequence confidence is the mean of its tokens';
  3. sequences with conf <= δ escalate and the expensive tier decodes
     them again; Eq 7's cost uses FLOPs per token and N^exp = the
     escalated count.

:func:`greedy_decode` is the dense uniform ``prefill`` then
``decode_step`` loop of one model.  The gate is always the
``confidence_gate`` kernel on the card (its plain version on the CPU),
and escalations are always packed into dense sub-batches: the JAX
package's ``use_gate_kernel``/``--gate-kernel`` and ``pack``/``--pack``
have no counterpart.  For Poisson traffic, latency percentiles and
escalation budgets use ``repro_torch.launch.serve_async``.

    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu \\
        --batch 6 --prompt-len 16 --gen-len 6
"""
from __future__ import annotations

import argparse
import time
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.data import bigram_lm
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.serve_async import PROMPT_VOCAB
from repro_torch.models import init_params, transformer
from repro_torch.models.cache import init_cache
from repro_torch.models.params import tree_map
from repro_torch.serving import CascadeEngine, TierSpec
from repro_torch.serving.engine import VirtualClock, resolve_device


@dataclass
class ServeStats:
    n: int
    n_exp: int
    flops_fast: float
    flops_exp: float

    @property
    def flops_cascade(self) -> float:
        """Eq 7 with FLOPs in place of MACs."""
        return self.flops_fast + (self.n_exp / max(self.n, 1)) * self.flops_exp


@torch.no_grad()
def greedy_decode(cfg, params, prompts, gen_len):
    """prompts [B, P] int32 on the params' device.  Returns (tokens [B,
    gen_len] int32, conf [B, gen_len]): the uniform prefill, then
    ``gen_len - 1`` dense-arena decode steps, every token and its
    confidence from the confidence gate.  A model with a modality
    frontend gets zero frontend embeddings, as in the JAX package."""
    B, P = prompts.shape
    dev = params["embed"].device
    cache = init_cache(cfg, B, P + gen_len, torch.float32, dev)
    logits, part = transformer.prefill(params, cfg, {
        "tokens": prompts, **transformer.zero_frontend(cfg, B, dev)})
    tree_map(lambda full, new: full[tuple(slice(0, s) for s in new.shape)]
             .copy_(new), cache, part)
    toks, confs = [], []
    for t in range(gen_len):
        gate = kernel_ops.confidence_gate(logits[:, -1])
        tok = gate["argmax"][:, None]
        toks.append(tok)
        confs.append(gate["conf"])
        if t + 1 < gen_len:
            pos = torch.full((B, 1), P + t, dtype=torch.int32, device=dev)
            logits, cache = transformer.decode_step(params, cfg, tok, cache,
                                                    pos)
    return torch.cat(toks, 1), torch.stack(confs, 1)


def serve_cascade(fast_arch="gemma3-1b", exp_arch="phi4-mini-3.8b", *,
                  variant="smoke", fast_variant=None, exp_variant=None,
                  batch=8, prompt_len=32, gen_len=16,
                  delta=0.5, seed=0, fast_params=None, exp_params=None,
                  verbose=True, slots=None, device="cuda"):
    """Serve ``batch`` prompts, all arriving at 0, through the cascade
    on ``device`` and drain it; returns ``(out_tokens [B, G], seq_conf
    [B], ServeStats)``, the tensors on the CPU.  ``slots`` bounds the
    per-tier KV slot pools (default ``batch``).  Prompts
    come from ``bigram_lm`` over the tiers' shared vocabulary, capped at
    ``serve_async.PROMPT_VOCAB`` (its trigram table is ``vocab x
    vocab``; the smoke vocabularies are below the cap)."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    fast_cfg = get_config(fast_arch,
                          variant if fast_variant is None else fast_variant)
    exp_cfg = get_config(exp_arch,
                         variant if exp_variant is None else exp_variant)
    vocab = min(fast_cfg.vocab_size, exp_cfg.vocab_size, PROMPT_VOCAB)
    if fast_params is None:
        fast_params = init_params(fast_cfg, seed, torch.float32, device)
    if exp_params is None:
        exp_params = init_params(exp_cfg, seed + 1, torch.float32, device)

    prompts = np.asarray(bigram_lm(num_seqs=batch, seq_len=prompt_len,
                                   vocab=vocab, seed=seed))

    t0 = time.time()
    engine = CascadeEngine(
        [TierSpec("fast", fast_cfg, fast_params),
         TierSpec("exp", exp_cfg, exp_params)],
        slots=batch if slots is None else slots,
        prompt_len=prompt_len, gen_len=gen_len, deltas=[delta],
        clock=VirtualClock(), device=device)
    for p in prompts:
        engine.submit(p, arrival_time=0.0)
    engine.run()

    out_tokens = np.stack([np.asarray(r.tokens, np.int32)
                           for r in engine.requests])
    seq_conf = np.asarray([r.seq_conf_by_tier[0] for r in engine.requests],
                          np.float32)
    n_exp = engine.scheduler.gate_stats[0].escalated

    # Eq 7 accounting: FLOPs per generated token = 2 * active params
    flops_fast = 2.0 * fast_cfg.active_param_count() * gen_len
    flops_exp = 2.0 * exp_cfg.active_param_count() * gen_len
    stats = ServeStats(n=batch, n_exp=n_exp, flops_fast=flops_fast,
                       flops_exp=flops_exp)
    if verbose:
        print(f"served {batch} requests in {time.time()-t0:.1f}s: "
              f"escalated {n_exp}/{batch} (δ={delta})")
        print(f"  FLOPs/token: fast={flops_fast/gen_len:.3e} "
              f"exp={flops_exp/gen_len:.3e} "
              f"cascade={stats.flops_cascade/gen_len:.3e}")
    return torch.from_numpy(out_tokens), torch.from_numpy(seq_conf), stats


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fast", default="gemma3-1b")
    ap.add_argument("--expensive", default="phi4-mini-3.8b")
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--delta", type=float, default=0.5)
    ap.add_argument("--slots", type=int, default=None,
                    help="per-tier KV slot pool size (default: batch)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args()
    serve_cascade(args.fast, args.expensive, variant=args.variant,
                  batch=args.batch, prompt_len=args.prompt_len,
                  gen_len=args.gen_len, delta=args.delta,
                  slots=args.slots, device=args.device)


if __name__ == "__main__":
    main()
