"""Training entry point (the torch twin of ``repro/launch/train.py``).

Runs real steps on one device: next-token LM training, or LtC cascade
training (Eq 4) of a fast arch against a frozen expensive arch.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch gemma3-1b --variant smoke --steps 50 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch gemma3-1b --expensive phi4-mini-3.8b --variant smoke ...

The default device is ``cuda``; without a card it raises.  The data is
``bigram_lm`` over ``vocab`` tokens (default the model's vocabulary)
batched by ``Batches``, so a seed gives the JAX package's batches.
``bigram_lm`` builds a ``vocab x vocab`` int64 trigram table on the
host: at gemma3-1b's published 262144 that is 550 GB, in both packages,
so a run at the published widths passes a smaller ``vocab``.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save as save_ckpt
from repro_torch.configs import get_config
from repro_torch.data import Batches, bigram_lm
from repro_torch.launch import steps as steps_lib
from repro_torch.models import init_params, transformer
from repro_torch.serving.engine import resolve_device


def run(arch: str, *, variant="smoke", steps=50, batch=8, seq=128,
        lr=1e-2, expensive=None, ltc_w=1.0, cost_c=0.5, seed=0,
        ckpt=None, exp_params=None, log_every=10, data_seed=0,
        return_losses=False, vocab=None, trigram_frac=0.3, device="cuda",
        history=None):
    """Train ``arch`` for ``steps`` steps from random f32 weights drawn
    from ``seed`` on ``device``; with ``expensive``, by the LtC loss
    against that arch (weights ``exp_params``, or drawn from ``seed +
    1``), frozen.  Returns the params (and the per-step losses —
    ``l_org`` under LtC — with ``return_losses``).  A ``history`` list
    receives each step's ``{"step", "ms", ...metrics}``, the time on the
    host clock around the step, which ends in a device sync."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(arch, variant)
    params = init_params(cfg, seed, torch.float32, device)

    tokens = bigram_lm(num_seqs=max(batch * 16, 256), seq_len=seq,
                       vocab=vocab or cfg.vocab_size, seed=data_seed,
                       trigram_frac=trigram_frac)
    it = iter(Batches({"tokens": tokens}, batch, seed=seed))
    # the trained model's frontend only, as in the JAX package
    extra = transformer.zero_frontend(cfg, batch, device)

    if expensive is None:
        train_step, opt = steps_lib.make_train_step(cfg, lr=lr)
        args_extra = ()
    else:
        exp_cfg = get_config(expensive, variant)
        if exp_params is None:
            exp_params = init_params(exp_cfg, seed + 1, torch.float32,
                                     device)
        train_step, opt = steps_lib.make_ltc_train_step(
            cfg, exp_cfg, w=ltc_w, cost_c=cost_c, lr=lr)
        args_extra = (exp_params,)

    opt_state = opt.init(params)
    losses = []
    t0 = time.time()
    for i in range(steps):
        b = {k: torch.as_tensor(v, device=device)
             for k, v in next(it).items()}
        b.update(extra)
        ts = time.perf_counter()
        params, opt_state, m = train_step(params, opt_state, *args_extra, b)
        m = {k: float(v) for k, v in m.items()}     # waits for the device
        if history is not None:
            history.append({"step": i + 1,
                            "ms": (time.perf_counter() - ts) * 1e3, **m})
        losses.append(m["loss"] if "loss" in m else m["l_org"])
        if log_every and (i + 1) % log_every == 0:
            print(f"step {i+1}: loss {losses[-1]:.4f} "
                  f"({(time.time()-t0)/(i+1):.2f}s/step)")
    if ckpt:
        save_ckpt(ckpt, params, step=steps)
        print(f"saved {ckpt}")
    if return_losses:
        return params, losses
    return params


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--variant", default="smoke")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-2)
    ap.add_argument("--expensive", default=None,
                    help="train with the LtC loss against this frozen arch")
    ap.add_argument("--ltc-w", type=float, default=1.0)
    ap.add_argument("--cost-c", type=float, default=0.5)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions of the kernels)")
    args = ap.parse_args()
    run(args.arch, variant=args.variant, steps=args.steps, batch=args.batch,
        seq=args.seq, lr=args.lr, expensive=args.expensive, ltc_w=args.ltc_w,
        cost_c=args.cost_c, ckpt=args.ckpt, device=args.device)


if __name__ == "__main__":
    main()
