"""Optimizers over parameter trees (the torch twin of
``repro/optim/optimizer.py``; functional, no ``torch.optim``).

API::

    opt = sgd_momentum(momentum=0.9, weight_decay=5e-4)
    state = opt.init(params)
    params, state = opt.update(params, grads, state, lr)

``params`` and ``grads`` are trees of tensors (dicts, lists, tuples);
``update`` returns new tensors and never writes the ones it is given.
The math is the JAX package's, not ``torch.optim``'s defaults: SGD adds
the weight decay to the gradient before the momentum, AdamW decays
decoupled (``p - lr·(m̂/(√v̂+eps) + wd·p)``), and Adafactor (factored
second moment, no momentum) factors every leaf of rank >= 2 — ``vr``
drops the last dim, ``vc`` the second-to-last, so a ``[E, d, f]`` expert
stack keeps per-expert statistics — and ends with the RMS clip.  Every
state holds its ``step`` as an int32 scalar tensor.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.models.params import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable   # (params, grads, state, lr) -> (params, state)
    name: str


def _step0(params):
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return torch.zeros((), dtype=torch.int32, device=dev)


def sgd_momentum(momentum: float = 0.9, weight_decay: float = 0.0,
                 nesterov: bool = False) -> Optimizer:
    def init(params):
        return {"mu": tree_map(torch.zeros_like, params),
                "step": _step0(params)}

    def update(params, grads, state, lr):
        if weight_decay:
            grads = tree_map(lambda g, p: g + weight_decay * p, grads,
                             params)
        mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
        if nesterov:
            step_dir = tree_map(lambda m, g: momentum * m + g, mu, grads)
        else:
            step_dir = mu
        params = tree_map(lambda p, d: (p - lr * d).to(p.dtype), params,
                          step_dir)
        return params, {"mu": mu, "step": state["step"] + 1}

    return Optimizer(init, update, "sgd_momentum")


def adamw(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return {"m": tree_map(torch.zeros_like, params),
                "v": tree_map(torch.zeros_like, params),
                "step": _step0(params)}

    def update(params, grads, state, lr):
        t = state["step"] + 1
        m = tree_map(lambda a, g: b1 * a + (1 - b1) * g, state["m"], grads)
        v = tree_map(lambda a, g: b2 * a + (1 - b2) * g * g, state["v"],
                     grads)
        c1 = 1 - b1 ** t.float()
        c2 = 1 - b2 ** t.float()

        def upd(p, mm, vv):
            step_dir = (mm / c1) / (torch.sqrt(vv / c2) + eps)
            return (p - lr * (step_dir + weight_decay * p)).to(p.dtype)

        return tree_map(upd, params, m, v), {"m": m, "v": v, "step": t}

    return Optimizer(init, update, "adamw")


def adafactor(eps: float = 1e-30, clip_threshold: float = 1.0,
              decay: float = 0.8) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern 2018), no
    momentum: a leaf of rank >= 2 stores row and column statistics only
    (O(n + m) per (n, m) matrix)."""

    def init(params):
        def leaf(p):
            f32 = dict(dtype=torch.float32, device=p.device)
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], **f32),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          **f32)}
            return {"v": torch.zeros(p.shape, **f32)}
        return {"v": tree_map(leaf, params), "step": _step0(params)}

    def update(params, grads, state, lr):
        t = state["step"] + 1
        beta = 1.0 - (t.float() + 1.0) ** -decay

        def upd(p, g, s):
            g32 = g.float()
            g2 = g32 * g32 + eps
            if p.dim() >= 2:
                vr = beta * s["vr"] + (1 - beta) * g2.mean(dim=-1)
                vc = beta * s["vc"] + (1 - beta) * g2.mean(dim=-2)
                denom = vr.mean(dim=-1, keepdim=True)
                precond = (vr[..., None] / denom[..., None].clamp_min(eps)) \
                    * vc[..., None, :]
                u = g32 * torch.rsqrt(precond.clamp_min(eps))
                ns = {"vr": vr, "vc": vc}
            else:
                v = beta * s["v"] + (1 - beta) * g2
                u = g32 * torch.rsqrt(v.clamp_min(eps))
                ns = {"v": v}
            rms = torch.sqrt((u * u).mean())
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            return (p.float() - lr * u).to(p.dtype), ns

        states = []

        def step_leaf(p, g, s):
            new, ns = upd(p, g, s)
            states.append(ns)
            return new

        new_p = tree_map(step_leaf, params, grads, state["v"])
        it = iter(states)      # tree_map visits the leaves in one order
        return new_p, {"v": tree_map(lambda _: next(it), params),
                       "step": t}

    return Optimizer(init, update, "adafactor")


def get_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd_momentum, "sgd_momentum": sgd_momentum,
            "adamw": adamw, "adafactor": adafactor}[name](**kw)


# ---- learning-rate schedules ----------------------------------------------


def step_decay(base: float, boundaries, factor: float):
    """The paper's schedule: lr *= factor at each boundary (epochs or
    steps)."""
    def lr(step):
        return base * factor ** sum(int(step >= b) for b in boundaries)

    return lr


def cosine(base: float, total_steps: int, warmup: int = 0,
           min_ratio: float = 0.1):
    """Linear warm-up to ``base``, then a cosine down to
    ``min_ratio·base`` at ``total_steps``; an f32 scalar tensor."""
    def lr(step):
        step = torch.as_tensor(step, dtype=torch.float32)
        warm = base * step / max(warmup, 1)
        t = ((step - warmup) / max(total_steps - warmup, 1)).clamp(0, 1)
        cos = base * (min_ratio + (1 - min_ratio) * 0.5
                      * (1 + torch.cos(math.pi * t)))
        return torch.where(step < warmup, warm, cos)

    return lr
