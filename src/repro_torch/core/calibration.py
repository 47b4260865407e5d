"""Confidence-calibration baselines the paper compares against (§5);
the torch twin of ``repro/core/calibration.py``.

* Baseline           — raw max softmax probability (no calibration).
* TemperatureScaling — Guo et al. 2017: one scalar T fit by NLL on the
  validation split.
* ConfNet / IDK      — auxiliary confidence heads (one hidden layer on
  the fast model's features).  ConfNet predicts the fast model's
  correctness (BCE); IDK optimizes the oracle-expensive cascade
  objective.  Their losses live in ``repro_torch.core.losses``; here are
  the head and the post-hoc fitting loops (plain Adam, written out as
  the JAX package writes it, not ``torch.optim``).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core import losses
from repro_torch.core.thresholds import linspace


# --------------------------------------------------------------------------
# Temperature scaling
# --------------------------------------------------------------------------


def fit_temperature(logits, labels, *, steps: int = 200, lr: float = 0.01):
    """Fit T minimizing NLL(logits/T, labels) by gradient descent on
    log T."""
    logits = logits.detach()
    log_t = torch.zeros((), device=logits.device)
    for _ in range(steps):
        log_t.requires_grad_(True)
        nll = losses.cross_entropy(logits / torch.exp(log_t), labels)
        (grad,) = torch.autograd.grad(nll, log_t)
        log_t = (log_t - lr * grad).detach()
    return float(torch.exp(log_t))


# --------------------------------------------------------------------------
# Auxiliary confidence head (ConfNet / IDK)
# --------------------------------------------------------------------------


class ConfHead(NamedTuple):
    w1: torch.Tensor
    b1: torch.Tensor
    w2: torch.Tensor
    b2: torch.Tensor


def init_conf_head(gen: torch.Generator, feat_dim: int, hidden: int = 64,
                   device="cuda") -> ConfHead:
    """The JAX package's init rule, drawn from ``gen`` (a CPU
    ``torch.Generator``; the draws differ from ``jax.random``'s)."""
    w1 = torch.randn(feat_dim, hidden, generator=gen) / math.sqrt(feat_dim)
    w2 = torch.randn(hidden, 1, generator=gen) / math.sqrt(hidden)
    return ConfHead(w1.to(device), torch.zeros(hidden, device=device),
                    w2.to(device), torch.zeros(1, device=device))


def conf_head_apply(head: ConfHead, feats) -> torch.Tensor:
    h = torch.relu(feats @ head.w1 + head.b1)
    return torch.sigmoid((h @ head.w2 + head.b2)[..., 0])


def fit_conf_head(gen: torch.Generator, feats, fast_logits, labels, *,
                  kind: str = "confnet", cost_c: float = 0.5,
                  steps: int = 500, lr: float = 1e-2, hidden: int = 64):
    """Post-hoc training of the auxiliary head on held-out features,
    from a head drawn by :func:`init_conf_head` on ``gen``.

    kind: 'confnet' (BCE to self-correctness) | 'idk' (oracle cascade
    objective)."""
    head = init_conf_head(gen, feats.shape[-1], hidden, feats.device)
    # the (frozen) fast model's correctness is a constant of the fit
    target = losses.correct(fast_logits, labels)
    fast_wrong = 1.0 - target

    def loss_fn(h):
        conf = conf_head_apply(h, feats)
        p = conf.clamp(1e-6, 1 - 1e-6)
        if kind == "confnet":
            return -(target * torch.log(p)
                     + (1 - target) * torch.log(1 - p)).mean()
        return (conf * fast_wrong + (1.0 - conf) * cost_c).mean()

    m = [torch.zeros_like(a) for a in head]
    v = [torch.zeros_like(a) for a in head]
    for t in range(1, steps + 1):
        leaves = [a.detach().requires_grad_(True) for a in head]
        grad = torch.autograd.grad(loss_fn(ConfHead(*leaves)), leaves)
        m = [0.9 * a + 0.1 * b for a, b in zip(m, grad)]
        v = [0.999 * a + 0.001 * b * b for a, b in zip(v, grad)]
        mh = [a / (1 - 0.9 ** t) for a in m]
        vh = [a / (1 - 0.999 ** t) for a in v]
        head = ConfHead(*(p.detach() - lr * a / (torch.sqrt(b) + 1e-8)
                          for p, a, b in zip(head, mh, vh)))
    return head


# --------------------------------------------------------------------------
# Metrics
# --------------------------------------------------------------------------


def ece(confs, corrects, bins: int = 15) -> float:
    """Expected Calibration Error (Guo et al. 2017).  Bin i holds the
    confidences in ``(edge_i, edge_{i+1}]`` of :func:`linspace` edges, so
    a confidence of exactly 0 falls in no bin."""
    confs = torch.as_tensor(confs)
    corrects = torch.as_tensor(corrects, dtype=torch.float32,
                               device=confs.device)
    edges = linspace(bins + 1, confs.device)
    total = confs.shape[0]
    zero = torch.zeros((), dtype=confs.dtype, device=confs.device)
    err = torch.zeros((), device=confs.device)
    for i in range(bins):
        in_bin = (confs > edges[i]) & (confs <= edges[i + 1])
        n = in_bin.sum()
        if n == 0:
            continue
        avg_conf = torch.where(in_bin, confs, zero).sum() / n
        avg_acc = torch.where(in_bin, corrects, 0.0).sum() / n
        err = err + n / total * (avg_conf - avg_acc).abs()
    return float(err)
