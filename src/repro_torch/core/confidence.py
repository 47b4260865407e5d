"""Confidence scores (torch twin of ``repro/core/confidence.py``).

The paper uses the maximum softmax probability of the fast model as the
confidence score ``conf`` (§3, §4); the standard alternatives are here
as well.  Every function takes logits ``[..., K]`` and reduces the last
dim.
"""
from __future__ import annotations

import math

import torch


def max_prob(logits, temperature: float = 1.0):
    """Maximum softmax probability — the paper's conf (Eq 3)."""
    return torch.softmax(logits / temperature, dim=-1).amax(dim=-1)


def entropy(logits, temperature: float = 1.0):
    """Shannon entropy of the predictive distribution (nats)."""
    logp = torch.log_softmax(logits / temperature, dim=-1)
    return -(logp.exp() * logp).sum(dim=-1)


def entropy_confidence(logits, temperature: float = 1.0):
    """1 - H/log(K): entropy mapped to a [0,1] confidence."""
    k = logits.shape[-1]
    return 1.0 - entropy(logits, temperature) / math.log(k)


def margin(logits, temperature: float = 1.0):
    """Top-1 minus top-2 softmax probability."""
    p = torch.softmax(logits / temperature, dim=-1)
    top2 = torch.topk(p, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def sequence_confidence(token_conf, mask=None, reduce: str = "mean"):
    """Aggregate per-token confidences to a per-sequence score.

    A sequence is escalated when its aggregate confidence falls below δ.
    reduce: 'mean' | 'min' | 'prod'.
    """
    if mask is None:
        mask = torch.ones_like(token_conf)
    mask = mask.to(token_conf.dtype)
    if reduce == "mean":
        return (token_conf * mask).sum(-1) / mask.sum(-1).clamp_min(1)
    if reduce == "min":
        big = torch.where(mask > 0, token_conf,
                          torch.full_like(token_conf, math.inf))
        return big.amin(dim=-1)
    if reduce == "prod":
        logc = torch.where(mask > 0, token_conf.clamp(1e-9, 1.0).log(),
                           torch.zeros_like(token_conf))
        return logc.sum(dim=-1).exp()
    raise ValueError(reduce)


SCORES = {
    "max_prob": max_prob,
    "entropy": entropy_confidence,
    "margin": margin,
}


def score(logits, kind: str = "max_prob", temperature: float = 1.0):
    """The confidence named ``kind`` (``max_prob``, ``entropy`` or
    ``margin``), differentiable in the logits."""
    return SCORES[kind](logits, temperature)
