"""Loss functions: the paper's contribution (Eqs 3–6) and the substrate
(the torch twin of ``repro/core/losses.py``).

``cascade_loss`` is Eq 3:

    L_casc = mean( conf · 1[y != argmax fast]
                 + (1-conf) · (1[y != argmax exp] + C) )

``conf`` is the fast model's max softmax probability (differentiable);
the correctness indicators are constants for the fast model's
parameters and are detached, as the JAX package stop-gradients them.

The label's logit is a gather where the JAX package contracts a one-hot
row: the same value, except that a label outside ``[0, K)`` has a zero
one-hot row there, so its NLL is ``lse`` — here too, not an index error.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import confidence as C


def _label_logit(x, labels):
    """x [..., K] at ``labels`` [...]; 0 where a label lies outside
    [0, K) (the JAX package's zero one-hot row)."""
    k = x.shape[-1]
    labels = labels.long()
    inside = (labels >= 0) & (labels < k)
    got = x.gather(-1, labels.clamp(0, k - 1)[..., None])[..., 0]
    return torch.where(inside, got, torch.zeros_like(got))


def _masked_mean(per, mask):
    if mask is None:
        return per.mean()
    m = mask.float()
    return (per * m).sum() / m.sum().clamp_min(1.0)


def cross_entropy(logits, labels, mask=None, label_smoothing: float = 0.0):
    """Mean softmax cross-entropy.  labels: int [...]; logits [..., K]."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    nll = lse - _label_logit(x, labels)
    if label_smoothing:
        uniform = lse - x.mean(dim=-1)
        nll = (1 - label_smoothing) * nll + label_smoothing * uniform
    return _masked_mean(nll, mask)


def _chunk_nll(h, proj, labels, mask):
    x = (h @ proj).float()
    nll = torch.logsumexp(x, dim=-1) - _label_logit(x, labels)
    return (nll * mask).sum(), mask.sum()


def chunked_lm_loss(hidden, proj, labels, chunk: int = 512, mask=None):
    """Next-token CE computed chunk by chunk along the sequence, never
    holding the full ``[B, S, V]`` logits.

    hidden [B, S, D] (final-norm output), proj [D, V] (LM head or
    ``embed.T``), labels [B, S].  ``S`` is padded to a multiple of
    ``chunk`` (padding masked out), as the JAX package pads; each chunk's
    ``[B, chunk, V]`` logits are recomputed in backward
    (``torch.utils.checkpoint``), as its scan body is ``jax.checkpoint``ed.
    """
    B, S, _ = hidden.shape
    if mask is None:
        mask = torch.ones(B, S, dtype=torch.float32, device=hidden.device)
    pad = (-S) % chunk
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask.float(), (0, pad))
        S += pad
    mask = mask.float()
    tot = torch.zeros((), device=hidden.device)
    cnt = torch.zeros((), device=hidden.device)
    for s in range(0, S, chunk):
        t, c = checkpoint(_chunk_nll, hidden[:, s:s + chunk], proj,
                          labels[:, s:s + chunk], mask[:, s:s + chunk],
                          use_reentrant=False, preserve_rng_state=False)
        tot, cnt = tot + t, cnt + c
    return tot / cnt.clamp_min(1.0)


def correct(logits, labels):
    """1[argmax(logits) == label], float32, detached."""
    return (logits.argmax(dim=-1) == labels).float().detach()


def cascade_loss(fast_logits, exp_logits, labels, cost_c: float = 0.5,
                 mask=None, conf_kind: str = "max_prob"):
    """Eq 3 of the paper.  Shapes: logits [..., K], labels [...]."""
    conf = C.score(fast_logits, conf_kind)
    fast_wrong = 1.0 - correct(fast_logits, labels)
    exp_wrong = 1.0 - correct(exp_logits, labels)
    per = conf * fast_wrong + (1.0 - conf) * (exp_wrong + cost_c)
    return _masked_mean(per, mask)


def ltc_loss(fast_logits, exp_logits, labels, *, w: float = 1.0,
             cost_c: float = 0.5, mask=None, label_smoothing: float = 0.0):
    """Eq 4: L = L_org + w·L_casc.  Returns (loss, metrics-dict)."""
    l_org = cross_entropy(fast_logits, labels, mask, label_smoothing)
    l_casc = cascade_loss(fast_logits, exp_logits, labels, cost_c, mask)
    return l_org + w * l_casc, {"l_org": l_org, "l_casc": l_casc}


def ltc_chain_loss(logits_chain: Sequence, labels, *, w: float = 1.0,
                   cost_c: float = 0.5, mask=None):
    """Eq 6 (model splitting): the joint loss over M exits trained
    together, ``logits_chain`` sorted fast -> expensive:

        L = Σ_{m<M} { L_org^(m) + w·L_casc^(m,m+1) } + L_org^(M)
    """
    total = cross_entropy(logits_chain[-1], labels, mask)
    metrics = {}
    for m in range(len(logits_chain) - 1):
        l_org = cross_entropy(logits_chain[m], labels, mask)
        l_casc = cascade_loss(logits_chain[m], logits_chain[m + 1].detach(),
                              labels, cost_c, mask)
        total = total + l_org + w * l_casc
        metrics[f"l_org_{m}"] = l_org
        metrics[f"l_casc_{m}"] = l_casc
    return total, metrics


def moe_aux_loss(aux, lb_coef: float = 0.01, z_coef: float = 1e-3):
    """Router load-balance + z-loss accumulated by the MoE blocks."""
    return lb_coef * aux.get("lb_loss", 0.0) + z_coef * aux.get("z_loss", 0.0)


# ---- auxiliary-head losses for the comparison baselines -------------------


def confnet_loss(conf_pred, fast_logits, labels, mask=None):
    """ConfNet (Wan et al. 2018): BCE of an auxiliary confidence head
    against the fast model's own correctness — calibration to *self*."""
    target = correct(fast_logits, labels)
    p = conf_pred.clamp(1e-6, 1 - 1e-6)
    per = -(target * torch.log(p) + (1 - target) * torch.log(1 - p))
    return _masked_mean(per, mask)


def idk_loss(conf_pred, fast_logits, labels, cost_c: float = 0.5, mask=None):
    """IDK Cascades (Wang et al. 2018): an auxiliary head optimizing the
    cascade objective under an *oracle* expensive model (no exp-wrong
    term — the difference from LtC the paper's discussion highlights)."""
    fast_wrong = 1.0 - correct(fast_logits, labels)
    per = conf_pred * fast_wrong + (1.0 - conf_pred) * cost_c
    return _masked_mean(per, mask)
