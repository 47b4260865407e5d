"""Cascade inference executor and metrics, paper §3, Eqs 1, 2, 7 (the
torch twin of ``repro/core/cascade.py``).

* Offline evaluation: with every member's predictions on a dataset,
  :func:`evaluate_cascade` computes Acc^casc, N^exp and MACs^casc for a
  δ or a sweep of δs without running the models again (the paper
  collects predictions once and sweeps δ on the validation split).
* Online: :class:`CascadeExecutor` routes a live batch through member
  predict functions, with every member run on the whole batch and only
  the escalated rows accounted.

A sample stops at gate m only when ``conf > δ_m``: a confidence equal to
δ escalates.  Accuracy and cost are f32, as in the JAX package, and a
mean over the N samples is their sum times ``f32(1/N)``, as XLA computes
``jnp.mean`` (the sum of a 0/1 vector is exact; its division by N would
differ from that product in the last bit).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence

import torch

from repro_torch.core import confidence as C


@dataclass(frozen=True)
class Member:
    """One cascade element.  cost = MACs (or FLOPs) per sample."""
    name: str
    cost: float
    predict: Optional[Callable] = None   # batch -> logits (online mode)


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def evaluate_cascade(confs, corrects, costs, deltas):
    """Generic M-element cascade evaluation.

    confs:    [M-1, N] confidence of members 0..M-2 (the last member has no
              gate).
    corrects: [M, N]  1/0 correctness of each member's prediction.
    costs:    [M]     per-sample cost of each member.
    deltas:   [M-1] or [D, M-1] thresholds (one row per point of a sweep).

    Returns a dict of f32 tensors: acc [D], cost [D], frac_used [D, M]
    (the fraction of samples that *ran* each member), n_exp [D, M-1]
    (Eq 1 per gate).  The sweep is a broadcast over D (the JAX package
    vmaps one δ row)."""
    corrects = _f32(corrects)
    dev = corrects.device
    confs = _f32(confs, dev)
    costs = _f32(costs, dev)
    deltas = _f32(deltas, dev)
    if deltas.dim() < 2:
        deltas = deltas.reshape(1, -1)
    M, N = corrects.shape
    D = deltas.shape[0]
    inv_n = torch.tensor(1.0 / N, dtype=torch.float32, device=dev)
    active = torch.ones(D, N, device=dev)        # sample still cascading
    acc = torch.zeros(D, N, device=dev)
    total_cost = torch.zeros(D, device=dev)
    frac_used, n_exp = [], []
    for m in range(M):
        used = active.sum(1) * inv_n
        frac_used.append(used)
        total_cost = total_cost + used * costs[m]
        if m < M - 1:
            stop = active * (confs[m][None, :] > deltas[:, m:m + 1]).float()
            escalate = active - stop
            n_exp.append(escalate.sum(1))
            acc = acc + stop * corrects[m]
            active = escalate
        else:
            acc = acc + active * corrects[m]
    return {"acc": acc.sum(1) * inv_n, "cost": total_cost,
            "frac_used": torch.stack(frac_used, 1),
            "n_exp": (torch.stack(n_exp, 1) if n_exp
                      else torch.zeros(D, 0, device=dev))}


def two_element_metrics(conf, fast_correct, exp_correct, macs_fast,
                        macs_exp, delta):
    """The paper's two-element case: (Acc^casc, MACs^casc, N^exp) per
    Eqs 2, 7, 1, scalars for a scalar δ, else one per δ."""
    conf = _f32(conf)
    delta = _f32(delta, conf.device)
    out = evaluate_cascade(conf[None, :],
                           torch.stack([_f32(fast_correct, conf.device),
                                        _f32(exp_correct, conf.device)]),
                           [macs_fast, macs_exp], delta.reshape(-1, 1))
    sq = (lambda x: x[0]) if delta.dim() == 0 else (lambda x: x)
    return sq(out["acc"]), sq(out["cost"]), sq(out["n_exp"][:, 0])


class CascadeExecutor:
    """Run a live cascade over members with per-gate thresholds.

    Every member's ``predict`` runs on the whole batch, and only the
    escalated rows are accounted; the escalation masks come back so a
    serving layer can pack them (``repro_torch.launch.serve`` packs)."""

    def __init__(self, members: Sequence[Member], deltas: Sequence[float],
                 conf_kind: str = "max_prob"):
        if len(deltas) != len(members) - 1:
            raise ValueError("one δ per non-final member")
        self.members = tuple(members)
        self.deltas = tuple(float(d) for d in deltas)
        self.conf_kind = conf_kind

    def __call__(self, batch):
        """Returns (predictions [B], info dict)."""
        logits0 = self.members[0].predict(batch)
        preds = logits0.argmax(-1)
        active = torch.ones(preds.shape, device=preds.device)
        cost = torch.full(preds.shape, float(self.members[0].cost),
                          device=preds.device)
        escalations = []
        for m, member in enumerate(self.members[1:]):
            conf = C.score(logits0, self.conf_kind)
            esc = active * (conf <= self.deltas[m]).float()
            escalations.append(esc)
            logits1 = member.predict(batch)
            preds = torch.where(esc > 0, logits1.argmax(-1), preds)
            cost = cost + esc * member.cost
            active = esc
            logits0 = logits1
        return preds, {"cost": cost, "escalated": escalations}
