"""δ selection on the validation split (paper §5: 'We used a set of
validation images to search for the δ with the highest cascade
accuracy'); the torch twin of ``repro/core/thresholds.py``.

* :func:`best_accuracy_delta` — the paper's: δ* = argmax Acc^casc(δ)
  (ties broken toward lower cost).
* :func:`min_cost_delta` — the §3 optimization problem: minimize cost
  subject to Acc^casc >= (1-ε)·Acc_target.

The δ grid is :func:`linspace`, bit for bit the JAX package's
``jnp.linspace(0, 1, num)``: ``torch.linspace`` differs from it in 39 of
201 f32 entries, and moving one grid point can move a confidence across
δ.
"""
from __future__ import annotations

import torch

from repro_torch.core.cascade import evaluate_cascade


def linspace(num: int, device=None):
    """f32 ``[0, 1]`` grid of ``num`` points equal to
    ``jnp.linspace(0.0, 1.0, num)``: ``i · f32(1/(num-1))`` in f32, the
    last point 1."""
    if num == 1:
        return torch.zeros(1, dtype=torch.float32, device=device)
    step = torch.tensor(1.0 / (num - 1), dtype=torch.float32, device=device)
    grid = torch.arange(num, dtype=torch.float32, device=device) * step
    grid[-1] = 1.0
    return grid


def _sweep(conf, fast_correct, exp_correct, costs, num: int = 201):
    conf = torch.as_tensor(conf, dtype=torch.float32)
    deltas = linspace(num, conf.device)
    corrects = torch.stack([torch.as_tensor(c, dtype=torch.float32,
                                            device=conf.device)
                            for c in (fast_correct, exp_correct)])
    return deltas, evaluate_cascade(conf[None, :], corrects, costs,
                                    deltas[:, None])


def best_accuracy_delta(conf, fast_correct, exp_correct, costs, num=201):
    """The paper's policy.  Returns (delta, acc, cost)."""
    deltas, out = _sweep(conf, fast_correct, exp_correct, costs, num)
    acc, cost = out["acc"], out["cost"]
    # lexicographic: max acc, then min cost
    score = acc - 1e-9 * cost / cost.max().clamp_min(1e-9)
    i = int(score.argmax())
    return float(deltas[i]), float(acc[i]), float(cost[i])


def min_cost_delta(conf, fast_correct, exp_correct, costs, acc_target,
                   eps: float = 0.0, num=201):
    """§3 objective: min N^exp s.t. Acc^casc >= (1-eps)·acc_target.
    Falls back to the best-accuracy δ if the constraint is infeasible.
    Returns (delta, acc, cost, feasible)."""
    deltas, out = _sweep(conf, fast_correct, exp_correct, costs, num)
    acc, cost = out["acc"], out["cost"]
    ok = acc >= (1.0 - eps) * acc_target
    feasible = bool(ok.any())
    if not feasible:
        i = int(acc.argmax())
    else:
        i = int(torch.where(ok, cost, torch.full_like(cost, float("inf")))
                .argmin())
    return float(deltas[i]), float(acc[i]), float(cost[i]), feasible
