"""Optimizers over parameter trees (the torch twin of
``repro/optim/optimizer.py``; functional, no ``torch.optim``).

API::

    opt = sgd_momentum(momentum=0.9, weight_decay=5e-4)
    state = opt.init(params)
    params, state = opt.update(params, grads, state, lr)

``params`` and ``grads`` are trees of tensors (dicts, lists, tuples);
``update`` returns new tensors and never writes the ones it is given.

``opt.update_sharded(params, grads, state, lr, specs, sizes=None)`` is
the update of trees placed on a mesh (``params[e][j]`` grid device ``(e,
j)``'s slices by ``specs``, :mod:`repro_torch.launch.mesh`; ``sizes`` the
mesh's axis sizes, default the grid's ``(data, model)``): each device
steps its own slice of each leaf and its own replica of ``"step"``, with
the gradients already summed over each leaf's replicas
(``mesh.sync_grads``).  SGD and AdamW act elementwise; every
reduction Adafactor takes over a leaf (``vr``'s mean over the last dim,
``vc``'s over the second-to-last, ``denom`` and the RMS clip) is summed
over the devices whose slices split the reduced dims, so each slice
steps as the whole leaf would.
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

from repro_torch.launch.mesh import (group_sum, grid_of, map_leaves,
                                     spec_axes)
from repro_torch.models.params import tree_leaves, tree_map


class Optimizer(NamedTuple):
    init: Callable
    update: Callable   # (params, grads, state, lr) -> (params, state)
    name: str
    # (placed params, grads, state, lr, specs) -> (params, state)
    update_sharded: Callable = None


def _elementwise_sharded(update):
    """The sharded update of an elementwise optimizer: each device's
    ``update`` of its own slices."""
    def update_sharded(params, grads, state, lr, specs, sizes=None):
        out = [[update(p, g, s, lr) for p, g, s in zip(*rows)]
               for rows in zip(params, grads, state)]
        return ([[o[0] for o in row] for row in out],
                [[o[1] for o in row] for row in out])
    return update_sharded


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

    return Optimizer(init, update, "sgd_momentum",
                     _elementwise_sharded(update))


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

    return Optimizer(init, update, "adamw", _elementwise_sharded(update))


def _mean_whole(xs, dim, axes, keepdim=False):
    """The mean of each of ``xs`` (one whole leaf) over ``dim`` (None:
    every dim); ``axes`` is not read."""
    return [x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
            for x in xs]


def _mean_placed(sizes: dict):
    """The mean over ``dim`` of the whole leaf whose slices ``xs`` (one a
    grid device of a mesh of ``sizes``, row-major) are, at each slice:
    local sums added over the devices that split the reduced dims
    (``axes``, the spec entries on them; :func:`group_sum`) over the
    whole leaf's count; a plain mean where no axis splits them."""
    M = sizes["model"]

    def mean(xs, dim, axes, keepdim=False):
        axes = {a for entry in axes for a in spec_axes(entry)}
        if not axes:
            return _mean_whole(xs, dim, axes, keepdim)
        dims = tuple(range(xs[0].dim())) if dim is None else (dim,)
        count = 1
        for t_dim in dims:
            count *= xs[0].shape[t_dim]
        for a in axes:
            count *= sizes[a]
        parts = [[x.sum(dim=dims, keepdim=keepdim) for x in xs[r:r + M]]
                 for r in range(0, len(xs), M)]
        return [t / count for row in group_sum(parts, axes, sizes)
                for t in row]
    return mean


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

    def upd(ps, gs, ss, betas, lr, spec, mean):
        """One leaf's step over its slices ``ps`` (their gradients
        ``gs``, states ``ss`` and steps' ``betas``; one whole leaf
        unsharded): ``mean(xs, dim, axes)`` is the whole leaf's mean
        over ``dim`` at each slice, ``axes`` the mesh axes of ``spec``
        on the reduced dims."""
        g32 = [g.float() for g in gs]
        g2 = [g * g + eps for g in g32]
        if ps[0].dim() >= 2:
            vr = [b * s["vr"] + (1 - b) * r for b, s, r in
                  zip(betas, ss, mean(g2, -1, {spec[-1]}))]
            vc = [b * s["vc"] + (1 - b) * c for b, s, c in
                  zip(betas, ss, mean(g2, -2, {spec[-2]}))]
            denom = mean(vr, -1, {spec[-2]}, keepdim=True)
            us = [g * torch.rsqrt(((r[..., None] / dn[..., None].clamp_min(
                eps)) * c[..., None, :]).clamp_min(eps))
                for g, r, c, dn in zip(g32, vr, vc, denom)]
            ns = [{"vr": r, "vc": c} for r, c in zip(vr, vc)]
        else:
            v = [b * s["v"] + (1 - b) * g for b, s, g in zip(betas, ss, g2)]
            us = [g * torch.rsqrt(vv.clamp_min(eps)) for g, vv in zip(g32, v)]
            ns = [{"v": vv} for vv in v]
        rms = [torch.sqrt(r) for r in mean([u * u for u in us], None,
                                           set(spec))]
        us = [u / torch.clamp_min(r / clip_threshold, 1.0)
              for u, r in zip(us, rms)]
        return [(p.float() - lr * u).to(p.dtype) for p, u in zip(ps, us)], ns

    def _beta(state):
        t = state["step"] + 1
        return t, 1.0 - (t.float() + 1.0) ** -decay

    def update(params, grads, state, lr):
        t, beta = _beta(state)
        states = []

        def step_leaf(p, g, s):
            new, ns = upd([p], [g], [s], [beta], lr, (None,) * p.dim(),
                          _mean_whole)
            states.append(ns[0])
            return new[0]

        new_p = tree_map(step_leaf, params, grads, state["v"])
        it = iter(states)      # tree_map visits the leaves in one order
        return new_p, {"v": tree_map(lambda _: next(it), params),
                       "step": t}

    def update_sharded(params, grads, state, lr, specs, sizes=None):
        M = len(params[0])
        steps = [[_beta(s) for s in row] for row in state]
        betas = [b for row in steps for _, b in row]
        mean = _mean_placed(sizes or {"data": len(params), "model": M})

        def flat(grid):
            return [t for row in grid for t in row]

        def regrid(xs):
            return [xs[r:r + M] for r in range(0, len(xs), M)]

        def leaf(spec, ps, gs, ss):
            new, ns = upd(flat(ps), flat(gs), flat(ss), betas, lr, spec,
                          mean)
            return regrid(new), regrid(ns)
        out = map_leaves(leaf, specs, params, grads,
                         [[s["v"] for s in row] for row in state])
        new_v = grid_of(params, [o[1] for o in out])
        return (grid_of(params, [o[0] for o in out]),
                [[{"v": v, "step": t} for v, (t, _) in zip(vr, sr)]
                 for vr, sr in zip(new_v, steps)])

    return Optimizer(init, update, "adafactor", update_sharded)


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
