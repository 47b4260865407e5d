"""Classifier zoo for the paper's experiments (Tables 1–6, Figs 3–5);
the torch twin of ``repro/models/classifier.py``.

A family of residual MLP classifiers on the synthetic tasks whose
analytic MACs and capacities mirror the ordering of (MobileNetV2, VGG11,
AlexNet, ResNet18, ResNet152) in Table 1 — a shallow-but-wide member
with poor cost/accuracy (AlexNet's role), compact members, and deep
expensive members that are more accurate — and the early-exit stack
(the MSDNet stand-in for Fig 3): one backbone with exit heads after
chosen depths, trained jointly (Eq 6).

Training is SGD with momentum (the paper's optimizer) at a step-decayed
rate, on the tensors' device.  Initial weights and the batch order come
from CPU ``torch.Generator``s seeded from ``seed`` (the order's also
from a CRC-32 of the member's name), never from Python's ``hash``,
which changes from process to process: the JAX package seeds its order
with ``hash(cfg.name)``, so its own runs differ between processes.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Tuple

import torch

from repro_torch.core import losses
from repro_torch.models.params import tree_leaves, tree_map, value_and_grad
from repro_torch.optim import get_optimizer


def clip_by_global_norm(grads, max_norm: float):
    leaves = tree_leaves(grads)
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in leaves))
    scale = torch.clamp_max(max_norm / norm.clamp_min(1e-9), 1.0)
    return tree_map(lambda g: g * scale, grads)


@dataclass(frozen=True)
class MLPConfig:
    name: str
    width: int                        # residual trunk width
    depth: int                        # number of residual blocks
    num_classes: int
    in_dim: int

    @property
    def macs(self) -> int:
        # stem + depth residual blocks (2 matmuls each) + head
        return (self.in_dim * self.width
                + self.depth * 2 * self.width * self.width
                + self.width * self.num_classes)


def zoo(in_dim: int, num_classes: int) -> dict:
    """The five paper roles.  MACs ordering mirrors Table 1
    (mobilenet < vgg < alexnet < resnet18 << resnet152) and the AlexNet
    member is wide-but-shallow: costly without matching accuracy."""
    return {
        "mobilenetv2": MLPConfig("mobilenetv2", 64, 2, num_classes, in_dim),
        "vgg11": MLPConfig("vgg11", 96, 3, num_classes, in_dim),
        "alexnet": MLPConfig("alexnet", 160, 1, num_classes, in_dim),
        "resnet18": MLPConfig("resnet18", 128, 6, num_classes, in_dim),
        "resnet152": MLPConfig("resnet152", 224, 12, num_classes, in_dim),
    }


def _normal(gen, shape, scale, device):
    return (torch.randn(shape, generator=gen) * scale).to(device)


def init_mlp(cfg: MLPConfig, gen: torch.Generator, device="cuda"):
    """The JAX package's init rule, drawn from ``gen`` (CPU)."""
    z = lambda n: torch.zeros(n, device=device)        # noqa: E731
    w = cfg.width
    params = {"stem": {"w": _normal(gen, (cfg.in_dim, w),
                                    math.sqrt(2.0 / cfg.in_dim), device),
                       "b": z(w)},
              "blocks": []}
    for _ in range(cfg.depth):
        params["blocks"].append({
            "w1": _normal(gen, (w, w), math.sqrt(2.0 / w), device),
            "b1": z(w),
            # small init: near-identity blocks
            "w2": _normal(gen, (w, w), math.sqrt(0.5 / w), device),
            "b2": z(w),
        })
    params["head"] = {"w": _normal(gen, (w, cfg.num_classes),
                                   1 / math.sqrt(w), device),
                      "b": z(cfg.num_classes)}
    return params


def init_train_head(width: int, gen: torch.Generator, device="cuda"):
    """The confidence head :func:`train_classifier` trains beside the
    MLP (ConfNet / IDK): a hidden layer of 64, the output layer zero."""
    return {"w1": _normal(gen, (width, 64), 1 / math.sqrt(width), device),
            "b1": torch.zeros(64, device=device),
            "w2": torch.zeros(64, 1, device=device),
            "b2": torch.zeros(1, device=device)}


def _lnorm(h):
    m = h.mean(-1, keepdim=True)
    v = h.var(-1, keepdim=True, unbiased=False)   # jnp.var: population
    return (h - m) * torch.rsqrt(v + 1e-6)


def mlp_apply(params, x, *, with_features: bool = False):
    h = torch.relu(x @ params["stem"]["w"] + params["stem"]["b"])
    for blk in params["blocks"]:
        u = torch.relu(_lnorm(h) @ blk["w1"] + blk["b1"])   # pre-norm
        h = h + (u @ blk["w2"] + blk["b2"])
    logits = h @ params["head"]["w"] + params["head"]["b"]
    if with_features:
        return logits, h
    return logits


def _head_conf(head, feats):
    h = torch.relu(feats @ head["w1"] + head["b1"])
    return torch.sigmoid((h @ head["w2"] + head["b2"])[..., 0])


def _order_gen(seed: int, name: str) -> torch.Generator:
    """The batch order's stream: one per member, stable across
    processes."""
    return torch.Generator().manual_seed(
        (int(seed) << 32) ^ zlib.crc32(name.encode()))


def _grad_step(loss_fn, params, opt, state, lr_now):
    """One clipped SGD step: (params, state, loss)."""
    (loss, _), g = value_and_grad(lambda p: (loss_fn(p), None), params)
    with torch.no_grad():
        params, state = opt.update(params, clip_by_global_norm(g, 1.0),
                                   state, lr_now)
    return params, state, loss


def _tensor(a, device, dtype=None):
    return torch.as_tensor(a, device=device, dtype=dtype)


def train_classifier(cfg: MLPConfig, data_x, data_y, *, seed: int = 0,
                     exp_logits=None, ltc_w: float = 0.0,
                     cost_c: float = 0.5, epochs: int = 30,
                     batch_size: int = 256, lr: float = 0.05,
                     weight_decay: float = 5e-4, conf_head: bool = False,
                     conf_head_kind: str = "confnet", verbose: bool = False,
                     device="cuda"):
    """SGD+momentum training (the paper's optimizer, step-decayed LR)
    on ``device``.

    exp_logits + ltc_w > 0 => LtC training (Eq 4) with the frozen
    expensive model's precomputed logits.  conf_head => jointly train an
    auxiliary confidence head (ConfNet / IDK baselines); the result is
    then ``{"mlp": ..., "head": ...}``.
    """
    x_all = _tensor(data_x, device, torch.float32)
    y_all = _tensor(data_y, device, torch.int64)
    e_all = None if exp_logits is None else _tensor(exp_logits, device,
                                                     torch.float32)
    gen = torch.Generator().manual_seed(int(seed))
    params = init_mlp(cfg, gen, device)
    if conf_head:
        params = {"mlp": params,
                  "head": init_train_head(cfg.width, gen, device)}

    opt = get_optimizer("sgd_momentum", momentum=0.9,
                        weight_decay=weight_decay)
    state = opt.init(params)
    n = x_all.shape[0]
    steps_per_epoch = max(1, n // batch_size)
    total = epochs * steps_per_epoch
    b1, b2 = int(0.3 * total), int(0.6 * total)

    def loss_fn(p, xb, yb, eb):
        logits, feats = mlp_apply(p["mlp"] if conf_head else p, xb,
                                  with_features=True)
        loss = losses.cross_entropy(logits, yb)
        if ltc_w > 0.0 and eb is not None:
            loss = loss + ltc_w * losses.cascade_loss(logits, eb, yb, cost_c)
        if conf_head:
            conf = _head_conf(p["head"], feats)
            if conf_head_kind == "confnet":
                loss = loss + losses.confnet_loss(conf, logits, yb)
            else:
                loss = loss + losses.idk_loss(conf, logits, yb, cost_c)
        return loss

    order = _order_gen(seed, cfg.name)
    t = 0
    for ep in range(epochs):
        perm = torch.randperm(n, generator=order).to(device)
        for i in range(steps_per_epoch):
            sl = perm[i * batch_size:(i + 1) * batch_size]
            eb = e_all[sl] if e_all is not None else None
            lr_now = lr * (0.2 ** ((t >= b1) + (t >= b2)))
            params, state, loss = _grad_step(
                lambda p: loss_fn(p, x_all[sl], y_all[sl], eb), params,
                opt, state, lr_now)
            t += 1
        if verbose and (ep + 1) % 10 == 0:
            print(f"  [{cfg.name}] epoch {ep+1}: loss {float(loss):.4f}")
    return params


@torch.no_grad()
def predict(params, x, *, conf_head: bool = False):
    """Returns (logits, conf_head_scores or None)."""
    if conf_head:
        logits, feats = mlp_apply(params["mlp"], x, with_features=True)
        return logits, _head_conf(params["head"], feats)
    return mlp_apply(params, x), None


# --------------------------------------------------------------------------
# Early-exit backbone (MSDNet stand-in, Fig 3) — Eq 6 joint training
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class EarlyExitConfig:
    name: str
    widths: Tuple[int, ...]          # backbone widths, one block per entry
    exits: Tuple[int, ...]           # exit after block i (0-based); last
                                     # block always has the final exit
    num_classes: int
    in_dim: int

    def macs_upto(self, exit_idx: int) -> int:
        """Cumulative MACs through exit `exit_idx` (incl. its head)."""
        dims = (self.in_dim,) + self.widths
        block_end = (self.exits + (len(self.widths) - 1,))[exit_idx]
        macs = sum(dims[i] * dims[i + 1] for i in range(block_end + 1))
        macs += dims[block_end + 1] * self.num_classes
        return macs


def init_early_exit(cfg: EarlyExitConfig, gen: torch.Generator,
                    device="cuda"):
    """The JAX package's init rule, drawn from ``gen`` (CPU)."""
    dims = (cfg.in_dim,) + cfg.widths
    blocks, heads = [], []
    for a, b in zip(dims[:-1], dims[1:]):
        blocks.append({"w": _normal(gen, (a, b), math.sqrt(2.0 / a), device),
                       "b": torch.zeros(b, device=device)})
    for i in tuple(cfg.exits) + (len(cfg.widths) - 1,):
        d = cfg.widths[i]
        heads.append({"w": _normal(gen, (d, cfg.num_classes),
                                   1 / math.sqrt(d), device),
                      "b": torch.zeros(cfg.num_classes, device=device)})
    return {"blocks": blocks, "heads": heads}


def early_exit_apply(params, cfg: EarlyExitConfig, x):
    """Returns list of logits, one per exit (fast -> final)."""
    outs = []
    h = x
    exit_points = tuple(cfg.exits) + (len(cfg.widths) - 1,)
    head_i = 0
    for i, blk in enumerate(params["blocks"]):
        h = torch.relu(h @ blk["w"] + blk["b"])
        if head_i < len(exit_points) and i == exit_points[head_i]:
            hd = params["heads"][head_i]
            outs.append(h @ hd["w"] + hd["b"])
            head_i += 1
    return outs


def train_early_exit(cfg: EarlyExitConfig, data_x, data_y, *, seed: int = 0,
                     ltc_w: float = 0.0, cost_c: float = 0.5,
                     epochs: int = 30, batch_size: int = 256,
                     lr: float = 0.05, device="cuda"):
    """Joint training of all exits; ltc_w>0 adds Eq 6's pairwise L_casc."""
    x_all = _tensor(data_x, device, torch.float32)
    y_all = _tensor(data_y, device, torch.int64)
    params = init_early_exit(cfg, torch.Generator().manual_seed(int(seed)),
                             device)
    opt = get_optimizer("sgd_momentum", momentum=0.9, weight_decay=5e-4)
    state = opt.init(params)
    n = x_all.shape[0]
    spe = max(1, n // batch_size)
    total = epochs * spe
    b1, b2 = int(0.3 * total), int(0.6 * total)

    def loss_fn(p, xb, yb):
        chain = early_exit_apply(p, cfg, xb)
        if ltc_w > 0:
            return losses.ltc_chain_loss(chain, yb, w=ltc_w,
                                         cost_c=cost_c)[0]
        return sum(losses.cross_entropy(c, yb) for c in chain)

    order = _order_gen(seed, cfg.name)
    t = 0
    for ep in range(epochs):
        perm = torch.randperm(n, generator=order).to(device)
        for i in range(spe):
            sl = perm[i * batch_size:(i + 1) * batch_size]
            lr_now = lr * (0.2 ** ((t >= b1) + (t >= b2)))
            params, state, _ = _grad_step(
                lambda p: loss_fn(p, x_all[sl], y_all[sl]), params, opt,
                state, lr_now)
            t += 1
    return params
