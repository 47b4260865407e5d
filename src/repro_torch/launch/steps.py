"""Step functions: train, prefill and serve (the torch twin of
``repro/launch/steps.py``).

``make_train_step`` is next-token LM training (L_org + MoE aux);
``make_ltc_train_step`` is the paper's Eq 4 applied to the fast member
of a cascade pair, the expensive member frozen (``repro_torch.core.
losses``).  A train step takes and returns plain parameter trees: it
differentiates a detached copy of every leaf with ``torch.autograd.grad``
and applies the optimizer's functional ``update``, as the JAX package
differentiates its pure loss.  The sharding trees (``opt_state_specs``,
``opt_state_shapes``) wait for multi-device placement.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import losses
from repro_torch.models import transformer
from repro_torch.models.params import tree_map, value_and_grad
from repro_torch.optim import get_optimizer


def make_optimizer(cfg: ModelConfig):
    if cfg.optimizer in ("sgd", "sgd_momentum"):
        return get_optimizer("sgd_momentum", momentum=0.9)
    if cfg.optimizer == "adamw":
        return get_optimizer("adamw", weight_decay=0.01)
    return get_optimizer("adafactor")


def _remat(cfg: ModelConfig, force_remat: bool) -> ModelConfig:
    """Activation checkpointing of the periods as the training default:
    without it every layer's attention and FFN intermediates stay live
    for backward."""
    if force_remat and cfg.num_periods and not cfg.remat:
        return dataclasses.replace(cfg, remat=True)
    return cfg


# --------------------------------------------------------------------------
# Train
# --------------------------------------------------------------------------


def lm_loss(params, cfg: ModelConfig, batch, chunked_ce: int = 0):
    labels = batch["tokens"][:, 1:]
    if chunked_ce:
        hidden, aux = transformer.forward(params, cfg, batch, mode="train",
                                          return_hidden=True)
        proj = transformer.lm_proj(params, cfg)
        loss = losses.chunked_lm_loss(
            hidden[:, :-1], proj, labels,
            chunk=min(chunked_ce, labels.shape[1]))
    else:
        logits, aux = transformer.train_logits(params, cfg, batch)
        loss = losses.cross_entropy(logits[:, :-1], labels)
    loss = loss + losses.moe_aux_loss(aux)
    return loss, {"loss": loss}


def make_train_step(cfg: ModelConfig, lr: float = 1e-3,
                    force_remat: bool = True, microbatches: int = 1,
                    chunked_ce: int = 0):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss"})`` and its optimizer.  ``microbatches`` accumulates the
    gradients of equal splits of the batch (their f32 sum over the
    count, the loss their mean); ``chunked_ce`` takes the loss over
    sequence chunks of that size (``chunked_lm_loss``)."""
    cfg = _remat(cfg, force_remat)
    opt = make_optimizer(cfg)

    def loss_fn(p, b):
        return lm_loss(p, cfg, b, chunked_ce=chunked_ce)

    def train_step(params, opt_state, batch):
        if microbatches == 1:
            (_, m), grads = value_and_grad(loss_fn, params, batch)
            m = {k: v.detach() for k, v in m.items()}
        else:
            M = microbatches
            grads = tree_map(lambda p: torch.zeros(p.shape,
                                                   dtype=torch.float32,
                                                   device=p.device), params)
            ls = []
            for i in range(M):
                mb = {k: v.reshape(M, v.shape[0] // M, *v.shape[1:])[i]
                      for k, v in batch.items()}
                (loss, _), g = value_and_grad(loss_fn, params, mb)
                grads = tree_map(torch.add, grads, g)
                ls.append(loss)
            grads = tree_map(lambda g: g / M, grads)
            m = {"loss": torch.stack(ls).mean()}
        with torch.no_grad():
            params, opt_state = opt.update(params, grads, opt_state, lr)
        return params, opt_state, m

    return train_step, opt


def make_ltc_train_step(fast_cfg: ModelConfig, exp_cfg: ModelConfig,
                        *, w: float = 1.0, cost_c: float = 0.5,
                        lr: float = 1e-3):
    """Eq 4 for LM cascades: ``train_step(fast_params, opt_state,
    exp_params, batch) -> (fast_params, opt_state, {"l_org",
    "l_casc"})``.  The frozen expensive model's forward runs on the same
    batch (its ``frontend_embeds`` too, as the JAX step passes it) under
    ``torch.no_grad()`` to supply the 1[exp wrong] indicator; its tokens
    are clamped to its vocabulary (the JAX
    package's gather clamps an index, so a token past it embeds as the
    last id), the labels are not.  The fast model's periods are
    checkpointed as :func:`make_train_step` does by default (the JAX LtC
    step keeps ``cfg.remat``): recomputation changes no value and keeps
    the published gemma3-1b's activations off the card."""
    fast_cfg = _remat(fast_cfg, True)
    opt = make_optimizer(fast_cfg)

    def loss_fn(fast_params, exp_logits, batch):
        fast_logits, aux = transformer.train_logits(fast_params, fast_cfg,
                                                    batch)
        labels = batch["tokens"][:, 1:]
        loss, m = losses.ltc_loss(fast_logits[:, :-1], exp_logits, labels,
                                  w=w, cost_c=cost_c)
        return loss + losses.moe_aux_loss(aux), m

    def train_step(fast_params, opt_state, exp_params, batch):
        with torch.no_grad():
            exp_tokens = batch["tokens"].clamp(max=exp_cfg.vocab_size - 1)
            exp_logits, _ = transformer.train_logits(
                exp_params, exp_cfg, {**batch, "tokens": exp_tokens})
            exp_logits = exp_logits[:, :-1]
        (_, m), grads = value_and_grad(loss_fn, fast_params, exp_logits,
                                       batch)
        m = {k: v.detach() for k, v in m.items()}
        with torch.no_grad():
            fast_params, opt_state = opt.update(fast_params, grads,
                                                opt_state, lr)
        return fast_params, opt_state, m

    return train_step, opt


# --------------------------------------------------------------------------
# Serve
# --------------------------------------------------------------------------


def make_prefill_step(cfg: ModelConfig):
    """``prefill_step(params, batch) -> (last logits [B, 1, V], part
    cache)``."""
    def prefill_step(params, batch):
        logits, cache = transformer.forward(params, cfg, batch,
                                            mode="prefill")
        return logits[:, -1:], cache

    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step over the dense arena: next-token logits, the
    cascade gate's confidence (max softmax probability — the paper's
    conf) and the cache, updated in place."""
    def serve_step(params, token, pos, cache):
        logits, new_cache = transformer.decode_step(params, cfg, token,
                                                    cache, pos)
        conf = torch.softmax(logits.float(), -1).amax(-1)
        return logits, conf, new_cache

    return serve_step
