"""Parameter declaration and initialisation (the torch twin of
``repro/models/params.py``).

Every block declares its parameters as a tree of :class:`P` (shape +
logical axes + init rule); the tree's keys, shapes and init rules are
the JAX package's, so a JAX parameter tree converts leaf for leaf with
:func:`from_jax`.  The repeated ``period`` carries a leading stacked
``num_periods`` dim; with ``tie_embeddings`` the LM head is ``embed``.

Only the mixers and FFNs of the served models are declared here:
attention, the Mamba-1 selective SSM and the RWKV-6 time mix, dense
``swiglu``/``gelu`` FFNs and the RWKV-6 channel mix (``rwkv_cmix``), and
mixture-of-experts FFNs (a ``[d, E]`` router and expert weights stacked
on a leading ``E`` dim); the early-exit heads (``exit_heads``: a norm
and a ``[d, V]`` projection for each period in ``early_exit_periods``);
and a modality frontend's ``frontend_proj`` ``[frontend_dim, d_model]``,
which maps the precomputed patch or frame embeddings into the model
(``transformer._embed``).  Besides the generic rules, Mamba's ``A_log``
is ``log(1..d_state)`` (``mamba_A``) and its ``dt_bias`` the inverse
softplus of a ``U[1e-3, 1e-1)`` draw (``mamba_dt``).

From the one declaration come, as in the JAX package, the weights
(:func:`init_params`), each leaf's per-device shape on the ``meta``
device (:func:`param_shapes`) and its partition spec on a tier mesh
(:func:`param_specs`).  A spec is a tuple of ``"model"``, ``"data"`` or
None per dim, by the MaxText-style logical-axis rules of
:func:`logical_to_spec`: the ``model`` axis goes to the first divisible
dim in the order experts > vocab > ffn > fused_heads > d_inner >
frontend, and under ``cfg.fsdp`` the ``data`` axis to a remaining
divisible ``d_model``/``ffn2`` dim.  The serving engine places each
model shard's slices by these specs
(:func:`repro_torch.models.sharding.model_shard_params`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import local_shape


class P(NamedTuple):
    shape: tuple
    axes: tuple            # logical axis name per dim (or None)
    init: str = "fan_in"   # fan_in | zeros | ones | normal:<s> | mamba_*


# priority of logical axes for the `model` mesh axis
_MODEL_PRIORITY = ("experts", "vocab", "ffn", "fused_heads", "d_inner",
                   "frontend")
# axes eligible for the `data` mesh axis under fsdp
_FSDP_AXES = ("d_model", "ffn2")


def _axis_sizes(mesh) -> dict:
    """Axis sizes by name of anything with ``axis_names`` and
    ``devices.shape`` (a :class:`repro_torch.launch.mesh.TierMesh`, or a
    JAX mesh)."""
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def logical_to_spec(p: P, mesh, fsdp: bool) -> tuple:
    """One leaf's partition spec on ``mesh``: ``"model"`` on the first
    dim (by :data:`_MODEL_PRIORITY`) whose size the model axis divides,
    and under ``fsdp`` ``"data"`` on the first free ``d_model``/``ffn2``
    dim the data axis divides; None elsewhere."""
    sizes = _axis_sizes(mesh)
    model = sizes.get("model", 1)
    data = sizes.get("data", 1)
    spec = [None] * len(p.shape)
    if model > 1:
        for target in _MODEL_PRIORITY:
            hit = next((i for i, (a, s) in enumerate(zip(p.axes, p.shape))
                        if a == target and s % model == 0), None)
            if hit is not None:
                spec[hit] = "model"
                break
    if fsdp and data > 1:
        for i, (a, s) in enumerate(zip(p.axes, p.shape)):
            if a in _FSDP_AXES and spec[i] is None and s % data == 0:
                spec[i] = "data"
                break
    return tuple(spec)


def _attn_decl(cfg: ModelConfig, m) -> dict:
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": P((d, H * hd), ("d_model", "fused_heads")),
        "wk": P((d, KV * hd), ("d_model", "fused_heads")),
        "wv": P((d, KV * hd), ("d_model", "fused_heads")),
        "wo": P((H * hd, d), ("fused_heads", "d_model")),
    }


def _mamba_decl(cfg: ModelConfig, m) -> dict:
    d = cfg.d_model
    d_in = m.expand * d
    dt_rank = math.ceil(d / 16)
    return {
        "in_proj": P((d, 2 * d_in), ("d_model", "d_inner")),
        "conv_w": P((m.d_conv, d_in), (None, "d_inner")),
        "conv_b": P((d_in,), ("d_inner",), "zeros"),
        "x_proj": P((d_in, dt_rank + 2 * m.d_state), ("d_inner", None)),
        "dt_proj": P((dt_rank, d_in), (None, "d_inner")),
        "dt_bias": P((d_in,), ("d_inner",), "mamba_dt"),
        "A_log": P((d_in, m.d_state), ("d_inner", None), "mamba_A"),
        "D": P((d_in,), ("d_inner",), "ones"),
        "out_proj": P((d_in, d), ("d_inner", "d_model")),
    }


def _rwkv6_decl(cfg: ModelConfig, m) -> dict:
    d = cfg.d_model
    r = m.decay_lora
    return {
        # token-shift interpolation weights (data-independent part)
        "mix_r": P((d,), (None,), "normal:0.02"),
        "mix_k": P((d,), (None,), "normal:0.02"),
        "mix_v": P((d,), (None,), "normal:0.02"),
        "mix_g": P((d,), (None,), "normal:0.02"),
        "mix_w": P((d,), (None,), "normal:0.02"),
        "wr": P((d, d), ("d_model", "d_inner")),
        "wk": P((d, d), ("d_model", "d_inner")),
        "wv": P((d, d), ("d_model", "d_inner")),
        "wg": P((d, d), ("d_model", "d_inner")),
        "wo": P((d, d), ("d_inner", "d_model")),
        # data-dependent decay LoRA: w_t = exp(-exp(w0 + tanh(x A) B))
        "w0": P((d,), (None,), "normal:0.02"),
        "wA": P((d, r), ("d_model", None)),
        "wB": P((r, d), (None, "d_inner")),
        "bonus": P((d // m.head_dim, m.head_dim), (None, None), "normal:0.02"),
        "ln_x": P((d,), (None,), "ones"),   # per-head group norm scale
    }


def _dense_decl(cfg: ModelConfig, f) -> dict:
    d = cfg.d_model
    if f.act == "rwkv_cmix":
        # RWKV-6 channel mix: token-shift lerp + squared-relu + receptance
        return {
            "mix_k": P((d,), (None,), "normal:0.02"),
            "mix_r": P((d,), (None,), "normal:0.02"),
            "wk": P((d, f.d_ff), ("d_model", "ffn")),
            "wv": P((f.d_ff, d), ("ffn", "ffn2")),
            "wr": P((d, d), ("d_model", "d_inner")),
        }
    if f.act == "swiglu":
        return {
            "wi0": P((d, f.d_ff), ("d_model", "ffn")),
            "wi1": P((d, f.d_ff), ("d_model", "ffn")),
            "wo": P((f.d_ff, d), ("ffn", "ffn2")),
        }
    if f.act == "gelu":
        return {
            "wi": P((d, f.d_ff), ("d_model", "ffn")),
            "wo": P((f.d_ff, d), ("ffn", "ffn2")),
        }
    raise NotImplementedError(f"dense ffn act {f.act!r} is not ported")


def _moe_decl(cfg: ModelConfig, f) -> dict:
    d, E = cfg.d_model, f.num_experts
    decl = {"router": P((d, E), ("d_model", None), "normal:0.02")}
    if f.act == "swiglu":
        decl.update({
            "wi0": P((E, d, f.d_ff), ("experts", "d_model", "ffn")),
            "wi1": P((E, d, f.d_ff), ("experts", "d_model", "ffn")),
            "wo": P((E, f.d_ff, d), ("experts", "ffn", "d_model")),
        })
    elif f.act == "gelu":
        decl.update({
            "wi": P((E, d, f.d_ff), ("experts", "d_model", "ffn")),
            "wo": P((E, f.d_ff, d), ("experts", "ffn", "d_model")),
        })
    else:
        raise NotImplementedError(f"moe ffn act {f.act!r} is not ported")
    return decl


_MIXER_DECL = {"attn": _attn_decl, "mamba": _mamba_decl,
               "rwkv6": _rwkv6_decl}
_FFN_DECL = {"dense": _dense_decl, "moe": _moe_decl}


def _layer_decl(cfg: ModelConfig, layer) -> dict:
    if layer.mixer.kind not in _MIXER_DECL or layer.ffn.kind not in _FFN_DECL:
        raise NotImplementedError(
            f"{cfg.name}: only attention, Mamba and RWKV-6 mixers with dense "
            f"or MoE FFNs are ported (got {layer.mixer.kind}/"
            f"{layer.ffn.kind})")
    return {
        "norm1": P((cfg.d_model,), (None,), "ones"),
        "mixer": _MIXER_DECL[layer.mixer.kind](cfg, layer.mixer),
        "norm2": P((cfg.d_model,), (None,), "ones"),
        "ffn": _FFN_DECL[layer.ffn.kind](cfg, layer.ffn),
    }


def tree_map(fn, tree, *rest):
    """Map `fn` over the leaves of a tree of dicts, lists and tuples — or,
    given more trees of the same structure, over their leaves side by
    side.  The result keeps the first tree's containers; a leaf of the
    first tree takes the whole subtree at the same place of the others
    (an optimizer's per-leaf state)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """Leaves of a tree of dicts (in key-insertion order), lists and
    tuples (in order)."""
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    if isinstance(tree, (list, tuple)) and not hasattr(tree, "_fields"):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    return [tree]


def value_and_grad(loss_fn, params, *args):
    """((loss, aux), grads): ``loss_fn(params, *args) -> (loss, aux)``
    evaluated on a detached, grad-requiring copy of every leaf of
    ``params``, and the gradient of ``loss`` as a tree of the same
    structure — the functional form of ``jax.value_and_grad(...,
    has_aux=True)`` over a parameter tree.  ``loss`` comes back
    detached; a leaf the loss does not reach (an exit head under the LM
    loss) gets zeros, as under ``jax.grad``."""
    req = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, aux = loss_fn(req, *args)
    leaves = tree_leaves(req)
    grads = iter([torch.zeros_like(p) if g is None else g for p, g in zip(
        leaves, torch.autograd.grad(loss, leaves, allow_unused=True))])
    return (loss.detach(), aux), tree_map(lambda _: next(grads), req)


def _stack(decl: dict, n: int):
    """Prepend a `stack` dim of size n to every leaf (period weights)."""
    return tree_map(lambda p: P((n,) + p.shape, ("stack",) + p.axes, p.init),
                    decl)


def declare_model(cfg: ModelConfig) -> dict:
    d, V = cfg.d_model, cfg.vocab_size
    decl = {
        "embed": P((V, d), ("vocab", "d_model"), "normal:0.02"),
        "final_norm": P((d,), (None,), "ones"),
    }
    if not cfg.tie_embeddings:
        decl["lm_head"] = P((d, V), ("d_model", "vocab"))
    if cfg.frontend:
        decl["frontend_proj"] = P((cfg.frontend_dim, d),
                                  ("frontend", "d_model"))
    if cfg.head:
        decl["head"] = {f"layer{i}": _layer_decl(cfg, l)
                        for i, l in enumerate(cfg.head)}
    if cfg.num_periods:
        period = {f"block{i}": _layer_decl(cfg, l)
                  for i, l in enumerate(cfg.period)}
        decl["period"] = _stack(period, cfg.num_periods)
    if cfg.tail:
        decl["tail"] = {f"layer{i}": _layer_decl(cfg, l)
                        for i, l in enumerate(cfg.tail)}
    if cfg.early_exit_periods:
        decl["exit_heads"] = {
            f"exit{i}": {"norm": P((d,), (None,), "ones"),
                         "proj": P((d, V), ("d_model", "vocab"))}
            for i in cfg.early_exit_periods}
    return decl


def _init_leaf(p: P, gen: torch.Generator, dtype, device):
    if p.init == "zeros":
        return torch.zeros(p.shape, dtype=dtype, device=device)
    if p.init == "ones":
        return torch.ones(p.shape, dtype=dtype, device=device)
    if p.init == "mamba_A":
        # S4D-real init: A = -(1..d_state), stored as log
        n = p.shape[-1]
        a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
        return torch.log(a).expand(p.shape).to(dtype).contiguous()
    if p.init == "mamba_dt":
        # dt bias such that softplus(bias) ~ U[1e-3, 1e-1): inverse softplus
        u = torch.rand(p.shape, generator=gen, dtype=torch.float32,
                       device=device) * (1e-1 - 1e-3) + 1e-3
        return (u + torch.log(-torch.expm1(-u))).to(dtype)
    if p.init.startswith("normal:"):
        s = float(p.init.split(":")[1])
    else:  # fan_in: every dim but the last (an expert leaf's E·d), per
        # period of a stacked leaf
        fan_in = p.shape[0] if len(p.shape) == 1 else math.prod(p.shape[:-1])
        if "stack" in p.axes:
            fan_in //= p.shape[0]
        s = 1.0 / math.sqrt(max(fan_in, 1))
    w = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(s).to(dtype)


def init_params(cfg: ModelConfig, seed: int, dtype=torch.float32,
                device="cuda"):
    """Random weights by the JAX package's init rules (``ones``,
    ``normal:s``, fan-in, ``mamba_A``, ``mamba_dt``).  The draws come
    from a ``torch.Generator`` seeded with `seed` on `device`, so
    billions of parameters are drawn on the card, not the host; they
    differ from the JAX package's ``jax.random`` draws — use
    :func:`from_jax` for equal weights."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return tree_map(lambda p: _init_leaf(p, gen, dtype, device),
                    declare_model(cfg))


def from_jax(tree, device="cpu", dtype=None):
    """Convert a JAX parameter tree (leaves anything ``np.asarray``
    takes) into the same tree of torch tensors on `device`, leaf for
    leaf whatever the mixer (Mamba's ``A_log``/``dt_bias``/``D`` too) —
    the weight bridge the parity tests use."""
    def leaf(a):
        t = torch.from_numpy(np.array(a, copy=True))
        return t.to(device=device, dtype=dtype or t.dtype)
    return tree_map(leaf, tree)


def param_specs(cfg: ModelConfig, mesh):
    """Every leaf's partition spec on ``mesh`` (:func:`logical_to_spec`),
    in the parameter tree's structure."""
    return tree_map(lambda p: logical_to_spec(p, mesh, cfg.fsdp),
                    declare_model(cfg))


def param_shapes(cfg: ModelConfig, dtype=torch.bfloat16, mesh=None):
    """Every leaf as an empty ``meta``-device tensor (no memory): its
    global shape, or with ``mesh`` the shape one device holds under
    :func:`param_specs` (each split dim divided by its axis's size).  The
per-device shapes describe the JAX placement for the parity tests; the
serving engine slices its shards by
:func:`repro_torch.models.sharding.model_shard_params`, whose ``wk`` /
``wv`` follow the KV-head rule where the model axis outnumbers the KV
heads."""
    sizes = _axis_sizes(mesh) if mesh is not None else {}

    def leaf(p: P):
        spec = (logical_to_spec(p, mesh, cfg.fsdp) if mesh is not None
                else (None,) * len(p.shape))
        return torch.empty(local_shape(p.shape, spec, sizes), dtype=dtype,
                           device="meta")
    return tree_map(leaf, declare_model(cfg))


def param_count_from_decl(cfg: ModelConfig) -> int:
    return sum(math.prod(p.shape) for p in tree_leaves(declare_model(cfg)))
