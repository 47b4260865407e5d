"""Config system: architecture descriptions as frozen dataclasses.

A model is described as ``head ++ period * num_periods ++ tail`` where each
element is a :class:`Layer` (mixer + ffn).  The repeated ``period`` keeps
its weights stacked on a leading ``num_periods`` dim and runs as a Python
loop over that dim; ``head``/``tail`` are unrolled.

Each architecture lives in its own module under ``repro_torch.configs``
and registers a :class:`ModelConfig` via :func:`register`.  The fields
are those of the JAX package's ``repro/configs/base.py``, so one config
describes the same model in both packages.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field, replace
from typing import Optional, Tuple

# --------------------------------------------------------------------------
# Block specs
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class Attn:
    """Grouped-query attention mixer.

    window: sliding-window size (None = full causal attention).
    rope:   'rope' | 'mrope' (multimodal 3-section rotary) | 'none'.
    """

    window: Optional[int] = None
    rope: str = "rope"
    kind: str = field(default="attn", init=False)


@dataclass(frozen=True)
class Mamba:
    """Mamba-1 selective SSM mixer (diagonal A, data-dependent dt/B/C)."""

    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    kind: str = field(default="mamba", init=False)


@dataclass(frozen=True)
class RWKV6:
    """RWKV-6 'Finch' time-mix: linear attention with data-dependent decay."""

    head_dim: int = 64
    decay_lora: int = 64
    kind: str = field(default="rwkv6", init=False)


@dataclass(frozen=True)
class Dense:
    """Dense FFN.  act: 'swiglu' | 'gelu' | 'rwkv_cmix' (squared-relu channel mix)."""

    d_ff: int
    act: str = "swiglu"
    kind: str = field(default="dense", init=False)


@dataclass(frozen=True)
class MoE:
    """Token-choice top-k mixture of experts (einsum dispatch, capacity-bounded)."""

    num_experts: int
    top_k: int
    d_ff: int
    capacity_factor: float = 1.25
    act: str = "swiglu"
    kind: str = field(default="moe", init=False)


@dataclass(frozen=True)
class Layer:
    mixer: object  # Attn | Mamba | RWKV6
    ffn: object    # Dense | MoE


# --------------------------------------------------------------------------
# Model config
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    d_model: int
    vocab_size: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    head: Tuple[Layer, ...] = ()
    period: Tuple[Layer, ...] = ()
    num_periods: int = 0
    tail: Tuple[Layer, ...] = ()

    tie_embeddings: bool = False
    rope_theta: float = 1e4
    norm_eps: float = 1e-6

    # Modality frontend stub (sanctioned): precomputed embeddings are inputs.
    frontend: Optional[str] = None   # 'vision' | 'audio' | None
    frontend_dim: int = 0            # dim of the precomputed embeddings
    frontend_len: int = 0            # number of frontend positions per sample

    # Early-exit ("model splitting") support: exit heads after these period
    # indices (0-based, exit fires after period i completes).
    early_exit_periods: Tuple[int, ...] = ()

    # Distribution / memory knobs consumed by the launcher.
    remat: bool = False              # activation checkpointing (training)
    fsdp: bool = False               # 2D (model x data) weight sharding
    unroll_periods: bool = False     # python-loop the periods (used by the
                                     # dry-run's scan-cost correction)
    optimizer: str = "adafactor"     # train-step optimizer for dry-run
    dtype: str = "bfloat16"

    # KV-cache quantization ('int8' | None) — beyond-paper serving
    # optimization (§Perf): halves the decode memory term vs bf16.
    kv_quant: Optional[str] = None

    # Shard k/v over the seq dim (model axis) in full-seq attention when
    # the kv heads can't absorb it, so the probs·v contraction
    # partial-sums instead of all-gathering the T-sharded probs.
    # Default True after §Perf iteration 4 (30x collective reduction on
    # starcoder2 train; baseline numbers preserved in EXPERIMENTS.md).
    kv_seq_hint: bool = True

    # long_500k policy (see DESIGN.md): archs whose attention state is
    # bounded run natively; full-attention archs use a documented
    # sliding-window variant built by `long_context_variant`.
    supports_long_natively: bool = False
    long_variant_window: int = 8192

    source: str = ""                 # citation for the architecture

    # ---- derived -----------------------------------------------------

    @property
    def layers(self) -> Tuple[Layer, ...]:
        return self.head + self.period * self.num_periods + self.tail

    @property
    def num_layers(self) -> int:
        return len(self.head) + len(self.period) * self.num_periods + len(self.tail)

    @property
    def attn_free(self) -> bool:
        return all(l.mixer.kind != "attn" for l in self.layers)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.d_model * self.vocab_size
        if self.frontend:
            n += self.frontend_dim * self.d_model
        for layer in self.layers:
            n += _mixer_params(self, layer.mixer) + _ffn_params(self, layer.ffn)
            n += 2 * self.d_model  # two RMSNorm scales
        n += self.d_model  # final norm
        return n

    def active_param_count(self) -> int:
        """Params active per token (MoE: top_k of num_experts experts)."""
        n = self.vocab_size * self.d_model
        if not self.tie_embeddings:
            n += self.d_model * self.vocab_size
        for layer in self.layers:
            n += _mixer_params(self, layer.mixer)
            f = layer.ffn
            if f.kind == "moe":
                per = _ffn_params(self, f) / f.num_experts
                n += int(per * f.top_k)
            else:
                n += _ffn_params(self, f)
            n += 2 * self.d_model
        n += self.d_model
        return n


def _mixer_params(cfg: ModelConfig, m) -> int:
    d = cfg.d_model
    if m.kind == "attn":
        return d * cfg.num_heads * cfg.head_dim + 2 * d * cfg.num_kv_heads * cfg.head_dim \
            + cfg.num_heads * cfg.head_dim * d
    if m.kind == "mamba":
        d_in = m.expand * d
        dt_rank = math.ceil(d / 16)
        return (d * 2 * d_in            # in_proj (x, z)
                + m.d_conv * d_in       # depthwise conv
                + d_in * (dt_rank + 2 * m.d_state)  # x_proj
                + dt_rank * d_in + d_in            # dt_proj (+bias)
                + d_in * m.d_state + d_in          # A_log, D
                + d_in * d)             # out_proj
    if m.kind == "rwkv6":
        # r/k/v/g/o projections + decay lora + token-shift mixers (approx).
        return 5 * d * d + 2 * d * m.decay_lora + 6 * d
    raise ValueError(m.kind)


def _ffn_params(cfg: ModelConfig, f) -> int:
    d = cfg.d_model
    if f.kind == "dense":
        mats = 3 if f.act == "swiglu" else 2
        return mats * d * f.d_ff
    if f.kind == "moe":
        mats = 3 if f.act == "swiglu" else 2
        return d * f.num_experts + f.num_experts * mats * d * f.d_ff
    raise ValueError(f.kind)


# --------------------------------------------------------------------------
# Variants
# --------------------------------------------------------------------------


def _map_layers(layers, fn):
    return tuple(fn(l) for l in layers)


def long_context_variant(cfg: ModelConfig) -> ModelConfig:
    """Sliding-window variant for the long_500k shape (dense archs only).

    Replaces every full-attention mixer with a windowed one; archs that
    support long context natively are returned unchanged.
    """
    if cfg.supports_long_natively:
        return cfg
    w = cfg.long_variant_window

    def fix(layer: Layer) -> Layer:
        m = layer.mixer
        if m.kind == "attn" and m.window is None:
            m = replace(m, window=w)
        return Layer(m, layer.ffn)

    return dataclasses.replace(
        cfg,
        name=cfg.name + "-swa",
        head=_map_layers(cfg.head, fix),
        period=_map_layers(cfg.period, fix),
        tail=_map_layers(cfg.tail, fix),
    )


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced variant of the same family: <=2 layers, d_model<=512, <=4 experts.

    Used by per-arch smoke tests that run a real forward/train step on CPU.
    """
    d_model = min(cfg.d_model, 256)
    head_dim = 32
    num_heads = max(2, d_model // 64)
    num_kv = max(1, min(cfg.num_kv_heads, num_heads))
    # keep the GQA ratio flavour: kv strictly <= heads, divides heads
    while num_heads % num_kv:
        num_kv -= 1

    def fix(layer: Layer) -> Layer:
        m, f = layer.mixer, layer.ffn
        if m.kind == "mamba":
            m = replace(m, d_state=8)
        if m.kind == "rwkv6":
            m = replace(m, head_dim=32, decay_lora=16)
        if m.kind == "attn" and m.window is not None:
            m = replace(m, window=16)
        if f.kind == "moe":
            f = MoE(num_experts=4, top_k=min(2, f.top_k), d_ff=64,
                    capacity_factor=2.0, act=f.act)
        else:
            f = Dense(d_ff=min(f.d_ff, 512), act=f.act)
        return Layer(m, f)

    # two layers total, drawn from the period so every mixer kind the
    # family uses is exercised.
    src = (cfg.head + cfg.period + cfg.tail)
    kinds_seen, picked = set(), []
    for l in src:
        if l.mixer.kind not in kinds_seen or (len(picked) < 2 and l.ffn.kind == "moe"
                                              and not any(p.ffn.kind == "moe" for p in picked)):
            picked.append(l)
            kinds_seen.add(l.mixer.kind)
        if len(picked) == 2:
            break
    while len(picked) < 2:
        picked.append(src[0])

    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=d_model,
        vocab_size=min(cfg.vocab_size, 512),
        num_heads=num_heads,
        num_kv_heads=num_kv,
        head_dim=head_dim,
        head=(),
        period=tuple(fix(l) for l in picked),
        num_periods=1,
        tail=(),
        frontend_dim=64 if cfg.frontend else 0,
        frontend_len=8 if cfg.frontend else 0,
        early_exit_periods=(),
        remat=False,
        fsdp=False,
    )


# --------------------------------------------------------------------------
# Registry
# --------------------------------------------------------------------------

_REGISTRY: dict = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str, variant: Optional[str] = None) -> ModelConfig:
    cfg = _REGISTRY[name]
    if variant == "smoke":
        return smoke_variant(cfg)
    if variant == "long":
        return long_context_variant(cfg)
    if variant:
        raise ValueError(f"unknown variant {variant!r}")
    return cfg


def list_configs():
    return sorted(_REGISTRY)
