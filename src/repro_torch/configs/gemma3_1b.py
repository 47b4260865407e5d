"""Gemma-3 1B — dense decoder with 5:1 local:global attention.

[hf:google/gemma-3-1b-pt]  26L d_model=1152 4H (GQA kv=1) d_ff=6912
vocab=262144.  head_dim=256 (Gemma uses head_dim decoupled from d_model).
Pattern: 5 sliding-window (512) layers then 1 global layer; 26 layers =
4 periods of 6 + 2 local tail layers.  Supports long_500k natively: only
~5 global layers hold a full-length KV cache and the model is small.
"""
from repro_torch.configs.base import Attn, Dense, Layer, ModelConfig, register

_LOCAL = Layer(Attn(window=512), Dense(d_ff=6912, act="swiglu"))
_GLOBAL = Layer(Attn(), Dense(d_ff=6912, act="swiglu"))

CONFIG = register(ModelConfig(
    name="gemma3-1b",
    family="dense",
    d_model=1152,
    vocab_size=262144,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    period=(_LOCAL,) * 5 + (_GLOBAL,),
    num_periods=4,
    tail=(_LOCAL, _LOCAL),
    tie_embeddings=True,
    rope_theta=1e6,
    supports_long_natively=True,
    source="hf:google/gemma-3-1b-pt",
))
