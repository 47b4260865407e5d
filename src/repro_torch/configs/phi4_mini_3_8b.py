"""Phi-4-mini 3.8B — dense RoPE/SwiGLU/GQA decoder.

[arXiv:2412.08905]  32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064.
"""
from repro_torch.configs.base import Attn, Dense, Layer, ModelConfig, register

CONFIG = register(ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    d_model=3072,
    vocab_size=200064,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    period=(Layer(Attn(), Dense(d_ff=8192, act="swiglu")),),
    num_periods=32,
    tie_embeddings=True,
    source="arXiv:2412.08905",
))
