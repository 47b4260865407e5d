"""MusicGen-large — decoder-only transformer over EnCodec tokens.

[arXiv:2306.05284]  48L d_model=2048 32H (kv=32, i.e. MHA) d_ff=8192
vocab=2048.  The EnCodec conv codec is the sanctioned frontend stub:
`input_specs` provides audio-token ids (and conditioning embeddings of
`frontend_dim`) directly.  MusicGen uses sinusoidal positions; we use RoPE
(noted hardware/impl adaptation — positional scheme is orthogonal to LtC).
"""
from repro_torch.configs.base import Attn, Dense, Layer, ModelConfig, register

CONFIG = register(ModelConfig(
    name="musicgen-large",
    family="audio",
    d_model=2048,
    vocab_size=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    period=(Layer(Attn(), Dense(d_ff=8192, act="gelu")),),
    num_periods=48,
    frontend="audio",
    frontend_dim=768,     # conditioning (T5-style) embedding dim, stubbed
    frontend_len=64,
    source="arXiv:2306.05284",
))
