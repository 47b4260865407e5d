"""StarCoder2-7B — dense GQA decoder with RoPE and non-gated FFN.

[arXiv:2402.19173]  32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152.
"""
from repro_torch.configs.base import Attn, Dense, Layer, ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-7b",
    family="dense",
    d_model=4608,
    vocab_size=49152,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    period=(Layer(Attn(), Dense(d_ff=18432, act="gelu")),),
    num_periods=32,
    source="arXiv:2402.19173",
))
