"""RWKV-6 'Finch' 3B — attention-free RNN with data-dependent decay.

[arXiv:2404.05892]  32L d_model=2560 d_ff=8960 vocab=65536.  40 heads of
dim 64; channel-mix FFN uses squared-relu (rwkv_cmix).  O(1) decode state.
About 3.1 B parameters: 12.4 GB in f32, so one card holds the whole
model.  Its recurrent state cannot be carried across prefill chunks, so
the engine serves it on the uniform one-shot prefill path.
"""
from repro_torch.configs.base import Dense, Layer, ModelConfig, RWKV6, register

CONFIG = register(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    d_model=2560,
    vocab_size=65536,
    num_heads=40,          # time-mix heads (d_model / head_dim)
    num_kv_heads=40,
    head_dim=64,
    period=(Layer(RWKV6(head_dim=64), Dense(d_ff=8960, act="rwkv_cmix")),),
    num_periods=32,
    supports_long_natively=True,
    source="arXiv:2404.05892",
))
