"""Kimi K2 — trillion-parameter MoE, 384 experts top-8 (paper-table config).

[arXiv:2501.kimi2]  61L d_model=7168 64H (GQA kv=8) expert d_ff=2048
vocab=163840, MoE 384e top-8.  DeepSeek-V3-style: the first layer keeps a
dense FFN, all remaining layers are MoE.  head_dim = d_model/num_heads = 112
per the assigned table (the real model uses MLA; the assignment specifies
GQA, which we follow).
"""
from repro_torch.configs.base import Attn, Dense, Layer, MoE, ModelConfig, register

_MOE = MoE(num_experts=384, top_k=8, d_ff=2048, capacity_factor=1.25)

CONFIG = register(ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    d_model=7168,
    vocab_size=163840,
    num_heads=64,
    num_kv_heads=8,
    head_dim=112,
    head=(Layer(Attn(), Dense(d_ff=16384)),),   # dense first layer (DSv3 style)
    period=(Layer(Attn(), _MOE),),
    num_periods=60,
    remat=True,
    fsdp=True,
    optimizer="adafactor",
    source="arXiv:2501.kimi2",
))
