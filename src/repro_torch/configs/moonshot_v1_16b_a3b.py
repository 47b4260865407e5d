"""Moonlight-16B-A3B — MoE decoder (64 experts, top-6).

[hf:moonshotai/Moonlight-16B-A3B]  48L d_model=2048 16H (kv=16) expert
d_ff=1408, vocab=163840, MoE 64e top-6.  The assignment labels it [dense]
but specifies MoE fields; we build it as the MoE it is (noted in DESIGN.md).
First layer dense (DeepSeek-V3 style), d_ff = 4*2048? -> use 11264 (~8x
expert) following Moonlight's dense-layer sizing.
"""
from repro_torch.configs.base import Attn, Dense, Layer, MoE, ModelConfig, register

_MOE = MoE(num_experts=64, top_k=6, d_ff=1408, capacity_factor=1.25)

CONFIG = register(ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    d_model=2048,
    vocab_size=163840,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    head=(Layer(Attn(), Dense(d_ff=11264)),),
    period=(Layer(Attn(), _MOE),),
    num_periods=47,
    source="hf:moonshotai/Moonlight-16B-A3B",
))
