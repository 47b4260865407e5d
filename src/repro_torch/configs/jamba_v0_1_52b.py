"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887]  32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536.
Each 8-layer Jamba block has one attention layer (index 4 within the block,
per the paper's a/m ratio 1:7) and MoE replaces the dense FFN every other
layer (e=16, k=2).  At its 4 periods it holds about 51.6 B parameters,
206 GB in f32, more than one 80 GB card; one period (8 layers, 13.3 B
parameters, 53.2 GB in f32) fits beside gemma3-1b.  Its Mamba state
cannot be carried across prefill chunks, so the engine serves it on the
uniform one-shot prefill path.
"""
from repro_torch.configs.base import (Attn, Dense, Layer, Mamba, MoE,
                                      ModelConfig, register)


def _layer(i: int) -> Layer:
    mixer = Attn() if i == 4 else Mamba(d_state=16, d_conv=4, expand=2)
    ffn = (MoE(num_experts=16, top_k=2, d_ff=14336)
           if i % 2 == 1 else Dense(d_ff=14336))
    return Layer(mixer, ffn)


CONFIG = register(ModelConfig(
    name="jamba-v0.1-52b",
    family="hybrid",
    d_model=4096,
    vocab_size=65536,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    period=tuple(_layer(i) for i in range(8)),
    num_periods=4,
    remat=True,
    fsdp=True,
    supports_long_natively=True,   # 28/32 layers are SSM; 4 attn layers' KV fits
    source="arXiv:2403.19887",
))
