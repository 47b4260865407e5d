"""Granite-3.0 MoE 3B-A800M — 40 experts top-8.

[hf:ibm-granite/granite-3.0-1b-a400m-base family]  32L d_model=1536 24H
(GQA kv=8) expert d_ff=512 vocab=49155, MoE 40e top-8.  About 3.30 B
parameters: 13.2 GB in f32, so one card holds the whole model.
"""
from repro_torch.configs.base import Attn, Layer, MoE, ModelConfig, register

CONFIG = register(ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    d_model=1536,
    vocab_size=49155,
    num_heads=24,
    num_kv_heads=8,
    head_dim=64,
    period=(Layer(Attn(), MoE(num_experts=40, top_k=8, d_ff=512)),),
    num_periods=32,
    tie_embeddings=True,
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
))
