"""Qwen2-VL-72B — VLM decoder with M-RoPE (3-section rotary).

[arXiv:2409.12191]  80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
The ViT vision encoder + projector is the sanctioned frontend stub:
`input_specs` provides precomputed patch embeddings (dim 1280, the ViT
output width); a learned projector maps them into d_model and they replace
the token embeddings at the leading `frontend_len` positions.  M-RoPE splits
head_dim into (temporal, height, width) = (16, 24, 24) rotary sections
[arXiv:2409.12191 §2.1].
"""
from repro_torch.configs.base import Attn, Dense, Layer, ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    d_model=8192,
    vocab_size=152064,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    period=(Layer(Attn(rope="mrope"), Dense(d_ff=29568, act="swiglu")),),
    num_periods=80,
    frontend="vision",
    frontend_dim=1280,
    frontend_len=1024,     # patches per image at the dry-run resolution
    remat=True,
    fsdp=True,
    source="arXiv:2409.12191",
))
