"""PyTorch port of the cascade serving system (the JAX package
``repro`` is the reference it is tested against).

The port serves the two-tier confidence-gated cascade on one CUDA
device: block-paged KV cache, chunked prefill, one ragged flat token
batch per tier per tick, and the paper's max-softmax gate, with
gemma3-1b as the fast tier and phi4-mini-3.8b, granite-moe-3b-a800m,
rwkv6-3b or the hybrid jamba-v0.1-52b (Mamba + attention + MoE) as the
expensive one.  Its hot spots are eight hand-written CUDA kernels
(``csrc/``: ragged, paged, mixed and flash attention, the confidence
gate, the MoE router gate, and the RWKV-6 and Mamba scans) loaded
through ``ctypes``; each has a plain PyTorch version beside it that the
CPU tests and the on-card checks compare against.

Nothing here imports ``jax`` or the ``repro`` package.
"""
