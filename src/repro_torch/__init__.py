"""PyTorch port of the cascade serving system (the JAX package
``repro`` is the reference it is tested against).

The port serves the two-tier confidence-gated cascade on one CUDA
device: block-paged KV cache, chunked prefill, one ragged flat token
batch per tier per tick, and the paper's max-softmax gate.  Its two hot
spots are hand-written CUDA kernels (``csrc/``) loaded through
``ctypes``; each has a plain PyTorch version beside it that the CPU
tests and the on-card checks compare against.

Nothing here imports ``jax`` or the ``repro`` package.
"""
