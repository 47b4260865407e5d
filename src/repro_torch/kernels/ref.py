"""Plain PyTorch versions of the ported kernels, under the JAX package's
names (``repro/kernels/ref.py``): the ground truth the kernel tests and
``chip_smoke.py`` compare against."""
from repro_torch.kernels.confidence_gate import confidence_gate_ref
from repro_torch.kernels.flash_attention import flash_attention_ref
from repro_torch.kernels.mamba_scan import mamba_scan_ref
from repro_torch.kernels.mixed_attention import mixed_attention_ref
from repro_torch.kernels.paged_attention import paged_attention_ref
from repro_torch.kernels.prefill_attention import paged_prefill_attention_ref
from repro_torch.kernels.ragged_attention import ragged_attention_ref
from repro_torch.kernels.router_gate import router_gate_ref
from repro_torch.kernels.rwkv6_scan import rwkv6_scan_ref

__all__ = ["confidence_gate_ref", "flash_attention_ref", "mamba_scan_ref",
           "mixed_attention_ref", "paged_attention_ref",
           "paged_prefill_attention_ref", "ragged_attention_ref",
           "router_gate_ref", "rwkv6_scan_ref"]
