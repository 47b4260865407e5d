"""Architecture registry.  Importing this package registers the ten
architectures of the JAX package's registry: gemma3-1b (the fast tier)
and phi4-mini-3.8b, granite-moe-3b-a800m, rwkv6-3b, jamba-v0.1-52b,
starcoder2-7b, musicgen-large (audio frontend), qwen2-vl-72b (M-RoPE and
the vision frontend), moonshot-v1-16b-a3b and kimi-k2-1t-a32b (the
expensive tier)."""
from repro_torch.configs.base import (Attn, Dense, Layer, Mamba, MoE,
                                      ModelConfig, RWKV6, get_config,
                                      list_configs, long_context_variant,
                                      register, smoke_variant)

# registry order = import order
from repro_torch.configs import (  # noqa: F401,E402
    jamba_v0_1_52b, musicgen_large, phi4_mini_3_8b, starcoder2_7b,
    kimi_k2_1t_a32b, moonshot_v1_16b_a3b, qwen2_vl_72b, rwkv6_3b,
    granite_moe_3b_a800m, gemma3_1b)

ASSIGNED = ("jamba-v0.1-52b", "musicgen-large", "phi4-mini-3.8b",
            "starcoder2-7b", "kimi-k2-1t-a32b", "moonshot-v1-16b-a3b",
            "qwen2-vl-72b", "rwkv6-3b", "granite-moe-3b-a800m", "gemma3-1b")

__all__ = [
    "Attn", "Dense", "Layer", "Mamba", "MoE", "ModelConfig", "RWKV6",
    "get_config", "list_configs", "long_context_variant", "register",
    "smoke_variant", "ASSIGNED",
]
