"""Architecture registry.  Importing this package registers the models
the port serves: gemma3-1b (the fast tier) and phi4-mini-3.8b,
granite-moe-3b-a800m, rwkv6-3b or jamba-v0.1-52b (the expensive
tier)."""
from repro_torch.configs.base import (Attn, Dense, Layer, Mamba, MoE,
                                      ModelConfig, RWKV6, get_config,
                                      list_configs, long_context_variant,
                                      register, smoke_variant)

# registry order = import order
from repro_torch.configs import (  # noqa: F401,E402
    phi4_mini_3_8b, granite_moe_3b_a800m, gemma3_1b, rwkv6_3b,
    jamba_v0_1_52b)

ASSIGNED = ("phi4-mini-3.8b", "granite-moe-3b-a800m", "gemma3-1b",
            "rwkv6-3b", "jamba-v0.1-52b")

__all__ = [
    "Attn", "Dense", "Layer", "Mamba", "MoE", "ModelConfig", "RWKV6",
    "get_config", "list_configs", "long_context_variant", "register",
    "smoke_variant", "ASSIGNED",
]
