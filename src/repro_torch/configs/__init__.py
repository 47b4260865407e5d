"""Architecture registry.  Importing this package registers the two
cascade tiers the port serves: gemma3-1b (fast) and phi4-mini-3.8b
(expensive)."""
from repro_torch.configs.base import (Attn, Dense, Layer, Mamba, MoE,
                                      ModelConfig, RWKV6, get_config,
                                      list_configs, long_context_variant,
                                      register, smoke_variant)

# registry order = import order
from repro_torch.configs import phi4_mini_3_8b, gemma3_1b  # noqa: F401,E402

ASSIGNED = ("phi4-mini-3.8b", "gemma3-1b")

__all__ = [
    "Attn", "Dense", "Layer", "Mamba", "MoE", "ModelConfig", "RWKV6",
    "get_config", "list_configs", "long_context_variant", "register",
    "smoke_variant", "ASSIGNED",
]
