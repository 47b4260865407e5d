from repro_torch.models import blocks, cache, params, transformer  # noqa: F401
from repro_torch.models.cache import init_paged_cache
from repro_torch.models.params import declare_model, from_jax, init_params
from repro_torch.models.transformer import ragged_step

__all__ = ["blocks", "cache", "params", "transformer", "declare_model",
           "from_jax", "init_params", "init_paged_cache", "ragged_step"]
