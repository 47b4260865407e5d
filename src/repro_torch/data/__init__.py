from repro_torch.data.synthetic import bigram_lm

__all__ = ["bigram_lm"]
