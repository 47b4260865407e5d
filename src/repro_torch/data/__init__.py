from repro_torch.data.pipeline import Batches, batch_pspec, shard_batch
from repro_torch.data.synthetic import (Dataset, bigram_lm, gaussian_mixture,
                                        teacher_task)

__all__ = ["Batches", "Dataset", "batch_pspec", "bigram_lm",
           "gaussian_mixture", "shard_batch", "teacher_task"]
