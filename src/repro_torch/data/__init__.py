from repro_torch.data.pipeline import Batches
from repro_torch.data.synthetic import (Dataset, bigram_lm, gaussian_mixture,
                                        teacher_task)

__all__ = ["Batches", "Dataset", "bigram_lm", "gaussian_mixture",
           "teacher_task"]
