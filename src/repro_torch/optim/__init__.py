"""Optimizers and learning-rate schedules over the port's parameter
trees."""
from repro_torch.optim.optimizer import (Optimizer, adafactor, adamw,
                                         cosine, get_optimizer,
                                         sgd_momentum, step_decay)

__all__ = ["Optimizer", "adafactor", "adamw", "cosine", "get_optimizer",
           "sgd_momentum", "step_decay"]
