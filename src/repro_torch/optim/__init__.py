"""Optimizers over parameter dicts."""
from repro_torch.optim.optimizers import (
    Optimizer, adagrad_norm, adam, apply_updates, get_optimizer, momentum, sgd,
)

__all__ = ["Optimizer", "adagrad_norm", "adam", "apply_updates",
           "get_optimizer", "momentum", "sgd"]
