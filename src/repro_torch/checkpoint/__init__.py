"""Carry checkpoints in the JAX package's ``.npz``/``.json`` layout."""
from repro_torch.checkpoint.checkpoint import (
    checkpoint_step, latest_checkpoint, load_checkpoint, save_checkpoint,
)

__all__ = ["save_checkpoint", "load_checkpoint", "checkpoint_step",
           "latest_checkpoint"]
