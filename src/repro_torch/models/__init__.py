"""The model zoo: every family's decoder stack (``transformer``, ``layers``,
``moe``, ``ssm``, ``flash``), its serving entry points (``init_cache``,
``prefill``, ``decode_step``) and its DynaBRO tasks (``zoo``), exported as
in the JAX package."""
from repro_torch.models.transformer import (
    decode_step,
    forward,
    init_cache,
    init_params,
    loss_fn,
    prefill,
)
from repro_torch.models.zoo import make_zoo_task, task_for_config

__all__ = ["init_params", "forward", "loss_fn", "init_cache", "decode_step",
           "prefill", "make_zoo_task", "task_for_config"]
