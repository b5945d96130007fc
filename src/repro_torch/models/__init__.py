"""The model zoo's dense family (``transformer``, ``layers``) and its DynaBRO
tasks (``zoo``). The serving entry points are exported as in the JAX package
and raise until serving is ported."""
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
