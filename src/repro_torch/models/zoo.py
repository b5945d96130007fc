"""Model-zoo DynaBRO tasks: the port of the JAX package's ``models/zoo.py``.

Wraps a real architecture (a ``configs`` arch id, reduced, or any
``ModelConfig`` of the dense family) as a ``core.scenarios.Task``, so the
compiled driver runs the zoo through the same path as the other testbeds:
``run_dynabro_scan(task.grad_fn, ..., microbatch=True)`` streams each
round's units without the (m, 2^j, P) gradient stack. Unit batches follow
``SyntheticLMData.mlmc_batches``'s nested keying (level j−1 is the prefix of
level j). The audio and VLM families' extra inputs come with those families
(ROADMAP.md queue 1).
"""
from __future__ import annotations

import torch
from torch.func import grad

from repro_torch.configs import ModelConfig, get_reduced_config
from repro_torch.core.scenarios import Task
from repro_torch.data.pipeline import SyntheticLMData
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params, loss_fn

EVAL_STEP = 999_983  # the held-out batch's step: no training round reaches it


def task_for_config(cfg: ModelConfig, *, seq_len: int = 32, unit_batch: int = 1,
                    dtype=torch.float32, seed: int = 0, device="cuda") -> Task:
    """The DynaBRO ``Task`` of model ``cfg`` on ``device``: ``params0`` from
    ``init_params(cfg, seed)``; ``grad_fn`` the per-unit gradient of the
    model's ``loss_fn`` (``torch.func.grad``); ``make_sampler(m)`` the (m,
    n, unit_batch, S) token/label batches of ``SyntheticLMData(seed)``; the
    ``objective`` the loss on a held-out batch of 4 sequences."""
    dev = resolve_device(device)
    params0 = init_params(cfg, seed, dtype, device=dev)
    data = SyntheticLMData(cfg.vocab_size, seq_len, global_batch=unit_batch,
                           seed=seed, device=dev)

    def grad_fn(params, b):
        return grad(lambda p: loss_fn(p, b, cfg))(params)

    def make_sampler(m: int):
        return data.mlmc_sampler(m, unit_batch)

    eval_b = data.batch(EVAL_STEP, 4)

    def objective(p) -> float:
        with torch.no_grad():
            return float(loss_fn(p, eval_b, cfg))

    return Task(params0, grad_fn, make_sampler, objective)


def make_zoo_task(arch_id: str, *, seq_len: int = 32, unit_batch: int = 1,
                  d_model: int = 64, n_layers: int = 2, dtype=torch.float32,
                  seed: int = 0, device="cuda"):
    """Returns ``(Task, ModelConfig)`` for ``arch_id`` reduced to
    ``d_model`` and ``n_layers`` (``get_reduced_config``): the task of
    ``task_for_config``."""
    cfg = get_reduced_config(arch_id, d_model=d_model, n_layers=n_layers)
    return task_for_config(cfg, seq_len=seq_len, unit_batch=unit_batch,
                           dtype=dtype, seed=seed, device=device), cfg
