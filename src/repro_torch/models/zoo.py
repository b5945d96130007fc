"""Model-zoo DynaBRO tasks: the port of the JAX package's ``models/zoo.py``.

Wraps a real architecture (a ``configs`` arch id, reduced, or any
``ModelConfig``) as a ``core.scenarios.Task``, so the compiled driver runs
the zoo through the same path as the other testbeds:
``run_dynabro_scan(task.grad_fn, ..., microbatch=True)`` streams each
round's units without the (m, 2^j, P) gradient stack. Unit batches follow
``SyntheticLMData.mlmc_batches``'s nested keying (level j−1 is the prefix of
level j), and the audio and VLM families' ``extra`` leaves (``_extra_units``)
are keyed unit by unit the same way, so the nesting holds for every family.
"""
from __future__ import annotations

import torch
from torch.func import grad

from repro_torch.configs import ModelConfig, get_reduced_config
from repro_torch.core.scenarios import Task
from repro_torch.data.pipeline import SyntheticLMData, key_seed
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_params, loss_fn

EVAL_STEP = 999_983  # the held-out batch's step: no training round reaches it
EXTRA_TAG = 0x5EED  # the last word of an extra unit's key: not a token key


def _extra_units(cfg: ModelConfig, seed: int, step: int, m: int, n: int,
                 unit_batch: int, dtype, device) -> dict:
    """The audio family's {"frames"} (E = ``encoder_seq``) or the VLM's
    {"patches"} (E = ``n_image_tokens``) of one round: (m, n, unit_batch, E,
    d_model) standard normals. Unit (w, k) is drawn on ``device`` by a
    generator of its own, keyed on (seed, step, w, k, EXTRA_TAG), so it is a
    pure function of its key and the level-(j−1) draw is the prefix of the
    level-j one, as for the tokens. The stream is the port's own (the JAX
    package draws from threefry keys); a card's generator and the CPU's
    give different normals for one key."""
    if cfg.family == "audio":
        name, E = "frames", cfg.encoder_seq
    else:
        name, E = "patches", cfg.n_image_tokens
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    grid = torch.empty((m, n, unit_batch, E, cfg.d_model), dtype=torch.float32,
                       device=dev)
    for w in range(m):
        for k in range(n):
            gen.manual_seed(key_seed(seed, step, w, k, EXTRA_TAG))
            torch.randn(grid.shape[2:], generator=gen, out=grid[w, k])
    return {name: grid.to(dtype)}


def task_for_config(cfg: ModelConfig, *, seq_len: int = 32, unit_batch: int = 1,
                    dtype=torch.float32, seed: int = 0, device="cuda") -> Task:
    """The DynaBRO ``Task`` of model ``cfg`` on ``device``: ``params0`` from
    ``init_params(cfg, seed)``; ``grad_fn`` the per-unit gradient of the
    model's ``loss_fn`` (``torch.func.grad``); ``make_sampler(m)`` the (m,
    n, unit_batch, S) token/label batches of ``SyntheticLMData(seed)``, with
    the audio and VLM families' ``extra`` (``_extra_units``); the
    ``objective`` the loss on a held-out batch of 4 sequences (and its
    extra, keyed on the held-out step)."""
    dev = resolve_device(device)
    params0 = init_params(cfg, seed, dtype, device=dev)
    data = SyntheticLMData(cfg.vocab_size, seq_len, global_batch=unit_batch,
                           seed=seed, device=dev)

    def grad_fn(params, b):
        return grad(lambda p: loss_fn(p, b, cfg))(params)

    has_extra = cfg.family in ("audio", "vlm")

    def make_sampler(m: int):
        base = data.mlmc_sampler(m, unit_batch)
        if not has_extra:
            return base

        def sample(t, n):
            b = base(t, n)
            b["extra"] = _extra_units(cfg, seed, t, m, n, unit_batch, dtype, dev)
            return b

        return sample

    eval_b = data.batch(EVAL_STEP, 4)
    if has_extra:
        eval_b["extra"] = {k: v[0, 0] for k, v in _extra_units(
            cfg, seed, EVAL_STEP, 1, 1, 4, dtype, dev).items()}

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
