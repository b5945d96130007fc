"""Mode A — paper-faithful DynaBRO training (Algorithm 2), per-round driver.

Workers are simulated with ``torch.func.vmap`` (the paper's experimental
setup): per round t, each of the m workers computes ``2^{J_t}`` unit-batch
gradients; Byzantine workers (per the switching strategy, possibly changing
*within* the round) corrupt theirs; the server aggregates levels 0, J−1, J
with a robust rule, applies the MLMC combine + fail-safe filter, and takes an
optimizer step.

An in-cap round (1 ≤ J ≤ j_max) aggregates three levels, a beyond-cap round
one. On the card each aggregation launches its rule's kernels once per
parameter leaf: the coordinate-wise reduce for Mean/CWMed/CWTM, the pairwise
distances and then the weighted combine for Krum and MFM, the pairwise
distances and then the mix+reduce for NNM with a coordinate-wise base, and
a combine plus, per Weiszfeld iteration, a cross distance and a combine for
GeoMed.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import vmap

from repro_torch.core import attacks as attacks_lib
from repro_torch.core.agg_engine import get_aggregator
from repro_torch.core.aggregators import MFM
from repro_torch.core.mlmc import MLMCConfig, mlmc_combine, round_cost, sample_level
from repro_torch.core.switching import Switcher
from repro_torch.optim.optimizers import Optimizer, apply_updates

GradFn = Callable[[Any, Any], Any]  # (params, unit_batch) -> grad dict


@dataclasses.dataclass
class DynaBROConfig:
    mlmc: MLMCConfig
    aggregator: str = "cwtm"  # any core.agg_engine registry rule
    delta: float = 0.25
    attack: str = "sign_flip"
    attack_kwargs: Optional[dict] = None
    use_mlmc: bool = True  # False -> plain robust-aggregated SGD
    agg_backend: str = "auto"  # engine backend: ref | kernel | auto
    # rule hyperparameters: Krum's multi, GeoMed's iters/eps, MFM's tau (else
    # mlmc.mfm_tau(n)); a "delta" here overrides the field above
    aggregator_kwargs: Optional[dict] = None


def _per_worker_grads(grad_fn: GradFn, params, batches):
    """batches: tree leading (m, n, ...) -> grads dict leading (m, n, ...)."""
    g1 = vmap(grad_fn, in_dims=(None, 0))
    return vmap(g1, in_dims=(None, 0))(params, batches)


def _attack_stack(cfg: DynaBROConfig, grads, masks):
    """grads: (m, n, ...) leaves; masks: (n, m) bool -> attacked grads. The
    attack runs once per within-round computation k with that k's mask."""
    atk = attacks_lib.get_attack(cfg.attack, **(cfg.attack_kwargs or {}))
    swapped = {k: torch.swapaxes(v, 0, 1) for k, v in grads.items()}  # (n, m, ...)
    attacked = vmap(atk)(swapped, masks)
    return {k: torch.swapaxes(v, 0, 1) for k, v in attacked.items()}


def _aggregate(cfg: DynaBROConfig, stacked, n: int):
    """Robustly aggregate a worker-stacked parameter dict whose entries are
    means of ``n`` unit gradients; MFM's threshold scales as 1/√n."""
    kw = dict(cfg.aggregator_kwargs or {})
    delta = kw.pop("delta", cfg.delta)
    if cfg.aggregator == "mfm":
        tau = kw.pop("tau", None)
        agg = MFM(backend=cfg.agg_backend, **kw)
        return agg.tree(stacked, tau=cfg.mlmc.mfm_tau(n) if tau is None else tau)
    agg = get_aggregator(cfg.aggregator, delta=delta, backend=cfg.agg_backend,
                         **kw)
    return agg.tree(stacked)


def _combine_from_levels(cfg: DynaBROConfig, g0_stack, gh, gbar_all, n: int,
                         j: int):
    """Aggregate the per-worker level means and apply the MLMC combine.
    g0_stack / gh / gbar_all are (m, ...) dicts: each worker's level-0 unit,
    first-half mean and full mean, means of 1, n//2 and n unit gradients;
    ``gh`` is None whenever the MLMC branch below is dead."""
    if cfg.use_mlmc and 1 <= j <= cfg.mlmc.j_max:
        g0 = _aggregate(cfg, g0_stack, 1)
        gjm1 = _aggregate(cfg, gh, n // 2)
        gj = _aggregate(cfg, gbar_all, n)
        return mlmc_combine(g0, gjm1, gj, j, cfg.mlmc)
    g0 = _aggregate(cfg, g0_stack, 1)
    g, info = mlmc_combine(g0, None, None, cfg.mlmc.j_max + 1, cfg.mlmc)
    if not cfg.use_mlmc:  # plain robust SGD on the full mini-batch
        g = _aggregate(cfg, gbar_all, n)
    return g, info


def _combine_levels(cfg: DynaBROConfig, grads, j: int):
    """Slice the attacked (m, n, ...) stack into the three level means and
    combine."""
    n = next(iter(grads.values())).shape[1]
    gbar_all = {k: v.mean(1) for k, v in grads.items()}  # level j: mean of n
    g0_stack = {k: v[:, 0] for k, v in grads.items()}  # level 0: first sample
    gh = None
    if cfg.use_mlmc and 1 <= j <= cfg.mlmc.j_max:
        gh = {k: v[:, : n // 2].mean(1) for k, v in grads.items()}
    return _combine_from_levels(cfg, g0_stack, gh, gbar_all, n, j)


def make_dynabro_step(grad_fn: GradFn, cfg: DynaBROConfig, opt: Optimizer):
    """Returns step(params, opt_state, batches, masks, j).

    batches: tree leading (m, 2^j) (or (m, 1) when j=0 / beyond cap);
    masks: (2^j, m) bool tensor — within-round identity masks.
    """

    def step(params, opt_state, batches, masks, j: int):
        grads = _per_worker_grads(grad_fn, params, batches)  # (m, n, ...)
        grads = _attack_stack(cfg, grads, masks)
        g, info = _combine_levels(cfg, grads, j)
        updates, opt_state = opt.update(g, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, info

    return step


@dataclasses.dataclass
class RoundLog:
    level: int
    failsafe_ok: bool
    n_byz: int
    cost: int


def run_dynabro(
    grad_fn: GradFn,
    params,
    opt: Optimizer,
    cfg: DynaBROConfig,
    switcher: Switcher,
    sample_batches: Callable[[int, int], Any],  # (t, n) -> tree leading (m, n)
    T: int,
    seed: int = 0,
    eval_fn: Optional[Callable[[Any, int], Dict[str, float]]] = None,
    eval_every: int = 0,
    step=None,
):
    """Run Algorithm 2 for T rounds on the device of ``params``. Returns
    (params, logs, evals).

    The levels come from ``np.random.default_rng(seed)`` and the masks from
    ``switcher.within_round``, round by round, exactly as the JAX package's
    per-round (legacy) driver draws them."""
    dev = next(iter(params.values())).device
    rng = np.random.default_rng(seed)
    step = step or make_dynabro_step(grad_fn, cfg, opt)
    opt_state = opt.init(params)
    logs, evals = [], []
    for t in range(T):
        j = sample_level(rng, cfg.mlmc.j_max) if cfg.use_mlmc else 0
        n = 2 ** j if (cfg.use_mlmc and j <= cfg.mlmc.j_max) else 1
        masks = np.stack([switcher.within_round(t, k) for k in range(n)])
        batches = sample_batches(t, n)
        params, opt_state, info = step(params, opt_state, batches,
                                       torch.as_tensor(masks, device=dev), j)
        logs.append(RoundLog(j, bool(info["failsafe_ok"]), int(masks[0].sum()),
                             round_cost(j, cfg.mlmc.j_max)))
        if eval_fn and eval_every and (t + 1) % eval_every == 0:
            evals.append((t + 1, eval_fn(params, t)))
    return params, logs, evals
