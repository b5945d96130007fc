"""Mode A — paper-faithful DynaBRO training (Algorithm 2) and the
worker-momentum baseline, each through a per-round driver and a compiled
whole-T driver.

Workers are simulated with ``torch.func.vmap`` (the paper's experimental
setup): per round t, each of the m workers computes ``2^{J_t}`` unit-batch
gradients; Byzantine workers (per the switching strategy, possibly changing
*within* the round) corrupt theirs; the server aggregates levels 0, J−1, J
with a robust rule, applies the MLMC combine + fail-safe filter, and takes an
optimizer step. The baseline (Karimireddy et al., 2021) robustly aggregates
the workers' momenta of attacked gradients instead.

An in-cap round (1 ≤ J ≤ j_max) aggregates three levels, a beyond-cap round
one. On the card each aggregation launches its rule's kernels: one
coordinate-wise reduce a tree for Mean/CWMed/CWTM, the pairwise distances
(one launch a leaf) and then one weighted combine a tree for Krum and MFM,
the pairwise distances and then one mix+reduce a tree for NNM with a
coordinate-wise base, and a combine plus, per Weiszfeld iteration, a cross
distance a leaf and a combine for GeoMed.

The per-round drivers (``run_dynabro``, ``run_momentum``) draw each round's
level, masks and batch on the host and read the fail-safe flag back every
round. The compiled drivers (``run_dynabro_scan``, ``run_momentum_scan``)
draw the same schedules before the rounds of a segment run and replay the
rounds without a host sync; on a card each round replays one captured CUDA
graph of its level (``ScanFn``). Both draw the ``random`` attack's noise
from one generator in the same order (``core/attacks.py``). The compiled
DynaBRO driver's ``microbatch`` form streams a round's units through three
accumulators instead of the (m, 2^J, ...) gradient stack (the model zoo's
path, ``models/zoo.py``); its ``random`` draws come unit by unit.

On a ``(workers, 'model')`` mesh the compiled DynaBRO driver takes the
model zoo's GSPMD path (``_gspmd_scan_fn``): each rank keeps its blocks of
the parameters, gathers them for the gradients of its block of workers,
exchanges the worker stacks for every worker at its blocks, and attacks,
aggregates and updates those, its rounds eager on a card too.

The lane-batched sweep (``run_dynabro_scan_sweep``) runs C cells that
share the level plan and the batches as lanes of one compiled round: each
lane's per-worker gradients, the attacks and rules per lane group from
their theta rows (``attacks.attack_switch``, ``agg_engine.agg_switch``:
the coordinate-wise rules in one lane reduce for all their lanes, the
geometry rules once per lane), ``mlmc_combine`` and the optimizer per
lane; on a card one CUDA graph per level replays the whole lane batch.
A lane's bits do not depend on the other lanes of its batch.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import gc
import math
import threading
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
from torch.func import vmap
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.core import attacks as attacks_lib
from repro_torch.core.agg_engine import agg_switch, agg_theta, get_aggregator
from repro_torch.core.aggregators import MFM
from repro_torch.core.mlmc import (
    MLMCConfig, level_prefix, level_schedule, mlmc_combine, round_cost,
    sample_level,
)
from repro_torch.core import sharded
from repro_torch.core.switching import Switcher
from repro_torch.kernels.fused import LAUNCHES
from repro_torch.optim.optimizers import Optimizer, apply_updates

GradFn = Callable[[Any, Any], Any]  # (params, unit_batch) -> grad dict
F32 = torch.float32
DYNABRO_SEED = 100_003  # the random attack's generator: seed * this a run
MOMENTUM_SEED = 77_003

# The level graphs captured by this process, on any thread (the aggregation
# service captures on its serve thread): one a level key, however many
# pieces a worker mesh cuts it into. With ``kernels.build.BUILDS`` these are
# the port's compiles, which ``lint.runtime.recompile_guard`` counts.
CAPTURES = {"captures": 0}
_CAPTURES_LOCK = threading.Lock()


def count_captures(n: int = 1) -> None:
    """Add ``n`` level-graph captures to ``CAPTURES``."""
    with _CAPTURES_LOCK:
        CAPTURES["captures"] += n


def capture_count() -> int:
    with _CAPTURES_LOCK:
        return CAPTURES["captures"]


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


def _device_of(params) -> torch.device:
    return next(iter(params.values())).device


def _generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def _per_worker_grads(grad_fn: GradFn, params, batches):
    """batches: tree leading (m, n, ...) -> grads dict leading (m, n, ...)."""
    g1 = vmap(grad_fn, in_dims=(None, 0))
    return vmap(g1, in_dims=(None, 0))(params, batches)


def _random_on_blocks(cfg: DynaBROConfig, plan, stacked, mask, generator,
                      lead: int):
    """The ``random`` attack on a sharded round's stack of parameter blocks
    (``lead`` leading dims): each leaf's whole noise drawn from
    ``generator`` as the unsharded round draws it, leaves in sorted order,
    and this rank's block of it kept (a copy, so the draw is freed)."""
    noise = {}
    for k in sorted(stacked):
        v = stacked[k]
        full = torch.randn(plan.full_shape(k, v.shape, lead),
                           generator=generator, dtype=F32, device=v.device)
        noise[k] = plan.block(k, full, lead).clone(
            memory_format=torch.contiguous_format)
        del full
    scale = (cfg.attack_kwargs or {}).get("scale", 10.0)  # random_noise's
    return attacks_lib.apply_noise(stacked, mask, noise, scale)


def _attack_stack(cfg: DynaBROConfig, grads, masks, generator=None, plan=None):
    """grads: (m, n, ...) leaves; masks: (n, m) bool -> attacked grads. The
    attack runs once per within-round computation k with that k's mask:
    mapped over k by vmap, or, for an attack that draws noise, on the whole
    (n, m, ...) stack at once from ``generator`` (under a ``plan``, the
    GSPMD path, the whole leaves' draw narrowed to the rank's blocks)."""
    atk = attacks_lib.get_attack(cfg.attack, **(cfg.attack_kwargs or {}))
    swapped = {k: torch.swapaxes(v, 0, 1) for k, v in grads.items()}  # (n, m, ...)
    if cfg.attack in attacks_lib.STACK_ATTACKS and plan is not None:
        attacked = _random_on_blocks(cfg, plan, swapped, masks, generator, 2)
    elif cfg.attack in attacks_lib.STACK_ATTACKS:
        attacked = atk(swapped, masks, generator=generator)
    else:
        attacked = vmap(atk)(swapped, masks)
    return {k: torch.swapaxes(v, 0, 1) for k, v in attacked.items()}


def _aggregate(cfg: DynaBROConfig, stacked, n: int, plan=None):
    """Robustly aggregate a worker-stacked parameter dict whose entries are
    means of ``n`` unit gradients; MFM's threshold scales as 1/√n. Under a
    ``plan`` (the GSPMD path) the leaves are the rank's parameter blocks and
    the rules' distances are summed over every rank's blocks."""
    kw = dict(cfg.aggregator_kwargs or {})
    delta = kw.pop("delta", cfg.delta)
    leaf_sum = None if plan is None else plan.total
    if cfg.aggregator == "mfm":
        tau = kw.pop("tau", None)
        agg = MFM(backend=cfg.agg_backend, **kw)
        return agg.tree(stacked, tau=cfg.mlmc.mfm_tau(n) if tau is None else tau,
                        leaf_sum=leaf_sum)
    agg = get_aggregator(cfg.aggregator, delta=delta, backend=cfg.agg_backend,
                         **kw)
    return agg.tree(stacked, leaf_sum=leaf_sum)


def _combine_from_levels(cfg: DynaBROConfig, g0_stack, gh, gbar_all, n: int,
                         j: int, plan=None):
    """Aggregate the per-worker level means and apply the MLMC combine.
    g0_stack / gh / gbar_all are (m, ...) dicts: each worker's level-0 unit,
    first-half mean and full mean, means of 1, n//2 and n unit gradients;
    ``gh`` is None whenever the MLMC branch below is dead. Under a ``plan``
    the correction's norm is summed over every rank's blocks."""
    norm_fn = None if plan is None else plan.norm
    if cfg.use_mlmc and 1 <= j <= cfg.mlmc.j_max:
        g0 = _aggregate(cfg, g0_stack, 1, plan)
        gjm1 = _aggregate(cfg, gh, n // 2, plan)
        gj = _aggregate(cfg, gbar_all, n, plan)
        return mlmc_combine(g0, gjm1, gj, j, cfg.mlmc, norm_fn=norm_fn)
    g0 = _aggregate(cfg, g0_stack, 1, plan)
    g, info = mlmc_combine(g0, None, None, cfg.mlmc.j_max + 1, cfg.mlmc)
    if not cfg.use_mlmc:  # plain robust SGD on the full mini-batch
        g = _aggregate(cfg, gbar_all, n, plan)
    return g, info


def _combine_levels(cfg: DynaBROConfig, grads, j: int, plan=None):
    """Slice the attacked (m, n, ...) stack into the three level means and
    combine."""
    n = next(iter(grads.values())).shape[1]
    gbar_all = {k: v.mean(1) for k, v in grads.items()}  # level j: mean of n
    g0_stack = {k: v[:, 0] for k, v in grads.items()}  # level 0: first sample
    gh = None
    if cfg.use_mlmc and 1 <= j <= cfg.mlmc.j_max:
        gh = {k: v[:, : n // 2].mean(1) for k, v in grads.items()}
    return _combine_from_levels(cfg, g0_stack, gh, gbar_all, n, j, plan)


def _stream_levels(grad_fn: GradFn, cfg: DynaBROConfig, atk, params, batches,
                   masks, n: int, j: int, generator=None, gather=None,
                   plan=None):
    """The round's three level means without the (m, n, ...) stack: unit by
    unit, the (m, ...) worker gradients of unit k (batches: tree leading (m,
    n)), attacked with unit k's mask (masks: (n, m)) and, for ``random``,
    drawn from ``generator`` in unit order, are summed into float32
    accumulators: the level-0 snapshot (unit 0), the first-half sum and the
    full sum, as the JAX package's ``_stream_levels`` does. The sums are
    divided in place (the same bits as a division into new buffers), cast
    to the parameters' dtypes and combined by ``_combine_from_levels``. The
    accumulators are contiguous; the first half's is kept only when the
    MLMC branch is live and the full sum only when it or plain SGD reads
    it. The summation order differs from the stacked means', so the
    streamed round is not bitwise the stacked one. ``gather`` re-assembles
    each unit's worker gradients from the ranks' blocks, as in
    ``make_dynabro_step``; a ``plan`` (the GSPMD path) exchanges them
    instead, so the accumulators hold every worker at the rank's parameter
    blocks (``ShardPlan.exchange``)."""
    mlmc_live = cfg.use_mlmc and 1 <= j <= cfg.mlmc.j_max
    need_all = mlmc_live or not cfg.use_mlmc
    worker_grads = vmap(grad_fn, in_dims=(None, 0))
    a0 = ah = aa = None
    for k in range(n):
        g = worker_grads(params, tree_map(lambda l: l.select(1, k), batches))
        if gather is not None:
            g = gather(g)
        if plan is not None:
            g = plan.exchange(g, 1)
        if plan is not None and cfg.attack in attacks_lib.STACK_ATTACKS:
            g = _random_on_blocks(cfg, plan, g, masks[k], generator, 1)
        else:
            g = atk(g, masks[k], generator=generator)
        g = {key: v.to(F32).contiguous() for key, v in g.items()}
        if k == 0:
            a0 = g

            def zeros():
                return {key: torch.zeros(v.shape, dtype=F32, device=v.device)
                        for key, v in g.items()}
            ah = zeros() if mlmc_live else None
            aa = zeros() if need_all else None
        if ah is not None and k < n // 2:
            for key, v in ah.items():
                v.add_(g[key])
        if aa is not None:
            for key, v in aa.items():
                v.add_(g[key])
        del g

    def mean(acc, count):
        return None if acc is None else {
            key: v.div_(count).to(params[key].dtype) for key, v in acc.items()}

    g0_stack = {key: v.to(params[key].dtype) for key, v in a0.items()}
    return _combine_from_levels(cfg, g0_stack, mean(ah, n // 2), mean(aa, n),
                                n, j, plan)


def make_dynabro_step(grad_fn: GradFn, cfg: DynaBROConfig, opt: Optimizer,
                      gather=None):
    """Returns step(params, opt_state, batches, masks, j, generator=None):
    one round of Algorithm 2, shared by both drivers.

    batches: tree leading (m, 2^j) (or (m, 1) when j=0 / beyond cap);
    masks: (2^j, m) bool tensor — within-round identity masks; generator:
    what the ``random`` attack draws from. ``gather`` (a sharded compiled
    driver's ``_WorkerGather``) re-assembles the gradients of this rank's
    block of workers, ``batches`` leading (m_local, 2^j), into the (m, ...)
    stack before the attack.
    """

    def step(params, opt_state, batches, masks, j: int, generator=None):
        grads = _per_worker_grads(grad_fn, params, batches)  # (m, n, ...)
        if gather is not None:
            grads = gather(grads)
        grads = _attack_stack(cfg, grads, masks, generator)
        g, info = _combine_levels(cfg, grads, j)
        updates, opt_state = opt.update(g, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, info

    return step


def make_momentum_step(grad_fn: GradFn, cfg: DynaBROConfig, lr: float,
                       beta: float, gather=None):
    """Worker-momentum baseline (App. E semantics): returns
    step(params, worker_m, batches, mask, generator=None), one round shared
    by both momentum drivers: the attack on the m unit gradients (batches:
    tree leading (m,); mask: (m,)), each worker's float32 momentum
    ``beta * m + (1 - beta) * g``, and an sgd step of ``lr`` on the robust
    aggregate of the momenta (n = 1). beta=0 recovers vanilla distributed
    SGD. ``gather`` re-assembles the unit gradients of this rank's block of
    workers (``make_dynabro_step``); the momenta are every worker's."""
    atk = attacks_lib.get_attack(cfg.attack, **(cfg.attack_kwargs or {}))

    def step(params, worker_m, batches, mask, generator=None):
        grads = vmap(grad_fn, in_dims=(None, 0))(params, batches)
        if gather is not None:
            grads = gather(grads)
        grads = atk(grads, mask, generator=generator)
        worker_m = {k: beta * worker_m[k] + (1.0 - beta) * grads[k].to(F32)
                    for k in sorted(worker_m)}
        agg = _aggregate(cfg, worker_m, 1)
        params = apply_updates(params, {k: lr * agg[k] for k in sorted(agg)})
        return params, worker_m

    return step


def _zero_momenta(params, m: int):
    return {k: torch.zeros((m,) + params[k].shape, dtype=F32,
                           device=params[k].device) for k in sorted(params)}


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
    per-round (legacy) driver draws them; the ``random`` attack draws from a
    generator seeded with ``seed * 100_003``."""
    dev = _device_of(params)
    rng = np.random.default_rng(seed)
    gen = _generator(dev, seed * DYNABRO_SEED)
    step = step or make_dynabro_step(grad_fn, cfg, opt)
    opt_state = opt.init(params)
    logs, evals = [], []
    for t in range(T):
        j = sample_level(rng, cfg.mlmc.j_max) if cfg.use_mlmc else 0
        n = 2 ** j if (cfg.use_mlmc and j <= cfg.mlmc.j_max) else 1
        masks = np.stack([switcher.within_round(t, k) for k in range(n)])
        batches = sample_batches(t, n)
        params, opt_state, info = step(params, opt_state, batches,
                                       torch.as_tensor(masks, device=dev), j,
                                       gen)
        logs.append(RoundLog(j, bool(info["failsafe_ok"]), int(masks[0].sum()),
                             round_cost(j, cfg.mlmc.j_max)))
        if eval_fn and eval_every and (t + 1) % eval_every == 0:
            evals.append((t + 1, eval_fn(params, t)))
    return params, logs, evals


def run_momentum(
    grad_fn: GradFn,
    params,
    cfg: DynaBROConfig,
    switcher: Switcher,
    sample_batches: Callable[[int, int], Any],
    T: int,
    lr: float,
    beta: float,
    seed: int = 0,
    eval_fn: Optional[Callable[[Any, int], Dict[str, float]]] = None,
    eval_every: int = 0,
    step=None,
):
    """Worker-momentum / vanilla-SGD baseline, one round at a time on the
    device of ``params``: one unit batch a worker a round,
    ``sample_batches(t, 1)[:, 0]``, under ``switcher.mask(t)``; the
    ``random`` attack draws from a generator seeded with ``seed * 77_003``.
    Returns (params, evals)."""
    dev = _device_of(params)
    gen = _generator(dev, seed * MOMENTUM_SEED)
    step = step or make_momentum_step(grad_fn, cfg, lr, beta)
    worker_m = _zero_momenta(params, switcher.m)
    evals = []
    for t in range(T):
        mask = torch.as_tensor(switcher.mask(t), device=dev)
        batches = tree_map(lambda l: l[:, 0], sample_batches(t, 1))
        params, worker_m = step(params, worker_m, batches, mask, gen)
        if eval_fn and eval_every and (t + 1) % eval_every == 0:
            evals.append((t + 1, eval_fn(params, t)))
    return params, evals


# ------------------------------------------------------ host schedules
#
# The compiled drivers draw every schedule before the rounds run, seeded as
# the per-round drivers draw them, so the two are round-for-round equal.


def _pad_units(tree, n_max: int, axis: int):
    """Pad the within-round unit axis to n_max by repeating the first unit
    (a level-j round only ever reads the first 2^j units)."""
    def pad(l):
        n = l.shape[axis]
        if n == n_max:
            return l
        reps = list(l.shape)
        reps[axis] = n_max - n
        return torch.cat([l, l.narrow(axis, 0, 1).expand(reps)], dim=axis)
    return tree_map(pad, tree)


def _batch_schedule(sample_batches, tn, n_max: int, vectorize: bool = True,
                    row_fn=None):
    """Stack a segment's batches into an (L, m, n_max, ...) padded schedule
    (a nested dict, such as the zoo's ``extra``, keeps its structure):
    ``tn`` is the segment's [(t, n_t), ...], and each round calls
    ``sample_batches(t, n_t)`` once, in round order, at the per-round
    driver's batch size (the sampler's output may depend on n, so padding
    follows sampling). Each round is written straight into its row of the
    schedule, padded as ``_pad_units`` pads (the first unit repeated), so
    no second copy of the segment is held. ``row_fn`` (None: none) maps
    each round's (m, n_t, ...) tree before it is written, as a sharded
    driver narrows it to its rank's workers, so the schedule is as wide as
    what ``row_fn`` keeps. ``vectorize`` is taken for the JAX package's
    signature and changes nothing: the port's samplers are called one
    round at a time."""
    out = None
    for i, (t, n) in enumerate(tn):
        row = sample_batches(t, int(n))
        if row_fn is not None:
            row = row_fn(row)
        if out is None:
            out = tree_map(lambda l: l.new_empty(
                (len(tn), l.shape[0], n_max) + tuple(l.shape[2:])), row)

        def fill(dst, src):
            k = src.shape[1]
            dst[i, :, :k].copy_(src)
            dst[i, :, k:].copy_(src[:, :1].expand_as(dst[i, :, k:]))
        tree_map(fill, out, row)
        del row
    return out


def _level_plan(cfg: DynaBROConfig, rng: np.random.Generator, T: int):
    """Host-side MLMC level plan: (levels (T,), per-round unit counts ns,
    n_max), replaying the level stream the per-round driver draws."""
    j_max = cfg.mlmc.j_max
    if cfg.use_mlmc:
        levels = level_schedule(rng, j_max, T)
        n_max = 2 ** j_max
        ns = np.where(levels <= j_max, 2 ** levels.astype(np.int64), 1)
    else:
        levels = np.zeros(T, np.int32)
        n_max = 1
        ns = np.ones(T, np.int64)
    return levels, ns, n_max


def _round_logs(levels, ok, masks, j_max: int) -> list:
    """Per-round RoundLog list from the level plan, the (T,) fail-safe flags
    and the (T, n_max, m) mask schedule (beyond-cap rounds, j > j_max, cost
    1: the correction is dropped)."""
    return [RoundLog(int(levels[t]), bool(ok[t]), int(masks[t, 0].sum()),
                     round_cost(int(levels[t]), j_max))
            for t in range(len(levels))]


def _mask_schedule(switcher: Switcher, T: int, n_max: int,
                   ns: np.ndarray) -> np.ndarray:
    """(T, n_max, m) identity schedule: the vectorized ``mask_schedule``
    when ``within_round`` is the stock one, else a replay of the per-round
    driver's exact call sequence (only the n_t computations of each round;
    pad rows are never read, so stateful within-round strategies stay
    exact)."""
    if type(switcher).within_round is Switcher.within_round:
        return switcher.mask_schedule(T, n_max)
    masks = np.zeros((T, n_max, switcher.m), bool)
    for t in range(T):
        for k in range(int(ns[t])):
            masks[t, k] = switcher.within_round(t, k)
    return masks


def _segment_bounds(T: int, eval_every: int, chunk: int):
    stops = {T}
    if eval_every:
        stops |= set(range(eval_every, T + 1, eval_every))
    if chunk and chunk > 0:
        stops |= set(range(chunk, T + 1, chunk))
    return sorted(stops)


# ------------------------------------------------------ worker meshes
#
# Every rank calls a sharded driver with the same arguments. On a 1-axis
# worker mesh params, optimizer state, momenta, masks, levels and
# generators are replicated; only the batch schedule is split on its worker
# axis, rank r of an axis of n holding workers [r·m/n, (r+1)·m/n). After the
# worker gather every rank runs the same attack, aggregation and update, so
# every rank returns the same params and logs. On a 2-axis (workers,
# 'model') mesh (the GSPMD path, ``_gspmd_scan_fn``) the params and the
# optimizer state are split too, and a rank attacks, aggregates and
# updates its own blocks of them (``sharded.ShardPlan``).


def _check_scan_fn_mesh(scan_fn, mesh) -> None:
    """Reject a prebuilt scan_fn whose build-time mesh disagrees with this
    run's ``mesh=``: an unsharded fn passed with a mesh would silently run
    the whole loop unsharded (and vice versa). Fns built outside
    ``make_*_scan_fn`` carry no tag and are trusted."""
    have = getattr(scan_fn, "worker_mesh", mesh)
    if (have is None) != (mesh is None) or have != mesh:
        raise ValueError(
            f"scan_fn was built with mesh={have}, but this run passes "
            f"mesh={mesh}; rebuild the scan_fn with the same mesh")


def _check_worker_mesh(mesh, worker_axis: str, m: Optional[int] = None,
                       allow_model: bool = True) -> None:
    """A 1-axis ``(worker_axis,)`` mesh, or with ``allow_model`` the 2-axis
    ``(worker_axis, 'model')`` mesh of the GSPMD path, whose worker axis
    divides m (None: not checked)."""
    axes = tuple(mesh.axis_names)
    if not allow_model and "model" in axes:  # momentum runs
        raise ValueError(
            "momentum scan driver supports only 1-axis worker meshes; the "
            "2-axis (workers, 'model') GSPMD path is DynaBRO-only "
            "(DESIGN.md §9)")
    allowed = ((worker_axis,), (worker_axis, "model")) if allow_model \
        else ((worker_axis,),)
    if axes not in allowed:
        want = f"1-axis ({worker_axis!r},)" + (
            f" or 2-axis ({worker_axis!r}, 'model')" if allow_model else "")
        raise ValueError(
            f"sharded driver needs a {want} mesh, got "
            f"axes {axes} (see launch.mesh.make_worker_mesh)")
    n_dev = mesh.shape[worker_axis]
    if m is not None and m % n_dev:
        raise ValueError(
            f"worker count m={m} not divisible by the {worker_axis!r} mesh "
            f"axis size {n_dev}")


def _check_lane_mesh(mesh, lane_axis: str, worker_axis: str,
                     m: Optional[int] = None) -> None:
    """Reject a sweep mesh that is not the 2-axis ``(lanes, workers)``
    form; with ``m`` also check worker divisibility (the lane divisibility
    check needs the lane count and lives in the sweep)."""
    axes = tuple(mesh.axis_names)
    if axes != (lane_axis, worker_axis):
        raise ValueError(
            f"sharded sweeps need a 2-axis ({lane_axis!r}, {worker_axis!r}) "
            f"mesh, got axes {axes} (see launch.mesh.make_lane_mesh)")
    if m is not None and m % mesh.shape[worker_axis]:
        raise ValueError(
            f"worker count m={m} not divisible by the {worker_axis!r} mesh "
            f"axis size {mesh.shape[worker_axis]}")


def _check_param_specs(mesh, param_specs) -> None:
    if param_specs is not None and (mesh is None
                                    or "model" not in mesh.axis_names):
        raise ValueError(
            "param_specs only applies to the 2-axis (workers, 'model') GSPMD "
            "path; the 1-axis shard_map path replicates params (DESIGN.md §9)")


def _gspmd_plan(mesh, worker_axis: str, param_specs):
    """The GSPMD path's ``sharded.ShardPlan`` on a ``(workers, 'model')``
    mesh (the JAX package's ``_gspmd_constraints``), or None on a mesh of
    one device: that mesh runs the unsharded round function, bitwise
    ``mesh=None`` by construction."""
    if math.prod(list(mesh.shape.values())) == 1:
        return None
    return sharded.ShardPlan(mesh, worker_axis, param_specs)


def _norm_mesh(mesh):
    """A mesh of one device is the unsharded path: None."""
    if mesh is None or math.prod(list(mesh.shape.values())) == 1:
        return None
    return mesh


class _WorkerGather:
    """The worker gather of a sharded round function over ``mesh``'s
    ``axis``: ``gather(tree, dim=0)`` re-assembles the (.., m_local, ..)
    stacks of the ranks (``dim`` the worker axis) into (.., m, ..) in rank
    order, and ``shard(tree, dim)`` takes this rank's block of workers out
    of a full batch. Eager it runs the collective
    (``sharded.gather_worker_stack``); while ``_LevelGraphs`` captures a
    round, ``split`` is set and cuts the capture there instead."""

    def __init__(self, mesh, axis: str):
        self.mesh, self.axis = mesh, axis
        self.n = mesh.shape[axis]
        self.split = None

    def __call__(self, tree, dim: int = 0):
        if self.split is not None:
            return self.split(tree, dim)
        return sharded.gather_worker_stack(tree, self.mesh, self.axis, dim)

    def buffers(self, flats):
        """The buffers an all-gather of ``sharded.pack``'s ``flats`` writes,
        and the call that runs it."""
        bufs = sharded.empty_buffers(flats, self.n)
        return bufs, functools.partial(sharded.all_gather_into, bufs, flats,
                                       self.mesh.group(self.axis))

    def shard(self, tree, dim: int):
        return sharded.worker_block(tree, self.n,
                                    self.mesh.coordinate(self.axis), dim,
                                    self.axis)


def _worker_gather(mesh, worker_axis: str) -> Optional[_WorkerGather]:
    """The gather of a sharded round function, or None where there is
    nothing to re-assemble (no mesh, or a worker axis of one device, whose
    block is the whole stack): the 1-device mesh runs the unsharded round
    function, bitwise the unsharded driver by construction."""
    if mesh is None or mesh.shape[worker_axis] == 1:
        return None
    return _WorkerGather(mesh, worker_axis)


def _check_scan_fn_microbatch(scan_fn, microbatch: bool) -> None:
    """Reject a prebuilt scan_fn (None: none given) built for the other unit
    path: the streamed and the stacked rounds are not bitwise equal."""
    have = getattr(scan_fn, "microbatch", microbatch)
    if have != microbatch:
        raise ValueError(
            f"scan_fn was built with microbatch={have}, but this run passes "
            f"microbatch={microbatch}; rebuild the scan_fn to match (the two "
            "paths are not bitwise-equivalent)")


@functools.cache
def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The one stream a device's level graphs are warmed up and captured
    on: the distance kernels keep a counter per stream that has called them
    (``kernels/fused.py``, 256 a device), so the graphs of every run share
    one."""
    return torch.cuda.Stream(dev)


def _graph_shapes(carry, batch_rows, mask_rows, lane=None) -> tuple:
    """What a set of level graphs is built for: the device, the shapes and
    dtypes of the carry, of a round's batch and of its masks (rows of a
    schedule: their first axis is the rounds'), and for lanes the plan's
    groups and the shapes of its rows."""
    def signature(tree, skip=0):
        return tuple((tuple(l.shape[skip:]), l.dtype)
                     for l in tree_leaves(tree))
    lanes = None if lane is None else (lane[0].key, signature(lane[1]))
    return (tree_leaves(carry)[0].device, signature(carry),
            signature(batch_rows, 1), tuple(mask_rows.shape[1:]), lanes)


def _seed_generators(gens, seeds) -> None:
    """Seed each generator, or set it to a ``get_state()`` tensor given in
    place of its seed."""
    for gen, s in zip(gens, seeds):
        if isinstance(s, torch.Tensor):
            gen.set_state(s)
        else:
            gen.manual_seed(int(s))


def _call_round(round_fn, carry, batch, masks, key, generators, lane):
    """One round: ``round_fn(carry, batch, masks, key, generator)``, or for
    lanes ``round_fn(carry, batch, masks, key, generators, lane)``."""
    if lane is None:
        return round_fn(carry, batch, masks, key, generators[0])
    return round_fn(carry, batch, masks, key, generators, lane)


class _LevelGraphs:
    """The static buffers of a compiled run on a card, and one captured CUDA
    graph per key (MLMC level) over them.

    A graph reads its round's batch at the segment round index ``sidx``
    from the (L, ...) segment schedule and its masks at the run round index
    ``gidx`` from the (T, ...) mask schedule, runs the round function on the
    static carry, copies the new carry into it in place, writes the round's
    fail-safe flag and correction norm at ``gidx`` and advances both
    indices: a replay takes no input from the host. The graphs share one
    memory pool; they never run at once, and all a round keeps is copied
    out of the pool before it ends.

    Under a worker mesh (``gather``, a ``_WorkerGather``) a round's worker
    gather is a collective the host runs (gloo's goes through it), which a
    graph cannot hold: the capture is cut at each gather into the graph
    before it and the graph after it, and a replay runs the gather eagerly
    between them, from the packed stacks the first graph leaves in the pool
    (kept alive, so no later capture takes their memory) into buffers the
    second graph reads. ``GATHERS`` counts the replays' gathers as
    ``LAUNCHES`` counts their kernels. Without one a round is one graph.

    Launch counts: a replay calls no wrapper, so each graph keeps the
    ``LAUNCHES`` its capture counted, and the driver adds them once for
    every replay; the warm-up's and the capture's own counts are taken back
    out.

    Lanes (``lane``: a ``LanePlan`` and its rows on the card): the rows are
    static buffers too, copied in before a run, so a sweep with new
    hyperparameters for the same lane groups replays the same graphs; the
    flags are (T, C).
    """

    def __init__(self, round_fn, carry, batch_rows, mask_rows, generators,
                 L: int, T: int, flags: bool, lane=None, gather=None):
        dev = tree_leaves(carry)[0].device
        self.round_fn, self.generators, self.flags = round_fn, generators, flags
        self.gather = gather
        self.carry = tree_map(torch.clone, carry)
        self.batches = tree_map(
            lambda l: torch.zeros((L,) + l.shape[1:], dtype=l.dtype, device=dev),
            batch_rows)
        self.masks = torch.zeros((T,) + tuple(mask_rows.shape[1:]),
                                 dtype=torch.bool, device=dev)
        self.lane = None if lane is None else (
            lane[0], {k: v.clone() for k, v in lane[1].items()})
        flag_shape = () if lane is None else (lane[0].lanes,)
        self.ok = torch.zeros((T,) + flag_shape, dtype=torch.bool, device=dev)
        self.corr_norm = torch.zeros((T,) + flag_shape, dtype=F32, device=dev)
        self.sidx = torch.zeros(1, dtype=torch.int64, device=dev)
        self.gidx = torch.zeros(1, dtype=torch.int64, device=dev)
        self.shapes = _graph_shapes(carry, batch_rows, mask_rows, lane)
        self.L, self.T = L, T
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = _capture_stream(dev)
        # key -> ([(CUDAGraph, the gather after it or None), ...], launches)
        self.graphs: Dict[Any, tuple] = {}
        self.capture_seconds: Dict[Any, float] = {}

    def fits(self, carry, batch_rows, mask_rows, L: int, T: int,
             lane=None) -> bool:
        return (self.shapes == _graph_shapes(carry, batch_rows, mask_rows, lane)
                and L <= self.L and T <= self.T)

    def _round(self, key):
        batch = tree_map(lambda b: b.index_select(0, self.sidx)[0], self.batches)
        masks = self.masks.index_select(0, self.gidx)[0]
        return _call_round(self.round_fn, self.carry, batch, masks, key,
                           self.generators, self.lane)

    def _begin(self) -> torch.cuda.CUDAGraph:
        graph = torch.cuda.CUDAGraph()
        for generator in self.generators:
            graph.register_generator_state(generator)
        graph.capture_begin(pool=self.pool)
        return graph

    def _capture_round(self, key) -> list:
        """Capture one round on the capturing stream as graph pieces, cut at
        each worker gather (``torch.cuda.graph``'s own steps: the card
        synchronised and the cache emptied before the first piece, and the
        capture ended when the round raises, so the stream takes work
        again).

        The cyclic collector stays off until the round is captured: a CUDA
        graph freed while a capture runs, on any thread, ends the capture
        with ``cudaErrorStreamCaptureInvalidated``, and an earlier session
        left in a reference cycle (a server and its thread) holds graphs
        that only the collector frees. It is not run before the capture,
        as ``torch.cuda.graph`` does: a full collection of a process that
        holds a model costs tenths of a second a capture."""
        pieces, graph = [], None

        def split(tree, dim):
            nonlocal graph
            flats, layout = sharded.pack(tree, dim)
            done, graph = graph, None
            done.capture_end()
            bufs, gather = self.gather.buffers(flats)
            pieces.append((done, gather))
            graph = self._begin()
            return sharded.unpack(bufs, layout)

        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        collecting = gc.isenabled()
        gc.disable()
        try:
            if self.gather is not None:
                self.gather.split = split
            with torch.cuda.stream(self.stream):
                try:
                    graph = self._begin()
                    carry, ok, corr_norm = self._round(key)
                    tree_map(lambda dst, src: dst.copy_(src), self.carry, carry)
                    if self.flags:
                        row = (1,) + tuple(self.ok.shape[1:])
                        self.ok.index_copy_(0, self.gidx, ok.reshape(row))
                        self.corr_norm.index_copy_(0, self.gidx,
                                                   corr_norm.reshape(row).to(F32))
                    self.gidx.add_(1)
                    self.sidx.add_(1)
                    done, graph = graph, None
                    done.capture_end()
                    pieces.append((done, None))
                finally:
                    if graph is not None:
                        graph.capture_end()
                    if self.gather is not None:
                        self.gather.split = None
        finally:
            if collecting:
                gc.enable()
        return pieces

    def capture(self, keys) -> None:
        """Warm the rounds of ``keys`` up on the capturing stream (the
        kernels' counters, the libraries' workspaces), then capture each. The
        warm-ups all come first: a warm-up allocates from the caching
        allocator's default pool, which each capture empties as it begins,
        and a capture from the graphs' pool, which keeps its memory while
        the graphs live; so a warm-up after a capture would hold both at
        once (a model's round holds tens of GB). A capture that fails
        raises: there is no eager fallback. The warm-ups' gathers run the
        collective; neither they nor the captures count."""
        before, gathers = dict(LAUNCHES), dict(sharded.GATHERS)
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        for key in keys:
            t0 = time.perf_counter()
            # the warm-up reads the schedules at the round indices: earlier
            # replays may have left them past the buffers' end
            self.sidx.zero_()
            self.gidx.zero_()
            with torch.cuda.stream(self.stream):
                self._round(key)  # results dropped; the carry is not written
            self.stream.synchronize()
            self.capture_seconds[key] = time.perf_counter() - t0
        current.wait_stream(self.stream)
        LAUNCHES.update(before)
        sharded.GATHERS.update(gathers)
        for key in keys:
            t0 = time.perf_counter()
            self.sidx.zero_()
            self.gidx.zero_()
            pieces = self._capture_round(key)
            # the round's outputs went back to the pool for the next capture
            launches = {k: v - before[k] for k, v in LAUNCHES.items()
                        if v != before[k]}
            LAUNCHES.update(before)
            self.graphs[key] = (pieces, launches)
            self.capture_seconds[key] += time.perf_counter() - t0
            count_captures()

    def replay(self, keys) -> None:
        """Replay the graphs of ``keys`` in order, each under
        ``torch.cuda.set_sync_debug_mode("error")`` (a host sync in the loop
        raises), and the gathers between a round's graphs outside it."""
        rounds = [self.graphs[k][0] for k in keys]
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for pieces in rounds:
                for graph, gather in pieces:
                    graph.replay()
                    if gather is not None:
                        torch.cuda.set_sync_debug_mode(mode)
                        gather()
                        torch.cuda.set_sync_debug_mode("error")
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        for key, count in collections.Counter(keys).items():
            for k, v in self.graphs[key][1].items():
                LAUNCHES[k] += v * count


class ScanFn:
    """A compiled driver's round loop over one round function, reusable
    across runs (``make_dynabro_scan_fn``, ``make_momentum_scan_fn``).

    ``round_fn(carry, batch, masks, key, generator) -> (carry, ok,
    corr_norm)`` runs one round from its padded batch and its masks; ``key``
    is the round's MLMC level (0 in momentum mode, where ``flags`` is False
    and ok/corr_norm are None). A lane round function (the sweep's,
    ``lanes`` True) takes ``(carry, batch, masks, key, generators, lane)``
    instead, ``lane`` a ``LanePlan`` and its rows on the card, and gives
    (C,) flags.

    On the CPU the rounds run eagerly, one call each, and the fail-safe
    flags are read once a segment. On a card each key gets one captured CUDA
    graph (``_LevelGraphs``), kept for the next run while the shapes (and
    the lane groups) fit; ``capture_seconds`` holds each key's warm-up and
    capture time and ``captures`` counts the captures made (each also in
    the process's ``CAPTURES``); ``drop_graphs`` frees them. ``run_round``
    runs one round through the same graphs (``Session.step``). After a run,
    ``corr_norms`` holds its rounds' correction norms ((T,) or (T, C), read
    once after the last segment; None in momentum mode). ``microbatch``
    tells which unit path a DynaBRO round function runs.

    ``gather`` is the round function's ``_WorkerGather`` under a worker
    mesh: every rank runs the same rounds, each from its own block of the
    workers' batches (``run`` and ``run_round`` take full batches and keep
    the block), and the level graphs are cut at the gathers.

    ``plan`` is the GSPMD path's ``sharded.ShardPlan`` on a ``(workers,
    'model')`` mesh: the carry holds the rank's parameter blocks
    (``place``), ``run`` gives ``eval_fn`` and returns the full params
    (``full``), a rank keeps its block of workers' batches, and the rounds
    run eagerly on a card too (a round holds several collectives, which no
    graph can); ``eager_rounds`` counts the rounds run eagerly.
    """

    lane_attacks: Optional[tuple] = None
    lane_aggregators: Optional[tuple] = None
    lanes = False
    microbatch = False
    gather: Optional[_WorkerGather] = None
    plan: Optional[sharded.ShardPlan] = None

    def __init__(self, round_fn, flags: bool):
        self.round_fn, self.flags = round_fn, flags
        self._generators: Dict[torch.device, list] = {}
        self._graphs: Optional[_LevelGraphs] = None
        self.captures = 0
        self.eager_rounds = 0
        self.corr_norms: Optional[np.ndarray] = None

    def place(self, params):
        """The carry's params for full ``params``: the rank's blocks under a
        ``plan``, else ``params``."""
        return params if self.plan is None else self.plan.blocks(params)

    def full(self, params):
        """Full params from the carry's: gathered under a ``plan``."""
        return params if self.plan is None else self.plan.gather(params)

    def _block_rows(self):
        """This rank's block of workers of a full batch (dim 0), or None."""
        narrow = self.gather or self.plan
        return None if narrow is None else functools.partial(narrow.shard,
                                                             dim=0)

    def drop_graphs(self) -> None:
        """Free the kept graphs and their buffers: the next run or round
        on a card captures its levels anew."""
        self._graphs = None

    @property
    def capture_seconds(self) -> Dict[Any, float]:
        return dict(self._graphs.capture_seconds) if self._graphs else {}

    def generators(self, dev: torch.device, count: int = 1) -> tuple:
        """The ``random`` attack's generators of runs on ``dev``: one, or one
        per replicate of a sweep. The level graphs draw from these."""
        gens = self._generators.setdefault(dev, [])
        while len(gens) < count:
            gens.append(torch.Generator(device=dev))
        return tuple(gens[:count])

    def _level_graphs(self, carry, batch_rows, masks_dev, gens, L, T, lane):
        """The kept graphs where they fit, else new ones (the old graphs'
        pool goes first)."""
        g = self._graphs
        if g is None or g.generators != gens or not g.fits(
                carry, batch_rows, masks_dev, L, T, lane):
            g = self._graphs = None
            g = self._graphs = _LevelGraphs(self.round_fn, carry, batch_rows,
                                            masks_dev, gens, L, T, self.flags,
                                            lane, self.gather)
        return g

    def run(self, carry, keys, masks: np.ndarray, batches, bounds, seed,
            eval_fn=None, eval_every: int = 0, lane=None, start: int = 0,
            whole_carry: bool = False):
        """Run the rounds ``start`` .. ``bounds[-1]`` - 1 of ``keys`` (T,)
        from ``carry``, in the segments ending at ``bounds``: ``batches(a,
        b)`` gives rounds a..b-1's schedule (tree leading (b - a, ...));
        under a worker mesh it is called with ``row_fn=``, the narrowing of
        each drawn round to this rank's workers (``_batch_schedule``).
        ``masks`` (T, ...) every round's. ``seed`` seeds the generator, or
        is one seed per replicate of a sweep; a seed given as a
        ``get_state()`` tensor sets the generator to that state instead (a
        run that continues an earlier one from round ``start``). ``lane`` is
        a sweep's ``LanePlan``. Returns (params, or the whole carry with
        ``whole_carry``; the rounds' flags, a (rounds,) or (rounds, C) bool
        array, or None; evals)."""
        dev = tree_leaves(carry)[0].device
        rows = self._block_rows()
        if rows is not None:  # each round narrowed as it is drawn
            batches = functools.partial(batches, row_fn=rows)
        seeds = ((seed,) if isinstance(seed, (int, np.integer, torch.Tensor))
                 else tuple(seed))
        gens = self.generators(dev, len(seeds))
        masks_dev = torch.as_tensor(masks, device=dev)
        lane_dev = None if lane is None else (lane, lane.tensors(dev))
        if dev.type == "cuda" and self.plan is None:
            return self._run_graphs(carry, keys, masks_dev, batches, bounds,
                                    seeds, gens, eval_fn, eval_every, lane_dev,
                                    start, whole_carry)
        _seed_generators(gens, seeds)
        oks, dns, evals, a = [], [], [], start
        for b in bounds:
            seg = batches(a, b)
            flags = []
            for i, t in enumerate(range(a, b)):
                carry, ok, dn = _call_round(
                    self.round_fn, carry, tree_map(lambda l: l[i], seg),
                    masks_dev[t], int(keys[t]), gens, lane_dev)
                self.eager_rounds += 1
                flags.append(ok)
                dns.append(dn)
            if self.flags:
                oks.append(torch.stack(flags).cpu().numpy())
            if eval_fn and eval_every and b % eval_every == 0:
                evals.append((b, eval_fn(self.full(carry[0]), b - 1)))
            a = b
        self.corr_norms = (torch.stack(dns).to(F32).cpu().numpy()
                           if self.flags else None)
        return (carry if whole_carry else self.full(carry[0]),
                np.concatenate(oks) if self.flags else None, evals)

    def _run_graphs(self, carry, keys, masks_dev, batches, bounds, seeds, gens,
                    eval_fn, eval_every, lane, start, whole_carry):
        T = len(keys)
        L = max(b - a for a, b in zip([start] + bounds[:-1], bounds))
        seg = batches(start, bounds[0])
        with torch.cuda.device(masks_dev.device):
            g = self._level_graphs(carry, seg, masks_dev, gens, L, T, lane)
            # the first segment goes into the graphs' own buffers before the
            # captures, so its schedule is not held twice while they run
            tree_map(lambda dst, src: dst[:bounds[0] - start].copy_(src),
                     g.batches, seg)
            seg = None
            new = sorted({int(k) for k in keys[start:bounds[-1]]}
                         - set(g.graphs))
            g.capture(new)
            self.captures += len(new)
            # the captures above warmed up on the generators: seed them after
            _seed_generators(gens, seeds)
            tree_map(lambda dst, src: dst.copy_(src), g.carry, carry)
            if lane is not None:
                for k, v in lane[1].items():
                    g.lane[1][k].copy_(v)
            g.masks[:T].copy_(masks_dev)
            g.gidx.fill_(start)
            oks, evals, a = [], [], start
            for b in bounds:
                if a > start:
                    tree_map(lambda dst, src: dst[:b - a].copy_(src),
                             g.batches, batches(a, b))
                g.sidx.zero_()
                g.replay([int(k) for k in keys[a:b]])
                if self.flags:
                    oks.append(g.ok[a:b].cpu().numpy())  # one read a segment
                if eval_fn and eval_every and b % eval_every == 0:
                    evals.append((b, eval_fn(tree_map(torch.clone, g.carry[0]),
                                             b - 1)))
                a = b
            out = tree_map(torch.clone, g.carry if whole_carry else g.carry[0])
            self.corr_norms = (g.corr_norm[start:bounds[-1]].cpu().numpy()
                               if self.flags else None)
        return out, (np.concatenate(oks) if self.flags else None), evals

    def run_round(self, carry, key: int, batch, masks,
                  state: Optional[torch.Tensor] = None):
        """One round at level ``key`` from ``carry``, the round's padded
        ``batch`` and ``masks`` on the carry's device, and ``state``, the
        generator's ``get_state()`` at the round's start (None: a round that
        does not draw). Returns (carry, ok, corr_norm, the generator's state
        after the round).

        The round is the one ``run`` runs: eager on the CPU and under a
        ``plan`` (whose carry holds the rank's blocks); otherwise on a card
        the replay of the level's graph among the graphs kept (a run's, or,
        if none fits, a set built for one round), captured only where the
        level has none yet. So rounds driven one at a time give the bits of
        the same rounds inside ``run``."""
        dev = tree_leaves(carry)[0].device
        rows = self._block_rows()
        if rows is not None:
            batch = rows(batch)
        (gen,) = self.generators(dev, 1)
        if state is not None:
            gen.set_state(state)
        if dev.type != "cuda" or self.plan is not None:
            carry, ok, dn = self.round_fn(carry, batch, masks, key, gen)
            self.eager_rounds += 1
            return carry, ok, dn, gen.get_state()
        batch_rows = tree_map(lambda l: l[None], batch)
        with torch.cuda.device(dev):
            g = self._level_graphs(carry, batch_rows, masks[None], (gen,), 1,
                                   1, None)
            if key not in g.graphs:
                g.capture([key])
                self.captures += 1
                if state is not None:
                    gen.set_state(state)  # the capture warmed up on it
            tree_map(lambda dst, src: dst.copy_(src), g.carry, carry)
            tree_map(lambda dst, src: dst[0].copy_(src), g.batches, batch)
            g.masks[0].copy_(masks)
            g.gidx.zero_()
            g.sidx.zero_()
            g.replay([key])
            carry = tree_map(torch.clone, g.carry)
            ok = g.ok[0].clone() if self.flags else None
            dn = g.corr_norm[0].clone() if self.flags else None
        return carry, ok, dn, gen.get_state()


def make_dynabro_scan_fn(grad_fn: GradFn, cfg: DynaBROConfig, opt: Optimizer,
                         *, mesh=None, worker_axis: str = "workers",
                         lane_attacks=None, lane_aggregators=None,
                         param_specs=None, microbatch: bool = False,
                         sweep_mesh=None, lane_axis: str = "lanes") -> ScanFn:
    """Build the compiled DynaBRO round loop: a ``ScanFn`` whose round
    function runs ``make_dynabro_step`` at the round's level on the level's
    nested prefix of the n_max-padded batch (``level_prefix``) and masks,
    so every round equals the per-round driver's at that level. On a card
    it replays one CUDA graph per level (1 … j_max + 1, or one level 0 with
    ``use_mlmc=False``). Reusable across ``run_dynabro_scan`` calls.

    ``lane_attacks`` / ``lane_aggregators`` (sequences of names) build the
    sweep's lane form instead (``run_dynabro_scan_sweep``): lanes index
    these names through a ``LanePlan``, and an absent axis runs ``cfg``'s
    attack or rule on every lane.

    ``microbatch`` streams each round's units through three float32
    accumulators instead of materializing the (m, 2^j, ...) per-worker
    gradient stack (``_stream_levels``): the model zoo's path, where one
    stack of a real model's gradients is GBs. The unit loop unrolls inside
    each level's graph. Its parity contract is with the JAX package's
    microbatched driver; it is not bitwise the stacked path. Not for the
    lane form (sweeps materialize by design).

    ``mesh`` (a 1-axis mesh from ``launch.mesh.make_worker_mesh``) shards
    the round over ``worker_axis``: each rank computes the per-worker
    gradients of its block of workers, the stacks are re-assembled with a
    worker all-gather (``_WorkerGather``; on a card the level graphs are
    cut there), and the attack, the aggregation and the update run on
    every rank as the unsharded round runs them. A mesh of one device runs
    the unsharded round function, bitwise ``mesh=None``. The scan_fn keeps
    ``mesh`` as ``worker_mesh`` for the drivers' check.

    A **2-axis** ``(workers, 'model')`` mesh (``make_worker_mesh(model=)``)
    takes the model zoo's GSPMD path instead (``_gspmd_scan_fn``):
    ``param_specs`` (a spec tree over the params from
    ``launch.sharding.plan_params``; None replicates the params) splits
    each parameter over the worker axis (FSDP) and over 'model', the carry
    holds the rank's blocks, and a round gathers the params, computes the
    rank's block of workers, exchanges the worker stacks so each rank holds
    every worker at its blocks, and attacks, aggregates and updates those
    (``sharded.ShardPlan``). Every rank returns the same params and logs;
    against ``mesh=None`` the logs are equal and the params within rtol
    1e-5, atol 1e-6 (the coordinate-wise rules with sgd come out bitwise
    on the CPU; distances and norms are summed in another order). On a mesh
    whose axes are all size 1 the unsharded round function runs, bitwise
    ``mesh=None``; ``param_specs`` without a 2-axis mesh raises
    ``ValueError``.

    ``sweep_mesh`` (a 2-axis ``(lanes, workers)`` mesh from
    ``launch.mesh.make_lane_mesh``) builds the sweep's lane form sharded
    over ``worker_axis`` the same way (``Session.sweep`` splits the lanes
    over ``lane_axis``); exclusive with ``mesh`` and ``microbatch``.
    ``lane_attacks`` / ``lane_aggregators`` reject ``mesh``."""
    if (lane_attacks is not None or lane_aggregators is not None) \
            and mesh is not None:
        raise ValueError(
            "lane_attacks/lane_aggregators are for the vmapped sweep, which "
            "runs unsharded; drop mesh= (DESIGN.md §7)")
    if sweep_mesh is not None:
        if mesh is not None:
            raise ValueError(
                "sweep_mesh= (the vmapped sweep's lane mesh) and mesh= (the "
                "per-run worker mesh) are exclusive; see DESIGN.md §12")
        if microbatch:
            raise ValueError(
                "microbatch streaming is not supported on the sweep "
                "variants (DESIGN.md §9); drop sweep_mesh/microbatch")
        _check_lane_mesh(sweep_mesh, lane_axis, worker_axis)
    if microbatch and (lane_attacks is not None
                       or lane_aggregators is not None):
        raise ValueError(
            "microbatch streaming is not supported on the lane-batched sweep "
            "variant (DESIGN.md §9); drop lane_attacks/lane_aggregators")
    _check_param_specs(mesh, param_specs)
    if mesh is not None:
        _check_worker_mesh(mesh, worker_axis)
    if lane_attacks is not None or lane_aggregators is not None:
        return _lane_scan_fn(grad_fn, cfg, opt, lane_attacks, lane_aggregators,
                             sweep_mesh, worker_axis)
    plan = (_gspmd_plan(mesh, worker_axis, param_specs)
            if mesh is not None and "model" in mesh.axis_names else None)
    if plan is not None:
        scan_fn = _gspmd_scan_fn(grad_fn, cfg, opt, plan, microbatch)
        scan_fn.worker_mesh = mesh
        return scan_fn
    if microbatch:
        scan_fn = _streamed_scan_fn(grad_fn, cfg, opt,
                                    _worker_gather(mesh, worker_axis))
        scan_fn.worker_mesh = mesh
        return scan_fn
    j_max = cfg.mlmc.j_max
    n_max = 2 ** j_max if cfg.use_mlmc else 1
    gather = _worker_gather(mesh, worker_axis)
    step = make_dynabro_step(grad_fn, cfg, opt, gather)

    def round_fn(carry, batch, masks, j, generator):
        n = 2 ** j if (cfg.use_mlmc and 1 <= j <= j_max) else 1
        params, opt_state, info = step(
            carry[0], carry[1], level_prefix(batch, n, n_max, axis=1),
            masks[:n], j, generator)
        return (params, opt_state), info["failsafe_ok"], info["corr_norm"]

    scan_fn = ScanFn(round_fn, flags=True)
    scan_fn.gather = gather
    scan_fn.worker_mesh = mesh
    scan_fn.sweep_mesh = sweep_mesh
    # the same cfg's lane form, for sweeps that carry this scan_fn
    scan_fn.lane_form = functools.cache(functools.partial(
        _lane_scan_fn, grad_fn, cfg, opt, None, None, sweep_mesh, worker_axis))
    return scan_fn


def _streamed_scan_fn(grad_fn: GradFn, cfg: DynaBROConfig, opt: Optimizer,
                      gather=None) -> ScanFn:
    """``make_dynabro_scan_fn(microbatch=True)``'s round loop."""
    j_max = cfg.mlmc.j_max
    n_max = 2 ** j_max if cfg.use_mlmc else 1
    atk = attacks_lib.get_attack(cfg.attack, **(cfg.attack_kwargs or {}))

    def round_fn(carry, batch, masks, j, generator):
        n = 2 ** j if (cfg.use_mlmc and 1 <= j <= j_max) else 1
        params, opt_state = carry
        g, info = _stream_levels(grad_fn, cfg, atk, params,
                                 level_prefix(batch, n, n_max, axis=1),
                                 masks[:n], n, j, generator, gather)
        updates, opt_state = opt.update(g, opt_state, params)
        params = apply_updates(params, updates)
        return (params, opt_state), info["failsafe_ok"], info["corr_norm"]

    scan_fn = ScanFn(round_fn, flags=True)
    scan_fn.microbatch = True
    scan_fn.gather = gather
    return scan_fn


def _gspmd_scan_fn(grad_fn: GradFn, cfg: DynaBROConfig, opt: Optimizer,
                   plan: sharded.ShardPlan, microbatch: bool) -> ScanFn:
    """The GSPMD path's round loop on ``plan``'s mesh: the carry holds the
    rank's parameter and optimizer-state blocks, and a round gathers the
    full params, computes the per-worker gradients of the rank's block of
    workers (streamed unit by unit with ``microbatch``, else the (m_local,
    n, ...) stack), exchanges them to every worker at the rank's blocks,
    attacks and aggregates the blocks (the rules' distances and the
    correction's norm summed over every rank's blocks), and updates the
    blocks (AdaGrad-Norm's norm summed the same way). Eager on a card too:
    a round holds several collectives."""
    j_max = cfg.mlmc.j_max
    n_max = 2 ** j_max if cfg.use_mlmc else 1
    atk = attacks_lib.get_attack(cfg.attack, **(cfg.attack_kwargs or {}))

    def round_fn(carry, batch, masks, j, generator):
        n = 2 ** j if (cfg.use_mlmc and 1 <= j <= j_max) else 1
        blocks, opt_state = carry
        params = plan.gather(blocks)
        b = level_prefix(batch, n, n_max, axis=1)
        if microbatch:
            g, info = _stream_levels(grad_fn, cfg, atk, params, b, masks[:n],
                                     n, j, generator, plan=plan)
        else:
            grads = plan.exchange(_per_worker_grads(grad_fn, params, b), 2)
            del params
            grads = _attack_stack(cfg, grads, masks[:n], generator, plan)
            g, info = _combine_levels(cfg, grads, j, plan)
        updates, opt_state = opt.update(g, opt_state, blocks,
                                        sq_norm=plan.sq_norm)
        return ((apply_updates(blocks, updates), opt_state),
                info["failsafe_ok"], info["corr_norm"])

    scan_fn = ScanFn(round_fn, flags=True)
    scan_fn.microbatch = microbatch
    scan_fn.plan = plan
    return scan_fn


def run_dynabro_scan(
    grad_fn: GradFn,
    params,
    opt: Optimizer,
    cfg: DynaBROConfig,
    switcher: Switcher,
    sample_batches: Callable[[int, int], Any],
    T: int,
    seed: int = 0,
    eval_fn: Optional[Callable[[Any, int], Dict[str, float]]] = None,
    eval_every: int = 0,
    chunk: int = 0,
    scan_fn: Optional[ScanFn] = None,
    vectorize_batches: bool = True,
    mesh=None,
    worker_axis: str = "workers",
    param_specs=None,
    microbatch: bool = False,
):
    """Compiled drop-in for ``run_dynabro``: same returns, round-for-round
    equal schedules (level stream, switching masks, batch draws, the
    ``random`` attack's generator), on the device of ``params``.

    The rounds run in segments that end at every ``eval_every``-th round
    (where ``eval_fn`` runs) and every ``chunk``-th (0: none), which bounds
    the batches held at once; a segment's batches are drawn, one sampler
    call a round, before its rounds run, and its fail-safe flags are read
    once, after them. On a card the rounds replay one CUDA graph per level
    with no host sync between evaluation points. ``scan_fn`` takes a
    prebuilt ``make_dynabro_scan_fn`` result to reuse its graphs (built
    with this run's ``microbatch``). ``microbatch`` streams each round's
    units (``make_dynabro_scan_fn``); the model zoo runs this way.
    ``vectorize_batches`` changes nothing (``_batch_schedule``).

    ``mesh`` (a 1-axis worker mesh, ``launch.mesh.make_worker_mesh``) runs
    the loop sharded over ``worker_axis`` (``make_dynabro_scan_fn``): every
    rank of the mesh calls this with the same arguments and returns the same
    params and logs; ``switcher.m`` must be divisible by the axis. A mesh of
    one device is bitwise ``mesh=None``. A 2-axis ``(workers, 'model')``
    mesh takes the GSPMD path with ``param_specs`` (the spec tree from
    ``launch.sharding.plan_params``) splitting the parameters over both
    axes; the params given and returned are full on every rank
    (``make_dynabro_scan_fn`` for the contracts)."""
    _check_param_specs(mesh, param_specs)
    if mesh is not None:
        _check_worker_mesh(mesh, worker_axis, switcher.m)
    _check_scan_fn_mesh(scan_fn, mesh)
    _check_scan_fn_microbatch(scan_fn, microbatch)
    if T <= 0:
        return params, [], []
    scan_fn = scan_fn or make_dynabro_scan_fn(
        grad_fn, cfg, opt, mesh=mesh, worker_axis=worker_axis,
        param_specs=param_specs, microbatch=microbatch)
    levels, ns, n_max = _level_plan(cfg, np.random.default_rng(seed), T)
    masks = _mask_schedule(switcher, T, n_max, ns)

    def batches(a, b, row_fn=None):
        return _batch_schedule(sample_batches, list(zip(range(a, b), ns[a:b])),
                               n_max, vectorize=vectorize_batches, row_fn=row_fn)

    params = scan_fn.place(params)
    params, ok, evals = scan_fn.run(
        (params, opt.init(params)), levels, masks, batches,
        _segment_bounds(T, eval_every if eval_fn else 0, chunk),
        seed * DYNABRO_SEED, eval_fn, eval_every)
    return params, _round_logs(levels, ok, masks, cfg.mlmc.j_max), evals


# ------------------------------------------------------ lane-batched sweeps


@dataclasses.dataclass(frozen=True, eq=False)
class LanePlan:
    """The lanes of a sweep: each lane's attack and rule as an index into
    the lane scan_fn's names (host data: they decide which lanes each
    attack and rule runs on, so they are part of what a set of level graphs
    is built for), its attack and rule theta rows and its fail-safe
    coefficient (1+√2)·c_E·C·V (data: copied into the graphs' buffers
    before a run). With ``replicates`` R > 1 the lanes are cells × R,
    cell-major: lane c runs replicate c % R."""

    attack_ids: Tuple[int, ...]
    agg_ids: Tuple[int, ...]
    attack_theta: np.ndarray  # (C, N_PARAMS) float32
    agg_theta: np.ndarray  # (C, N_AGG_PARAMS) float32
    thr_coeff: np.ndarray  # (C,) float32
    replicates: int = 1

    @property
    def lanes(self) -> int:
        return len(self.attack_ids)

    @property
    def key(self) -> tuple:
        return (self.attack_ids, self.agg_ids, self.replicates)

    def tensors(self, dev: torch.device) -> Dict[str, torch.Tensor]:
        """The rows on ``dev``, as the lane round function reads them."""
        return {name: torch.as_tensor(np.asarray(getattr(self, name),
                                                 np.float32), device=dev)
                for name in ("attack_theta", "agg_theta", "thr_coeff")}

    def take(self, idx) -> "LanePlan":
        """The plan of the lanes ``idx``, in that order (whole cells of a
        replicated plan: the lanes stay cell-major)."""
        idx = [int(i) for i in idx]
        return LanePlan(tuple(self.attack_ids[i] for i in idx),
                        tuple(self.agg_ids[i] for i in idx),
                        np.asarray(self.attack_theta)[idx],
                        np.asarray(self.agg_theta)[idx],
                        np.asarray(self.thr_coeff)[idx], self.replicates)

    def repeat(self, R: int) -> "LanePlan":
        """The plan of R replicate lanes per lane (cell-major)."""
        rep = lambda a: np.repeat(np.asarray(a), R, axis=0)  # noqa: E731
        return LanePlan(tuple(int(i) for i in rep(self.attack_ids)),
                        tuple(int(i) for i in rep(self.agg_ids)),
                        rep(self.attack_theta), rep(self.agg_theta),
                        rep(self.thr_coeff), R)


def _norm_lane_specs(specs):
    out = []
    for a in specs:
        name, kw = (a, {}) if isinstance(a, str) else (a[0], dict(a[1] or {}))
        out.append((name, kw))
    return out


def _lane_attack_plan(attacks):
    """Per-lane attack specs (a name or ``(name, kwargs)``) as the lanes'
    plan: the distinct names in first-appearance order, the (C,) int32
    lane -> name index and the (C, N_PARAMS) float32 theta rows."""
    specs = _norm_lane_specs(attacks)
    names = tuple(dict.fromkeys(name for name, _ in specs))
    ids = np.array([names.index(name) for name, _ in specs], np.int32)
    thetas = np.stack([attacks_lib.attack_theta(name, kw)
                       for name, kw in specs])
    return names, ids, thetas


def _lane_agg_plan(aggregators, cfg: DynaBROConfig):
    """The rule axis of ``_lane_attack_plan``: the distinct rule names, the
    lane -> name index, the (C, N_AGG_PARAMS) theta rows, and the (C,)
    fail-safe coefficients: MFM lanes on Option 2 (c_E = 6√2), every other
    rule on Option 1 with ``cfg``'s kappa."""
    specs = _norm_lane_specs(aggregators)
    names = tuple(dict.fromkeys(name for name, _ in specs))
    ids = np.array([names.index(name) for name, _ in specs], np.int32)
    thetas = np.stack([agg_theta(name, kw) for name, kw in specs])
    coeffs = np.array(
        [dataclasses.replace(
            cfg.mlmc, option=2 if name == "mfm" else 1).threshold_coeff
         for name, _ in specs], np.float32)
    return names, ids, thetas, coeffs


def make_lane_plan(cfg: DynaBROConfig, lanes: int, attacks=None,
                   aggregators=None):
    """((attack names, rule names), ``LanePlan``) of ``lanes`` lanes: per
    lane attack and rule specs, or, for an axis given as None, ``cfg``'s
    attack (with its kwargs) or rule (with its delta and kwargs, at
    ``cfg``'s own fail-safe coefficient) on every lane. The names are what
    the lane scan_fn is built with: None for an axis given as None."""
    if attacks is not None:
        atk_names, a_ids, a_th = _lane_attack_plan(attacks)
    else:
        atk_names, a_ids = None, np.zeros(lanes, np.int32)
        a_th = np.stack([attacks_lib.attack_theta(
            cfg.attack, cfg.attack_kwargs)] * lanes)
    if aggregators is not None:
        agg_names, g_ids, g_th, coeffs = _lane_agg_plan(aggregators, cfg)
    else:
        kw = dict(cfg.aggregator_kwargs or {})
        kw.setdefault("delta", cfg.delta)
        agg_names, g_ids = None, np.zeros(lanes, np.int32)
        g_th = np.stack([agg_theta(cfg.aggregator, kw)] * lanes)
        coeffs = np.full(lanes, cfg.mlmc.threshold_coeff, np.float32)
    plan = LanePlan(tuple(int(i) for i in a_ids), tuple(int(i) for i in g_ids),
                    a_th, g_th, coeffs)
    return (atk_names, agg_names), plan


def _lane_opt_step(opt: Optimizer, params, opt_state, grads):
    """The optimizer step of a lane batch, a lane at a time: ``params`` and
    ``opt_state`` lead with the lane axis C, ``grads`` is the C lanes'
    gradient dicts. Under ``vmap`` adagrad_norm's norm would be a batched
    reduction whose sums change with the lane count on a card."""
    steps = []
    for c, g in enumerate(grads):
        p = {k: v[c] for k, v in params.items()}
        updates, state = opt.update(
            g, tree_map(lambda l, c=c: l[c], opt_state), p)
        steps.append((apply_updates(p, updates), state))
    params = {k: torch.stack([st[0][k] for st in steps]) for k in sorted(params)}
    return params, tree_map(lambda *ls: torch.stack(ls), *[st[1] for st in steps])


def _lane_scan_fn(grad_fn: GradFn, cfg: DynaBROConfig, opt: Optimizer,
                  lane_attacks, lane_aggregators, sweep_mesh=None,
                  worker_axis: str = "workers") -> ScanFn:
    """The sweep's compiled round loop over a ``LanePlan``'s lanes (the
    carry's leaves lead with the lane axis C; the batch is shared, or (R,
    ...) with one per replicate; the masks are (C, n_max, m)):

    - each lane's per-worker gradients as a lone run computes them (one
      ``vmap`` over its workers and units a lane: batching the lanes too
      changes the last bits of small products, which flips knife-edge
      choices such as Krum's);
    - each attack on its lanes (``attacks.attack_switch``);
    - each aggregation (levels 0, J−1, J) with each rule on its lanes
      (``agg_engine.agg_switch``): the coordinate-wise rules in one lane
      reduce for all their lanes (their trims from the theta rows, on the
      card), the geometry rules once per lane; outside vmap, since the
      kernels are ctypes calls;
    - ``mlmc_combine`` per lane at the lane's own bound, coefficient /
      √(2^J) in float32 as ``MLMCConfig.threshold`` computes it;
    - the optimizer a lane at a time.

    Every op batched over the lanes gives a lane the bits it gives that
    lane alone (the unit means, the lane reduce, the noise of ``random``;
    the card test ``test_lane_round_ops_ignore_the_lane_count`` holds them
    at 8, 5, 3, 2 and 1 lanes), so a lane of a sweep is the same lane of
    any sweep of a subset of its lanes (what ``Session.sweep_halving``
    needs). Each lane's round is the round of a lone ``run_dynabro_scan``
    of that lane, up to the rounding of the rules' lane forms.

    Under ``sweep_mesh`` each rank computes the gradients of its block of
    workers (the worker axis of ``sweep_mesh``) and the worker gather
    re-assembles the (C, m, n, ...) stack before the attack."""
    atk_names = (tuple(lane_attacks) if lane_attacks is not None
                 else (cfg.attack,))
    agg_names = (tuple(lane_aggregators) if lane_aggregators is not None
                 else (cfg.aggregator,))
    j_max = cfg.mlmc.j_max
    n_max = 2 ** j_max if cfg.use_mlmc else 1
    atk_apply = attacks_lib.attack_switch(atk_names)
    agg_apply = agg_switch(agg_names, backend=cfg.agg_backend, mlmc=cfg.mlmc)
    gather = _worker_gather(sweep_mesh, worker_axis)

    def lane_grads(params, batch, R: int):
        # each lane's gradients as a lone run computes them, one vmap over
        # its workers and units: a vmap over the lanes too hands cuBLAS
        # batched products whose sums differ in the last bit at 1 or 2 units
        # a worker, enough to flip Krum's choice at its collapse (PERF.md)
        lanes = []
        for c in range(next(iter(params.values())).shape[0]):
            b = batch if R == 1 else tree_map(lambda l: l[c % R], batch)
            lanes.append(_per_worker_grads(
                grad_fn, {k: v[c] for k, v in params.items()}, b))
        return {k: torch.stack([g[k] for g in lanes]) for k in sorted(lanes[0])}

    def lane_attack(plan, grads, masks, gens, theta):
        # contiguous, so that a lane's attack sees the same layout (and
        # gives the same bits) in any group of lanes
        swapped = {k: torch.swapaxes(v, 1, 2).contiguous()
                   for k, v in grads.items()}
        R = plan.replicates
        if R == 1:
            out = atk_apply(plan.attack_ids, swapped, masks, gens[0], theta)
        else:  # each replicate's lanes draw from its own generator
            lanes = [None] * plan.lanes
            for r in range(R):
                idx = list(range(r, plan.lanes, R))
                sub = atk_apply([plan.attack_ids[c] for c in idx],
                                {k: v[r::R] for k, v in swapped.items()},
                                masks[r::R], gens[r], theta[r::R])
                for i, c in enumerate(idx):
                    lanes[c] = {k: v[i] for k, v in sub.items()}
            out = {k: torch.stack([lane[k] for lane in lanes])
                   for k in sorted(swapped)}
        return {k: torch.swapaxes(v, 1, 2) for k, v in out.items()}

    def round_fn(carry, batch, masks, j, gens, lane):
        plan, rows = lane
        params, opt_state = carry
        n = 2 ** j if (cfg.use_mlmc and 1 <= j <= j_max) else 1
        b = level_prefix(batch, n, n_max, axis=1 if plan.replicates == 1 else 2)
        grads = lane_grads(params, b, plan.replicates)  # (C, m, n, ...)
        if gather is not None:
            grads = gather(grads, 1)
        grads = lane_attack(plan, grads, masks[:, :n], gens,
                            rows["attack_theta"])
        gbar_all = {k: v.mean(2) for k, v in grads.items()}
        g0_stack = {k: v[:, :, 0] for k, v in grads.items()}

        def agg(stacked, nn):
            return agg_apply(plan.agg_ids, stacked, nn, rows["agg_theta"])

        def lane_of(tree, c):
            return {k: v[c] for k, v in tree.items()}

        outs = []
        if cfg.use_mlmc and 1 <= j <= j_max:
            gh = {k: v[:, :, : n // 2].mean(2) for k, v in grads.items()}
            g0, gjm1, gj = agg(g0_stack, 1), agg(gh, n // 2), agg(gbar_all, n)
            thr = rows["thr_coeff"] / float(np.sqrt(np.float32(2.0 ** j)))
            for c in range(plan.lanes):
                outs.append(mlmc_combine(lane_of(g0, c), lane_of(gjm1, c),
                                         lane_of(gj, c), j, cfg.mlmc,
                                         threshold=thr[c]))
        else:
            g0 = agg(g0_stack, 1)
            g_all = None if cfg.use_mlmc else agg(gbar_all, n)
            for c in range(plan.lanes):
                g, info = mlmc_combine(lane_of(g0, c), None, None, j_max + 1,
                                       cfg.mlmc)
                outs.append((g if g_all is None else lane_of(g_all, c), info))
        ok = torch.stack([o[1]["failsafe_ok"] for o in outs])
        dn = torch.stack([o[1]["corr_norm"] for o in outs])
        params, opt_state = _lane_opt_step(opt, params, opt_state,
                                           [g for g, _ in outs])
        return (params, opt_state), ok, dn

    scan_fn = ScanFn(round_fn, flags=True)
    scan_fn.lanes = True
    scan_fn.gather = gather
    scan_fn.sweep_mesh = sweep_mesh
    scan_fn.lane_attacks = (tuple(lane_attacks) if lane_attacks is not None
                            else None)
    scan_fn.lane_aggregators = (tuple(lane_aggregators)
                                if lane_aggregators is not None else None)
    return scan_fn


def run_dynabro_scan_sweep(
    grad_fn: GradFn,
    params,
    opt: Optimizer,
    cfg: DynaBROConfig,
    switchers,
    sample_batches: Callable[[int, int], Any],
    T: int,
    seed: int = 0,
    chunk: int = 0,
    scan_fn=None,
    vectorize_batches: bool = True,
    attacks=None,
    aggregators=None,
    sweep_mesh=None,
    lane_axis: str = "lanes",
):
    """Run C = len(switchers) DynaBRO cells as lanes of one compiled loop.

    Every cell shares ``cfg``, ``seed`` and ``sample_batches`` and differs
    in its switcher and, with ``attacks`` / ``aggregators`` (one spec per
    lane: a name or ``(name, kwargs)``), in its attack and its rule and
    their parameters; MFM lanes run the Option-2 fail-safe coefficient.
    The level plan and the batches are shared; masks, params, optimizer
    state and the lanes' theta rows are per lane. Mixed-rule grids run one
    sub-sweep per distinct rule (with ``scan_fn`` None or a ``{rule:
    scan_fn}`` mapping), and results come back in the caller's lane order:
    ``[(params_c, logs_c), ...]``.

    Each lane equals a lone ``run_dynabro_scan`` of that lane's switcher,
    attack and rule in its round logs (fail-safe flags included) and in
    every discrete choice, and in its params within the rounding of the
    rules' lane forms (1e-6 for CWTM, 1e-5 for the geometry rules on the
    card at the Figure-1 setting). On a card one CUDA graph per level
    replays the whole lane batch, with one ``cw_reduce`` launch an
    aggregation for the coordinate-wise lanes.

    ``sweep_mesh`` (a ``(lanes, workers)`` mesh from
    ``launch.mesh.make_lane_mesh``) runs the cells sharded over it, as
    ``Session.sweep(lane_mesh=)`` does.

    A wrapper over ``repro_torch.api.Session.sweep`` with a validated
    ``SweepSpec``."""
    from repro_torch.api.session import Session
    from repro_torch.api.specs import SweepSpec
    spec = SweepSpec(
        switchers=tuple(switchers),
        attacks=None if attacks is None else tuple(attacks),
        aggregators=None if aggregators is None else tuple(aggregators),
        scan_fn=scan_fn)
    sess = Session(cfg, grad_fn=grad_fn, params0=params, opt=opt,
                   sample_batches=sample_batches, seed=seed,
                   vectorize_batches=vectorize_batches,
                   m=next((sw.m for sw in switchers
                           if isinstance(sw, Switcher)), None))
    return sess.sweep(spec, T, chunk=chunk, lane_mesh=sweep_mesh,
                      lane_axis=lane_axis)


def make_momentum_scan_fn(grad_fn: GradFn, cfg: DynaBROConfig, lr: float,
                          beta: float, *, mesh=None,
                          worker_axis: str = "workers") -> ScanFn:
    """Compiled worker-momentum loop: a ``ScanFn`` over the round of
    ``make_momentum_step`` (one CUDA graph on a card). ``mesh`` (1-axis
    only) shards the per-worker gradients over ``worker_axis`` as
    ``make_dynabro_scan_fn`` does; the worker momenta stay replicated."""
    if mesh is not None:
        _check_worker_mesh(mesh, worker_axis, allow_model=False)
    gather = _worker_gather(mesh, worker_axis)
    step = make_momentum_step(grad_fn, cfg, lr, beta, gather)

    def round_fn(carry, batch, mask, key, generator):
        return step(carry[0], carry[1], batch, mask, generator), None, None

    scan_fn = ScanFn(round_fn, flags=False)
    scan_fn.gather = gather
    scan_fn.worker_mesh = mesh
    return scan_fn


def run_momentum_scan(
    grad_fn: GradFn,
    params,
    cfg: DynaBROConfig,
    switcher: Switcher,
    sample_batches: Callable[[int, int], Any],
    T: int,
    lr: float,
    beta: float,
    seed: int = 0,
    eval_fn: Optional[Callable[[Any, int], Dict[str, float]]] = None,
    eval_every: int = 0,
    chunk: int = 0,
    scan_fn: Optional[ScanFn] = None,
    vectorize_batches: bool = True,
    mesh=None,
    worker_axis: str = "workers",
):
    """Compiled drop-in for ``run_momentum`` (same returns; segments,
    ``chunk``, ``scan_fn`` and ``mesh``, 1-axis only, as in
    ``run_dynabro_scan``)."""
    if mesh is not None:
        _check_worker_mesh(mesh, worker_axis, switcher.m, allow_model=False)
    _check_scan_fn_mesh(scan_fn, mesh)
    if T <= 0:
        return params, []
    scan_fn = scan_fn or make_momentum_scan_fn(
        grad_fn, cfg, lr, beta, mesh=mesh, worker_axis=worker_axis)
    masks = np.stack([switcher.mask(t) for t in range(T)])  # (T, m)

    def batches(a, b, row_fn=None):
        sched = _batch_schedule(sample_batches, [(t, 1) for t in range(a, b)],
                                1, vectorize=vectorize_batches, row_fn=row_fn)
        return tree_map(lambda l: l[:, :, 0], sched)  # (L, m, ...)

    params, _, evals = scan_fn.run(
        (params, _zero_momenta(params, switcher.m)), np.zeros(T, np.int32),
        masks, batches, _segment_bounds(T, eval_every if eval_fn else 0, chunk),
        seed * MOMENTUM_SEED, eval_fn, eval_every)
    return params, evals
