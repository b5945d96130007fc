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
from one generator in the same order (``core/attacks.py``).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch.func import vmap
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.core import attacks as attacks_lib
from repro_torch.core.agg_engine import get_aggregator
from repro_torch.core.aggregators import MFM
from repro_torch.core.mlmc import (
    MLMCConfig, level_prefix, level_schedule, mlmc_combine, round_cost,
    sample_level,
)
from repro_torch.core.switching import Switcher
from repro_torch.kernels.fused import LAUNCHES
from repro_torch.optim.optimizers import Optimizer, apply_updates

GradFn = Callable[[Any, Any], Any]  # (params, unit_batch) -> grad dict
F32 = torch.float32
DYNABRO_SEED = 100_003  # the random attack's generator: seed * this a run
MOMENTUM_SEED = 77_003


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


def _attack_stack(cfg: DynaBROConfig, grads, masks, generator=None):
    """grads: (m, n, ...) leaves; masks: (n, m) bool -> attacked grads. The
    attack runs once per within-round computation k with that k's mask:
    mapped over k by vmap, or, for an attack that draws noise, on the whole
    (n, m, ...) stack at once from ``generator``."""
    atk = attacks_lib.get_attack(cfg.attack, **(cfg.attack_kwargs or {}))
    swapped = {k: torch.swapaxes(v, 0, 1) for k, v in grads.items()}  # (n, m, ...)
    if cfg.attack in attacks_lib.STACK_ATTACKS:
        attacked = atk(swapped, masks, generator=generator)
    else:
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
    """Returns step(params, opt_state, batches, masks, j, generator=None):
    one round of Algorithm 2, shared by both drivers.

    batches: tree leading (m, 2^j) (or (m, 1) when j=0 / beyond cap);
    masks: (2^j, m) bool tensor — within-round identity masks; generator:
    what the ``random`` attack draws from.
    """

    def step(params, opt_state, batches, masks, j: int, generator=None):
        grads = _per_worker_grads(grad_fn, params, batches)  # (m, n, ...)
        grads = _attack_stack(cfg, grads, masks, generator)
        g, info = _combine_levels(cfg, grads, j)
        updates, opt_state = opt.update(g, opt_state, params)
        params = apply_updates(params, updates)
        return params, opt_state, info

    return step


def make_momentum_step(grad_fn: GradFn, cfg: DynaBROConfig, lr: float,
                       beta: float):
    """Worker-momentum baseline (App. E semantics): returns
    step(params, worker_m, batches, mask, generator=None), one round shared
    by both momentum drivers: the attack on the m unit gradients (batches:
    tree leading (m,); mask: (m,)), each worker's float32 momentum
    ``beta * m + (1 - beta) * g``, and an sgd step of ``lr`` on the robust
    aggregate of the momenta (n = 1). beta=0 recovers vanilla distributed
    SGD."""
    atk = attacks_lib.get_attack(cfg.attack, **(cfg.attack_kwargs or {}))

    def step(params, worker_m, batches, mask, generator=None):
        grads = vmap(grad_fn, in_dims=(None, 0))(params, batches)
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


def _batch_schedule(sample_batches, tn, n_max: int, vectorize: bool = True):
    """Stack a segment's batches into an (L, m, n_max, ...) padded schedule:
    ``tn`` is the segment's [(t, n_t), ...], and each round calls
    ``sample_batches(t, n_t)`` once, in round order, at the per-round
    driver's batch size (the sampler's output may depend on n, so padding
    follows sampling). ``vectorize`` is taken for the JAX package's
    signature and changes nothing: the port's samplers draw on the host,
    one call a round."""
    rows = [_pad_units(sample_batches(t, int(n)), n_max, axis=1) for t, n in tn]
    return tree_map(lambda *ls: torch.stack(ls), *rows)


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


# ------------------------------------------------------ compiled drivers

# the JAX drivers' keywords that the port does not take yet, and the
# ROADMAP.md queue 1 item that brings each
_UNPORTED = {
    "mesh": "Multi-device",
    "sweep_mesh": "Multi-device",
    "param_specs": "Mode B and the model zoo",
    "microbatch": "Mode B and the model zoo",
    "lane_attacks": "Lane-batched sweeps",
    "lane_aggregators": "Lane-batched sweeps",
}


def _refuse_unported(**kw) -> None:
    for name, value in kw.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}= is not ported to repro_torch yet (ROADMAP.md "
                f"queue 1, {_UNPORTED[name]!r})")


@functools.cache
def _capture_stream(dev: torch.device) -> torch.cuda.Stream:
    """The one stream a device's level graphs are warmed up and captured
    on: the distance kernels keep a counter per stream that has called them
    (``kernels/fused.py``, 256 a device), so the graphs of every run share
    one."""
    return torch.cuda.Stream(dev)


def _graph_shapes(carry, batch_rows, mask_rows) -> tuple:
    """What a set of level graphs is built for: the device, and the shapes
    and dtypes of the carry, of a round's batch and of its masks."""
    def signature(tree):
        return tuple((tuple(l.shape), l.dtype) for l in tree_leaves(tree))
    return (tree_leaves(carry)[0].device, signature(carry),
            signature(batch_rows), tuple(mask_rows.shape[1:]))


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

    Launch counts: a replay calls no wrapper, so each graph keeps the
    ``LAUNCHES`` its capture counted, and the driver adds them once for
    every replay; the warm-up's and the capture's own counts are taken back
    out.
    """

    def __init__(self, round_fn, carry, batch_rows, mask_rows, generator,
                 L: int, T: int, flags: bool):
        dev = tree_leaves(carry)[0].device
        self.round_fn, self.generator, self.flags = round_fn, generator, flags
        self.carry = tree_map(torch.clone, carry)
        self.batches = tree_map(
            lambda l: torch.zeros((L,) + l.shape[1:], dtype=l.dtype, device=dev),
            batch_rows)
        self.masks = torch.zeros((T,) + tuple(mask_rows.shape[1:]),
                                 dtype=torch.bool, device=dev)
        self.ok = torch.zeros(T, dtype=torch.bool, device=dev)
        self.corr_norm = torch.zeros(T, dtype=F32, device=dev)
        self.sidx = torch.zeros(1, dtype=torch.int64, device=dev)
        self.gidx = torch.zeros(1, dtype=torch.int64, device=dev)
        self.shapes = _graph_shapes(carry, batch_rows, mask_rows)
        self.L, self.T = L, T
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = _capture_stream(dev)
        self.graphs: Dict[Any, tuple] = {}  # key -> (CUDAGraph, launches)
        self.capture_seconds: Dict[Any, float] = {}

    def fits(self, carry, batch_rows, mask_rows, L: int, T: int) -> bool:
        return (self.shapes == _graph_shapes(carry, batch_rows, mask_rows)
                and L <= self.L and T <= self.T)

    def _round(self, key):
        batch = tree_map(lambda b: b.index_select(0, self.sidx)[0], self.batches)
        masks = self.masks.index_select(0, self.gidx)[0]
        return self.round_fn(self.carry, batch, masks, key, self.generator)

    def capture(self, key) -> None:
        """Warm the round up on the capturing stream (the kernels' counters,
        the libraries' workspaces), then capture it. A capture that fails
        raises: there is no eager fallback."""
        t0 = time.perf_counter()
        before = dict(LAUNCHES)
        current = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            self._round(key)  # results dropped; the carry is not written
        current.wait_stream(self.stream)
        LAUNCHES.update(before)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
            carry, ok, corr_norm = self._round(key)
            tree_map(lambda dst, src: dst.copy_(src), self.carry, carry)
            if self.flags:
                self.ok.index_copy_(0, self.gidx, ok.reshape(1))
                self.corr_norm.index_copy_(0, self.gidx,
                                           corr_norm.reshape(1).to(F32))
            self.gidx.add_(1)
            self.sidx.add_(1)
        launches = {k: v - before[k] for k, v in LAUNCHES.items()
                    if v != before[k]}
        LAUNCHES.update(before)
        self.graphs[key] = (graph, launches)
        self.capture_seconds[key] = time.perf_counter() - t0

    def replay(self, keys) -> None:
        """Replay the graphs of ``keys`` in order under
        ``torch.cuda.set_sync_debug_mode("error")``: a host sync in the loop
        raises."""
        graphs = [self.graphs[k][0] for k in keys]
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            for graph in graphs:
                graph.replay()
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
    and ok/corr_norm are None).

    On the CPU the rounds run eagerly, one call each, and the fail-safe
    flags are read once a segment. On a card each key gets one captured CUDA
    graph (``_LevelGraphs``), kept for the next run while the shapes fit;
    ``capture_seconds`` holds each key's warm-up and capture time and
    ``captures`` counts the captures made.
    """

    def __init__(self, round_fn, flags: bool):
        self.round_fn, self.flags = round_fn, flags
        self._generators: Dict[torch.device, torch.Generator] = {}
        self._graphs: Optional[_LevelGraphs] = None
        self.captures = 0

    @property
    def capture_seconds(self) -> Dict[Any, float]:
        return dict(self._graphs.capture_seconds) if self._graphs else {}

    def run(self, carry, keys, masks: np.ndarray, batches, bounds, seed: int,
            eval_fn=None, eval_every: int = 0):
        """Run the rounds of ``keys`` (T,) in the segments ending at
        ``bounds``: ``batches(a, b)`` gives rounds a..b-1's schedule (tree
        leading (b - a, ...)), ``masks`` (T, ...) every round's. Returns
        (params, flags (T,) bool array or None, evals)."""
        dev = tree_leaves(carry)[0].device
        gen = self._generators.get(dev)
        if gen is None:
            gen = self._generators[dev] = torch.Generator(device=dev)
        masks_dev = torch.as_tensor(masks, device=dev)
        if dev.type == "cuda":
            return self._run_graphs(carry, keys, masks_dev, batches, bounds,
                                    seed, gen, eval_fn, eval_every)
        gen.manual_seed(seed)
        oks, evals, a = [], [], 0
        for b in bounds:
            seg = batches(a, b)
            flags = []
            for i, t in enumerate(range(a, b)):
                carry, ok, _ = self.round_fn(
                    carry, tree_map(lambda l: l[i], seg), masks_dev[t],
                    int(keys[t]), gen)
                flags.append(ok)
            if self.flags:
                oks.append(torch.stack(flags).cpu().numpy())
            if eval_fn and eval_every and b % eval_every == 0:
                evals.append((b, eval_fn(carry[0], b - 1)))
            a = b
        return carry[0], (np.concatenate(oks) if self.flags else None), evals

    def _run_graphs(self, carry, keys, masks_dev, batches, bounds, seed, gen,
                    eval_fn, eval_every):
        T = len(keys)
        L = max(b - a for a, b in zip([0] + bounds[:-1], bounds))
        seg = batches(0, bounds[0])
        with torch.cuda.device(masks_dev.device):
            g = self._graphs
            if g is None or not g.fits(carry, seg, masks_dev, L, T):
                g = self._graphs = None  # the old graphs' pool goes first
                g = self._graphs = _LevelGraphs(self.round_fn, carry, seg,
                                                masks_dev, gen, L, T,
                                                self.flags)
            for key in sorted({int(k) for k in keys} - set(g.graphs)):
                g.capture(key)
                self.captures += 1
            # the captures above warmed up on the generator: seed it after
            gen.manual_seed(seed)
            tree_map(lambda dst, src: dst.copy_(src), g.carry, carry)
            g.masks[:T].copy_(masks_dev)
            g.gidx.zero_()
            oks, evals, a = [], [], 0
            for b in bounds:
                if a:
                    seg = batches(a, b)
                tree_map(lambda dst, src: dst[:b - a].copy_(src), g.batches, seg)
                g.sidx.zero_()
                g.replay([int(k) for k in keys[a:b]])
                if self.flags:
                    oks.append(g.ok[a:b].cpu().numpy())  # one read a segment
                if eval_fn and eval_every and b % eval_every == 0:
                    evals.append((b, eval_fn(tree_map(torch.clone, g.carry[0]),
                                             b - 1)))
                a = b
            params = tree_map(torch.clone, g.carry[0])
        return params, (np.concatenate(oks) if self.flags else None), evals


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

    ``mesh``, ``lane_attacks``, ``lane_aggregators``, ``param_specs``,
    ``microbatch`` and ``sweep_mesh`` are not ported and raise
    ``NotImplementedError``; ``worker_axis`` and ``lane_axis`` are taken for
    the JAX package's signature."""
    _refuse_unported(mesh=mesh, lane_attacks=lane_attacks,
                     lane_aggregators=lane_aggregators, param_specs=param_specs,
                     microbatch=microbatch, sweep_mesh=sweep_mesh)
    j_max = cfg.mlmc.j_max
    n_max = 2 ** j_max if cfg.use_mlmc else 1
    step = make_dynabro_step(grad_fn, cfg, opt)

    def round_fn(carry, batch, masks, j, generator):
        n = 2 ** j if (cfg.use_mlmc and 1 <= j <= j_max) else 1
        params, opt_state, info = step(
            carry[0], carry[1], level_prefix(batch, n, n_max, axis=1),
            masks[:n], j, generator)
        return (params, opt_state), info["failsafe_ok"], info["corr_norm"]

    return ScanFn(round_fn, flags=True)


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
    prebuilt ``make_dynabro_scan_fn`` result to reuse its graphs.
    ``vectorize_batches`` changes nothing (``_batch_schedule``); ``mesh``,
    ``param_specs`` and ``microbatch`` raise ``NotImplementedError``."""
    _refuse_unported(mesh=mesh, param_specs=param_specs, microbatch=microbatch)
    if T <= 0:
        return params, [], []
    scan_fn = scan_fn or make_dynabro_scan_fn(grad_fn, cfg, opt)
    levels, ns, n_max = _level_plan(cfg, np.random.default_rng(seed), T)
    masks = _mask_schedule(switcher, T, n_max, ns)

    def batches(a, b):
        return _batch_schedule(sample_batches, list(zip(range(a, b), ns[a:b])),
                               n_max, vectorize=vectorize_batches)

    params, ok, evals = scan_fn.run(
        (params, opt.init(params)), levels, masks, batches,
        _segment_bounds(T, eval_every if eval_fn else 0, chunk),
        seed * DYNABRO_SEED, eval_fn, eval_every)
    return params, _round_logs(levels, ok, masks, cfg.mlmc.j_max), evals


def make_momentum_scan_fn(grad_fn: GradFn, cfg: DynaBROConfig, lr: float,
                          beta: float, *, mesh=None,
                          worker_axis: str = "workers") -> ScanFn:
    """Compiled worker-momentum loop: a ``ScanFn`` over the round of
    ``make_momentum_step`` (one CUDA graph on a card). ``mesh`` raises
    ``NotImplementedError``."""
    _refuse_unported(mesh=mesh)
    step = make_momentum_step(grad_fn, cfg, lr, beta)

    def round_fn(carry, batch, mask, key, generator):
        return step(carry[0], carry[1], batch, mask, generator), None, None

    return ScanFn(round_fn, flags=False)


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
    ``chunk`` and ``scan_fn`` as in ``run_dynabro_scan``). ``mesh`` raises
    ``NotImplementedError``."""
    _refuse_unported(mesh=mesh)
    if T <= 0:
        return params, []
    scan_fn = scan_fn or make_momentum_scan_fn(grad_fn, cfg, lr, beta)
    masks = np.stack([switcher.mask(t) for t in range(T)])  # (T, m)

    def batches(a, b):
        sched = _batch_schedule(sample_batches, [(t, 1) for t in range(a, b)],
                                1, vectorize=vectorize_batches)
        return tree_map(lambda l: l[:, :, 0], sched)  # (L, m, ...)

    params, _, evals = scan_fn.run(
        (params, _zero_momenta(params, switcher.m)), np.zeros(T, np.int32),
        masks, batches, _segment_bounds(T, eval_every if eval_fn else 0, chunk),
        seed * MOMENTUM_SEED, eval_fn, eval_every)
    return params, evals
