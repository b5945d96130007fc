"""Scenario-matrix runner: attack × switcher × aggregator grids through the
compiled driver, the port of the JAX package's ``core/scenarios.py``.

Every cell of a grid is one full DynaBRO run. ``run_matrix`` drives each
cell through ``run_dynabro_scan`` (``driver="scan"``) or ``run_dynabro``
(``"legacy"``) and returns a results table of dicts; ``driver="vmap"`` runs
the whole grid (attack, attack kwargs, switcher, rule and rule kwargs per
lane) as lanes of the lane-batched sweep (``Session.sweep``), one sub-sweep
per distinct rule; ``format_table`` pivots the rows for a terminal.

Rule hyperparameters are a grid axis of their own: they are theta rows on
the card (``agg_engine.agg_theta``), so grids varying only ``delta`` /
``tau`` / ``multi`` / ``iters`` (CWTM at δ ∈ {0.1, 0.25, 0.4}) are lanes of
one sweep, written ``("cwtm", {"delta": 0.4})`` like attack kwargs.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Callable, Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch
from torch.utils._pytree import tree_leaves

from repro_torch.core.agg_engine import agg_param_names
from repro_torch.core.mlmc import MLMCConfig
from repro_torch.core.robust_train import (
    DynaBROConfig, run_dynabro, run_dynabro_scan,
)
from repro_torch.core.switching import get_switcher
from repro_torch.device import resolve_device
from repro_torch.optim.optimizers import Optimizer, sgd

# grid entries: a bare name or (name, kwargs)
Spec = Union[str, Tuple[str, Mapping[str, Any]]]


def _norm(spec: Spec) -> Tuple[str, Dict[str, Any]]:
    if isinstance(spec, str):
        return spec, {}
    name, kw = spec
    return name, dict(kw)


def _fmt_kw(kw: Tuple[Tuple[str, Any], ...]) -> str:
    return ",".join(f"{k}={v}" for k, v in kw)


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One cell of the sweep grid."""
    attack: str
    switcher: str
    aggregator: str
    attack_kwargs: Tuple[Tuple[str, Any], ...] = ()
    switcher_kwargs: Tuple[Tuple[str, Any], ...] = ()
    aggregator_kwargs: Tuple[Tuple[str, Any], ...] = ()

    @property
    def attack_label(self) -> str:
        """Attack name qualified with its kwargs — ``ipm(eps=0.3)`` — so
        grids that vary only a parameter stay distinguishable."""
        kw = _fmt_kw(self.attack_kwargs)
        return f"{self.attack}({kw})" if kw else self.attack

    @property
    def switcher_label(self) -> str:
        kw = _fmt_kw(self.switcher_kwargs)
        return f"{self.switcher}({kw})" if kw else self.switcher

    @property
    def aggregator_label(self) -> str:
        """Rule name qualified with its hyperparameters — ``cwtm(delta=0.4)``
        — so delta/tau-only grids keep distinct pivot lines."""
        kw = _fmt_kw(self.aggregator_kwargs)
        return f"{self.aggregator}({kw})" if kw else self.aggregator

    @property
    def name(self) -> str:
        return (f"{self.attack_label}|{self.switcher_label}|"
                f"{self.aggregator_label}")


def scenario_grid(attacks: Sequence[Spec], switchers: Sequence[Spec],
                  aggregators: Sequence[Spec]) -> List[Scenario]:
    """Cartesian product of the three grid axes; every axis takes bare names
    or ``(name, kwargs)`` — aggregator kwargs are rule hyperparameters
    (``delta`` / ``tau`` / ``multi`` / ``iters``, see ``agg_engine``)."""
    out = []
    for a in attacks:
        an, akw = _norm(a)
        for s in switchers:
            sn, skw = _norm(s)
            for g in aggregators:
                gn, gkw = _norm(g)
                out.append(Scenario(an, sn, gn, tuple(sorted(akw.items())),
                                    tuple(sorted(skw.items())),
                                    tuple(sorted(gkw.items()))))
    return out


@dataclasses.dataclass
class Task:
    """A Mode-A testbed: initial params, per-unit grad fn, batch sampler
    factory (m -> sample_batches), and a scalar objective for reporting."""
    params0: Any
    grad_fn: Callable[[Any, Any], Any]
    make_sampler: Callable[[int], Callable[[int, int], Any]]
    objective: Callable[[Any], float]


def make_quadratic_task(sigma: float = 0.5, seed: int = 0,
                        device="cuda") -> Task:
    """The paper's 2D quadratic testbed (Appendix E): f(x) = ½ xᵀAx, exact
    optimum 0, per-unit gradients ``A x + σ·u`` with u ~ N(0, I).

    A unit is the (2,) noise vector u itself: ``sample(t, n)`` returns the
    (m, n, 2) float32 units of round t, drawn on the host from
    ``np.random.default_rng((s, t))`` (s the seed, or ``sampler_seed``) and
    placed on ``device``. The JAX package's task draws its units from
    threefry keys instead; the two streams differ, and tests hand both
    packages these numpy units."""
    dev = resolve_device(device)
    A = torch.tensor([[2.0, 1.0], [1.0, 2.0]], device=dev)
    params0 = {"x": torch.tensor([3.0, -2.0], device=dev)}

    def grad_fn(params, unit):
        return {"x": A @ params["x"] + sigma * unit}

    def make_sampler(m, sampler_seed=None):
        s = seed if sampler_seed is None else sampler_seed

        def sample(t, n):
            units = np.random.default_rng((s, t)).standard_normal((m, n, 2))
            return torch.from_numpy(units.astype(np.float32)).to(dev)
        return sample

    def objective(p):
        return float(0.5 * p["x"] @ A @ p["x"])

    return Task(params0, grad_fn, make_sampler, objective)


def _cell_cfg(sc: Scenario, m: int, T: int, V: float, kappa: float,
              j_cap: int, use_mlmc: bool, delta: float) -> DynaBROConfig:
    """One cfg builder for the per-cell and the lane paths, so that
    ``driver="vmap"`` is a drop-in. A ``delta`` in the scenario's
    aggregator kwargs overrides the grid-wide default."""
    akw = dict(sc.aggregator_kwargs)
    return DynaBROConfig(
        mlmc=MLMCConfig(T=T, m=m, V=V,
                        option=2 if sc.aggregator == "mfm" else 1,
                        kappa=kappa, j_cap=j_cap),
        aggregator=sc.aggregator, delta=akw.get("delta", delta),
        attack=sc.attack, attack_kwargs=dict(sc.attack_kwargs) or None,
        use_mlmc=use_mlmc, aggregator_kwargs=akw or None)


def _agg_spec(sc: Scenario, delta: float):
    """The per-lane aggregator spec of the vmapped sweep: the scenario's
    kwargs, with the grid-wide ``delta`` filled in for rules that take one
    (so the lane theta matches ``_cell_cfg``'s per-cell delta)."""
    kw = dict(sc.aggregator_kwargs)
    if "delta" not in kw and "delta" in agg_param_names(sc.aggregator):
        kw["delta"] = delta
    return (sc.aggregator, kw)


def _row(task: Task, sc: Scenario, params, logs, *, driver: str, m: int,
         T: int, wall: float) -> Dict[str, Any]:
    return {
        "attack": sc.attack, "attack_label": sc.attack_label,
        "switcher": sc.switcher, "switcher_label": sc.switcher_label,
        "aggregator": sc.aggregator,
        "aggregator_label": sc.aggregator_label,
        "driver": driver, "m": m, "T": T,
        "final": task.objective(params),
        "failsafe_trips": sum(1 for l in logs if l.level >= 1 and not l.failsafe_ok),
        "mean_level": sum(l.level for l in logs) / max(len(logs), 1),
        "cost": sum(l.cost for l in logs),
        "wall_s": wall,
    }


def _stat_row(task: Task, sc: Scenario, cell, *, m: int, T: int,
              wall: float) -> Dict[str, Any]:
    """One results row for a cell's replicate lanes (``cell`` is the
    ``[(params, logs), ...]`` list of one cell): the single-run row shape
    plus the replicate statistics columns ``final_mean`` / ``final_std`` /
    ``final_stderr`` / ``n_seeds``. With one replicate the
    statistics degenerate (std = stderr = 0.0, ``final`` untouched); with
    several, ``final`` becomes the replicate mean — honest sample std
    (ddof=1), not a typographic ±0 — and the log-derived columns
    (``failsafe_trips`` / ``mean_level`` / ``cost``) average over lanes."""
    per = [_row(task, sc, p, logs, driver="vmap", m=m, T=T, wall=wall)
           for p, logs in cell]
    r = dict(per[0])
    n = len(per)
    finals = [p["final"] for p in per]
    mean = sum(finals) / n
    r["n_seeds"] = n
    r["final_mean"] = mean
    if n > 1:
        var = sum((f - mean) ** 2 for f in finals) / (n - 1)
        r["final_std"] = var ** 0.5
        r["final_stderr"] = (var / n) ** 0.5
        r["final"] = mean
        for k in ("failsafe_trips", "mean_level", "cost"):
            r[k] = sum(p[k] for p in per) / n
    else:
        r["final_std"] = 0.0
        r["final_stderr"] = 0.0
    return r


def _row(task: Task, sc: Scenario, params, logs, *, driver: str, m: int,
         T: int, wall: float) -> Dict[str, Any]:
    return {
        "attack": sc.attack, "attack_label": sc.attack_label,
        "switcher": sc.switcher, "switcher_label": sc.switcher_label,
        "aggregator": sc.aggregator,
        "aggregator_label": sc.aggregator_label,
        "driver": driver, "m": m, "T": T,
        "final": task.objective(params),
        "failsafe_trips": sum(1 for l in logs if l.level >= 1 and not l.failsafe_ok),
        "mean_level": sum(l.level for l in logs) / max(len(logs), 1),
        "cost": sum(l.cost for l in logs),
        "wall_s": wall,
    }


def _stat_row(task: Task, sc: Scenario, cell, *, m: int, T: int,
              wall: float) -> Dict[str, Any]:
    """One results row for a cell's replicate lanes (``cell`` is the
    ``[(params, logs), ...]`` list of one cell): the single-run row shape
    plus the replicate statistics columns ``final_mean`` / ``final_std`` /
    ``final_stderr`` / ``n_seeds``. With one replicate the
    statistics degenerate (std = stderr = 0.0, ``final`` untouched); with
    several, ``final`` becomes the replicate mean — honest sample std
    (ddof=1), not a typographic ±0 — and the log-derived columns
    (``failsafe_trips`` / ``mean_level`` / ``cost``) average over lanes."""
    per = [_row(task, sc, p, logs, driver="vmap", m=m, T=T, wall=wall)
           for p, logs in cell]
    r = dict(per[0])
    n = len(per)
    finals = [p["final"] for p in per]
    mean = sum(finals) / n
    r["n_seeds"] = n
    r["final_mean"] = mean
    if n > 1:
        var = sum((f - mean) ** 2 for f in finals) / (n - 1)
        r["final_std"] = var ** 0.5
        r["final_stderr"] = (var / n) ** 0.5
        r["final"] = mean
        for k in ("failsafe_trips", "mean_level", "cost"):
            r[k] = sum(p[k] for p in per) / n
    else:
        r["final_std"] = 0.0
        r["final_stderr"] = 0.0
    return r


def _wait(params) -> None:
    """Wait for the card's work on ``params``, so a wall time covers it."""
    leaves = tree_leaves(params)
    if leaves and leaves[0].device.type == "cuda":
        torch.cuda.synchronize(leaves[0].device)


def run_scenario(
    task: Task,
    sc: Scenario,
    *,
    m: int,
    T: int,
    V: float,
    make_opt: Callable[[], Optimizer] = lambda: sgd(2e-2),
    delta: float = 0.25,
    kappa: float = 1.0,
    j_cap: int = 7,
    use_mlmc: bool = True,
    seed: int = 0,
    driver: str = "scan",
    chunk: int = 0,
    mesh=None,
) -> Dict[str, Any]:
    """Run one grid cell end to end; returns a results row. ``mesh`` (with
    ``driver="scan"``) runs the cell through the sharded compiled driver;
    ``driver="vmap"`` routes through the one-lane sweep."""
    if mesh is not None and driver != "scan":
        raise ValueError(
            f"mesh= requires driver='scan' (the sharded compiled driver); "
            f"got driver={driver!r}")
    if driver == "vmap":
        return run_matrix_vmapped(
            task, [sc], m=m, T=T, V=V, make_opt=make_opt, delta=delta,
            kappa=kappa, j_cap=j_cap, use_mlmc=use_mlmc, seed=seed,
            chunk=chunk)[0]
    if driver not in ("scan", "legacy"):
        raise ValueError(
            f"unknown driver {driver!r}; expected 'scan', 'legacy' or 'vmap'")
    cfg = _cell_cfg(sc, m, T, V, kappa, j_cap, use_mlmc, delta)
    switcher = get_switcher(sc.switcher, m, seed=seed,
                            **dict(sc.switcher_kwargs))
    run = run_dynabro_scan if driver == "scan" else run_dynabro
    kw = {"chunk": chunk, "mesh": mesh} if driver == "scan" else {}
    t0 = time.perf_counter()
    params, logs, _ = run(task.grad_fn, task.params0, make_opt(), cfg,
                          switcher, task.make_sampler(m), T, seed=seed, **kw)
    _wait(params)
    wall = time.perf_counter() - t0
    return _row(task, sc, params, logs, driver=driver, m=m, T=T, wall=wall)


def run_matrix(
    task: Task,
    scenarios: Sequence[Scenario],
    *,
    m: int,
    T: int,
    V: float,
    **kw,
) -> List[Dict[str, Any]]:
    """Sweep every scenario -> results table. ``driver="vmap"`` runs the
    grid as lanes of the sweep (``run_matrix_vmapped``) and is the one
    driver that takes the replicate axis (``seeds=`` / ``replicates=``) and
    ``lane_chunk=`` / ``lane_mesh=``; ``"scan"`` / ``"legacy"`` run one
    driver call a cell (``"scan"`` takes the worker ``mesh=``)."""
    if kw.get("driver") == "vmap":
        if kw.get("mesh") is not None:
            raise ValueError(
                "driver='vmap' sweeps run unsharded per lane; drop mesh= "
                "(lane_mesh= shards the lane axis) or use driver='scan' "
                "for the sharded per-cell driver")
        kw = {k: v for k, v in kw.items() if k not in ("driver", "mesh")}
        return run_matrix_vmapped(task, scenarios, m=m, T=T, V=V, **kw)
    for rep_kw in ("seeds", "replicates", "lane_chunk", "lane_mesh"):
        if kw.get(rep_kw):
            raise ValueError(
                f"{rep_kw}= is a replicate-lane option of the vmapped sweep; "
                f"pass driver='vmap' (per-cell drivers run one seed per "
                f"call)")
    return [run_scenario(task, sc, m=m, T=T, V=V, **kw) for sc in scenarios]


def run_matrix_vmapped(
    task: Task,
    scenarios: Sequence[Scenario],
    *,
    m: int,
    T: int,
    V: float,
    make_opt: Callable[[], Optimizer] = lambda: sgd(2e-2),
    delta: float = 0.25,
    kappa: float = 1.0,
    j_cap: int = 7,
    use_mlmc: bool = True,
    seed: int = 0,
    chunk: int = 0,
    seeds=None,
    replicates=None,
    lane_chunk: int = 0,
    lane_mesh=None,
) -> List[Dict[str, Any]]:
    """Sweep a grid with every cell a lane of the lane-batched sweep: each
    rule's cells in one compiled loop, the rows in input order (duplicate
    scenarios are duplicate lanes). ``wall_s`` is the grid's wall clock
    over its lanes. One sampler serves every lane, so ``task.make_sampler``
    must return samplers without hidden per-call state.

    ``seeds=`` / ``replicates=`` add the replicate axis: each cell runs one
    lane per replicate seed, the switcher masks, the ``random`` generator
    and the data sampler (``task.make_sampler(m, sampler_seed=...)``) each
    from that seed; the rows then carry ``final_mean`` / ``final_std`` /
    ``final_stderr`` (``final`` the mean) and ``n_seeds``. ``lane_mesh`` (a
    ``launch.mesh.make_lane_mesh`` mesh) shards the grid's cells over its
    lane axis (``Session.sweep``)."""
    scs = list(scenarios)
    if not scs:
        return []
    cfg = _cell_cfg(scs[0], m, T, V, kappa, j_cap, use_mlmc, delta)
    from repro_torch.api.session import Session, _task_sampler_factory
    from repro_torch.api.specs import SweepSpec
    spec = SweepSpec(
        switchers=tuple((sc.switcher, dict(sc.switcher_kwargs))
                        for sc in scs),
        attacks=tuple((sc.attack, dict(sc.attack_kwargs)) for sc in scs),
        aggregators=tuple(_agg_spec(sc, delta) for sc in scs),
        seeds=None if seeds is None else tuple(int(s) for s in seeds),
        replicates=None if replicates is None else int(replicates))
    factory = None
    if spec.n_replicates > 1 or spec.seeds is not None:
        factory = _task_sampler_factory(task, m)
        if factory is None:
            raise ValueError(
                "seeds=/replicates= need per-replicate data streams, but "
                "task.make_sampler does not accept sampler_seed=; add the "
                "kwarg (see make_quadratic_task) or drop the replicate axis")
    sess = Session(cfg, grad_fn=task.grad_fn, params0=task.params0,
                   opt=make_opt(), m=m, sample_batches=task.make_sampler(m),
                   seed=seed, sampler_factory=factory)
    replicated = spec.n_replicates > 1
    t0 = time.perf_counter()
    outs = sess.sweep(spec, T, chunk=chunk, lane_chunk=lane_chunk,
                      lane_mesh=lane_mesh)
    cells = outs if replicated else [[cell] for cell in outs]
    _wait([p for cell in cells for p, _ in cell])
    wall = (time.perf_counter() - t0) / len(scs)
    return [_stat_row(task, sc, cell, m=m, T=T, wall=wall)
            for sc, cell in zip(scs, cells)]


def format_table(rows: Sequence[Dict[str, Any]], value: str = "final",
                 row_key: str = "aggregator", col_key: str = "attack") -> str:
    """Pivot a results table for terminal display (one line per row_key).

    Keys use the kwarg-qualified ``<key>_label`` row field when present (so
    cells that differ only in ``eps``/``z``/``K`` get their own column/line
    instead of silently collapsing). If several rows still land on one
    (row, col) cell with *different* values — a residual collision the labels
    cannot split, e.g. pivoting away a varying axis — a RuntimeWarning names
    the cell and the first value is shown; duplicate rows with equal values
    (duplicate scenarios) stay silent.

    Rows carrying the replicate statistics columns (``n_seeds > 1`` with a
    ``<value>_mean`` / ``<value>_std`` pair) render as
    ``mean±std``; single-seed rows render the bare value — never a
    typographic ``±0.0000``."""
    def label(r, k):
        return str(r.get(f"{k}_label", r[k]))

    def differs(a, b):
        # NaN compares unequal to itself; duplicate lanes of a diverged
        # scenario (both NaN) are still duplicates, not a collision
        return a != b and not (a != a and b != b)

    def cell_str(r):
        if r.get("n_seeds", 1) > 1 and f"{value}_mean" in r:
            return f"{r[f'{value}_mean']:.4f}±{r[f'{value}_std']:.4f}"
        return f"{r[value]:.4f}"

    cols = list(dict.fromkeys(label(r, col_key) for r in rows))
    rks = list(dict.fromkeys(label(r, row_key) for r in rows))
    cells = {}
    for rk in rks:
        for c in cols:
            sel = [r for r in rows
                   if label(r, row_key) == rk and label(r, col_key) == c]
            if not sel:
                continue
            if len(sel) > 1 and any(differs(v[value], sel[0][value])
                                    for v in sel[1:]):
                warnings.warn(
                    f"format_table: {len(sel)} rows collide on cell "
                    f"({rk!r}, {c!r}) with differing {value!r} values; "
                    f"showing the first — pivot on a distinguishing key",
                    RuntimeWarning, stacklevel=2)
            cells[(rk, c)] = cell_str(sel[0])
    cw = max([12] + [len(c) + 2 for c in cols]
             + [len(s) + 2 for s in cells.values()])
    rw = max([12] + [len(rk) + 1 for rk in rks])
    lines = [" " * rw + "".join(f"{c:>{cw}s}" for c in cols)]
    for rk in rks:
        lines.append(f"{rk:{rw}s}" + "".join(
            f"{cells.get((rk, c), '—'):>{cw}s}" for c in cols))
    return "\n".join(lines)
