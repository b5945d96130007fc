"""The port's successive-halving sweep (``Session.sweep_halving``) on the
CPU: against the JAX package's on the same numpy inputs (equal ``pruned``
and ``rounds_run``, equal round logs, params within the sweep's 1e-6 for the
coordinate-wise rules and 1e-5 for the geometry rules); every survivor
bitwise equal to a plain ``Session.sweep`` of the surviving subset (and to
its lane of the full grid's sweep), each pruned cell equal to that sweep
stopped at its rung; scores on the replicate mean, NaN pruned first; the
reference's validation errors; ``lane_mesh=`` still refused."""
import dataclasses

import numpy as np
import pytest
import torch

from _torch_tasks import logs_of, to_numpy
from repro.api import specs as j_specs
from repro.optim import optimizers as j_optim
from repro_torch.api import specs as t_specs
from repro_torch.core import robust_train as t_rt
from repro_torch.launch.mesh import Mesh
from repro_torch.optim import optimizers as t_optim
from test_torch_sweep import M, T, _sessions, _switchers

RUNGS = [4, 8]


def _limit(agg):
    rule = t_specs.AggSpec.coerce(agg or "cwtm").rule
    return 1e-6 if rule in ("cwtm", "cwmed", "mean") else 1e-5


def _equal(a, b):
    assert sorted(a) == sorted(b)
    return all(torch.equal(a[k], b[k]) for k in a)


def _objective(p):
    return float(p["w"].square().sum() + p["b"].square().sum())


JAX_GRID = dict(
    aggregators=(("cwtm", {"delta": 0.3}), ("cwtm", {"delta": 0.45}), "cwmed",
                 ("cwtm", {"delta": 0.2})))


def test_halving_equals_jax_halving():
    """A grid of switchers and coordinate-wise rules with one rung at T // 2
    (the JAX package compiles its sweep once for each lane count; the
    attacks' and the geometry rules' halving is held to the port's own
    sweep below, and the sweep to the JAX package's in
    test_torch_sweep_jax.py)."""
    ts, js = _sessions()
    n = len(JAX_GRID["aggregators"])
    kw = dict(switchers=tuple(_switchers(n)), **JAX_GRID)
    t_out = ts.sweep_halving(t_specs.SweepSpec(**kw), T, objective=_objective,
                             keep=0.5)
    j_out = js.sweep_halving(j_specs.SweepSpec(**kw), T,
                             objective=lambda p: _objective(
                                 {k: torch.tensor(v)
                                  for k, v in to_numpy(p).items()}),
                             keep=0.5)
    assert [(o["pruned"], o["rounds_run"]) for o in t_out] == \
        [(o["pruned"], o["rounds_run"]) for o in j_out]
    assert sum(o["pruned"] for o in t_out) == n // 2
    for c, (to, jo) in enumerate(zip(t_out, j_out)):
        [(tp, tl)], [(jp, jl)] = to["results"], jo["results"]
        assert logs_of(tl) == logs_of(jl) and len(tl) == to["rounds_run"], c
        want = to_numpy(jp)
        for k in want:
            np.testing.assert_allclose(
                tp[k].numpy(), want[k], rtol=0,
                atol=_limit(kw["aggregators"][c]), err_msg=f"cell {c} {k}")


CASES = {
    "switchers": (t_optim.sgd(0.1), None, None, 1),
    "attacks_adagrad": (t_optim.adagrad_norm(0.5),
                        ("sign_flip", ("ipm", {"eps": 0.4}), ("alie", {"z": None}),
                         ("random", {"scale": 2.0}), ("shift", {"v": 0.5}),
                         ("random", {"scale": 5.0})), None, 1),
    "rules_adam": (t_optim.adam(0.05),
                   ("sign_flip", "ipm", "random", "sign_flip", "alie",
                    "sign_flip", "ipm"),
                   (("cwtm", {"delta": 0.3}), "krum", ("nnm+cwtm", {"delta": 0.3}),
                    "geomed", "mfm", "cwmed", ("nnm+krum", {"delta": 0.3})), 1),
    "replicates": (t_optim.adagrad_norm(0.5),
                   ("ipm", "random", "sign_flip", "alie"),
                   ("cwtm", "krum", "cwtm", "geomed"), 2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_survivors_are_a_subset_sweep_bitwise(case):
    opt, attacks, aggs, R = CASES[case]
    ts, _ = _sessions(opt)
    n = len(attacks or aggs or range(6))
    kw = dict(switchers=tuple(_switchers(n)), attacks=attacks, aggregators=aggs)
    if R > 1:
        kw["seeds"] = (2, 7)
    spec = t_specs.SweepSpec(**kw)
    out = ts.sweep_halving(spec, T, objective=_objective, keep=0.5,
                           rungs=RUNGS)
    alive = [c for c, o in enumerate(out) if not o["pruned"]]
    assert 0 < len(alive) < n
    as_cells = (lambda res: res) if R > 1 else (lambda res: [[r] for r in res])
    subset = as_cells(ts.sweep(spec.lane_subset(alive), T))
    full = as_cells(ts.sweep(spec, T))
    for j, c in enumerate(alive):
        assert out[c]["rounds_run"] == T and len(out[c]["results"]) == R
        for (p, logs), (ps, ls), (pf, lf) in zip(out[c]["results"], subset[j],
                                                 full[c]):
            assert _equal(p, ps) and logs_of(logs) == logs_of(ls), c
            assert _equal(p, pf) and logs_of(logs) == logs_of(lf), c
    # each pruned cell: the same grid's sweep stopped at its rung
    for rung in RUNGS:
        cells = [c for c, o in enumerate(out) if o["rounds_run"] == rung]
        if not cells:
            continue
        assert all(out[c]["pruned"] for c in cells)
        stopped = as_cells(ts.sweep(spec, rung))
        for c in cells:
            for (p, logs), (ps, ls) in zip(out[c]["results"], stopped[c]):
                assert _equal(p, ps) and logs_of(logs) == logs_of(ls), c


def test_keep_one_is_the_plain_sweep():
    ts, _ = _sessions()
    spec = t_specs.SweepSpec(switchers=tuple(_switchers(3)), seeds=(0, 1),
                             attacks=("random", "ipm", "sign_flip"))
    out = ts.sweep_halving(spec, T, objective=_objective, keep=1.0)
    plain = ts.sweep(spec, T)
    for o, cell in zip(out, plain):
        assert not o["pruned"] and o["rounds_run"] == T
        for (p, logs), (p1, l1) in zip(o["results"], cell):
            assert _equal(p, p1) and logs_of(logs) == logs_of(l1)


def test_scores_are_replicate_means_and_nan_prunes_first():
    """Scores from a replicate-keyed objective: the cell whose mean is
    lowest survives, a cell with one NaN replicate goes first, ties keep
    caller order, and ``min_cells`` floors the survivors."""
    ts, _ = _sessions()
    spec = t_specs.SweepSpec(switchers=tuple(_switchers(4)), seeds=(0, 1),
                             attacks=("sign_flip", "ipm", "alie", "shift"))
    sweep = ts.sweep(spec, RUNGS[0])
    # the objective reads which (cell, replicate) a params dict is
    keys = {float(p["w"].sum()): (c, r) for c, cell in enumerate(sweep)
            for r, (p, _) in enumerate(cell)}
    assert len(keys) == 8
    table = {(0, 0): 5.0, (0, 1): 1.0, (1, 0): 2.0, (1, 1): 2.0,
             (2, 0): 0.0, (2, 1): float("nan"), (3, 0): 3.0, (3, 1): 1.0}

    def objective(p):
        return table[keys[float(p["w"].sum())]]

    out = ts.sweep_halving(spec, T, objective=objective, keep=0.25,
                           rungs=[RUNGS[0]])
    # means: 3, 2, nan -> inf, 2: cell 1 and cell 3 tie; the stable sort
    # keeps cell 1
    assert [o["pruned"] for o in out] == [True, False, True, True]
    out = ts.sweep_halving(spec, T, objective=objective, keep=0.25,
                           rungs=[RUNGS[0]], min_cells=3)
    assert [o["pruned"] for o in out] == [False, False, True, False]
    assert all(o["rounds_run"] == (RUNGS[0] if o["pruned"] else T)
               for o in out)


def test_halving_validation():
    ts, _ = _sessions()
    spec = t_specs.SweepSpec(switchers=tuple(_switchers(3)))
    with pytest.raises(ValueError, match="keep"):
        ts.sweep_halving(spec, T, objective=_objective, keep=0.0)
    with pytest.raises(ValueError, match="rungs"):
        ts.sweep_halving(spec, T, objective=_objective, rungs=[T])
    with pytest.raises(ValueError, match="rungs"):
        ts.sweep_halving(spec, T, objective=_objective, rungs=[8, 8])
    with pytest.raises(ValueError, match="mapping"):
        ts.sweep_halving(dataclasses.replace(spec, scan_fn={"cwtm": None}), T,
                         objective=_objective)
    with pytest.raises(ValueError, match="T >= 1"):
        ts.sweep_halving(spec, 0, objective=_objective)
    assert ts.sweep_halving(t_specs.SweepSpec(switchers=()), T,
                            objective=_objective) == []
    with pytest.raises(ValueError, match="lanes"):
        ts.sweep_halving(spec, T, objective=_objective,
                         lane_mesh=Mesh(("workers",), (1,)))
    # nothing of the JAX package's is refused now, and a guarded session's
    # halving runs unguarded (it captures its shrunk batches anew)
    assert not hasattr(t_rt, "_UNPORTED")
    guarded = dataclasses.replace(spec, switchers=spec.switchers[:2])
    ts.guard_recompiles = True
    out = ts.sweep_halving(guarded, T, objective=_objective)
    assert [o["rounds_run"] for o in out].count(T) == 1
    assert not ts._steady_sigs


def test_default_rung_and_prebuilt_scan_fn():
    """One rung at T // 2 by default; a plain scan_fn of the session's cfg
    runs its lane form, bitwise the scan_fn the session builds."""
    ts, _ = _sessions()
    spec = t_specs.SweepSpec(switchers=tuple(_switchers(4)))
    out = ts.sweep_halving(spec, T, objective=_objective)
    assert sorted(o["rounds_run"] for o in out) == [T // 2] * 2 + [T] * 2
    fn = t_rt.make_dynabro_scan_fn(ts.grad_fn, ts.cfg, t_optim.sgd(0.1))
    again = ts.sweep_halving(dataclasses.replace(spec, scan_fn=fn), T,
                             objective=_objective)
    for o, o1 in zip(out, again):
        assert (o["pruned"], o["rounds_run"]) == (o1["pruned"], o1["rounds_run"])
        assert _equal(o["results"][0][0], o1["results"][0][0])
