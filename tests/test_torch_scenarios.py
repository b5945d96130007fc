"""The port's ``core/scenarios.py`` against the JAX package's: grid names,
``format_table`` text on the same rows, ``make_quadratic_task``'s numpy
units, and ``run_matrix`` rows of every driver on App. E's quadratic with
those units in both packages (log columns equal, finals within 1e-5
relative)."""
import warnings

import numpy as np
import pytest
import torch

from _torch_tasks import jax_quadratic, noise_units
from repro.core import scenarios as j_scen
from repro_torch.core import scenarios as t_scen
from repro_torch.launch.mesh import Mesh, make_worker_mesh

GRID = dict(attacks=["sign_flip", ("ipm", {"eps": 0.3}), ("alie", {"z": None})],
            switchers=[("periodic", {"n_byz": 2, "K": 4}), ("static", {"n_byz": 3})],
            aggregators=["cwmed", ("cwtm", {"delta": 0.3}), "krum"])
M, T = 8, 16
KW = dict(m=M, T=T, V=3.0)


def test_scenario_grid_equals_jax():
    want = j_scen.scenario_grid(**GRID)
    got = t_scen.scenario_grid(**GRID)
    assert [s.name for s in got] == [s.name for s in want]
    assert [(s.attack_label, s.switcher_label, s.aggregator_label)
            for s in got] == [(s.attack_label, s.switcher_label,
                               s.aggregator_label) for s in want]


def _rows():
    rng = np.random.default_rng(0)
    rows = []
    for sc in t_scen.scenario_grid(**GRID):
        r = {"attack": sc.attack, "attack_label": sc.attack_label,
             "switcher": sc.switcher, "switcher_label": sc.switcher_label,
             "aggregator": sc.aggregator, "aggregator_label": sc.aggregator_label,
             "final": float(rng.random()), "n_seeds": 1}
        rows.append(r)
    rows[1].update(n_seeds=3, final_mean=0.5, final_std=0.125)
    rows[2]["final"] = float("nan")
    return rows


@pytest.mark.parametrize("pivot", [("aggregator", "attack"),
                                   ("attack", "switcher"),
                                   ("switcher", "aggregator")])
def test_format_table_text_equals_jax(pivot):
    rows = _rows()
    with warnings.catch_warnings(record=True) as jw:
        warnings.simplefilter("always")
        want = j_scen.format_table(rows, row_key=pivot[0], col_key=pivot[1])
    with warnings.catch_warnings(record=True) as tw:
        warnings.simplefilter("always")
        got = t_scen.format_table(rows, row_key=pivot[0], col_key=pivot[1])
    assert got == want
    assert [str(w.message) for w in tw] == [str(w.message) for w in jw]


def test_quadratic_units_are_numpy_per_seed_and_round():
    task = t_scen.make_quadratic_task(device="cpu", seed=4)
    np.testing.assert_array_equal(task.make_sampler(5)(7, 3).numpy(),
                                  noise_units(4, 7, 5, 3))
    np.testing.assert_array_equal(
        task.make_sampler(5, sampler_seed=9)(7, 3).numpy(),
        noise_units(9, 7, 5, 3))
    g = task.grad_fn(task.params0, torch.zeros(2))
    np.testing.assert_array_equal(g["x"].numpy(), [4.0, -1.0])
    assert task.objective(task.params0) == pytest.approx(7.0)


def _cmp(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for k in ("attack_label", "switcher_label", "aggregator_label",
                  "driver", "m", "T", "failsafe_trips", "mean_level", "cost",
                  "n_seeds"):
            if k in b:
                assert a[k] == b[k], (k, a[k], b[k])
        for k in ("final", "final_mean", "final_std", "final_stderr"):
            if k in b:
                np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-7,
                                           err_msg=k)


@pytest.mark.parametrize("driver", ["scan", "legacy", "vmap"])
def test_run_matrix_equals_jax(driver):
    grid = dict(GRID, attacks=GRID["attacks"][:2], aggregators=["cwmed", "krum"])
    tg, jg = t_scen.scenario_grid(**grid), j_scen.scenario_grid(**grid)
    got = t_scen.run_matrix(t_scen.make_quadratic_task(device="cpu"), tg,
                            driver=driver, **KW)
    want = j_scen.run_matrix(jax_quadratic(), jg, driver=driver, **KW)
    _cmp(got, want)


def test_run_matrix_replicates_equal_jax():
    grid = dict(GRID, attacks=["sign_flip"], switchers=GRID["switchers"][:1],
                aggregators=["cwmed", ("cwtm", {"delta": 0.3})])
    tg, jg = t_scen.scenario_grid(**grid), j_scen.scenario_grid(**grid)
    got = t_scen.run_matrix(t_scen.make_quadratic_task(device="cpu"), tg,
                            driver="vmap", seeds=(0, 1, 2), **KW)
    want = j_scen.run_matrix(jax_quadratic(), jg, driver="vmap",
                             seeds=(0, 1, 2), **KW)
    _cmp(got, want)
    assert all(r["n_seeds"] == 3 and r["final_std"] > 0 for r in got)
    table = t_scen.format_table(got)
    assert "±" in table and table == j_scen.format_table(got)


def test_run_matrix_refusals():
    task = t_scen.make_quadratic_task(device="cpu")
    grid = t_scen.scenario_grid(["sign_flip"], [("static", {"n_byz": 2})], ["cwmed"])
    for kw in ({"seeds": (0, 1)}, {"replicates": 2}, {"lane_chunk": 2}):
        with pytest.raises(ValueError, match="driver='vmap'"):
            t_scen.run_matrix(task, grid, **KW, **kw)
    with pytest.raises(ValueError, match="unsharded"):
        t_scen.run_matrix(task, grid, driver="vmap",
                          mesh=make_worker_mesh(1), **KW)
    with pytest.raises(ValueError, match="driver='scan'"):
        t_scen.run_scenario(task, grid[0], driver="legacy",
                            mesh=make_worker_mesh(1), **KW)
    # the GSPMD path's (1, 1) (workers, 'model') mesh runs the unsharded
    # round, as the JAX package's does (tests/test_torch_gspmd.py)
    got = t_scen.run_scenario(task, grid[0],
                              mesh=Mesh(("workers", "model"), (1, 1)), **KW)
    want = t_scen.run_scenario(task, grid[0], **KW)
    assert all(got[k] == want[k] for k in ("final", "cost", "failsafe_trips"))
    with pytest.raises(ValueError, match="unknown driver"):
        t_scen.run_scenario(task, grid[0], driver="nope", **KW)
    no_seed = t_scen.Task(task.params0, task.grad_fn,
                          lambda m: task.make_sampler(m), task.objective)
    with pytest.raises(ValueError, match="sampler_seed"):
        t_scen.run_matrix(no_seed, grid, driver="vmap", seeds=(0, 1), **KW)
    assert t_scen.run_matrix(task, [], driver="vmap", **KW) == []
