"""The cases of ``tests/test_torch_mesh.py``: the port's sharded Mode A
drivers on App. E's quadratic (m=8, T=40, CWTM at delta 0.3 under
``periodic(n_byz=2, K=7)``, seed 4) and the Figure-1 MLP, each a function
of the mesh it runs on (None: unsharded).

Run as a script, it is one rank of a gloo group:

    python tests/_torch_mesh_ranks.py <world> <rank> <init file> <out dir>

It runs every case of ``GROUPS[world]`` on its meshes and pickles
``{case: result}`` to ``<out dir>/rank<rank>.pkl``. It imports the port
only, never JAX.
"""
import os
import pickle
import sys
from pathlib import Path

import torch
from torch.utils._pytree import tree_leaves

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.api import (  # noqa: E402
    DynaBROConfig, MLMCConfig, SweepSpec, build_session, get_switcher,
    make_lane_mesh, make_quadratic_task, make_worker_mesh, run_dynabro_scan,
    run_dynabro_scan_sweep, run_matrix, run_momentum_scan, run_scenario,
    scenario_grid, sgd,
)
from repro_torch.core import robust_train as rt  # noqa: E402
from repro_torch.core import sharded  # noqa: E402
from repro_torch.data import make_task  # noqa: E402

T, M, SEED = 40, 8, 4
SWEEP_T = 32
SWEEP_SWITCHERS = tuple(("periodic", {"n_byz": 3, "K": k})
                        for k in (4, 8, 16, 24))


def cfg(aggregator="cwtm", attack="sign_flip", delta=0.3, **kw):
    return DynaBROConfig(mlmc=MLMCConfig(T=T, m=M, V=3.0, kappa=1.0),
                         aggregator=aggregator, delta=delta, attack=attack,
                         **kw)


def switcher():
    return get_switcher("periodic", M, n_byz=2, K=7)


def params_np(params):
    return {k: v.detach().cpu().numpy() for k, v in sorted(params.items())}


def logs_of(logs):
    return [(l.level, bool(l.failsafe_ok), l.n_byz, l.cost) for l in logs]


def _counted(run):
    """``run()``'s result, the worker gathers it ran, and the worker counts
    of the batch schedules it wrote (a rank writes its block's)."""
    before, widths, draw = sharded.GATHERS["gathers"], set(), rt._batch_schedule

    def spy(*args, **kw):
        out = draw(*args, **kw)
        widths.update(leaf.shape[1] for leaf in tree_leaves(out))
        return out

    rt._batch_schedule = spy
    try:
        out = run()
    finally:
        rt._batch_schedule = draw
    return out, sharded.GATHERS["gathers"] - before, sorted(widths)


def dynabro(mesh, aggregator="cwtm", attack="sign_flip", chunk=0,
            microbatch=False):
    task = make_quadratic_task(device="cpu")
    (p, logs, _), gathers, widths = _counted(lambda: run_dynabro_scan(
        task.grad_fn, task.params0, sgd(2e-2), cfg(aggregator, attack),
        switcher(), task.make_sampler(M), T, seed=SEED, chunk=chunk,
        mesh=mesh, microbatch=microbatch))
    return {"params": params_np(p), "logs": logs_of(logs),
            "gathers": gathers, "schedule_workers": widths}


def mlp(mesh):
    """The Figure-1 MLP (d = 9,610) at m=8, T=12: a task whose per-worker
    gradients are matrix products batched over the rank's workers."""
    params0, grad_fn, sampler, _ = make_task(M, seed=0, device="cpu")
    c = DynaBROConfig(mlmc=MLMCConfig(T=12, m=M, V=5.0, kappa=1.0, j_cap=3),
                      aggregator="cwtm", delta=0.3, attack="sign_flip")
    p, logs, _ = run_dynabro_scan(grad_fn, params0, sgd(0.1), c, switcher(),
                                  sampler, 12, seed=SEED, mesh=mesh)
    return {"params": params_np(p), "logs": logs_of(logs)}


def momentum(mesh, chunk=0):
    task = make_quadratic_task(device="cpu")
    c = cfg("cwmed", "alie")
    (p, _), gathers, widths = _counted(lambda: run_momentum_scan(
        task.grad_fn, task.params0, c,
        get_switcher("momentum_tailored", M, alpha=0.1), task.make_sampler(M),
        T, lr=2e-2, beta=0.9, chunk=chunk, mesh=mesh))
    return {"params": params_np(p), "gathers": gathers,
            "schedule_workers": widths}


def session(mesh):
    """``Session.run`` and 8 ``Session.step`` rounds under ``random``."""
    task = make_quadratic_task(device="cpu")
    sess = build_session(cfg(attack="random"), task, m=M, opt=sgd(2e-2),
                         switcher=switcher(), seed=SEED, mesh=mesh)
    p, logs, _ = sess.run(T)
    carry, sched = sess.init_carry(), sess.schedule(T)
    for t in range(8):
        carry, _ = sess.step(carry, sess.round_inputs(sched, t))
    return {"params": params_np(p), "logs": logs_of(logs),
            "step_params": params_np(carry[0])}


def scenario(mesh):
    task = make_quadratic_task(device="cpu")
    grid = scenario_grid(["sign_flip"], [("static", {"n_byz": 3})], ["cwmed"])
    row = run_scenario(task, grid[0], m=M, T=T, V=3.0, mesh=mesh)
    return {k: row[k] for k in ("final", "cost", "failsafe_trips")}


def sweep_session():
    task = make_quadratic_task(device="cpu")
    return build_session(cfg("cwmed", delta=0.45), task, m=M, opt=sgd(2e-2),
                         seed=0)


def sweep_out(cells):
    return [[(params_np(p), logs_of(l)) for p, l in cell] for cell in cells]


def sweep(lane_mesh):
    """4 cells x 2 replicates, the JAX package's lane-mesh grid."""
    spec = SweepSpec(switchers=SWEEP_SWITCHERS, seeds=(0, 1))
    return sweep_out(sweep_session().sweep(spec, SWEEP_T,
                                           lane_mesh=lane_mesh))


def sweep_driver(lane_mesh):
    """``run_dynabro_scan_sweep(sweep_mesh=)``: 4 CWTM cells of Switcher
    instances, two attacks."""
    task = make_quadratic_task(device="cpu")
    sws = [get_switcher("periodic", M, n_byz=3, K=k) for k in (4, 8, 16, 24)]
    outs = run_dynabro_scan_sweep(
        task.grad_fn, task.params0, sgd(2e-2), cfg(), sws,
        task.make_sampler(M), SWEEP_T, seed=SEED,
        attacks=("sign_flip", "ipm") * 2, sweep_mesh=lane_mesh)
    return [(params_np(p), logs_of(l)) for p, l in outs]


def halving(lane_mesh):
    """4 cells of two rules (a lane batch a rule), rung at T // 2."""
    spec = SweepSpec(switchers=SWEEP_SWITCHERS,
                     aggregators=tuple((r, {"delta": 0.45})
                                       for r in ("cwmed", "cwtm") * 2))
    out = sweep_session().sweep_halving(
        spec, SWEEP_T, objective=lambda p: float(p["x"].square().sum()),
        lane_mesh=lane_mesh)
    return [(o["pruned"], o["rounds_run"],
             [(params_np(p), logs_of(l)) for p, l in o["results"]])
            for o in out]


def matrix(lane_mesh):
    grid = scenario_grid(["sign_flip", "ipm"], [("periodic", {"n_byz": 3, "K": 8})],
                         ["cwmed"])
    rows = run_matrix(make_quadratic_task(device="cpu"), grid, m=M,
                      T=SWEEP_T, V=3.0, driver="vmap", lane_mesh=lane_mesh)
    return [(r["final"], r["cost"], r["failsafe_trips"]) for r in rows]


def rejects_indivisible(mesh):
    """m=9 on a 2-way worker axis fails before anything runs."""
    task = make_quadratic_task(device="cpu")
    c = DynaBROConfig(mlmc=MLMCConfig(T=8, m=9, V=3.0, kappa=1.0),
                      aggregator="cwmed", delta=0.3)
    try:
        run_dynabro_scan(task.grad_fn, task.params0, sgd(2e-2), c,
                         get_switcher("static", 9, n_byz=2),
                         task.make_sampler(9), 8, mesh=mesh)
    except ValueError as e:
        return str(e)
    return None


def _worker(world):
    return lambda: make_worker_mesh(world)


def _lanes(n_lanes, n_workers):
    return lambda: make_lane_mesh(n_lanes, n_workers)


# world -> {case: (function, the mesh it runs on: a factory every rank
# calls in order)}; the unsharded reference of a case is function(None)
GROUPS = {
    2: {
        **{f"cwtm {a}": (lambda mesh, a=a: dynabro(mesh, attack=a),
                         _worker(2))
           for a in ("sign_flip", "ipm", "alie", "random")},
        "geomed": (lambda mesh: dynabro(mesh, "geomed"), _worker(2)),
        "nnm+cwtm": (lambda mesh: dynabro(mesh, "nnm+cwtm"), _worker(2)),
        "microbatch": (lambda mesh: dynabro(mesh, microbatch=True),
                       _worker(2)),
        "mlp": (mlp, _worker(2)),
        "session": (session, _worker(2)),
        "scenario": (scenario, _worker(2)),
        "sweep (2, 1)": (sweep, _lanes(2, 1)),
        "halving (2, 1)": (halving, _lanes(2, 1)),
        "matrix (2, 1)": (matrix, _lanes(2, 1)),
        "rejects m=9": (rejects_indivisible, _worker(2)),
    },
    4: {
        **{f"cwtm {a}": (lambda mesh, a=a: dynabro(mesh, attack=a),
                         _worker(4))
           for a in ("sign_flip", "ipm", "alie")},
        "momentum": (momentum, _worker(4)),
        "chunk 16": (lambda mesh: dynabro(mesh, chunk=16), _worker(4)),
        "sweep (4, 1)": (sweep, _lanes(4, 1)),
        "sweep (2, 2)": (sweep, _lanes(2, 2)),
        "run_dynabro_scan_sweep (2, 2)": (sweep_driver, _lanes(2, 2)),
        "halving (2, 2)": (halving, _lanes(2, 2)),
    },
}


def main(world: int, rank: int, init_file: str, out_dir: str) -> None:
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=world)
    try:
        results = {name: fn(mesh()) for name, (fn, mesh)
                   in GROUPS[world].items()}
    finally:
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
