"""``repro_torch.api``: the one facade over the port, under the names of the
JAX package's ``repro.api``.

Quickstart::

    from repro_torch.api import (MLMCConfig, DynaBROConfig, build_session,
                                 make_quadratic_task, get_switcher, sgd)

    task = make_quadratic_task()             # device="cpu" without a card
    cfg = DynaBROConfig(mlmc=MLMCConfig(T=200, m=16, V=3.0))
    sess = build_session(cfg, task, m=16, opt=sgd(2e-2),
                         switcher=get_switcher("periodic", 16, n_byz=3, K=10))
    params, logs, evals = sess.run(200)      # compiled driver
    carry = sess.init_carry()                # ... or round by round:
    sched = sess.schedule(200)
    carry, info = sess.step(carry, sess.round_inputs(sched, 0))

``make_worker_mesh`` / ``make_lane_mesh`` build the meshes of the sharded
drivers (``mesh=``, ``lane_mesh=``) over ``torch.distributed``: every rank
of the default process group calls the same driver with the same
arguments. ``make_worker_mesh(model=)`` builds the ``(workers, 'model')``
mesh of the model zoo's GSPMD path, whose ``param_specs=`` come from
``repro_torch.launch.sharding.plan_params``.
"""
from repro_torch.api.session import (
    RoundInputs, RoundSchedule, Session, StepInfo, build_session,
)
from repro_torch.api.specs import AggSpec, AttackSpec, SweepSpec
from repro_torch.core.mlmc import MLMCConfig
from repro_torch.core.robust_train import (
    DynaBROConfig, RoundLog, make_dynabro_scan_fn,
    make_momentum_scan_fn, run_dynabro, run_dynabro_scan,
    run_dynabro_scan_sweep, run_momentum, run_momentum_scan,
)
from repro_torch.core.scenarios import (
    Scenario, Task, format_table, make_quadratic_task, run_matrix,
    run_scenario, scenario_grid,
)
from repro_torch.core.switching import Switcher, get_switcher
from repro_torch.launch.mesh import make_lane_mesh, make_worker_mesh
from repro_torch.optim.optimizers import (
    Optimizer, adagrad_norm, adam, momentum, sgd,
)


__all__ = [
    "AggSpec", "AttackSpec", "SweepSpec",
    "RoundInputs", "RoundSchedule", "Session", "StepInfo", "build_session",
    "MLMCConfig", "DynaBROConfig", "RoundLog",
    "make_dynabro_scan_fn", "make_momentum_scan_fn",
    "run_dynabro", "run_dynabro_scan", "run_dynabro_scan_sweep",
    "run_momentum", "run_momentum_scan",
    "Scenario", "Task", "format_table", "make_quadratic_task", "run_matrix",
    "run_scenario", "scenario_grid",
    "Switcher", "get_switcher",
    "make_lane_mesh", "make_worker_mesh",
    "Optimizer", "adagrad_norm", "adam", "momentum", "sgd",
]
