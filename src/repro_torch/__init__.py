"""repro_torch — the PyTorch/CUDA port of the JAX package ``repro``.

It mirrors ``repro``'s layout and runs on an NVIDIA GPU by default; pass
``device="cpu"`` to run it on the CPU, where every kernel wrapper computes
its plain PyTorch version. It imports nothing of JAX or of ``repro``.

Ported so far: Algorithm 2 (MLMC + fail-safe, Options 1 and 2) and the
worker-momentum baseline, each through the per-round driver and the compiled
whole-T driver (one CUDA graph per MLMC level on a card), with every class
rule of the JAX package: the coordinate-wise rules (Mean, CWMed, CWTM) on
the CUDA kernel ``kernels/csrc/cw_reduce.cu``, and the geometry rules
(Krum, GeoMed, MFM and ``nnm+<base>``) on ``kernels/csrc/sqdist.cu``
(pairwise and cross squared distances) and ``kernels/csrc/combine.cu``
(weighted combine, mix+reduce); every attack, every switching strategy and
every optimizer, on the Gaussian-mixture MLP task and App. E's quadratic;
the ``repro.api`` facade (``Session`` and ``build_session``, the validated
specs, the lane-batched sweep ``run_dynabro_scan_sweep`` with each rule's
theta form, the scenario grids) and carry checkpoints; the model zoo
(``configs``, ``models``: every family of the registry as a DynaBRO task,
``make_zoo_task`` / ``task_for_config``, on ``data.SyntheticLMData``)
through the compiled driver's ``microbatch=True`` streaming, and its decode
entry points (``models.init_cache``, ``prefill``, ``decode_step``); the
successive-halving sweep ``Session.sweep_halving``; and the aggregation
service ``repro_torch.serve`` (a threaded server stepping a ``Session``
from worker updates); and Mode A's multi-device drivers over
``torch.distributed`` (``make_worker_mesh`` / ``make_lane_mesh``, the
compiled drivers' ``mesh=`` and the sweeps' ``lane_mesh=``). Its names are
re-exported here.
"""
from repro_torch.api import (
    AggSpec, AttackSpec, DynaBROConfig, MLMCConfig, Optimizer, RoundInputs,
    RoundLog, RoundSchedule, Scenario, Session, StepInfo, SweepSpec,
    Switcher, Task, adagrad_norm, adam, build_session, format_table,
    get_switcher, make_dynabro_scan_fn, make_lane_mesh, make_momentum_scan_fn,
    make_quadratic_task, make_worker_mesh, momentum, run_dynabro,
    run_dynabro_scan, run_dynabro_scan_sweep, run_matrix, run_momentum,
    run_momentum_scan, run_scenario, scenario_grid, sgd,
)
from repro_torch.checkpoint import (
    checkpoint_step, latest_checkpoint, load_checkpoint, save_checkpoint,
)
from repro_torch.convert import (
    params_from_numpy, params_to_numpy, zoo_cache_from_numpy,
    zoo_cache_to_numpy, zoo_params_from_numpy, zoo_params_to_numpy,
)
from repro_torch.core import (
    get_aggregator, get_attack, make_dynabro_step, make_momentum_step,
)
from repro_torch.data import SyntheticLMData, make_task
from repro_torch.device import resolve_device
from repro_torch.kernels import LAUNCHES
from repro_torch.models import make_zoo_task, task_for_config
from repro_torch.serve import (
    AggregationServer, HealthEndpoint, MetricsLog, RingBuffer, ServeConfig,
    ServeMetrics, SimulatedWorkers, Update, worker_payloads,
)

__all__ = [
    # repro.api's names
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
    # the checkpoints
    "save_checkpoint", "load_checkpoint", "checkpoint_step",
    "latest_checkpoint",
    # the port's own
    "params_from_numpy", "params_to_numpy", "get_aggregator", "get_attack",
    "make_dynabro_step", "make_momentum_step", "make_task", "resolve_device",
    "LAUNCHES",
    # the model zoo
    "SyntheticLMData", "make_zoo_task", "task_for_config",
    "zoo_params_from_numpy", "zoo_params_to_numpy", "zoo_cache_from_numpy",
    "zoo_cache_to_numpy",
    # repro.serve's names
    "AggregationServer", "ServeConfig", "Update", "RingBuffer",
    "ServeMetrics", "MetricsLog", "HealthEndpoint",
    "SimulatedWorkers", "worker_payloads",
]
