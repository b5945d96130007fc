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
compiled drivers' ``mesh=`` and the sweeps' ``lane_mesh=``), the model zoo's
GSPMD path and Mode B's robust step (``launch``); and ``lint``: the static
pass ``python -m repro_torch.lint`` and the runtime sanitizers (the
recompile guard over CUDA-graph captures and ``nvcc`` builds, which
``Session(guard_recompiles=True)`` runs, and the NaN tripwire). Its names
are re-exported here.

The names load on first use (PEP 562), so ``import repro_torch`` imports
neither torch nor a submodule: ``python -m repro_torch.lint`` runs where
torch is not installed.
"""
from __future__ import annotations

import importlib

_EXPORTS = {
    "repro_torch.api": (
        "AggSpec", "AttackSpec", "DynaBROConfig", "MLMCConfig", "Optimizer",
        "RoundInputs", "RoundLog", "RoundSchedule", "Scenario", "Session",
        "StepInfo", "SweepSpec", "Switcher", "Task", "adagrad_norm", "adam",
        "build_session", "format_table", "get_switcher",
        "make_dynabro_scan_fn", "make_lane_mesh", "make_momentum_scan_fn",
        "make_quadratic_task", "make_worker_mesh", "momentum", "run_dynabro",
        "run_dynabro_scan", "run_dynabro_scan_sweep", "run_matrix",
        "run_momentum", "run_momentum_scan", "run_scenario", "scenario_grid",
        "sgd"),
    "repro_torch.checkpoint": (
        "checkpoint_step", "latest_checkpoint", "load_checkpoint",
        "save_checkpoint"),
    "repro_torch.convert": (
        "params_from_numpy", "params_to_numpy", "zoo_cache_from_numpy",
        "zoo_cache_to_numpy", "zoo_params_from_numpy", "zoo_params_to_numpy"),
    "repro_torch.core": (
        "get_aggregator", "get_attack", "make_dynabro_step",
        "make_momentum_step"),
    "repro_torch.data": ("SyntheticLMData", "make_task"),
    "repro_torch.device": ("resolve_device",),
    "repro_torch.kernels": ("LAUNCHES",),
    "repro_torch.models": ("make_zoo_task", "task_for_config"),
    "repro_torch.serve": (
        "AggregationServer", "HealthEndpoint", "MetricsLog", "RingBuffer",
        "ServeConfig", "ServeMetrics", "SimulatedWorkers", "Update",
        "worker_payloads"),
}
_WHERE = {name: module for module, names in _EXPORTS.items()
          for name in names}

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


def __getattr__(name: str):
    module = _WHERE.get(name)
    if module is None:
        raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
    value = getattr(importlib.import_module(module), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(_WHERE))
