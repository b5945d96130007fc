"""Aggregation engine and rules, attacks, switching, MLMC and the training
loops: per-round and compiled, DynaBRO and worker momentum, and the
lane-batched sweep."""
from repro_torch.core.agg_engine import (
    count_ceil, count_floor, get_aggregator, registered_rules, trim_count,
)
from repro_torch.core.attacks import get_attack
from repro_torch.core.mlmc import MLMCConfig, level_schedule, mlmc_combine
from repro_torch.core.robust_train import (
    DynaBROConfig, LanePlan, RoundLog, ScanFn, make_dynabro_scan_fn,
    make_dynabro_step, make_momentum_scan_fn, make_momentum_step, run_dynabro,
    run_dynabro_scan, run_dynabro_scan_sweep, run_momentum, run_momentum_scan,
)
from repro_torch.core.switching import get_switcher

__all__ = ["count_ceil", "count_floor", "get_aggregator", "registered_rules",
           "trim_count",
           "get_attack", "MLMCConfig", "level_schedule", "mlmc_combine",
           "DynaBROConfig", "LanePlan", "RoundLog", "ScanFn",
           "make_dynabro_scan_fn", "make_dynabro_step",
           "make_momentum_scan_fn", "make_momentum_step", "run_dynabro",
           "run_dynabro_scan", "run_dynabro_scan_sweep", "run_momentum",
           "run_momentum_scan", "get_switcher"]
