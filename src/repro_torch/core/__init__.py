"""Aggregation engine and rules, attacks, switching, MLMC and the per-round
training loop."""
from repro_torch.core.agg_engine import (
    count_ceil, count_floor, get_aggregator, registered_rules, trim_count,
)
from repro_torch.core.attacks import get_attack
from repro_torch.core.mlmc import MLMCConfig, level_schedule, mlmc_combine
from repro_torch.core.robust_train import (
    DynaBROConfig, RoundLog, make_dynabro_step, run_dynabro,
)
from repro_torch.core.switching import get_switcher

__all__ = ["count_ceil", "count_floor", "get_aggregator", "registered_rules",
           "trim_count",
           "get_attack", "MLMCConfig", "level_schedule", "mlmc_combine",
           "DynaBROConfig", "RoundLog", "make_dynabro_step", "run_dynabro",
           "get_switcher"]
