"""Validated scenario and sweep specs: the config side of the
``repro_torch.api`` facade, a port of the JAX package's ``api/specs.py``
with the same validation, errors and labels.

A lane of a sweep is encoded three ways: per-cell config fields
(``DynaBROConfig.aggregator`` + ``delta`` + ``aggregator_kwargs``), per-lane
theta rows (``agg_theta`` + the fail-safe coefficient), and the prebuilt
lane scan_fn (``lane_attacks``/``lane_aggregators``, ``scan_fn`` one scan_fn
or a ``{rule: scan_fn}`` mapping). ``AttackSpec`` / ``AggSpec`` /
``SweepSpec`` are the one validated source they all derive from: a spec
checks its name and parameters at construction (the errors name the valid
choices) and emits each form (``AggSpec.theta()`` for the lanes,
``AggSpec.apply_to(cfg)`` for a per-cell run, ``SweepSpec.scan_fn`` for
the prebuilt form), so the encodings cannot drift.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Optional, Tuple, Union

from repro_torch.core import agg_engine
from repro_torch.core import attacks as attacks_lib
from repro_torch.core.mlmc import MLMCConfig
from repro_torch.core.switching import Switcher, get_switcher


def _freeze_kwargs(kw: Optional[Mapping[str, Any]]) -> Tuple[Tuple[str, Any], ...]:
    return tuple(sorted((dict(kw or {})).items()))


@dataclasses.dataclass(frozen=True)
class AttackSpec:
    """One validated attack choice: name + parameter overrides.

    Construction validates eagerly: an unknown attack or parameter raises
    with the valid choices named, instead of failing inside a sweep's
    round. ``theta()`` is the per-lane row (``attacks.attack_theta``);
    ``legacy`` the ``(name, kwargs)`` tuple the call sites without specs
    pass around.
    """

    name: str
    params: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        if self.name not in attacks_lib.ATTACKS:
            raise ValueError(
                f"unknown attack {self.name!r}; known: "
                f"{tuple(sorted(attacks_lib.ATTACKS))}")
        object.__setattr__(self, "params", _freeze_kwargs(dict(self.params)))
        self.theta()  # validates parameter names/values (raises on unknown)

    @classmethod
    def make(cls, name: str, **params) -> "AttackSpec":
        return cls(name, _freeze_kwargs(params))

    @classmethod
    def coerce(cls, spec: "AttackLike") -> "AttackSpec":
        """Accept a name, a ``(name, kwargs)`` pair, or an AttackSpec."""
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return cls(spec)
        try:
            name, kw = spec
        except (TypeError, ValueError):
            raise ValueError(
                f"cannot interpret {spec!r} as an attack spec; pass a name, "
                f"a (name, kwargs) pair, or an AttackSpec") from None
        return cls(name, _freeze_kwargs(kw))

    @property
    def kwargs(self) -> Dict[str, Any]:
        return dict(self.params)

    @property
    def legacy(self) -> Union[str, Tuple[str, Dict[str, Any]]]:
        return (self.name, self.kwargs) if self.params else self.name

    def theta(self):
        """(N_PARAMS,) float32 parameter row: the lanes' encoding."""
        return attacks_lib.attack_theta(self.name, self.kwargs)

    @property
    def label(self) -> str:
        kw = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.name}({kw})" if kw else self.name


@dataclasses.dataclass(frozen=True)
class AggSpec:
    """One validated aggregation-rule choice: rule + hyperparameters.

    The single source both rule encodings derive from:

    - per-lane form: ``theta()`` (= ``agg_engine.agg_theta``) and
      ``thr_coeff(mlmc)`` — the lane's fail-safe coefficient, Option-2
      (δ-oblivious) for MFM and Option-1 for every other rule, exactly as
      ``scenarios._cell_cfg`` configures cells;
    - per-cell (config) form: ``apply_to(cfg)`` returns the cfg a per-cell
      ``run_dynabro_scan`` reference run must use for this rule — the
      ``aggregator`` / ``delta`` / ``aggregator_kwargs`` / MLMC-option
      fields set consistently with the lane encoding above.
    """

    rule: str
    params: Tuple[Tuple[str, Any], ...] = ()

    def __post_init__(self):
        agg_engine.agg_param_spec(self.rule)  # unknown rule -> ValueError
        object.__setattr__(self, "params", _freeze_kwargs(dict(self.params)))
        self.theta()  # validates hyperparameter names/values

    @classmethod
    def make(cls, rule: str, **params) -> "AggSpec":
        return cls(rule, _freeze_kwargs(params))

    @classmethod
    def coerce(cls, spec: "AggLike") -> "AggSpec":
        if isinstance(spec, cls):
            return spec
        if isinstance(spec, str):
            return cls(spec)
        try:
            rule, kw = spec
        except (TypeError, ValueError):
            raise ValueError(
                f"cannot interpret {spec!r} as an aggregator spec; pass a "
                f"rule name, a (rule, kwargs) pair, or an AggSpec") from None
        return cls(rule, _freeze_kwargs(kw))

    @property
    def kwargs(self) -> Dict[str, Any]:
        return dict(self.params)

    @property
    def legacy(self) -> Union[str, Tuple[str, Dict[str, Any]]]:
        return (self.rule, self.kwargs) if self.params else self.rule

    def theta(self):
        """(N_AGG_PARAMS,) float32 hyperparameter row: the lanes' encoding."""
        return agg_engine.agg_theta(self.rule, self.kwargs)

    def thr_coeff(self, mlmc: MLMCConfig) -> float:
        """The lane's fail-safe coefficient (1+√2)·c_E·C·V: MFM lanes run
        the paper's δ-oblivious Option 2, every other rule Option 1."""
        option = 2 if self.rule == "mfm" else 1
        return float(dataclasses.replace(mlmc, option=option).threshold_coeff)

    def apply_to(self, cfg) -> Any:
        """The per-cell ``DynaBROConfig`` equivalent of this lane — what a
        per-cell reference run of the same rule must be configured with."""
        kw = self.kwargs
        return dataclasses.replace(
            cfg,
            mlmc=dataclasses.replace(
                cfg.mlmc, option=2 if self.rule == "mfm" else 1),
            aggregator=self.rule,
            delta=kw.get("delta", cfg.delta),
            aggregator_kwargs=kw or None)

    @property
    def label(self) -> str:
        kw = ",".join(f"{k}={v}" for k, v in self.params)
        return f"{self.rule}({kw})" if kw else self.rule


AttackLike = Union[str, Tuple[str, Mapping[str, Any]], AttackSpec]
AggLike = Union[str, Tuple[str, Mapping[str, Any]], AggSpec]
SwitcherLike = Union[str, Tuple[str, Mapping[str, Any]], Switcher]


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """One validated description of a lane-batched sweep.

    ``switchers`` is the lane axis (one entry per lane: a ``Switcher``
    instance, a name, or ``(name, kwargs)`` resolved against the session's
    ``m``/``seed``); ``attacks`` / ``aggregators`` optionally give each lane
    its own attack / rule (AttackSpec / AggSpec or their legacy encodings —
    everything is coerced and validated here, with lane-count mismatches
    reported up front). ``scan_fn`` carries the steady-state prebuilt form:
    either one lane-built scan_fn for a branch-homogeneous grid, or a
    ``{rule_name: scan_fn}`` mapping with one single-rule scan_fn per
    distinct rule of a mixed grid.

    ``seeds`` / ``replicates`` add the **replicate axis**: every cell is run
    once per replicate seed, each replicate with its own data-sampler,
    switcher-mask and ``random``-attack generator streams while the MLMC
    level plan stays a function of the *session* seed alone: replicates are
    paired on levels across cells, so cross-cell comparisons stay
    low-variance and every lane runs the round's one level graph. Pass
    explicit ``seeds=(s0, s1, ...)`` or a count ``replicates=N`` (seeds
    then default to ``session.seed + r``). With more than one replicate the
    switchers must be name / ``(name, kwargs)`` specs — a prebuilt
    ``Switcher`` instance carries one fixed seed and cannot be re-seeded
    per replicate.
    """

    switchers: Tuple[SwitcherLike, ...]
    attacks: Optional[Tuple[AttackSpec, ...]] = None
    aggregators: Optional[Tuple[AggSpec, ...]] = None
    scan_fn: Any = None
    seeds: Optional[Tuple[int, ...]] = None
    replicates: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "switchers", tuple(self.switchers))
        if self.seeds is not None:
            seeds = tuple(int(s) for s in self.seeds)
            if not seeds:
                raise ValueError("seeds= must name at least one seed")
            if len(set(seeds)) != len(seeds):
                raise ValueError(f"seeds= has duplicates: {seeds}")
            if self.replicates is not None \
                    and int(self.replicates) != len(seeds):
                raise ValueError(
                    f"replicates={self.replicates} disagrees with "
                    f"len(seeds)={len(seeds)}; pass one or the other")
            object.__setattr__(self, "seeds", seeds)
            object.__setattr__(self, "replicates", len(seeds))
        elif self.replicates is not None:
            if int(self.replicates) < 1:
                raise ValueError(
                    f"replicates= must be >= 1, got {self.replicates}")
            object.__setattr__(self, "replicates", int(self.replicates))
        C = len(self.switchers)
        for axis_name, specs, coerce in (
                ("attacks", self.attacks, AttackSpec.coerce),
                ("aggregators", self.aggregators, AggSpec.coerce)):
            if specs is None:
                continue
            specs = tuple(specs)
            # lane-count check first (the legacy drivers' error), THEN
            # per-spec validation — a wrong-length axis should say so even
            # when its entries are also malformed
            if len(specs) != C:
                raise ValueError(
                    f"{axis_name}: expected one per-lane spec per switcher "
                    f"({C}), got {len(specs)}")
            object.__setattr__(self, axis_name,
                               tuple(coerce(s) for s in specs))

    @property
    def lanes(self) -> int:
        return len(self.switchers)

    @property
    def n_replicates(self) -> int:
        return self.replicates if self.replicates is not None else 1

    def replicate_seeds(self, base_seed: int) -> Tuple[int, ...]:
        """The per-replicate seed tuple: explicit ``seeds=``, else
        ``base_seed + r`` for ``replicates=N`` (r = 0 is the base run)."""
        if self.seeds is not None:
            return self.seeds
        return tuple(base_seed + r for r in range(self.n_replicates))

    def resolve_switchers(self, m: Optional[int], seed: int):
        """Lane ``Switcher`` instances; name/(name, kwargs) entries need the
        session's worker count ``m`` (instances pass through untouched).
        With more than one replicate every entry must be a re-seedable
        name/(name, kwargs) spec — the sweep resolves the lane once per
        replicate seed."""
        out = []
        for sw in self.switchers:
            if isinstance(sw, Switcher):
                if self.n_replicates > 1 or self.seeds is not None:
                    raise ValueError(
                        f"switcher instance {type(sw).__name__}(m={sw.m}, "
                        f"seed={sw.seed}) cannot be re-seeded per replicate; "
                        f"pass a name or (name, kwargs) spec when the sweep "
                        f"carries seeds=/replicates=")
                out.append(sw)
                continue
            name, kw = (sw, {}) if isinstance(sw, str) else (sw[0], dict(sw[1]))
            if m is None:
                raise ValueError(
                    f"switcher spec {sw!r} needs a worker count to resolve; "
                    f"build the session with m= (or pass Switcher instances)")
            out.append(get_switcher(name, m, seed=seed, **kw))
        return out

    def attack_lanes(self):
        """Per-lane ``(name, kwargs)`` pairs (the lane-plan input), or None."""
        if self.attacks is None:
            return None
        return [(a.name, a.kwargs) for a in self.attacks]

    def agg_lanes(self):
        if self.aggregators is None:
            return None
        return [(g.rule, g.kwargs) for g in self.aggregators]

    def lane_subset(self, idx, scan_fn=None) -> "SweepSpec":
        """The sub-spec of lanes ``idx`` — the branch-homogeneous grouping
        recursion's unit of work."""
        return SweepSpec(
            switchers=tuple(self.switchers[c] for c in idx),
            attacks=(None if self.attacks is None
                     else tuple(self.attacks[c] for c in idx)),
            aggregators=(None if self.aggregators is None
                         else tuple(self.aggregators[c] for c in idx)),
            scan_fn=scan_fn,
            seeds=self.seeds,
            replicates=self.replicates)
