"""MLMC gradient estimation with the DynaBRO fail-safe filter (Alg. 1 & 2).

Per round: sample ``J ~ Geom(1/2)`` on the host; aggregate worker mini-batch
gradients at levels ``0, J-1, J``; combine ``g = ĝ⁰ + 2^J (ĝ^J − ĝ^{J−1})``
guarded by the fail-safe event

    E_t = { ‖ĝ^J − ĝ^{J−1}‖ ≤ (1+√2) · c_E · C · V / √(2^J) }      (Eq. 6)

with ``C = sqrt(8 log(16 m² T))``; Option 1 sets ``c_E = √γ``
(γ = 2κ_δ + 1/m), Option 2 (MFM) sets ``c_E = 6√2`` (δ-oblivious).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch
from torch.utils._pytree import tree_map


def sample_level(rng: np.random.Generator, j_max: int) -> int:
    """J ~ Geom(1/2) (support 1, 2, ...), truncated at j_max + 1."""
    j = int(rng.geometric(0.5))
    return min(j, j_max + 1)  # j_max+1 encodes 'beyond cap' -> correction dropped


def level_schedule(rng: np.random.Generator, j_max: int, T: int) -> np.ndarray:
    """The (T,) level sequence the per-round driver draws from ``rng``.
    Entries lie in {1, …, j_max+1}."""
    return np.array([sample_level(rng, j_max) for _ in range(T)], np.int32)


def level_prefix(tree, n_units: int, n_total: int, axis: int = 0):
    """Prefix-slice each leaf to the level-``n_units`` nested sub-batch of an
    ``n_total``-unit batch along ``axis``: the first ``n_units / n_total``
    of the axis (the MLMC levels are nested, the level-(J−1) mini-batch the
    first half of the level-J one). ``tree`` is a tensor or a nest of
    dicts, lists and tuples of tensors; the slices are views."""
    def sl(x):
        return x.narrow(axis, 0, x.shape[axis] * n_units // n_total)
    return tree_map(sl, tree)


def universal_C(m: int, T: int) -> float:
    return math.sqrt(8.0 * math.log(16.0 * m * m * T))


@dataclasses.dataclass(frozen=True)
class MLMCConfig:
    T: int  # total rounds (sets J_max = floor(log2 T) and the C constant)
    m: int  # number of workers
    V: float  # bounded-noise level (Assumption 2.2)
    option: int = 1  # 1: (δ,κ)-robust agg, 2: MFM
    kappa: float = 1.0  # κ_δ of the aggregator (Option 1)
    use_failsafe: bool = True
    j_cap: int = 7  # practical cap (Appendix J uses J_max=7)

    @property
    def j_max(self) -> int:
        return min(int(math.log2(max(self.T, 2))), self.j_cap)

    @property
    def gamma(self) -> float:
        return 2.0 * self.kappa + 1.0 / self.m

    @property
    def c_E(self) -> float:
        if self.option == 2:
            return 6.0 * math.sqrt(2.0)
        return math.sqrt(self.gamma)

    @property
    def threshold_coeff(self) -> float:
        """The j-independent factor (1+√2)·c_E·C·V of the fail-safe bound."""
        C = universal_C(self.m, self.T)
        return (1.0 + math.sqrt(2.0)) * self.c_E * C * self.V

    def threshold(self, j: int) -> float:
        """Fail-safe bound (1+√2)·c_E·C·V/√(2^j), computed in float32 as
        ``f32(coeff) / sqrt(f32(2^j))`` the way the JAX package's weak typing
        computes it, so ``failsafe_ok`` cannot flip at the boundary."""
        return float(np.float32(self.threshold_coeff)
                     / np.sqrt(np.float32(2.0 ** j)))

    def mfm_tau(self, n: int) -> float:
        """MFM threshold T^N = 2·C·V/√N (Option 2)."""
        return 2.0 * universal_C(self.m, self.T) * self.V / math.sqrt(n)


def tree_norm(tree) -> torch.Tensor:
    """Global L2 norm of a parameter dict, summed over leaves in sorted key
    order (the JAX package's ``jax.tree.leaves`` order)."""
    return torch.sqrt(sum(torch.sum(torch.square(tree[k].to(torch.float32)))
                          for k in sorted(tree)))


def mlmc_combine(g0, gjm1, gj, j: int, cfg: MLMCConfig, threshold=None,
                 norm_fn=None):
    """Combine aggregated level gradients into the MLMC estimate.

    g0/gjm1/gj: parameter dicts (aggregated gradients at batch sizes 1,
    2^{j-1}, 2^j). ``j`` is host-sampled. Returns (g, info dict).
    ``threshold`` overrides ``cfg.threshold(j)``: the sweep passes each
    lane's bound there as a float32 tensor on the card, since lanes mixing
    MFM with the (δ,κ)-robust rules differ in c_E. ``norm_fn`` overrides
    ``tree_norm`` on the correction."""
    dev = next(iter(g0.values())).device
    # True made on the device (a fill, not a copy from the host): the round
    # runs inside a captured CUDA graph in the compiled driver
    true = functools.partial(torch.ones, (), dtype=torch.bool, device=dev)
    if j > cfg.j_max or gj is None:
        info = {"level": j, "failsafe_ok": true(),
                "corr_norm": torch.zeros((), device=dev)}
        return g0, info
    diff = {k: gj[k].to(torch.float32) - gjm1[k].to(torch.float32)
            for k in sorted(gj)}
    dn = (norm_fn or tree_norm)(diff)
    if threshold is None:
        threshold = cfg.threshold(j)
    ok = dn <= threshold if cfg.use_failsafe else true()
    scale = torch.where(ok, 2.0 ** j, 0.0)
    g = {k: (g0[k].to(torch.float32) + scale * diff[k]).to(g0[k].dtype)
         for k in sorted(g0)}
    info = {"level": j, "failsafe_ok": ok, "corr_norm": dn}
    return g, info


def round_cost(j: int, j_max: int) -> int:
    """Per-worker stochastic-gradient evaluations a level-j round computes:
    1 + 2^{j-1} + 2^j in cap (1 ≤ j ≤ j_max), else 1."""
    if 1 <= j <= j_max:
        return 1 + 2 ** (j - 1) + 2 ** j
    return 1


def expected_cost(j: int, j_max: Optional[int] = None) -> int:
    """Per-worker cost of a level-j round; ``j_max=None`` means uncapped
    (every j ≥ 1 is treated as in-cap)."""
    return round_cost(j, j_max if j_max is not None else max(j, 1))
