"""Robust aggregation rules over the ``core.agg_engine`` primitives: the class
rules of the JAX package's ``core/aggregators.py``. ``agg.tree(stacked)``
reduces every leaf (leading worker axis m) to one worker's shape.

Coordinate-wise rules (Mean/CWMed/CWTM) reduce every leaf, in one launch
for the tree on the kernel backend. Distance-based
rules (Krum/GeoMed/NNM/MFM) compute the *global* pairwise distances by
summing per-leaf contributions, turn them into per-worker weights on the
device, then combine per leaf; no rule materializes the flat (m, d_total)
matrix.

``(δ, κ_δ)``-robustness (Def. 3.2, Allouah et al. 2023) holds for CWMed,
CWTM, Krum and GeoMed (κ_δ in ``KAPPA``); MFM (Alg. 3 of the paper) is
deliberately *not* (δ,κ)-robust (App. F.1) but gives the optimal δ²-scaling
under bounded noise (Lemma 5.1).

The uniform theta forms at the bottom (the JAX package's lane-batched sweep
forms) call the same cores with their counts as tensors on the card:
Krum's and NNM's k from ``traced_count``, the trims from
``traced_trim_count`` (for ``nnm+cwtm`` read on the card by the mix+reduce
kernel), GeoMed's steps gated on the lane's ``iters``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.agg_engine import (
    GEOMED_MAX_ITERS, Aggregator, CoordinateWiseRule, GeometryRule, Tree,
    agg_param_spec, count_ceil, pairwise_sqdist, register, register_uniform,
    traced_count, traced_trim_count, tree_combine_reduce, tree_cross_sqdist,
    tree_cw_reduce, tree_cw_reduce_lanes, tree_pairwise_sqdist,
    tree_weighted_combine, trim_count, uniform_aggregator,
)

__all__ = ["Mean", "CWMed", "CWTM", "Krum", "GeoMed", "NNM", "MFM", "KAPPA",
           "pairwise_sqdists", "tree_pairwise_sqdists", "tree_stack_to_mat",
           "mat_to_tree"]


# ---------------------------------------------------------------- helpers
#
# Flat-matrix helpers for tests and diagnostics; the rules do not use them.


def tree_stack_to_mat(stacked: Tree) -> torch.Tensor:
    """(m, ...)-leaf dict -> (m, d) float32 matrix, leaves in sorted key order
    (diagnostics only: O(m·d))."""
    m = next(iter(stacked.values())).shape[0]
    return torch.cat([stacked[k].reshape(m, -1).to(torch.float32)
                      for k in sorted(stacked)], dim=1)


def mat_to_tree(vec: torch.Tensor, like: Tree) -> Tree:
    """(d,) vector -> dict shaped like one worker's entry of ``like``."""
    out, off = {}, 0
    for k in sorted(like):
        shape = like[k].shape[1:]
        size = like[k][0].numel()
        out[k] = vec[off:off + size].reshape(shape).to(like[k].dtype)
        off += size
    return out


def pairwise_sqdists(x: torch.Tensor) -> torch.Tensor:
    """x: (m, d) -> (m, m) squared L2 distances (ref backend)."""
    return pairwise_sqdist(x.to(torch.float32), backend="ref")


def tree_pairwise_sqdists(stacked: Tree) -> torch.Tensor:
    """Global (m, m) squared distances summed over all leaves (ref backend)."""
    return tree_pairwise_sqdist(stacked, backend="ref")


# ---------------------------------------------------------------- cores
#
# The weight/score math of the geometry rules, on the device, with no host
# sync. Written in the JAX package's full-width masked style (a ``where``
# over a sorted row rather than a slice) so the op sequence is the same.


def _krum_scores(d2: torch.Tensor, k: int) -> torch.Tensor:
    """Sum of each worker's k nearest squared distances (self excluded)."""
    m = d2.shape[0]
    d2 = d2 + torch.diag(torch.full((m,), torch.inf, device=d2.device))
    srt = torch.sort(d2, dim=1).values
    col = torch.arange(m, device=d2.device)[None, :]
    return torch.where(col < k, srt, 0.0).sum(1)


def _krum_weights(d2: torch.Tensor, k: int, multi: int) -> torch.Tensor:
    """(m,) selection weights: 1/multi on the multi best-scored workers."""
    s = _krum_scores(d2, k)
    m = s.shape[0]
    # a stable full argsort by score: jax.lax.top_k(-s, m) keeps the lower
    # index first among ties, and torch.topk promises no order there
    idx = torch.sort(-s, descending=True, stable=True).indices
    per = torch.where(torch.arange(m, device=s.device) < multi, 1.0 / multi, 0.0)
    return torch.zeros_like(s).scatter_(0, idx, per)


def _nnm_weights(d2: torch.Tensor, k: int) -> torch.Tensor:
    """(m, m) mixing matrix: row i averages worker i's k nearest (self
    included), ties to the lower index as ``jax.lax.top_k`` breaks them."""
    m = d2.shape[0]
    idx = torch.sort(-d2, dim=1, descending=True, stable=True).indices
    ws = torch.where(torch.arange(m, device=d2.device) < k, 1.0 / k, 0.0)
    return torch.zeros((m, m), device=d2.device).scatter_(
        1, idx, ws.expand(m, m))


def _mfm_weights(d2: torch.Tensor, tau) -> torch.Tensor:
    """Median-Filtered-Mean weights (Alg. 3); all-zero => output 0."""
    m = d2.shape[0]
    d = torch.sqrt(d2)
    within_half = (d <= tau / 2).sum(1)  # includes self
    is_med_candidate = within_half > m / 2
    any_med = is_med_candidate.any()
    # the first candidate: argmax returns the first maximum, and takes no bool
    med_idx = torch.argmax(is_med_candidate.to(torch.int32))
    close = torch.index_select(d, 0, med_idx.reshape(1))[0] <= tau  # (m,)
    w = close.to(torch.float32)
    return torch.where(any_med, w / torch.clamp(w.sum(), min=1.0),
                       torch.zeros((m,), device=d2.device))


def _geomed_tree(stacked: Tree, iters, eps, backend: str,
                 unroll: Optional[int] = None, leaf_sum=None) -> Tree:
    """``iters`` Weiszfeld iterations from the mean, the iterate in float32
    throughout and cast back to each leaf's dtype at the end. An int
    ``iters`` runs that many steps; a tensor ``iters`` (the uniform form's)
    runs ``unroll`` steps, step i kept where i < iters. ``leaf_sum`` sums
    each step's distance partials over sharded leaves' blocks."""
    m = next(iter(stacked.values())).shape[0]
    dev = next(iter(stacked.values())).device
    static = not isinstance(iters, torch.Tensor)
    z = tree_weighted_combine(
        stacked, torch.full((m,), 1.0 / m, dtype=torch.float32, device=dev),
        backend=backend, out_dtype=torch.float32)
    for i in range(iters if static else unroll):
        d2 = tree_cross_sqdist(stacked, z, backend=backend, leaf_sum=leaf_sum)
        w = 1.0 / torch.sqrt(d2 + eps)
        zn = tree_weighted_combine(stacked, w / w.sum(), backend=backend,
                                   out_dtype=torch.float32)
        if static:
            z = zn
        else:
            live = i < iters
            z = {k: torch.where(live, zn[k], z[k]) for k in sorted(z)}
    return {k: z[k].to(stacked[k].dtype) for k in sorted(stacked)}


# ---------------------------------------------------------------- rules


class Mean(CoordinateWiseRule):
    name = "mean"
    cr_mode = "mean"  # the reduce mode, also NNM's fused mix+reduce


class CWMed(CoordinateWiseRule):
    """Coordinate-wise median (Yin et al., 2018)."""
    name = "cwmed"
    cr_mode = "med"


class CWTM(CoordinateWiseRule):
    """Coordinate-wise trimmed mean: drop ⌈δm⌉ highest/lowest per coordinate."""
    name = "cwtm"
    cr_mode = "tm"

    def __init__(self, delta: float = 0.25, backend: str = "auto"):
        super().__init__(backend)
        self.delta = delta

    def trim(self, m: int) -> int:
        return trim_count(self.delta, m)


class Krum(GeometryRule):
    """(Multi-)Krum (Blanchard et al., 2017): pick the vector(s) with the
    smallest sum of distances to its m - ⌈δm⌉ - 2 nearest neighbours."""
    name = "krum"

    def __init__(self, delta: float = 0.25, multi: int = 1,
                 backend: str = "auto"):
        super().__init__(backend)
        self.delta = delta
        self.multi = multi

    def _k(self, m: int) -> int:
        return max(m - count_ceil(self.delta * m) - 2, 1)

    def scores(self, d2: torch.Tensor) -> torch.Tensor:
        """(m,) Krum scores of the (m, m) squared distances ``d2``: each
        worker's sum over its k nearest (self excluded)."""
        return _krum_scores(d2, self._k(d2.shape[0]))

    def _weights(self, d2):
        return _krum_weights(d2, self._k(d2.shape[0]), self.multi)


class GeoMed(Aggregator):
    """Geometric median via Weiszfeld iterations (Pillutla et al., 2022).
    Each iteration is one cross-distance accumulate (x vs the iterate z) plus
    one weighted combine, both streamed per leaf."""
    name = "geomed"

    def __init__(self, iters: int = 8, eps: float = 1e-8,
                 backend: str = "auto"):
        super().__init__(backend)
        self.iters = iters
        self.eps = eps

    def tree(self, stacked, leaf_sum=None):
        return _geomed_tree(stacked, self.iters, self.eps, self.backend,
                            leaf_sum=leaf_sum)


class NNM(GeometryRule):
    """Nearest-Neighbor Mixing (Allouah et al., 2023): replace each input by
    the mean of its m - ⌈δm⌉ nearest neighbours, then apply a base rule."""
    name = "nnm"

    def __init__(self, base: Aggregator, delta: float = 0.25,
                 backend: str = "auto"):
        super().__init__(backend)
        self.base = base
        self.delta = delta
        self.name = f"nnm+{base.name}"

    def _weights(self, d2: torch.Tensor) -> torch.Tensor:
        m = d2.shape[0]
        return _nnm_weights(d2, m - count_ceil(self.delta * m))

    def tree(self, stacked, leaf_sum=None):
        d2 = tree_pairwise_sqdist(stacked, backend=self.backend,
                                  leaf_sum=leaf_sum)
        w = self._weights(d2)
        if isinstance(self.base, CoordinateWiseRule):
            # coordinate-wise base: mix+reduce as one primitive, the (m, d)
            # mixed stack never written (agg_engine.combine_reduce)
            return tree_combine_reduce(stacked, w, mode=self.base.cr_mode,
                                       trim=self.base.trim(d2.shape[0]),
                                       backend=self.backend)
        mixed = tree_weighted_combine(stacked, w, backend=self.backend)
        return self.base.tree(mixed, leaf_sum=leaf_sum)


class MFM(GeometryRule):
    """Median-Filtered Mean (Alg. 3). Threshold ``tau`` is set at
    construction or per call (it scales as 2·C·V/√N with the mini-batch size
    N, ``MLMCConfig.mfm_tau``)."""
    name = "mfm"

    def __init__(self, tau: Optional[float] = None, backend: str = "auto"):
        super().__init__(backend)
        self.tau = tau

    def __call__(self, x: torch.Tensor, tau: Optional[float] = None):
        """MFM of the rows of one (m, ...) stack, in float32."""
        return self.tree({"x": x.to(torch.float32)}, tau)["x"]

    def tree(self, stacked, tau: Optional[float] = None, leaf_sum=None):
        tau = tau if tau is not None else self.tau
        if tau is None:
            raise ValueError("MFM needs a threshold: pass tau")
        d2 = tree_pairwise_sqdist(stacked, backend=self.backend,
                                  leaf_sum=leaf_sum)
        return tree_weighted_combine(stacked, _mfm_weights(d2, tau),
                                     backend=self.backend)


# ---------------------------------------------------------------- registry

KAPPA = {
    # κ_δ orders from Allouah et al. (2023), Table 1 (up to constants)
    "mean": lambda d, m: float("inf"),
    "cwmed": lambda d, m: 4 * d / (1 - 2 * d) if d < 0.5 else float("inf"),
    "cwtm": lambda d, m: 6 * d / (1 - 2 * d) * (1 + d / (1 - 2 * d)) if d < 0.5 else float("inf"),
    "krum": lambda d, m: 6 * d / (1 - 2 * d) if d < 0.5 else float("inf"),
    "geomed": lambda d, m: 4 * (1 + d / (1 - 2 * d)) ** 2 if d < 0.5 else float("inf"),
}

register("mean", lambda delta=0.25, tau=None, backend="auto": Mean(backend=backend))
register("cwmed", lambda delta=0.25, tau=None, backend="auto": CWMed(backend=backend))
register("cwtm", lambda delta=0.25, tau=None, backend="auto": CWTM(delta, backend=backend))
register("krum", lambda delta=0.25, tau=None, backend="auto", multi=1:
         Krum(delta, multi=int(multi), backend=backend))
register("geomed", lambda delta=0.25, tau=None, backend="auto", iters=8,
         eps=1e-8: GeoMed(int(iters), eps, backend=backend))
register("mfm", lambda delta=0.25, tau=None, backend="auto": MFM(tau, backend=backend))


# ------------------------------------------------- uniform theta forms
#
# The ``(stacked, n, theta) -> agg_tree`` forms behind
# ``agg_engine.uniform_aggregator`` / ``agg_switch``: one lane's rule with its
# hyperparameters read from theta's slots (per ``agg_param_spec``), calling
# the class rules' cores. The coordinate-wise rules also take every lane of
# a sweep at once: one lane reduce (``tree_cw_reduce_lanes``).

_CW_MODES = {"mean": "mean", "cwmed": "med", "cwtm": "tm"}


def _uniform_cw(name):
    """The coordinate-wise rule ``name`` over one lane, and over the lanes
    of a sweep in one launch, its trim ``traced_trim_count(delta, m)``."""
    mode = _CW_MODES[name]

    def trim(theta, m):
        return traced_trim_count(theta[..., 0], m) if mode == "tm" else 0

    def build(backend, mlmc):
        def fn(stacked, n, theta):
            m = next(iter(stacked.values())).shape[0]
            return tree_cw_reduce(stacked, mode, trim(theta, m),
                                  backend=backend)
        return fn

    def build_lanes(backend, mlmc):
        def fn(stacked, n, thetas):
            m = next(iter(stacked.values())).shape[1]
            return tree_cw_reduce_lanes(stacked, mode, trim(thetas, m),
                                        backend=backend)
        return fn

    return build, build_lanes


def _build_krum(backend, mlmc):
    def fn(stacked, n, theta):
        m = next(iter(stacked.values())).shape[0]
        k = torch.clamp(m - traced_count(theta[0] * m) - 2, min=1)
        d2 = tree_pairwise_sqdist(stacked, backend=backend)
        return tree_weighted_combine(stacked, _krum_weights(d2, k, theta[1]),
                                     backend=backend)
    return fn


def _build_geomed(backend, mlmc):
    def fn(stacked, n, theta):
        return _geomed_tree(stacked, theta[0], theta[1], backend,
                            unroll=GEOMED_MAX_ITERS)
    return fn


def _build_mfm(backend, mlmc):
    def fn(stacked, n, theta):
        tau = theta[0]
        if mlmc is not None:  # NaN sentinel -> the Option-2 auto threshold
            auto = torch.full((), mlmc.mfm_tau(n), dtype=torch.float32,
                              device=tau.device)
            tau = torch.where(torch.isnan(tau), auto, tau)
        d2 = tree_pairwise_sqdist(stacked, backend=backend)
        return tree_weighted_combine(stacked, _mfm_weights(d2, tau),
                                     backend=backend)
    return fn


def _build_nnm(base_name, backend, mlmc):
    base_fn = uniform_aggregator(base_name, backend=backend, mlmc=mlmc)
    merged = [p for p, _ in agg_param_spec("nnm+" + base_name)]
    idx = [merged.index(p) for p, _ in agg_param_spec(base_name)]
    # the base's slots are one run of the composite's: (delta, rest) or
    # (rest) after NNM's delta
    lo = idx[0] if idx else 0
    assert idx == list(range(lo, lo + len(idx))), idx
    # a coordinate-wise base takes the mix+reduce primitive, as NNM.tree
    # does; the trim stays on the card, where the kernel reads it
    mode = _CW_MODES.get(base_name)

    def fn(stacked, n, theta):
        m = next(iter(stacked.values())).shape[0]
        k = m - traced_count(theta[0] * m)
        d2 = tree_pairwise_sqdist(stacked, backend=backend)
        w = _nnm_weights(d2, k)
        if mode is not None:
            trim = traced_trim_count(theta[0], m) if mode == "tm" else 0
            return tree_combine_reduce(stacked, w, mode=mode, trim=trim,
                                       backend=backend)
        mixed = tree_weighted_combine(stacked, w, backend=backend)
        return base_fn(mixed, n, theta[lo:lo + len(idx)])
    return fn


for _name in _CW_MODES:
    register_uniform(_name, *_uniform_cw(_name))
register_uniform("krum", _build_krum)
register_uniform("geomed", _build_geomed)
register_uniform("mfm", _build_mfm)
register_uniform("nnm", _build_nnm)
