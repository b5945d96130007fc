"""Robust aggregation rules over the ``core.agg_engine`` primitives: the
coordinate-wise rules of the JAX package's ``core/aggregators.py``.
``agg.tree(stacked)`` reduces every leaf (leading worker axis m) to one
worker's shape.

Krum, GeoMed, NNM and MFM are not ported yet; ``get_aggregator`` says so.
"""
from __future__ import annotations

from repro_torch.core.agg_engine import (
    CoordinateWiseRule, cw_mean, cw_median, cw_trimmed_mean, register,
    trim_count,
)


class Mean(CoordinateWiseRule):
    name = "mean"

    def _reduce(self, mat):
        return cw_mean(mat, backend=self.backend)


class CWMed(CoordinateWiseRule):
    """Coordinate-wise median (Yin et al., 2018)."""
    name = "cwmed"

    def _reduce(self, mat):
        return cw_median(mat, backend=self.backend)


class CWTM(CoordinateWiseRule):
    """Coordinate-wise trimmed mean: drop ⌈δm⌉ highest/lowest per coordinate."""
    name = "cwtm"

    def __init__(self, delta: float = 0.25, backend: str = "auto"):
        super().__init__(backend)
        self.delta = delta

    def _reduce(self, mat):
        return cw_trimmed_mean(mat, trim_count(self.delta, mat.shape[0]),
                               backend=self.backend)


register("mean", lambda delta=0.25, backend="auto": Mean(backend=backend))
register("cwmed", lambda delta=0.25, backend="auto": CWMed(backend=backend))
register("cwtm", lambda delta=0.25, backend="auto": CWTM(delta, backend=backend))
