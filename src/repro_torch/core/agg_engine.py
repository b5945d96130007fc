"""Backend-dispatching aggregation engine: the class-rule part of the JAX
package's ``core/agg_engine.py``.

Every rule decomposes into three primitives over a worker stack x: (m, d):

  1. coordinate-wise reduce: (m, d) -> (d,) median / trimmed mean / mean;
  2. pairwise-distance accumulate: per-leaf (m, m) (or (m, k) cross)
     squared distances, summed over the leaves into the global ones;
  3. weighted combine: (k, m) @ (m, d) -> (k, d) per leaf, and its
     mix-then-reduce form (combine, then 1) in one pass.

Each primitive has two backends: ``ref`` (plain PyTorch, ``kernels/ref.py``)
and ``kernel`` (the hand-written CUDA kernels, ``kernels/fused.py``).
``auto`` takes the kernel for a tensor on the card and the plain version for
one on the CPU; ``kernel`` on a CPU tensor raises. There is no size
threshold yet: the JAX package's ``PALLAS_MIN_BYTES`` was set for a TPU and a
CPU, and the H100's is to be set from the kernel and plain times in PERF.md.

Rules stream leaf by leaf in sorted key order (the JAX package's
``jax.tree.leaves`` order); only the (m, m) distance statistics are global,
and none materializes the flat (m, d_total) matrix. On the kernel backend
the coordinate-wise reduce and the combine forms take every leaf of a tree
in one launch.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import fused as kfused
from repro_torch.kernels import ref as kref

Tree = Dict[str, torch.Tensor]

BACKENDS = ("ref", "kernel")


def resolve_backend(backend: str, device: torch.device) -> str:
    """The backend a primitive runs for tensors on ``device``."""
    if backend == "auto":
        return "kernel" if device.type == "cuda" else "ref"
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; want one of "
                         f"{BACKENDS + ('auto',)}")
    if backend == "kernel" and device.type != "cuda":
        raise ValueError(f"backend='kernel' needs CUDA tensors, got {device};"
                         f" use backend='ref' or 'auto' on the CPU")
    return backend


def dispatch_backend(backend: str, x: torch.Tensor) -> str:
    """Per-call backend choice for one primitive on ``x`` (where an H100
    size threshold for ``auto`` will go)."""
    return resolve_backend(backend, x.device)


# ============================================================ primitives
#
# All take x: (m, d) and return float32.


def cw_mean(x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """(m, d) -> (d,) mean."""
    if dispatch_backend(backend, x) == "kernel":
        return kfused.cw_reduce(x, "mean")
    return kref.cw_mean_ref(x)


def cw_median(x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """(m, d) -> (d,) coordinate-wise median."""
    if dispatch_backend(backend, x) == "kernel":
        return kfused.cwmed(x)
    return kref.cwmed_ref(x)


def cw_trimmed_mean(x: torch.Tensor, trim, *,
                    backend: str = "auto") -> torch.Tensor:
    """(m, d) -> (d,) mean after dropping ``trim`` lowest/highest per
    coordinate. ``trim`` is an int or an integer tensor (on the kernel
    backend one on the card is read there, with no host sync)."""
    if dispatch_backend(backend, x) == "kernel":
        return kfused.cw_reduce(x, "tm", trim)
    return kref.cwtm_ref(x, trim)


def pairwise_sqdist(x: torch.Tensor, *, backend: str = "auto") -> torch.Tensor:
    """(m, d) -> (m, m) squared L2 distances."""
    if dispatch_backend(backend, x) == "kernel":
        return kfused.pairwise_sqdist(x)
    return kref.pairwise_sqdist_ref(x)


def cross_sqdist(x: torch.Tensor, y: torch.Tensor, *,
                 backend: str = "auto") -> torch.Tensor:
    """(m, d), (k, d) -> (m, k) squared L2 distances."""
    if dispatch_backend(backend, x) == "kernel":
        return kfused.cross_sqdist(x, y)
    return kref.cross_sqdist_ref(x, y)


def weighted_combine(x: torch.Tensor, w: torch.Tensor, *,
                     backend: str = "auto") -> torch.Tensor:
    """(m, d) rows combined with weights w: (k, m) -> (k, d), or (m,) -> (d,)."""
    w2 = w[None] if w.dim() == 1 else w
    if dispatch_backend(backend, x) == "kernel":
        out = kfused.weighted_combine(x, w2)
    else:
        out = kref.weighted_combine_ref(x, w2)
    return out[0] if w.dim() == 1 else out


def combine_reduce(x: torch.Tensor, w: torch.Tensor, mode: str, trim=0, *,
                   backend: str = "auto") -> torch.Tensor:
    """Mix-then-reduce in one primitive: the rows of ``w @ x`` (w: (k, m))
    reduced coordinate-wise to (d,) by ``mode`` in {"med", "tm", "mean"}, the
    hot step of NNM with a coordinate-wise base. The kernel backend is one
    launch that reads the stack once and never writes the mixed (k, d)
    matrix; the ref backend runs the two steps of the separate plain
    versions."""
    if dispatch_backend(backend, x) == "kernel":
        return kfused.combine_reduce(x, w, mode, trim)
    return kref.combine_reduce_ref(x, w, mode, trim)


# ------------------------------------------------------------ tree forms
#
# Leaves carry a leading worker axis m; primitives stream per leaf, in
# sorted key order (the reduce and the combines as one launch over the
# leaves' list).


def _as_mat(l: torch.Tensor) -> torch.Tensor:
    """A worker-stacked leaf (m, ...) as a contiguous (m, d) float32 matrix."""
    return l.reshape(l.shape[0], -1).to(torch.float32).contiguous()


def tree_cw_reduce(stacked: Tree, mode: str, trim=0, *,
                   backend: str = "auto") -> Tree:
    """Per-leaf coordinate-wise reduce by ``mode`` ("med", "tm" with
    ``trim``, an int or an integer tensor clipped to [0, (m-1)//2], or
    "mean"), returning a dict shaped like one worker's entry. One kernel
    launch for the whole tree on the kernel backend
    (``kernels/fused.tree_cw_reduce``), a plain reduce per leaf on the ref
    backend."""
    keys = sorted(stacked)
    if not keys:
        return {}
    mats = [_as_mat(stacked[k]) for k in keys]
    if dispatch_backend(backend, mats[0]) == "kernel":
        outs = kfused.tree_cw_reduce(mats, mode, trim)
    else:
        outs = [kref.cw_reduce_ref(x, mode, trim) for x in mats]
    return {k: o.reshape(stacked[k].shape[1:]).to(stacked[k].dtype)
            for k, o in zip(keys, outs)}


def tree_pairwise_sqdist(stacked: Tree, *, backend: str = "auto") -> torch.Tensor:
    """Global (m, m) squared distances summed over per-leaf contributions."""
    parts = [pairwise_sqdist(_as_mat(stacked[k]), backend=backend)
             for k in sorted(stacked)]
    return torch.clamp(sum(parts), min=0.0)


def tree_cross_sqdist(stacked: Tree, z: Tree, *,
                      backend: str = "auto") -> torch.Tensor:
    """Global (m,) squared distances from the m stacked entries to point z
    (a dict shaped like one worker's entry), summed per leaf."""
    parts = [cross_sqdist(_as_mat(stacked[k]),
                          z[k].reshape(1, -1).to(torch.float32).contiguous(),
                          backend=backend)[:, 0]
             for k in sorted(stacked)]
    return torch.clamp(sum(parts), min=0.0)


def tree_weighted_combine(stacked: Tree, w: torch.Tensor, *,
                          backend: str = "auto",
                          out_dtype: Optional[torch.dtype] = None) -> Tree:
    """Per-leaf weighted combine.

    w: (m,) -> a dict shaped like one worker's entry (the aggregate);
    w: (m, m) -> a dict with the worker axis kept (each row re-mixed).
    ``out_dtype=None`` keeps each leaf's dtype; pass torch.float32 to keep
    full precision across Weiszfeld iterations. One kernel launch for the
    whole tree on the kernel backend (``kernels/fused.tree_weighted_combine``),
    a plain combine per leaf on the ref backend."""
    keys = sorted(stacked)
    if not keys:
        return {}
    mats = [_as_mat(stacked[k]) for k in keys]
    w2 = w[None] if w.dim() == 1 else w
    if dispatch_backend(backend, mats[0]) == "kernel":
        outs = kfused.tree_weighted_combine(mats, w2)
    else:
        outs = [kref.weighted_combine_ref(x, w2) for x in mats]

    def leaf(l, out):
        shape = l.shape if w.dim() == 2 else l.shape[1:]
        return out.reshape(shape).to(out_dtype or l.dtype)
    return {k: leaf(stacked[k], o) for k, o in zip(keys, outs)}


def tree_combine_reduce(stacked: Tree, w: torch.Tensor, *, mode: str, trim=0,
                        backend: str = "auto") -> Tree:
    """Per-leaf ``combine_reduce``: mix the m worker rows with w (k, m) and
    reduce the result coordinate-wise, returning a dict shaped like one
    worker's entry. One kernel launch for the whole tree on the kernel
    backend (``kernels/fused.tree_combine_reduce``)."""
    keys = sorted(stacked)
    if not keys:
        return {}
    mats = [_as_mat(stacked[k]) for k in keys]
    if dispatch_backend(backend, mats[0]) == "kernel":
        outs = kfused.tree_combine_reduce(mats, w, mode, trim)
    else:
        outs = [kref.combine_reduce_ref(x, w, mode, trim) for x in mats]
    return {k: o.reshape(stacked[k].shape[1:]).to(stacked[k].dtype)
            for k, o in zip(keys, outs)}


# ============================================================ rule bases


class Aggregator:
    """Base: ``.tree()`` aggregates a worker-stacked parameter dict (every
    leaf with a leading worker axis m) into one worker's shape."""

    name = "base"

    def __init__(self, backend: str = "auto"):
        self.backend = backend

    def tree(self, stacked: Tree) -> Tree:
        raise NotImplementedError


class CoordinateWiseRule(Aggregator):
    """Rules that reduce each coordinate independently (Mean / CWMed / CWTM)
    by the reduce ``cr_mode`` ("mean", "med" or "tm") at ``trim(m)``: one
    ``tree_cw_reduce`` over the tree."""

    cr_mode: Optional[str] = None  # set by each rule

    def trim(self, m: int) -> int:
        """Rows dropped at each end of m (the trimmed mean's)."""
        return 0

    def leaf(self, l: torch.Tensor) -> torch.Tensor:
        return self.tree({"leaf": l})["leaf"]

    def tree(self, stacked: Tree) -> Tree:
        if not stacked:
            return {}
        m = next(iter(stacked.values())).shape[0]
        return tree_cw_reduce(stacked, self.cr_mode, self.trim(m),
                              backend=self.backend)


class GeometryRule(Aggregator):
    """Rules driven by global pairwise geometry: the (m, m) statistics are
    computed once from summed per-leaf contributions, turned into per-worker
    weights, and applied per leaf by the combine primitive."""

    def _weights(self, d2: torch.Tensor) -> torch.Tensor:  # (m, m) -> (m,)|(m, m)
        raise NotImplementedError

    def tree(self, stacked: Tree) -> Tree:
        d2 = tree_pairwise_sqdist(stacked, backend=self.backend)
        return tree_weighted_combine(stacked, self._weights(d2),
                                     backend=self.backend)


# ============================================================ registry

_REGISTRY: Dict[str, Callable[..., Aggregator]] = {}


def register(name: str, factory: Callable[..., Aggregator]) -> None:
    _REGISTRY[name] = factory


def registered_rules():
    """Names registered by ``repro_torch.core.aggregators`` (composites
    ``nnm+<base>`` are resolved by name and not listed)."""
    import repro_torch.core.aggregators  # noqa: F401  (registers the rules)
    return tuple(sorted(_REGISTRY))


def get_aggregator(name: str, delta: float = 0.25, tau: Optional[float] = None,
                   backend: str = "auto", **kwargs) -> Aggregator:
    """The rule registered as ``name``: ``mean``, ``cwmed``, ``cwtm``,
    ``krum``, ``geomed``, ``mfm``, or ``nnm+<base>`` (Nearest-Neighbor Mixing
    in front of any of them, ``delta`` shared by both). ``tau`` is MFM's
    threshold (None: given per call). Extra rule hyperparameters (Krum's
    ``multi``, GeoMed's ``iters``/``eps``) pass through ``kwargs``; unknown
    ones raise ``TypeError``, unknown names ``ValueError``.

    Rules are stateless after construction, so instances are memoized per
    (name, delta, tau, backend, kwargs): the per-round driver asks for its
    rule at every aggregation."""
    return _cached_rule(name.lower(), delta, tau, backend,
                        tuple(sorted(kwargs.items())))


@functools.lru_cache(maxsize=None)
def _cached_rule(name: str, delta: float, tau: Optional[float], backend: str,
                 extra: tuple) -> Aggregator:
    import repro_torch.core.aggregators as rules  # registers on first import
    kw = dict(extra)
    if name.startswith("nnm+"):
        return rules.NNM(get_aggregator(name[4:], delta, tau, backend, **kw),
                         delta, backend=backend)
    if name not in _REGISTRY:
        raise ValueError(f"unknown aggregator {name!r}; known: "
                         f"{registered_rules()} and nnm+<base>")
    return _REGISTRY[name](delta=delta, tau=tau, backend=backend, **kw)


def count_ceil(v: float) -> int:
    """⌈v⌉ for host-side δ·m counts, nudged by 1e-5: 0.28·25 is exactly 7,
    but f64 rounds the product to 7.000000000000001."""
    # jaxlint: disable=JXL003 -- this IS the sanctioned nudged helper JXL003 points at
    return math.ceil(v - 1e-5)


def count_floor(v: float) -> int:
    """⌊v⌋ for host-side δ·m counts, nudged by 1e-5 the other way: 0.3·10
    is exactly 3, but f64 rounds the product to 2.9999999999999996."""
    # jaxlint: disable=JXL003 -- this IS the sanctioned nudged helper JXL003 points at
    return math.floor(v + 1e-5)


def trim_count(delta: float, m: int) -> int:
    """⌈δm⌉ clipped to keep at least one row after two-sided trimming."""
    return min(count_ceil(delta * m), (m - 1) // 2)
