"""Backend-dispatching aggregation engine: the port of the JAX package's
``core/agg_engine.py``, class rules and uniform theta forms.

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
in one launch, and the lane reduce every leaf of every lane of a sweep.

The uniform theta forms at the bottom (``agg_theta``, ``uniform_aggregator``,
``agg_switch``) carry a rule's hyperparameters as a float32 row on the card,
so a sweep's lanes may differ in rule and hyperparameters: the counts they
derive (trims, Krum's and NNM's k) stay tensors on the card, with no host
sync.
"""
from __future__ import annotations

import functools
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
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


def tree_cw_reduce_lanes(stacked: Tree, mode: str, trim=0, *,
                         backend: str = "auto") -> Tree:
    """``tree_cw_reduce`` of every lane of a sweep: leaves (C, m, ...),
    lane c's worker stack at [c], -> leaves (C, ...). ``trim`` is an int for
    every lane or an integer tensor of C elements, lane c's at c. One kernel
    launch for every leaf of every lane on the kernel backend
    (``kernels/fused.tree_cw_reduce_lanes``), each lane's row the bits of a
    one-lane ``tree_cw_reduce``; a plain reduce per lane and leaf on the ref
    backend."""
    keys = sorted(stacked)
    if not keys:
        return {}
    mats = [stacked[k].reshape(stacked[k].shape[:2] + (-1,))
            .to(torch.float32).contiguous() for k in keys]
    if dispatch_backend(backend, mats[0]) == "kernel":
        outs = kfused.tree_cw_reduce_lanes(mats, mode, trim)
    else:
        outs = [kref.cw_reduce_lanes_ref(x, mode, trim) for x in mats]
    return {k: o.reshape(stacked[k].shape[:1] + stacked[k].shape[2:])
            .to(stacked[k].dtype) for k, o in zip(keys, outs)}


def _leaf_total(parts: Dict[str, torch.Tensor], leaf_sum) -> torch.Tensor:
    """The per-leaf partials summed in sorted key order, or by
    ``leaf_sum`` (a sharded round's ``core/sharded.ShardPlan.total``, over
    every rank's blocks of the leaves)."""
    if leaf_sum is not None:
        return leaf_sum(parts)
    return sum(parts[k] for k in sorted(parts))


def tree_pairwise_sqdist(stacked: Tree, *, backend: str = "auto",
                         leaf_sum=None) -> torch.Tensor:
    """Global (m, m) squared distances summed over per-leaf contributions.
    ``leaf_sum`` sums the leaves' partials where the leaves are blocks of
    sharded parameters (None: the leaves are whole)."""
    parts = {k: pairwise_sqdist(_as_mat(stacked[k]), backend=backend)
             for k in sorted(stacked)}
    return torch.clamp(_leaf_total(parts, leaf_sum), min=0.0)


def tree_cross_sqdist(stacked: Tree, z: Tree, *, backend: str = "auto",
                      leaf_sum=None) -> torch.Tensor:
    """Global (m,) squared distances from the m stacked entries to point z
    (a dict shaped like one worker's entry), summed per leaf (``leaf_sum``
    as in ``tree_pairwise_sqdist``)."""
    parts = {k: cross_sqdist(_as_mat(stacked[k]),
                             z[k].reshape(1, -1).to(torch.float32).contiguous(),
                             backend=backend)[:, 0]
             for k in sorted(stacked)}
    return torch.clamp(_leaf_total(parts, leaf_sum), min=0.0)


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
    leaf with a leading worker axis m) into one worker's shape, and
    ``__call__`` an (m, d) matrix, as a one-leaf tree in float32."""

    name = "base"
    coordinate_wise = False

    def __init__(self, backend: str = "auto"):
        self.backend = backend

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return self.tree({"x": torch.as_tensor(x).to(torch.float32)})["x"]

    def tree(self, stacked: Tree, leaf_sum=None) -> Tree:
        """The aggregate of ``stacked``. ``leaf_sum`` sums per-leaf partial
        statistics where the leaves are this rank's blocks of sharded
        parameters (``core/sharded.ShardPlan.total``); None: the leaves are
        whole. Coordinate-wise rules read none."""
        raise NotImplementedError

    def leaf(self, l: torch.Tensor) -> torch.Tensor:
        """(m, ...) -> (...). Exact only for coordinate-wise rules, which
        aggregate each parameter shard on its own."""
        raise NotImplementedError(
            f"{self.name} needs global geometry; only coordinate-wise rules "
            "support per-shard aggregation (DESIGN.md §3)")


class CoordinateWiseRule(Aggregator):
    """Rules that reduce each coordinate independently (Mean / CWMed / CWTM)
    by the reduce ``cr_mode`` ("mean", "med" or "tm") at ``trim(m)``: one
    ``tree_cw_reduce`` over the tree."""

    cr_mode: Optional[str] = None  # set by each rule
    coordinate_wise = True

    def trim(self, m: int) -> int:
        """Rows dropped at each end of m (the trimmed mean's)."""
        return 0

    def leaf(self, l: torch.Tensor) -> torch.Tensor:
        return self.tree({"leaf": l})["leaf"]

    def tree(self, stacked: Tree, leaf_sum=None) -> Tree:
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

    def tree(self, stacked: Tree, leaf_sum=None) -> Tree:
        d2 = tree_pairwise_sqdist(stacked, backend=self.backend,
                                  leaf_sum=leaf_sum)
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


# ==================================================== uniform theta forms
#
# The lane-batched sweep (``core/robust_train.py``) runs cells with different
# rules and hyperparameters as lanes of one compiled round, so a rule's
# hyperparameters are data: slot i of a lane's theta row holds the i-th
# hyperparameter of its rule per ``agg_param_spec``. Every rule has the
# uniform form ``(stacked, n, theta) -> agg_tree`` over one lane (``n`` the
# mini-batch size, which MFM's auto-tau scales with), and ``agg_switch``
# applies the forms to the lanes of a sweep, each rule once on its own
# lanes.

AGG_PARAMS: Dict[str, Tuple[Tuple[str, Any], ...]] = {
    "mean": (),
    "cwmed": (),
    "cwtm": (("delta", 0.25),),
    "krum": (("delta", 0.25), ("multi", 1)),
    "geomed": (("iters", 8), ("eps", 1e-8)),
    "mfm": (("tau", None),),  # None -> NaN sentinel: auto tau from (mlmc, n)
}

# ``nnm+<base>`` composites prepend NNM's delta and share the slot with the
# base rule's delta (as ``get_aggregator`` passes one delta to both); the
# widest row is nnm+geomed's (delta, iters, eps)
N_AGG_PARAMS = 1 + max(
    len([p for p in spec if p[0] != "delta"]) for spec in AGG_PARAMS.values())

# (rule, param) pairs where None is NaN in theta, resolved by the uniform
# form: plain mfm only, as the per-cell driver has an auto tau for it alone
AGG_NAN_SENTINELS = {("mfm", "tau")}

# the most Weiszfeld steps of the uniform GeoMed form: it runs this many,
# each gated on the lane's ``iters``
GEOMED_MAX_ITERS = 8


def agg_param_spec(name: str) -> Tuple[Tuple[str, Any], ...]:
    """(name, default) slots of ``name``'s theta row, composites included."""
    name = name.lower()
    if name.startswith("nnm+"):
        base = agg_param_spec(name[4:])
        return (("delta", 0.25),) + tuple(p for p in base if p[0] != "delta")
    if name not in AGG_PARAMS:
        raise ValueError(f"unknown aggregator {name!r}; known: "
                         f"{tuple(sorted(AGG_PARAMS))} and nnm+<base>")
    return AGG_PARAMS[name]


def agg_param_names(name: str) -> Tuple[str, ...]:
    return tuple(p for p, _ in agg_param_spec(name))


def agg_theta(name: str,
              kwargs: Optional[Mapping[str, Any]] = None) -> np.ndarray:
    """(N_AGG_PARAMS,) float32 hyperparameter row for ``name``: unset
    parameters take their ``agg_param_spec`` defaults; unknown ones raise,
    as does ``None`` for a parameter without NaN-sentinel support, or an
    ``iters`` beyond ``GEOMED_MAX_ITERS``. ``delta`` is accepted (and
    dropped) for rules without a delta slot, as ``get_aggregator`` takes
    one for every rule."""
    kw = dict(kwargs or {})
    if "delta" not in agg_param_names(name):
        kw.pop("delta", None)
    theta = np.zeros(N_AGG_PARAMS, np.float32)
    for i, (pname, default) in enumerate(agg_param_spec(name)):
        val = kw.pop(pname, default)
        if val is None and (name, pname) not in AGG_NAN_SENTINELS:
            raise TypeError(
                f"{name!r} aggregator parameter {pname!r} does not accept None")
        if pname == "iters" and val is not None and val > GEOMED_MAX_ITERS:
            raise ValueError(
                f"{name!r}: iters={val} exceeds the uniform form's static "
                f"unroll bound GEOMED_MAX_ITERS={GEOMED_MAX_ITERS}; use the "
                f"class rule (get_aggregator) for longer Weiszfeld runs")
        theta[i] = np.nan if val is None else float(val)
    if kw:
        raise TypeError(f"unknown {name!r} aggregator parameter(s): {sorted(kw)}")
    return theta


def traced_count(v) -> torch.Tensor:
    """⌈v⌉ as an int32 tensor for a float32 count like δ·m held in a tensor
    (on the card: no host sync), the tensor twin of ``count_ceil`` with the
    same 1e-5 nudge, so both agree on exact-integer products."""
    return torch.ceil(torch.as_tensor(v, dtype=torch.float32) - 1e-5).to(
        torch.int32)


def traced_trim_count(delta, m: int) -> torch.Tensor:
    """``trim_count`` for a delta held in a tensor: the same clipping, on
    the tensor's device."""
    return torch.clamp(traced_count(delta * m), 0, (m - 1) // 2)


_UNIFORM: Dict[str, Callable] = {}
_UNIFORM_LANES: Dict[str, Callable] = {}


def register_uniform(name: str, builder: Callable,
                     lanes_builder: Optional[Callable] = None) -> None:
    """``builder(backend, mlmc) -> fn(stacked, n, theta)`` over one lane; the
    special key ``"nnm"`` registers the composite ``builder(base_name,
    backend, mlmc)``. ``lanes_builder(backend, mlmc) -> fn(stacked, n,
    thetas)`` is the rule over the (C, m, ...) leaves and (C, N_AGG_PARAMS)
    rows of a sweep's lanes at once, where the rule has one (the
    coordinate-wise rules: one lane reduce)."""
    _UNIFORM[name] = builder
    if lanes_builder is not None:
        _UNIFORM_LANES[name] = lanes_builder


def uniform_aggregator(name: str, *, backend: str = "auto", mlmc=None):
    """``name`` under the uniform ``(stacked, n, theta)`` signature over one
    lane (leaves (m, ...), ``theta`` an (N_AGG_PARAMS,) float32 tensor),
    reading its hyperparameters from theta's slots. ``mlmc`` (an
    ``MLMCConfig``) supplies MFM's auto threshold ``mlmc.mfm_tau(n)`` where
    the tau slot holds NaN."""
    import repro_torch.core.aggregators  # noqa: F401  (registers the forms)
    name = name.lower()
    agg_param_spec(name)  # validates the name
    if name.startswith("nnm+"):
        return _UNIFORM["nnm"](name[4:], backend, mlmc)
    return _UNIFORM[name](backend, mlmc)


def uniform_lanes(name: str, *, backend: str = "auto", mlmc=None):
    """``name`` over the lanes of a sweep: ``fn(stacked, n, thetas)`` with
    leaves (C, m, ...) and thetas (C, N_AGG_PARAMS) -> leaves (C, ...).
    The coordinate-wise rules reduce every lane in one launch; the other
    rules run their uniform form once per lane."""
    import repro_torch.core.aggregators  # noqa: F401  (registers the forms)
    name = name.lower()
    if name in _UNIFORM_LANES:
        return _UNIFORM_LANES[name](backend, mlmc)
    one = uniform_aggregator(name, backend=backend, mlmc=mlmc)

    def per_lane(stacked, n, thetas):
        outs = [one({k: v[c] for k, v in stacked.items()}, n, thetas[c])
                for c in range(thetas.shape[0])]
        return {k: torch.stack([o[k] for o in outs]) for k in sorted(stacked)}
    return per_lane


def _per_level(fn, stacked, n, theta):
    """Run a uniform form at one batch size, or, when ``n`` is a tuple, at
    each of several: the leaves of ``stacked`` then carry a leading level
    axis, and so does the result."""
    if not isinstance(n, tuple):
        return fn(stacked, n, theta)
    outs = [fn({k: v[i] for k, v in stacked.items()}, ni, theta)
            for i, ni in enumerate(n)]
    return {k: torch.stack([o[k] for o in outs]) for k in sorted(stacked)}


def agg_switch(names: Sequence[str], *, backend: str = "auto",
               mlmc=None) -> Callable:
    """``apply(ids, stacked, n, theta)`` over the lanes of a sweep: ``ids``
    (C host ints) index ``names``, ``stacked`` holds (C, m, ...) leaves
    (with a leading level axis when ``n`` is a tuple, as in ``_per_level``)
    and ``theta`` the (C, N_AGG_PARAMS) rows on their device. Each rule runs
    once on its own lanes (``uniform_lanes``), and the results come back in
    lane order: nothing runs every rule and selects."""
    names = tuple(n.lower() for n in names)
    forms = {nm: uniform_lanes(nm, backend=backend, mlmc=mlmc) for nm in names}

    def apply(ids, stacked, n, theta):
        ids = [int(i) for i in ids]
        groups: Dict[str, list] = {}
        for c, i in enumerate(ids):
            groups.setdefault(names[i], []).append(c)
        lane_axis = 1 if isinstance(n, tuple) else 0
        if len(groups) == 1:
            (nm,) = groups
            return _per_level(forms[nm], stacked, n, theta)
        lanes = [None] * len(ids)
        for nm, idx in groups.items():
            sub = {k: torch.stack([v.select(lane_axis, c) for c in idx],
                                  dim=lane_axis) for k, v in stacked.items()}
            out = _per_level(forms[nm], sub, n,
                             torch.stack([theta[c] for c in idx]))
            for j, c in enumerate(idx):
                lanes[c] = {k: v.select(lane_axis, j) for k, v in out.items()}
        return {k: torch.stack([lane[k] for lane in lanes], dim=lane_axis)
                for k in sorted(stacked)}

    return apply
